"""Batched caption and VQA engine, the counterpart of the batch-serving
part of `gitax.runtime.pipeline.CaptionEngine`.

Ported: the constructor's int8 / fast-prefill / decode-kernel rules, the
per-prefix-length beam settings (`beam_for`, `_caption_fn`), uint8 upload
with normalization on the device, `dispatch_device_batch`,
`_dispatch_batch`, `generate_batch`, the VQA question prefix
(`encode_prefix`), the variable-resolution batches of the MinMax high-res
models (`dispatch_varshape`, `generate_varshape`: images cut to whole
patches and grouped into exact-grid buckets) and `resolve`.  The items of
`dispatch` and `generate_batch` are images [H, W, 3] or video clips
[F, H, W, 3], one shape per call.  As in gitax, the engine runs the plain
vocab head (no `vocab_kernel`).  Not ported: the TSV loops (they need a
JPEG decode), float image input and the device mesh.  Detokenization
takes a `gitax_torch.tokenization.BertTokenizer`.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..decode.beam import BeamSearchConfig
from ..models.git import GitModel
from ..ops.quant import quantize_git_model_
from ..tokenization import encode_prefix

# CLIP's normalization constants (the reference's image transform)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class CaptionEngine(object):
    """Batched captioning around a port GitModel, whose parameters set the
    device.  `dispatch` runs the search batch by batch and returns a
    handle to the device sequences; `resolve` copies them to the host and
    detokenizes.  (The beam loop reads the host once per step, so
    `dispatch` returns when the device is nearly done.)"""

    def __init__(self, model: GitModel, tokenizer, batch_size: int = 32,
                 beam: Optional[BeamSearchConfig] = None, dtype=torch.bfloat16,
                 max_text_len: int = 40, int8: bool = False,
                 fast_prefill: Optional[bool] = None, decode_kernel=None):
        if int8:
            # weight-only int8 decoder and head matmuls (ops/quant.py); the
            # model is quantized in place
            quantize_git_model_(model)
        self.model = model
        # bf16 prefill score math rides with int8 (both trade exactness);
        # pass fast_prefill=True with a model quantized beforehand
        self._fast_prefill = bool(int8) if fast_prefill is None else bool(fast_prefill)
        # the decode-attention kernel path is the default: the CUDA kernel
        # on a CUDA device, its plain version on the CPU
        self._decode_kernel = True if decode_kernel is None else decode_kernel
        self.device = model.textual.output.bias.device
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.beam = beam or BeamSearchConfig(num_beams=4, max_steps=40)
        self.dtype = dtype
        self.max_text_len = max_text_len
        self.mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=self.device)
        self.std = torch.tensor(CLIP_STD, dtype=torch.float32, device=self.device)

    def beam_for(self, prefix_len: int) -> BeamSearchConfig:
        """The search settings for a prefix length: the beam buffer holds
        the prefix plus max_text_len tokens; the length norm keeps the
        reference's 1024 for is_done parity."""
        return dataclasses.replace(
            self.beam,
            max_steps=max(self.beam.max_steps, prefix_len + self.max_text_len),
            norm_max_length=self.beam.norm_max_length or max(self.beam.max_steps, 1024),
        )

    def _caption_fn(self, prefix_len: int):
        """The batch program for a prefix length (`beam_for`'s settings)."""
        beam = self.beam_for(prefix_len)
        dtype = self.dtype

        def fn(images, prefix):
            x = images.to(dtype) / 255.0
            images = (x - self.mean.to(dtype)) / self.std.to(dtype)
            return self.model.generate(
                images, prefix, beam=beam, dtype=dtype,
                fast_prefill=self._fast_prefill, decode_kernel=self._decode_kernel,
            )

        return fn

    def dispatch_device_batch(self, imgs: np.ndarray, pref: np.ndarray):
        """Upload ONE same-shape batch (images [B, H, W, 3] or clips
        [B, F, H, W, 3], uint8, normalized on the device) with prefixes
        [B, Tp] and run the search.  Returns the device sequences [B, L]."""
        if imgs.dtype != np.uint8:
            raise ValueError("images must be uint8 HWC, got {}".format(imgs.dtype))
        if imgs.ndim not in (4, 5) or imgs.shape[-1] != 3:
            raise ValueError("a batch must be [B, H, W, 3] images or [B, F, H, W, 3] clips, "
                             "got {}".format(imgs.shape))
        pref = torch.from_numpy(np.asarray(pref, np.int64)).to(self.device)
        fn = self._caption_fn(pref.shape[1])
        seqs, _ = fn(torch.from_numpy(imgs).to(self.device), pref)
        return seqs

    def _dispatch_batch(self, images: List[np.ndarray], prefixes: List[List[int]]):
        """Same-shape items (images [H, W, 3] or clips [F, H, W, 3]) ->
        list of device sequence tensors covering >= len(images) rows (the
        tail batch is padded with its last item)."""
        n = len(images)
        if n == 0:
            raise ValueError("no images")
        shape = images[0].shape
        if len(shape) not in (3, 4) or shape[-1] != 3:
            raise ValueError("an item must be an image [H, W, 3] or a clip [F, H, W, 3], "
                             "got {}".format(shape))
        if any(a.shape != shape for a in images):
            raise ValueError("items of one dispatch must share one shape, got {}".format(
                sorted({a.shape for a in images})))
        b = self.batch_size
        tp = len(prefixes[0])
        if any(len(p) != tp for p in prefixes):
            raise ValueError("prefixes of one dispatch must have one length")
        pad_n = (-n) % b
        imgs = np.stack(images + [images[-1]] * pad_n)
        pref = np.asarray(prefixes + [prefixes[-1]] * pad_n, np.int64)
        return [self.dispatch_device_batch(imgs[i:i + b], pref[i:i + b])
                for i in range(0, len(imgs), b)]

    def dispatch(self, images: List[np.ndarray], prefixes: List[List[int]]):
        """Run generation over same-shape images [H, W, 3] or clips
        [F, H, W, 3]; returns a handle for `resolve`, of the form
        `dispatch_varshape` returns (one bucket)."""
        return len(images), [(list(range(len(images))), self._dispatch_batch(images, prefixes))]

    def encode_prefix(self, text: str) -> List[int]:
        """[CLS] + the last (max_text_len - 2) question tokens."""
        return encode_prefix(self.tokenizer, text, self.max_text_len)

    def dispatch_varshape(self, images: List[np.ndarray], prefixes: List[List[int]]):
        """Run generation over images of varying shapes (the MinMax
        high-res models, reference inference.py:29-64): each image is cut
        to whole patches, as the reference's strided patchify drops the
        remainder pixels, and the images are grouped into exact-grid
        buckets, one batch program each (gitax pipeline.py:296-319).  The
        prefixes of one call share one length.  Returns a handle for
        `resolve`."""
        p = self.model.cfg.encoder.patch_size
        groups = collections.defaultdict(list)
        for i, a in enumerate(images):
            if a.ndim != 3:
                raise ValueError("dispatch_varshape takes images [H, W, 3], got {}".format(a.shape))
            groups[((a.shape[0] // p) * p, (a.shape[1] // p) * p)].append(i)
        dispatched = []
        for (h, w), idxs in sorted(groups.items()):
            seqs = self._dispatch_batch([images[i][:h, :w] for i in idxs],
                                        [prefixes[i] for i in idxs])
            dispatched.append((idxs, seqs))
        return len(images), dispatched

    def resolve(self, handle):
        """Copy a dispatched handle's sequences to the host and detokenize
        them, in the order the images were given."""
        n, dispatched = handle
        results = [None] * n
        for idxs, seqs in dispatched:
            arr = torch.cat([s.cpu() for s in seqs], dim=0)[:len(idxs)].numpy()
            for i, row in zip(idxs, arr):
                results[i] = self.tokenizer.decode(row.tolist(), skip_special_tokens=True)
        return results

    def generate_batch(self, images: List[np.ndarray], prefixes: List[List[int]]):
        """images: list of same-shape HWC arrays or FHWC clips; prefixes:
        token lists of one length.  Returns the decoded strings."""
        return self.resolve(self.dispatch(images, prefixes))

    def generate_varshape(self, images: List[np.ndarray], prefixes: List[List[int]]):
        """`dispatch_varshape` then `resolve`: the decoded strings."""
        return self.resolve(self.dispatch_varshape(images, prefixes))
