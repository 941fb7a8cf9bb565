"""The system under test, built as its entry points build it, and the
benchmark's hooks on the calls into its layers.

`Program` builds gitax_torch's `GitModel` from the configuration file's widths,
loads the benchmark's weights, and wraps it in a `CaptionEngine` with the
settings of the TSV CLI (`inference.test_git_inference_single_tsv`: bf16,
weight-only int8, beam 4, buffer prefix + 40, the config's transform, the
native loader where it builds).

`Hooks` wraps public methods of those objects at run time, from this folder,
never in the program's files:
- always (they decide `correct` and the rates): `CaptionEngine.
  dispatch_device_batch` (each batch's frames a row, one frame's shape,
  prefixes, a 4 x 4 pixel fingerprint of each row's frames and its
  sequences), `GitModel.generate` (each batch's scores, the search's second
  output: on a mesh's rank 0, the rows of its own data shard, the first
  rows of the batch), `CaptionEngine.resolve` (when each handle's items
  completed);
- with tracing on, also the host clock around `dispatch_device_batch`,
  `resolve`, `to_host` and the decode pool's chunks, and CUDA events around
  `generate`, `encode_images` and `prefill` (a copy of chip_smoke.py's
  `SearchSpans`: the loop's device time is the generate span less the
  other two).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from . import vocab as V
from .reference import CLIP_MEAN, CLIP_STD

FP_GRID = 4  # fingerprint: a 4 x 4 grid of pixels a row


def fingerprint(imgs):
    """[B, H, W, 3] images or [B, F, H, W, 3] clips, uint8 or normalised
    float -> uint8 [B, 4, 4, 3] or [B, F, 4, 4, 3]: each frame's pixels at
    the centres of a 4 x 4 grid (the last three axes), de-normalised with
    CLIP's constants where the batch is float."""
    imgs = np.asarray(imgs)
    h, w = imgs.shape[-3], imgs.shape[-2]
    ys = ((np.arange(FP_GRID) + 0.5) * h / FP_GRID).astype(int)
    xs = ((np.arange(FP_GRID) + 0.5) * w / FP_GRID).astype(int)
    px = np.take(np.take(imgs, ys, axis=-3), xs, axis=-2).astype(np.float32)
    if imgs.dtype != np.uint8:
        px = (px * CLIP_STD + CLIP_MEAN) * 255.0
    return np.clip(np.rint(px), 0, 255).astype(np.uint8)


def frames(imgs):
    """The frames a row of a batch: 1 for [B, H, W, 3], F for [B, F, H, W, 3]."""
    return int(np.shape(imgs)[1]) if np.ndim(imgs) == 5 else 1


def port_config(cfg):
    """The program's GitConfig from the file's widths; for a model of the
    port's zoo it must equal the zoo's (with fast_softmax as the file says).
    `num_image_with_embedding` (the zoo's frames of a video model, each with
    its temporal embedding) is 0 where the file has none."""
    from gitax_torch.models.config import (MODEL_ZOO, GitConfig, ViTConfig, config_from_param,
                                           get_model_param)

    enc = ViTConfig(patch_size=cfg["patch_size"], width=cfg["encoder_width"],
                    layers=cfg["encoder_layers"], heads=cfg["encoder_heads"],
                    input_resolution=cfg["test_crop_size"], ln_eps=cfg["encoder_ln_eps"],
                    fast_softmax=bool(cfg["fast_softmax"]))
    port = GitConfig(encoder=enc, visual_feature_size=cfg["visual_feature_size"],
                     vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
                     num_layers=cfg["num_layers"], num_heads=cfg["num_heads"],
                     feedforward_size=cfg["feedforward_size"],
                     max_caption_length=cfg["max_caption_length"],
                     bert_ln_eps=cfg["bert_ln_eps"], embedding_ln_eps=cfg["embedding_ln_eps"],
                     projection_ln_eps=cfg["projection_ln_eps"],
                     num_image_with_embedding=int(cfg.get("num_image_with_embedding", 0)))
    if cfg["model_name"] in MODEL_ZOO:
        zoo = config_from_param(dict(get_model_param(cfg["model_name"]),
                                     fast_softmax=bool(cfg["fast_softmax"])))
        if zoo != port:
            raise ValueError("the file's sizes are not {}'s: {} against {}".format(
                cfg["model_name"], port, zoo))
    return port


def build_model(cfg, sd, device):
    """The port's GitModel of the file's widths on `device`, holding the
    benchmark's weights `sd` (copied into its own parameters)."""
    import torch

    from gitax_torch.models.git import GitModel

    model = GitModel(port_config(cfg), device=device, dtype=getattr(torch, cfg["dtype"]))
    model.load_state_dict(sd)
    return model


def engine_settings(cfg):
    """(tokenizer, keyword arguments of `CaptionEngine`) as the TSV CLI sets
    them for the file's configuration."""
    import torch

    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.preprocess.transforms import TestTransform
    from gitax_torch.tokenization import BertTokenizer

    transform = TestTransform(crop_size=cfg["test_crop_size"],
                              respect_ratio_max=cfg.get("test_respect_ratio_max"))
    return BertTokenizer(V.tokens(cfg["vocab_size"])), dict(
        batch_size=cfg["batch_size"],
        beam=BeamSearchConfig(num_beams=cfg["num_beams"], max_steps=cfg["max_steps"]),
        dtype=getattr(torch, cfg["dtype"]), max_text_len=cfg["max_text_len"],
        int8=bool(cfg["int8"]), transform=transform, use_native=None)


class Program(object):
    """The port's model and engine on `device`, from the benchmark's
    weights `sd` (copied into the program's own parameters)."""

    def __init__(self, cfg, sd, device):
        from gitax_torch.runtime.engine import CaptionEngine

        self.cfg = cfg
        self.model = build_model(cfg, sd, device)
        tokenizer, kwargs = engine_settings(cfg)
        self.transform = kwargs["transform"]
        self.engine = CaptionEngine(self.model, tokenizer, **kwargs)

    def close(self):
        self.engine.close()


class Hooks(object):
    """Run-time wrappers on the program's objects (see the module
    docstring).  `recording` gates the batch records; `traced` adds the
    host spans and CUDA events."""

    def __init__(self, program, traced):
        import torch

        self.p, self.traced = program, traced
        self.lock = threading.Lock()
        self.recording = False
        self.batches = []  # dicts: frames, shape, fp, prefix, seqs, scores, t, rows
        self.resolved = []  # (host time, items) of each resolve
        self.answers = []  # (id of a batch's sequences, row, text, host time) of each item
        self.real = {}  # id(seqs) -> real items of that batch (from resolve)
        self.dispatch_ms = []
        self.chunks = []  # (host ms, rows) of each decode chunk
        self.spans = []  # (name, host t0, host t1) while tracing
        self.events = {"encode_images": [], "prefill": [], "generate": []}
        self.generate_t = []  # host time of each traced generate call
        self.captures = 0
        self._last = threading.local()  # the scores of this thread's last generate
        self._undo = []
        eng, model = program.engine, program.model

        gen = model.generate

        def generate(*a, **kw):
            if traced:
                self.generate_t.append(time.perf_counter())
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
            seqs, scores = gen(*a, **kw)
            if traced:
                e.record()
                self._event("generate", s, e)
            self._last.scores = scores
            return seqs, scores

        self._wrap(model, "generate", generate)
        if traced:
            for name in ("encode_images", "prefill"):
                self._wrap(model, name, self._evented(name, getattr(model, name)))

        dispatch = eng.dispatch_device_batch

        def dispatch_device_batch(imgs, pref, **kw):
            self._last.scores = None
            t0 = time.perf_counter()
            seqs = dispatch(imgs, pref, **kw)
            t1 = time.perf_counter()
            scores, self._last.scores = self._last.scores, None
            if self.recording:
                with self.lock:
                    self.batches.append(dict(
                        frames=frames(imgs), shape=tuple(np.shape(imgs)[-3:-1]),
                        fp=fingerprint(imgs),
                        prefix=np.array(pref, np.int64), seqs=seqs, scores=scores, t=t1,
                        rows=int(np.shape(imgs)[0])))
                    if traced:
                        self.dispatch_ms.append((t1 - t0) * 1e3)
                        self.spans.append(("dispatch", t0, t1))
            return seqs

        self._wrap(eng, "dispatch_device_batch", dispatch_device_batch)

        resolve = eng.resolve

        def resolve_(handle):
            t0 = time.perf_counter()
            out = resolve(handle)
            t1 = time.perf_counter()
            n, dispatched = handle
            with self.lock:
                self.resolved.append((t1, n))
                for idxs, seqs in dispatched:
                    at = 0
                    for s in seqs:
                        real = min(len(idxs) - at, int(s.shape[0]))
                        self.real[id(s)] = real
                        if self.recording:
                            self.answers += [(id(s), r, out[idxs[at + r]], t1)
                                             for r in range(real)]
                        at += real
                if traced and self.recording:
                    self.spans.append(("resolve", t0, t1))
            return out

        self._wrap(eng, "resolve", resolve_)

        if traced:
            to_host = eng.to_host

            def to_host_(seqs):
                t0 = time.perf_counter()
                out = to_host(seqs)
                if self.recording:
                    with self.lock:
                        self.spans.append(("to_host", t0, time.perf_counter()))
                return out

            self._wrap(eng, "to_host", to_host_)
            chunk = getattr(eng, "_decode_chunk", None)
            if chunk is not None:
                def decode_chunk(payloads):
                    t0 = time.perf_counter()
                    out = chunk(payloads)
                    t1 = time.perf_counter()
                    if self.recording:
                        with self.lock:
                            self.chunks.append(((t1 - t0) * 1e3, len(payloads)))
                            self.spans.append(("decode", t0, t1))
                    return out

                self._wrap(eng, "_decode_chunk", decode_chunk)

        try:
            from gitax_torch.decode import device_loop
        except ImportError:
            device_loop = None
        capture = getattr(device_loop, "_capture", None)
        if capture is not None:
            def capture_(*a, **kw):
                self.captures += 1
                return capture(*a, **kw)

            device_loop._capture = capture_
            self._undo.append(lambda: setattr(device_loop, "_capture", capture))

    def _wrap(self, obj, name, fn):
        setattr(obj, name, fn)
        self._undo.append(lambda: delattr(obj, name))

    def _evented(self, name, fn):
        import torch

        def timed(*a, **kw):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            self._event(name, s, e)
            return out

        return timed

    def _event(self, name, s, e):
        with self.lock:
            self.events[name].append((s, e))

    def span_ms(self, t0, t1):
        """Each span's device ms per call of the generate calls made in host
        times [t0, t1]: {name: [ms, ...]} (waits for the card)."""
        keep = [i for i, t in enumerate(self.generate_t) if t0 <= t <= t1]
        return {name: [ev[i][0].elapsed_time(ev[i][1]) for i in keep]
                for name, ev in self.events.items()}

    def searches(self, ref, t0, t1):
        """The device intervals, in ms after the CUDA event `ref`, of the
        searches (each generate's end of prefill to its end) of the
        generate calls made in host times [t0, t1]."""
        pre, gen = self.events["prefill"], self.events["generate"]
        return [(ref.elapsed_time(pre[i][1]), ref.elapsed_time(gen[i][1]))
                for i, t in enumerate(self.generate_t) if t0 <= t <= t1]

    def remove(self):
        for undo in reversed(self._undo):
            undo()
        self._undo = []

    def host_batches(self):
        """The records with their sequences and scores on the host, and each
        batch's real items: from its resolve, or, where the window was cut
        before it, its distinct (prefix, image) rows (a batch is padded with
        copies of its last item).  A mesh's scores cover its rank 0's rows,
        the batch's first: fewer than its sequences'."""
        out = []
        for b in self.batches:
            seqs = b["seqs"].cpu().numpy()
            scores = None if b["scores"] is None else b["scores"].float().cpu().numpy()
            real = self.real.get(id(b["seqs"]))
            if real is None:
                rows = np.concatenate([b["prefix"], b["fp"].reshape(len(b["fp"]), -1)], 1)
                real = len(np.unique(rows, axis=0))
            out.append(dict(b, seqs=seqs, scores=scores, real=real))
        return out


def launch_counts():
    """The port's own launch counters of its kernels 1 and 2 (replayed
    graphs' launches added by `device_loop.settle`, which `steps_settled`
    calls first): {kernel name: launches}."""
    from gitax_torch.ops import decode_attention, flash_attention

    return {"decode_attention": decode_attention.decode_attention.launches,
            "flash_attention": flash_attention.launches}


def steps_settled(model):
    """The decode steps the model's searches have run, replayed graphs'
    included (`device_loop.settle`, which waits for the card)."""
    from gitax_torch.decode import device_loop

    device_loop.settle()
    return model.decode_step_calls
