"""Batched TSV inference, the counterpart of `gitax.runtime.pipeline`.

The reference's distributed batch inference (inference.py:134-225) runs
batch-size-1 forwards and scales by mpirun process count, with a
file-system barrier.  The port's engine, as gitax's:

  * rows are range-sharded per process exactly like the reference
    (ceil(N/W) contiguous rows per rank, inference.py:157-169), and each
    rank writes `out.{rank}.{world}.tsv`, which rank 0 concatenates
    (`finish_shards`: a torch.distributed barrier when a process group is
    up, else the reference's poll of the file system); on a launch of
    several hosts, each host's mesh takes its own rows and the barrier is
    a gloo group of the hosts' rank 0s (`Mesh.hosts_group`);
  * within a process, images are decoded and transformed by a host
    thread pool that prefetches ahead of the device (`_prefetched_chunks`)
    while the search runs batch by batch, the tail batch padded with its
    last item;
  * VQA prefixes are bucketed by token length, so that each dispatch
    has one prefix length, and answers are emitted in the reference's
    row order.

`CaptionEngine` takes gitax's `transform`: its mean and std normalise
uint8 batches on the device (CLIP's when the transform has none or there
is no transform); float batches, the transform's own normalised output,
are uploaded cast to the engine's dtype and not normalised again.  Also
ported: the constructor's int8 / fast-prefill / decode-kernel rules, the
per-prefix-length beam settings (`beam_for`, `_caption_fn`),
`dispatch_device_batch`, `_dispatch_batch`, `generate_batch`, `to_host`,
`encode_prefix`, the variable-resolution batches of the MinMax high-res
models (`dispatch_varshape`: images cut to whole patches and grouped into
exact-grid buckets) and `resolve`.  Items are images [H, W, 3] or video
clips [F, H, W, 3], one shape per dispatch.  As in gitax, the engine runs
the plain vocab head (no `vocab_kernel`).  `use_native` is gitax's
switch for the native loader (`gitax_torch.native`: libjpeg decode,
resize and crop in C++, uint8 out): None uses it where it built, True
requires it (raising with the build's reason where it did not build),
False decodes with PIL.  On a machine without `jpeglib.h` (the H100's)
None decodes with PIL, as gitax does there.  On one card the search
runs as a replayed CUDA graph step (`decode.device_loop`) and the upload
goes through page-locked buffers (`PinnedUploads`), so `dispatch`
returns before the search ends, as gitax's asynchronous dispatch does:
the TSV loops' three stages (decode of chunk i+1, the search of chunk i,
detokenisation of chunk i-1) overlap, and `resolve` (`to_host`) is the
first host wait.

On a mesh (`mesh=`, gitax pipeline.py:166-182 and 334-378) the engine is
one process per rank, not gitax's one SPMD program.  Rank 0 is the
engine its caller drives; ranks 1.. run `follow`.  Every rank holds the
same weights (rank 0's, broadcast), quantized whole when int8 and then
cut to its shards (`parallel.mesh.shard_for_inference`).  Each device
batch is padded on rank 0 to a multiple of the data axis by repeating
its last row, as gitax pads; rank 0 broadcasts a header (op, shape,
dtype, prefix length) over a gloo group on the host, which never times
out while a server idles, then the batch over the mesh's backend.  Each
data rank runs the search on its rows (`Mesh.batch_rows`), its model
group on its heads, and the sequences come back to rank 0 as an
all-reduce of zero-padded rows over the data axis.  Rank 0 issues every
collective from the thread that calls `dispatch_device_batch`, under a
lock, in one order.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import json
import logging
import os
import os.path as op
import threading
import time
import types
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..common import json_dump
from ..decode.beam import BeamSearchConfig
from ..io import fileio
from ..io.image import image_from_base64
from ..io.tsv import TSVFile, concat_tsv_files, tsv_writer
from ..models.git import GitModel
from ..ops.quant import quantize_git_model_
from ..parallel import comm
from ..parallel.mesh import broadcast_params, mesh_dims, shard_for_inference
from ..preprocess.transforms import CLIP_MEAN, CLIP_STD
from ..tokenization import encode_prefix
from . import distributed


def resolve_use_native(use_native: Optional[bool]) -> bool:
    """gitax's `use_native` rule (pipeline.py:197-201): None -> the native
    loader where it built, else PIL; True -> the loader, raising with the
    build's reason where it did not build; False -> PIL."""
    if use_native is False:
        return False
    from .. import native

    if use_native is None:
        return native.available()
    if not native.available():
        raise RuntimeError("use_native=True: the native loader did not build ({}); pass "
                           "use_native=None or False to decode with PIL".format(
                               native.unavailable_reason()))
    return True


def shard_range(total: int, rank: int, world_size: int) -> Tuple[int, int]:
    """Contiguous ceil-split row range (reference inference.py:165-169)."""
    per = (total + world_size - 1) // world_size
    start = per * rank
    return start, min(start + per, total)


def wait_and_concat_shards(out_tsv: str, world_size: int,
                           poll_s: Optional[float] = None,
                           timeout_s: Optional[float] = None):
    """Rank-0 file-system barrier + concat (reference inference.py:214-225),
    with an optional timeout instead of the reference's infinite wait.
    Defaults come from GITAX_SHARD_POLL_S (5 s) and
    GITAX_SHARD_WAIT_TIMEOUT_S (unset: wait forever, as the reference)."""
    if poll_s is None:
        poll_s = float(os.environ.get("GITAX_SHARD_POLL_S", "5"))
    if timeout_s is None:
        env_t = os.environ.get("GITAX_SHARD_WAIT_TIMEOUT_S")
        timeout_s = float(env_t) if env_t else None
    shards = ["{}.{}.{}.tsv".format(out_tsv, r, world_size) for r in range(world_size)]
    deadline = None if timeout_s is None else time.time() + timeout_s
    while True:
        # the shards are written through the fileio seam, so the barrier
        # polls through it too
        missing = [s for s in shards if not fileio.isfile(s)]
        if not missing:
            break
        if deadline and time.time() > deadline:
            raise TimeoutError("missing shards: {}".format(missing))
        logging.info("waiting for %s", ",".join(missing))
        time.sleep(poll_s)
    concat_tsv_files(shards, out_tsv)


def finish_shards(out_tsv: str, rank: int, world_size: int, group=None):
    """After this rank's shard is written: with a torch.distributed group
    of more than one process, a barrier (every shard is closed before its
    rank enters), then rank 0 concatenates; otherwise rank 0 polls the
    file system for the shards (reference inference.py:214-225).  group:
    the group of the shards' writers (the hosts' rank 0s of a launch of
    several meshes), else the whole process group."""
    if world_size <= 1:
        return
    if group is not None:
        import torch.distributed as dist

        dist.barrier(group=group)
    elif distributed.is_active():
        distributed.barrier("gitax_tsv_shards:" + op.basename(out_tsv))
    else:
        if rank == 0:
            wait_and_concat_shards(out_tsv, world_size)
        return
    if rank == 0:
        concat_tsv_files(["{}.{}.{}.tsv".format(out_tsv, r, world_size)
                          for r in range(world_size)], out_tsv)


# the ops of rank 0's header, and its int64 slots: op, ndim, shape (up to
# 5 dims), float batch, prefix length, whether pickled generate kwargs
# follow
_STOP, _RUN = 0, 1
_HEADER = 10
# the header group's timeout: a follower waits for rank 0's next batch
# for as long as a server idles
_IDLE = datetime.timedelta(days=30)


class _Channel(object):
    """The groups an engine on a mesh adds over its host's ranks: `control`
    (gloo, host tensors: the headers) and `world` (the mesh's backend: the
    weights and batches, on the mesh's timeout; the idle wait between
    batches is control's).  Every rank of the launch makes every host's,
    in the same order.  `src`: the global rank of the mesh's rank 0."""

    def __init__(self, mesh):
        import torch.distributed as dist

        per = mesh.data * mesh.model
        timeout = datetime.timedelta(seconds=mesh.timeout_s or distributed.group_timeout_s())
        self.src = mesh.base
        for base in range(0, dist.get_world_size(), per):
            ranks = list(range(base, base + per))
            control = dist.new_group(ranks, backend="gloo", timeout=_IDLE)
            world = dist.new_group(ranks, backend=mesh.backend, timeout=timeout)
            if base == mesh.base:
                self.control, self.world = control, world

    def header(self, values=None):
        """Rank 0's header (values, a list of ints) on every rank."""
        t = torch.zeros(_HEADER, dtype=torch.int64)
        if values is not None:
            t[:len(values)] = torch.tensor(values, dtype=torch.int64)
        return comm.broadcast(t, self.src, self.control).tolist()


class PinnedUploads(object):
    """Host-to-device copies through page-locked buffers.  A copy from
    pageable memory synchronises with the stream first, so the next
    batch's upload would wait for the search before it; from pinned
    memory it is enqueued behind it and the host goes on.  Each (shape,
    dtype) has a ring of up to RING buffers, each reused once the copy
    that last read it has run (an event): the host waits only when every
    buffer of the ring is still in flight.  At most KEYS shapes are kept,
    the least recently used dropped first."""

    RING = 3
    KEYS = 8

    def __init__(self):
        self._rings = collections.OrderedDict()

    def upload(self, host: torch.Tensor, device) -> torch.Tensor:
        """A copy of the CPU tensor `host` on the CUDA `device`, enqueued on
        the current stream without a host wait."""
        key = (tuple(host.shape), host.dtype)
        ring = self._rings.pop(key, [])
        self._rings[key] = ring
        while len(self._rings) > self.KEYS:
            self._rings.popitem(last=False)
        free = [i for i, (_, done) in enumerate(ring) if done.query()]
        if free:
            slot = ring.pop(free[0])
        elif len(ring) < self.RING:
            slot = (torch.empty(host.shape, dtype=host.dtype, pin_memory=True),
                    torch.cuda.Event())
        else:  # the oldest, once its copy has run
            slot = ring.pop(0)
            slot[1].synchronize()
        ring.append(slot)
        buf, done = slot
        buf.copy_(host)
        out = buf.to(device, non_blocking=True)
        done.record(torch.cuda.current_stream(device))
        return out


class CaptionEngine(object):
    """Batched captioning around a port GitModel, whose parameters set the
    device.  `dispatch` runs the search batch by batch and returns a
    handle to the device sequences; `resolve` copies them to the host and
    detokenizes; `run_caption_tsv` and `run_vqa_tsv` drive both over
    TSVs.  transform: the image transform of the TSV loops, whose mean
    and std normalise uint8 batches (None: CLIP's constants, and no TSV
    loop).  The decode pool's threads end with `close()` or when the
    engine is collected.

    mesh: a `parallel.mesh.Mesh` of data x model ranks (see the module
    docstring); every rank constructs its engine at once, rank 0 with the
    model and the others through `follower`.  batch_size must divide
    over the data axis.  on_close: called by `close()` after the
    followers are stopped (the entry points leave their group there).
    check_groups: count, on every batch, the sequence elements that
    differ between the ranks of a model group (`group_mismatches`)."""

    def __init__(self, model: GitModel, tokenizer, batch_size: int = 32,
                 beam: Optional[BeamSearchConfig] = None, dtype=torch.bfloat16,
                 max_text_len: int = 40, int8: bool = False,
                 fast_prefill: Optional[bool] = None, decode_kernel=None,
                 transform=None, decode_workers: int = 8, mesh=None, on_close=None,
                 check_groups: bool = False, use_native: Optional[bool] = None,
                 _channel=None):
        # before any collective: a refusal leaves no follower waiting
        self.use_native = resolve_use_native(use_native)
        self.mesh = mesh
        self.check_groups = check_groups
        self.group_mismatches = 0
        # rank 0 of a mesh stops its followers once; a failed batch leaves
        # the group broken, and then no stop header is sent
        self._stopped = mesh is None or mesh.rank != 0
        self._broken = False
        if mesh is not None:
            if batch_size % mesh.data:
                raise ValueError("batch_size {} must divide over the mesh data axis {}".format(
                    batch_size, mesh.data))
            self._channel = _channel or _Channel(mesh)
            if mesh.rank == 0:
                dtypes = {p.dtype for p in model.parameters()}
                if len(dtypes) != 1:
                    raise ValueError("a mesh engine takes a model of one dtype, got {}".format(
                        dtypes))
                comm.broadcast_object({"cfg": model.cfg, "dtype": dtypes.pop(), "kwargs": dict(
                    batch_size=batch_size, beam=beam, dtype=dtype, max_text_len=max_text_len,
                    int8=int8, fast_prefill=fast_prefill, decode_kernel=decode_kernel,
                    check_groups=check_groups,
                    transform=types.SimpleNamespace(
                        mean=list(getattr(transform, "mean", CLIP_MEAN)),
                        std=list(getattr(transform, "std", CLIP_STD))))},
                    self._channel.src, self._channel.control)
            broadcast_params(model, self._channel.src, self._channel.world)
            self._lock = threading.Lock()
        if int8:
            # weight-only int8 decoder and head matmuls (ops/quant.py); the
            # model is quantized in place, whole, before a mesh splits it
            quantize_git_model_(model)
        if mesh is not None:
            shard_for_inference(model, mesh)
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
        self.transform = transform
        # on-device normalisation of uint8 batches uses the transform's
        # constants, CLIP's only when it has none (gitax pipeline.py:219-225)
        self.mean = torch.from_numpy(np.asarray(getattr(transform, "mean", CLIP_MEAN),
                                                np.float32)).to(self.device)
        self.std = torch.from_numpy(np.asarray(getattr(transform, "std", CLIP_STD),
                                               np.float32)).to(self.device)
        # the host decode stage; its threads start at the first submit
        self.pool = ThreadPoolExecutor(max_workers=decode_workers)
        self._uploads = PinnedUploads()
        self._close = weakref.finalize(self, self.pool.shutdown, wait=False)
        self._on_close = on_close

    @classmethod
    def follower(cls, mesh):
        """The engine of a rank 1.. of a mesh: rank 0's settings and model
        config arrive by broadcast, its weights by `broadcast_params`."""
        channel = _Channel(mesh)
        spec = comm.broadcast_object(None, channel.src, channel.control)
        model = GitModel(spec["cfg"], device=mesh.device, dtype=spec["dtype"])
        # a follower decodes nothing: rank 0 sends it the batches
        return cls(model, None, mesh=mesh, use_native=False, _channel=channel,
                   **spec["kwargs"])

    def close(self):
        """End the decode pool's threads; on a mesh's rank 0 also stop the
        followers (a stop header) and call `on_close`."""
        try:
            if not self._stopped:
                self._stopped = True
                if not self._broken:
                    self._channel.header([_STOP])
        except Exception:  # the group is already broken: on_close ends the ranks
            logging.exception("could not stop the mesh's followers")
            self._broken = True
        finally:
            self._close()
            if self._on_close is not None:
                on_close, self._on_close = self._on_close, None
                on_close(ok=not self._broken)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def beam_for(self, prefix_len: int) -> BeamSearchConfig:
        """The search settings for a prefix length: the beam buffer holds
        the prefix plus max_text_len tokens; the length norm keeps the
        reference's 1024 for is_done parity."""
        return dataclasses.replace(
            self.beam,
            max_steps=max(self.beam.max_steps, prefix_len + self.max_text_len),
            norm_max_length=self.beam.norm_max_length or max(self.beam.max_steps, 1024),
        )

    def _caption_fn(self, prefix_len: int, generate=None):
        """The batch program for a prefix length (`beam_for`'s settings),
        or, given `generate` (keyword arguments of `GitModel.generate`),
        the one they set."""
        kwargs = generate or dict(beam=self.beam_for(prefix_len), fast_prefill=self._fast_prefill,
                                  decode_kernel=self._decode_kernel)
        dtype = self.dtype

        def fn(images, prefix):
            if images.dtype == torch.uint8:
                x = images.to(dtype) / 255.0
                images = (x - self.mean.to(dtype)) / self.std.to(dtype)
            return self.model.generate(images, prefix, dtype=dtype, **kwargs)

        return fn

    def dispatch_device_batch(self, imgs: np.ndarray, pref: np.ndarray, **generate):
        """Upload ONE same-shape batch (images [B, H, W, 3] or clips
        [B, F, H, W, 3]) with prefixes [B, Tp] and run the search: uint8
        batches are normalised on the device with the transform's
        constants; float batches (already normalised) are cast to the
        engine's dtype and uploaded as they are.  `generate`: keyword
        arguments of `GitModel.generate` in place of the engine's search
        settings (the single-image CLI's).  Returns the device sequences
        with >= B rows (a mesh pads B to a multiple of its data axis), on
        a mesh's rank 0.

        This is the one host-to-device seam: the TSV loops and the
        serving batcher both come through here, so a mesh engine serves
        every product surface.  On one card it returns once the upload and
        the search are enqueued (pinned uploads, the replayed search
        step); the sequences are ready when `to_host` has read them."""
        if imgs.ndim not in (4, 5) or imgs.shape[-1] != 3:
            raise ValueError("a batch must be [B, H, W, 3] images or [B, F, H, W, 3] clips, "
                             "got {}".format(imgs.shape))
        if imgs.dtype != np.uint8:
            imgs = np.asarray(imgs, np.float32)
        pref = np.asarray(pref, np.int64)
        if self.mesh is not None:
            return self._mesh_dispatch(imgs, pref, generate)
        dev_imgs = torch.from_numpy(imgs)
        if dev_imgs.dtype != torch.uint8:  # cast on the host: the upload is activation-width
            dev_imgs = dev_imgs.to(self.dtype)
        pref = torch.from_numpy(pref)
        if self.device.type == "cuda":  # no host wait: see PinnedUploads
            dev_imgs = self._uploads.upload(dev_imgs, self.device)
            pref = self._uploads.upload(pref, self.device)
        else:
            dev_imgs, pref = dev_imgs.to(self.device), pref.to(self.device)
        seqs, _ = self._caption_fn(pref.shape[1], generate)(dev_imgs, pref)
        return seqs

    # -- the mesh ------------------------------------------------------------
    def _mesh_dispatch(self, imgs, pref, generate):
        """Rank 0's side of a device batch on the mesh."""
        if self.mesh.rank != 0:
            raise RuntimeError("rank {} of the mesh follows rank 0's batches".format(
                self.mesh.rank))
        pad_n = (-len(imgs)) % self.mesh.data
        if pad_n:  # every data rank takes equal rows (gitax pipeline.py:364-367)
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad_n, axis=0)])
            pref = np.concatenate([pref, np.repeat(pref[-1:], pad_n, axis=0)])
        with self._lock:
            if self._stopped:
                raise RuntimeError("the engine is closed")
            try:
                self._channel.header([_RUN, imgs.ndim] + list(imgs.shape)
                                     + [0] * (5 - imgs.ndim)
                                     + [int(imgs.dtype != np.uint8), pref.shape[1],
                                        int(bool(generate))])
                if generate:
                    comm.broadcast_object(generate, self._channel.src, self._channel.control)
                dev_imgs = comm.broadcast(torch.from_numpy(imgs).to(self.device),
                                          self._channel.src, self._channel.world)
                dev_pref = comm.broadcast(torch.from_numpy(pref).to(self.device),
                                          self._channel.src, self._channel.world)
                return self._run(dev_imgs, dev_pref, generate or None)
            except BaseException:
                self._broken = True
                raise

    def _run(self, images, pref, generate):
        """Every rank's part of a device batch [B, ...]: its data rank's
        rows through its model group's search; the [B, L] sequences on
        rank 0 (None elsewhere)."""
        mesh = self.mesh
        total = images.shape[0]
        lo, hi = mesh.batch_rows(total)
        images, pref = images[lo:hi], pref[lo:hi]
        if images.dtype != torch.uint8:
            images = images.to(self.dtype)
        rng = (generate or {}).get("rng")
        if rng is not None and rng.device != self.device:
            # rank 0's generator, unpickled on another card: its state
            # (a seed and an offset on CUDA) on this rank's device
            local = torch.Generator(self.device)
            local.set_state(rng.get_state())
            generate = dict(generate, rng=local)
        seqs, _ = self._caption_fn(pref.shape[1], generate)(images, pref)
        if self.check_groups and mesh.model > 1:
            unequal = comm.count_unequal(seqs, mesh.model_group, mesh.model)
        if mesh.model_rank != 0:
            return None
        per_row = seqs.shape[0] // (hi - lo)  # num_return_sequences
        full = comm.gather_rows(seqs, lo * per_row, total * per_row, mesh.data_group)
        if self.check_groups and mesh.model > 1:
            n = comm.all_reduce(torch.tensor([unequal], device=self.device), mesh.data_group)
            self.group_mismatches += int(n.item())
        return full if mesh.rank == 0 else None

    def follow(self):
        """Ranks 1.. of a mesh: run rank 0's device batches until it closes
        its engine (a stop header)."""
        while True:
            head = self._channel.header()
            if head[0] == _STOP:
                return
            ndim = head[1]
            shape = head[2:2 + ndim]
            is_float, tp, kw = head[7:10]
            generate = (comm.broadcast_object(None, self._channel.src, self._channel.control)
                        if kw else None)
            imgs = torch.empty(shape, dtype=torch.float32 if is_float else torch.uint8,
                               device=self.device)
            comm.broadcast(imgs, self._channel.src, self._channel.world)
            pref = torch.empty((shape[0], tp), dtype=torch.int64, device=self.device)
            comm.broadcast(pref, self._channel.src, self._channel.world)
            self._run(imgs, pref, generate)

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
        if imgs.dtype != np.uint8:
            imgs = np.asarray(imgs, np.float32)
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

    def to_host(self, seqs) -> np.ndarray:
        """Device sequences -> a numpy array: the one place where the
        engine's device results reach the host (gitax's batcher reads them
        with np.asarray, serving.py:297, 436)."""
        return seqs.cpu().numpy()

    def resolve(self, handle):
        """Copy a dispatched handle's sequences to the host and detokenize
        them, in the order the images were given."""
        n, dispatched = handle
        results = [None] * n
        for idxs, seqs in dispatched:
            arr = self.to_host(torch.cat(seqs, dim=0))[:len(idxs)]
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

    # -- host-side preprocessing ------------------------------------------
    def _decode_row(self, b64):
        img = image_from_base64(b64)
        if img is None:
            return None
        return self.transform(img)

    def _decode_chunk(self, payloads):
        """Decode a list of base64 payloads to a list of arrays (None for
        failures): with the native loader uint8 arrays, a fixed crop or
        the MinMax size of the high-res family, with PIL for each row
        libjpeg refuses (PNG payloads); else the transform's float arrays
        (gitax pipeline.py:249-287)."""
        if not self.use_native:
            return [self._decode_row(p) for p in payloads]
        from .. import native
        from ..preprocess.transforms import center_crop, min_max_resize, resize_shorter

        raw = [p.encode() if isinstance(p, str) else p for p in payloads]
        crop = self.transform.crop_size
        ratio_max = getattr(self.transform, "respect_ratio_max", None)
        if ratio_max is not None:
            decoded = native.decode_minmax_batch(raw, crop, ratio_max)
        else:
            arrs, ok = native.decode_resize_crop_batch(raw, crop)
            decoded = [arrs[i] if good else None for i, good in enumerate(ok)]
        out = []
        for i, arr in enumerate(decoded):
            if arr is not None:
                out.append(arr)
                continue
            img = image_from_base64(payloads[i])
            if img is None:
                out.append(None)
            elif ratio_max is not None:
                out.append(np.asarray(min_max_resize(img, crop, ratio_max), np.uint8))
            else:
                out.append(np.asarray(center_crop(resize_shorter(img, crop), crop), np.uint8))
        return out

    def _prefetched_chunks(self, image_tsv, idxs, granule, depth=2):
        """Iterate (chunk_row_indices, decoded_arrays) with `depth` chunks
        of host decode in flight on the thread pool while the device runs:
        the host stage of both TSV loops."""
        chunks = [idxs[i:i + granule] for i in range(0, len(idxs), granule)]
        futures = collections.deque()

        def submit(batch_idxs):
            payloads = [image_tsv[j][1] for j in batch_idxs]
            futures.append((batch_idxs, self.pool.submit(self._decode_chunk, payloads)))

        for c in chunks[:depth]:
            submit(c)
        ci = depth
        while futures:
            batch_idxs, fut = futures.popleft()
            decoded = fut.result()
            if ci < len(chunks):
                submit(chunks[ci])
                ci += 1
            yield batch_idxs, decoded

    def _require_transform(self):
        if self.transform is None:
            raise ValueError("the TSV loops need the engine's image transform "
                             "(CaptionEngine(..., transform=...))")

    # -- TSV caption pipeline ---------------------------------------------
    def run_caption_tsv(self, image_tsv_path, out_tsv, rank=0, world_size=1):
        """Caption every decodable row of this rank's shard of a base64
        image TSV; rows that do not decode are dropped."""
        self._require_transform()
        image_tsv = TSVFile(image_tsv_path)
        start, end = shard_range(len(image_tsv), rank, world_size)
        cur_out = ("{}.{}.{}.tsv".format(out_tsv, rank, world_size)
                   if world_size > 1 else out_tsv)
        cls = self.tokenizer.cls_token_id

        def rows():
            from .profiling import ThroughputMeter

            idxs = list(range(start, end))
            meter = ThroughputMeter(name="caption_tsv", unit="images")
            # host decode of the next chunks (thread pool) || the search of
            # this chunk || detokenization of the previous one (this thread)
            pending = None  # (keys, dispatch handle)
            for batch_idxs, decoded in self._prefetched_chunks(image_tsv, idxs,
                                                               self.batch_size):
                arrs, keys = [], []
                for j, a in zip(batch_idxs, decoded):
                    if a is not None:
                        arrs.append(a)
                        keys.append(image_tsv.get_key(j))
                handle = (self.dispatch_varshape(arrs, [[cls]] * len(arrs))
                          if arrs else None)
                if pending is not None:
                    pkeys, phandle = pending
                    for k, cap in zip(pkeys, self.resolve(phandle)):
                        yield k, json_dump([{"caption": cap}])
                    meter.update(len(pkeys))
                pending = (keys, handle) if handle is not None else None
            if pending is not None:
                pkeys, phandle = pending
                for k, cap in zip(pkeys, self.resolve(phandle)):
                    yield k, json_dump([{"caption": cap}])
                meter.update(len(pkeys))

        tsv_writer(rows(), cur_out)
        finish_shards(out_tsv, rank, world_size, self.mesh and self.mesh.hosts_group)

    # -- TSV VQA pipeline ---------------------------------------------------
    def run_vqa_tsv(self, image_tsv_path, question_tsv_path, out_tsv,
                    rank=0, world_size=1):
        """Batched VQA over aligned image and question TSVs.  Images are
        decoded once each by the prefetching pool; (image, prefix) pairs
        are bucketed by prefix length, full buckets dispatch at once, at
        most `max_inflight` stay unresolved, and the answers are written
        in the reference's row order: image-major, question order within
        an image (inference.py:178-199); an undecodable image's questions
        are skipped with their slots consumed."""
        self._require_transform()
        image_tsv = TSVFile(image_tsv_path)
        question_tsv = TSVFile(question_tsv_path)
        assert len(image_tsv) == len(question_tsv)
        start, end = shard_range(len(image_tsv), rank, world_size)
        cur_out = ("{}.{}.{}.tsv".format(out_tsv, rank, world_size)
                   if world_size > 1 else out_tsv)

        def rows():
            idxs = list(range(start, end))
            dchunk = max(1, self.batch_size // 4)  # decode-prefetch granule
            buckets = {}  # tp -> (arrays, prefixes, [(order, qid)])
            # dispatched, unresolved handles, bounded: each pins its batch
            pending = collections.deque()
            max_inflight = 2
            results = {}
            order = 0

            def drain(to_len):
                while len(pending) > to_len:
                    handle, meta = pending.popleft()
                    for (pos, qid), ans in zip(meta, self.resolve(handle)):
                        results[pos] = (qid, ans)

            for batch_idxs, decoded in self._prefetched_chunks(image_tsv, idxs, dchunk):
                for i, arr in zip(batch_idxs, decoded):
                    ik = image_tsv.get_key(i)
                    qrow = question_tsv[i]
                    assert ik == qrow[0], (ik, qrow[0])  # key alignment (inference.py:176)
                    questions = json.loads(qrow[1])
                    if arr is None:
                        order += len(questions)
                        continue
                    for q in questions:
                        prefix = self.encode_prefix(q["question"])
                        b = buckets.setdefault(len(prefix), ([], [], []))
                        b[0].append(arr)
                        b[1].append(prefix)
                        b[2].append((order, q["question_id"]))
                        order += 1
                        if len(b[0]) == self.batch_size:
                            pending.append((self.dispatch_varshape(b[0], b[1]), b[2]))
                            buckets[len(prefix)] = ([], [], [])
                            drain(max_inflight)
            for tp in sorted(buckets):
                arrs, prefs, meta = buckets[tp]
                if arrs:
                    pending.append((self.dispatch_varshape(arrs, prefs), meta))
            drain(0)
            for pos in sorted(results):
                qid, ans = results[pos]
                yield (json_dump({"answer": ans, "question_id": qid}),)

        tsv_writer(rows(), cur_out)
        finish_shards(out_tsv, rank, world_size, self.mesh and self.mesh.hosts_group)


def follower_main(rank, world_size, init_method, mesh_shape, device=None, share_card=False,
                  timeout_s=distributed.MESH_TIMEOUT_S):
    """A spawned rank 1.. of an entry point's mesh
    (`distributed.open_inference_group`): join the group, build the
    follower engine, serve rank 0's batches, leave."""
    group = distributed.join_inference_group(rank, world_size, init_method, mesh_shape,
                                             device, share_card, timeout_s)
    try:
        follow_mesh(group.mesh)
    finally:
        group.close()


def follow_mesh(mesh):
    """Ranks 1.. of a mesh: the follower engine until rank 0 closes its
    own."""
    engine = CaptionEngine.follower(mesh)
    try:
        engine.follow()
    finally:
        engine.close()


def open_mesh_engine(model_fn, tokenizer, mesh_shape, device=None, share_card=False,
                     **engine_kwargs):
    """The entry points' mesh: join or start the group of `mesh_shape`
    (`distributed.open_inference_group`); on rank 0 build the model with
    `model_fn(device)` and return its engine, which leaves the group when
    closed; on ranks 1.. (a launch of data x model processes) follow rank
    0's batches and return None once it closes its engine."""
    data = mesh_dims(mesh_shape)[0]
    if engine_kwargs.get("batch_size", 32) % data:  # before any rank starts
        raise ValueError("batch_size {} must divide over the mesh data axis {}".format(
            engine_kwargs.get("batch_size", 32), data))
    group = distributed.open_inference_group(mesh_shape, "gitax_torch.runtime.engine:follower_main",
                                             device, share_card)
    try:
        if group.rank != 0:
            follow_mesh(group.mesh)
            group.close()
            return None
        return CaptionEngine(model_fn(group.mesh.device), tokenizer, mesh=group.mesh,
                             on_close=group.close, **engine_kwargs)
    except BaseException:
        group.close(ok=False)
        raise
