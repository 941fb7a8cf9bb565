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
  * VQA (image, prefix) pairs are bucketed by (whole-patch grid, prefix
    token length), so that a full bucket is one device batch of real
    rows; the buckets left at the pass's end are flushed, one padded
    batch each, and answers are emitted in the reference's row order.
  * with a video model (`num_image_with_embedding` F > 0) a caption
    TSV's row is a clip, its payload a JSON list of base64 frames in time
    order; a device batch's clips are decoded on several of the pool's
    threads at once, each handing its frames to a decode process of its
    own, to uint8 normalised on the device, and grouped by (frames, grid)
    (`dispatch_clips`).

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
first host wait.  A batch's sequences are copied to page-locked host
memory behind its work as it is dispatched, so that `to_host` waits for
that copy alone, and the card runs the batches dispatched since while
the host detokenises, decodes and dispatches the next.

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
lock, in one order.  Over NCCL (one card a rank) the search is the
replayed graph step on every rank, model groups of m > 1 included, and
rank 0's upload is pinned, so `dispatch_device_batch` returns once the
batch's broadcasts, the search and the sequences' all-reduce are
enqueued, before the search ends, as on one card (the captured step
sums over the mesh's graph group, every other collective over the model
group: `parallel.mesh.Mesh.graph_group`); over gloo (ranks
sharing one card) each model group's search reads the host once a
step.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import itertools
import json
import logging
import multiprocessing
import os
import os.path as op
import threading
import time
import types
import weakref
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..common import json_dump
from ..decode.beam import BeamSearchConfig
from ..io import fileio
from ..io.image import image_from_base64, pil_image
from ..io.tsv import TSVFile, concat_tsv_files, tsv_writer
from ..models.git import GitModel
from ..ops.quant import quantize_git_model_
from ..parallel import comm
from ..parallel.mesh import broadcast_params, mesh_dims, shard_for_inference
from ..preprocess.transforms import CLIP_MEAN, CLIP_STD, decode_uint8, uint8_frame
from ..tokenization import encode_prefix
from . import distributed, profiling


# the decode pool's chunks, numbered over the process (their spans' `chunk`)
_chunk_ids = itertools.count(1)


def _shut_pools(threads, procs):
    """The engine's finalizer: its decode threads, then its frame processes
    (idle between batches, so joining them is quick)."""
    threads.shutdown(wait=False)
    for p in procs:
        p.shutdown(wait=True, cancel_futures=True)


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
            profiling.count(upload_waits=1)
            with profiling.span("engine.upload_wait"):
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
    differ between the ranks of a model group (`group_mismatches`, read
    on the host only when asked)."""

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
        self._mismatches = None  # a device count on rank 0, summed over the batches
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
        self.decode_workers = decode_workers
        # the clip loop's frame decoders, processes started at its first
        # batch (`_decode_frames`); a list, so that the finalizer sees them
        self._frame_procs = []
        self._frame_lock = threading.Lock()
        self._uploads = PinnedUploads()
        # the real rows of the device batch `_dispatch_batch` is dispatching,
        # on the thread that dispatches it (the rest are padding)
        self._feed = threading.local()
        self._close = weakref.finalize(self, _shut_pools, self.pool, self._frame_procs)
        self._on_close = on_close

    @property
    def group_mismatches(self) -> int:
        """The sequence elements that differed within a model group, over
        every batch so far (rank 0 of a mesh with check_groups); waits for
        the card."""
        return 0 if self._mismatches is None else int(self._mismatches.item())

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
        rows = imgs.shape[0]
        real = getattr(self._feed, "real", None) or rows
        frames = imgs.shape[1] if imgs.ndim == 5 else 1
        profiling.count(rows=rows, real_rows=real, frames=rows * frames)
        p = self.model.cfg.encoder.patch_size
        with profiling.span("engine.device_batch", rows=rows, real=real, frames=frames,
                            grid=(imgs.shape[-3] // p, imgs.shape[-2] // p),
                            prefix=pref.shape[1]):
            if self.mesh is not None:
                return self._copy_to_host(self._mesh_dispatch(imgs, pref, generate))
            dev_imgs = torch.from_numpy(imgs)
            if dev_imgs.dtype != torch.uint8:  # cast on the host: the upload is activation-width
                with profiling.span("engine.host_cast"):
                    dev_imgs = dev_imgs.to(self.dtype)
            with profiling.span("engine.upload", bytes=dev_imgs.nbytes + pref.nbytes):
                dev_imgs, pref = self._upload(dev_imgs), self._upload(torch.from_numpy(pref))
            seqs, _ = self._caption_fn(pref.shape[1], generate)(dev_imgs, pref)
            return self._copy_to_host(seqs)

    @staticmethod
    def _copy_to_host(seqs):
        """Enqueue the copy of a batch's device sequences into page-locked
        host memory behind the batch's work, and an event after it, so
        that `to_host` waits for this batch alone and not for the batches
        dispatched after it; returns seqs (None and host tensors as they
        are)."""
        if seqs is not None and seqs.is_cuda:
            host = torch.empty(seqs.shape, dtype=seqs.dtype, pin_memory=True)
            host.copy_(seqs, non_blocking=True)
            landed = torch.cuda.Event()
            landed.record()
            seqs._on_host = (host, landed)
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
                dev_imgs = comm.broadcast(self._upload(torch.from_numpy(imgs)),
                                          self._channel.src, self._channel.world)
                dev_pref = comm.broadcast(self._upload(torch.from_numpy(pref)),
                                          self._channel.src, self._channel.world)
                return self._run(dev_imgs, dev_pref, generate or None)
            except BaseException:
                self._broken = True
                raise

    def _upload(self, host):
        """A CPU tensor on the engine's device: through `PinnedUploads` on a
        card (no host wait, see there), else a copy."""
        if self.device.type == "cuda":
            return self._uploads.upload(host, self.device)
        return host.to(self.device)

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
            unequal = comm.unequal_elements(seqs, mesh.model_group, mesh.model)
        if mesh.model_rank != 0:
            return None
        per_row = seqs.shape[0] // (hi - lo)  # num_return_sequences
        full = comm.gather_rows(seqs, lo * per_row, total * per_row, mesh.data_group)
        if self.check_groups and mesh.model > 1:
            n = comm.all_reduce(unequal.reshape(1), mesh.data_group)[0]
            self._mismatches = n if self._mismatches is None else self._mismatches + n
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
        with profiling.span("engine.stack", rows=n + pad_n, real=n):
            imgs = np.stack(images + [images[-1]] * pad_n)
            if imgs.dtype != np.uint8:
                imgs = np.asarray(imgs, np.float32)
            pref = np.asarray(prefixes + [prefixes[-1]] * pad_n, np.int64)
        out = []
        try:
            for i in range(0, len(imgs), b):
                self._feed.real = min(b, n - i)
                out.append(self.dispatch_device_batch(imgs[i:i + b], pref[i:i + b]))
        finally:
            self._feed.real = None
        return out

    def dispatch(self, images: List[np.ndarray], prefixes: List[List[int]]):
        """Run generation over same-shape images [H, W, 3] or clips
        [F, H, W, 3]; returns a handle for `resolve`, of the form
        `dispatch_varshape` returns (one bucket)."""
        with profiling.span("engine.dispatch", items=len(images)):
            return len(images), [(list(range(len(images))),
                                  self._dispatch_batch(images, prefixes))]

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
        with profiling.span("engine.dispatch", items=len(images)):
            if any(a.ndim != 3 for a in images):
                raise ValueError("dispatch_varshape takes images [H, W, 3], got {}".format(
                    sorted({a.shape for a in images if a.ndim != 3})))
            return len(images), self._dispatch_grouped(images, prefixes)

    def dispatch_clips(self, clips: List[np.ndarray], prefixes: List[List[int]]):
        """Run generation over clips [F, H, W, 3] of varying frame counts
        or frame shapes: each cut to whole patches and grouped into
        (frames, grid) buckets, one batch program each, as
        `dispatch_varshape` groups images.  The prefixes of one call share
        one length.  Returns a handle for `resolve`."""
        with profiling.span("engine.dispatch", items=len(clips)):
            if any(a.ndim != 4 for a in clips):
                raise ValueError("dispatch_clips takes clips [F, H, W, 3], got {}".format(
                    sorted({a.shape for a in clips if a.ndim != 4})))
            return len(clips), self._dispatch_grouped(clips, prefixes)

    def _dispatch_grouped(self, items, prefixes):
        """Items of one rank cut to whole patches and grouped by (frames,
        grid), in the key's order: [(indices, device sequences)]."""
        groups = collections.defaultdict(list)
        for i, a in enumerate(items):
            groups[a.shape[:-3] + self.whole_patches(a)].append(i)
        dispatched = []
        for key, idxs in sorted(groups.items()):
            h, w = key[-2:]
            seqs = self._dispatch_batch([items[i][..., :h, :w, :] for i in idxs],
                                        [prefixes[i] for i in idxs])
            dispatched.append((idxs, seqs))
        return dispatched

    def whole_patches(self, image: np.ndarray) -> Tuple[int, int]:
        """(H, W) of an image [H, W, 3] (or of a clip's frames) cut to whole
        patches: the exact grid `dispatch_varshape` batches it at."""
        p = self.model.cfg.encoder.patch_size
        return (image.shape[-3] // p) * p, (image.shape[-2] // p) * p

    def to_host(self, seqs) -> np.ndarray:
        """Device sequences -> a numpy array: the one place where the
        engine's device results reach the host (gitax's batcher reads them
        with np.asarray, serving.py:297, 436).  A dispatch's sequences
        are read from the copy it enqueued (`_copy_to_host`), once that
        has landed; any other tensor is copied here, after all the work
        on the stream."""
        with profiling.span("engine.to_host"):
            copied = getattr(seqs, "_on_host", None)
            if copied is None:
                return seqs.cpu().numpy()
            host, landed = copied
            landed.synchronize()
            return host.numpy()

    def resolve(self, handle):
        """Copy a dispatched handle's sequences to the host and detokenize
        them, in the order the images were given."""
        n, dispatched = handle
        results = [None] * n
        with profiling.span("engine.resolve", items=n):
            for idxs, seqs in dispatched:
                arr = np.concatenate([self.to_host(s) for s in seqs])[:len(idxs)]
                with profiling.span("engine.detokenize", items=len(idxs)):
                    for i, row in zip(idxs, arr):
                        results[i] = self.tokenizer.decode(row.tolist(),
                                                           skip_special_tokens=True)
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
            out.append(None if img is None else uint8_frame(img, crop, ratio_max))
        return out

    def _decode_frames(self, payloads):
        """Decode a clip part's base64 frames: uint8 arrays at the
        transform's crop (normalised on the device, as the native loader's
        are), None for a frame that does not decode.  With the native
        loader as `_decode_chunk`; else with PIL in `decode_workers`
        processes of their own (spawned at the first call), since PIL's
        JPEG decode holds the interpreter lock: six frames an item decoded
        on threads would starve the thread that enqueues the card's work."""
        if self.use_native:
            return self._decode_chunk(payloads)
        with self._frame_lock:
            if not self._frame_procs:
                # each process imports PIL before it takes a part, so that a
                # part waits for the first process free, not for an import
                self._frame_procs.append(ProcessPoolExecutor(
                    self.decode_workers, mp_context=multiprocessing.get_context("spawn"),
                    initializer=pil_image))
            procs = self._frame_procs[0]
        return procs.submit(decode_uint8, payloads, self.transform.crop_size,
                            getattr(self.transform, "respect_ratio_max", None)).result()

    def _decode_clips(self, rows, frames):
        """Decode TSV rows (key, payload) of clips, each payload a JSON list
        of base64 frames in time order, of which the first `frames` are
        kept, as `GitModel.encode_images` keeps them.  Returns (a clip
        [f, H, W, 3] a row, None for a row whose frames do not all decode;
        the frames decoded).  A payload that is not a list of frames
        raises, naming its row."""
        clips = []
        for key, payload in rows:
            try:
                clip = json.loads(payload)
            except ValueError:
                clip = None
            if not isinstance(clip, list) or not clip \
                    or not all(isinstance(b, str) for b in clip):
                raise ValueError("TSV row {!r}: a video model's row is a JSON list of base64 "
                                 "frames".format(key))
            clips.append(clip[:frames])
        flat = self._decode_frames([b for clip in clips for b in clip])
        out, at = [], 0
        for (key, _), clip in zip(rows, clips):
            got, at = flat[at:at + len(clip)], at + len(clip)
            if any(a is None for a in got):
                out.append(None)
            elif len({a.shape for a in got}) > 1:
                raise ValueError("TSV row {!r}: a clip's frames decode to one shape, got "
                                 "{}".format(key, sorted({a.shape for a in got})))
            else:
                out.append(np.stack(got))
        return out, len(flat)

    def _prefetched_chunks(self, image_tsv, idxs, granule, depth=2, clips=0):
        """Iterate (chunk_row_indices, decoded_arrays) with `depth` chunks
        of host decode in flight on the thread pool while the device runs:
        the host stage of both TSV loops.  Each chunk's `decode.chunk` span
        (on the pool) and the `tsv.pool_wait` that waited for it share its
        chunk id; reading a chunk's payloads is `tsv.assemble`.  clips:
        F > 0 reads each row as a clip of at most F frames
        (`_decode_clips`) and splits each chunk's rows over the pool's
        `decode_workers`, one part a thread, so that a device batch's
        frames decode at once (each thread handing its part's frames to a
        process, `_decode_frames`); each part is a chunk of the spans."""
        chunks = [idxs[i:i + granule] for i in range(0, len(idxs), granule)]
        futures = collections.deque()
        parts = self.decode_workers if clips else 1

        def decode(chunk, rows):
            with profiling.span("decode.chunk", chunk=chunk, rows=len(rows)) as s:
                if not clips:
                    s.set(frames=len(rows))
                    return self._decode_chunk(rows)
                out, n = self._decode_clips(rows, clips)
                s.set(frames=n)
                return out

        def submit(batch_idxs):
            per = -(-len(batch_idxs) // parts)
            tasks = []
            for at in range(0, len(batch_idxs), per):
                part = batch_idxs[at:at + per]
                chunk = next(_chunk_ids)
                with profiling.span("tsv.assemble", items=len(part), chunk=chunk):
                    rows = [image_tsv[j] if clips else image_tsv[j][1] for j in part]
                tasks.append((chunk, self.pool.submit(decode, chunk, rows)))
            futures.append((batch_idxs, tasks))

        for c in chunks[:depth]:
            submit(c)
        ci = depth
        while futures:
            batch_idxs, tasks = futures.popleft()
            decoded = []
            for chunk, fut in tasks:
                with profiling.span("tsv.pool_wait", chunk=chunk):
                    decoded += fut.result()
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
        image TSV; rows that do not decode are dropped.  With a video
        model (`num_image_with_embedding` F > 0) a row is a clip: its
        payload a JSON list of base64 frames in time order, of which the
        first F are captioned; a row whose frames do not all decode is
        dropped, and one that is not such a list raises, naming the row."""
        self._require_transform()
        image_tsv = TSVFile(image_tsv_path)
        start, end = shard_range(len(image_tsv), rank, world_size)
        cur_out = ("{}.{}.{}.tsv".format(out_tsv, rank, world_size)
                   if world_size > 1 else out_tsv)
        cls = self.tokenizer.cls_token_id
        frames = self.model.cfg.num_image_with_embedding

        def written(pending):
            # the writer's time between this loop's yields is `tsv.write`
            pkeys, phandle = pending
            caps = self.resolve(phandle)
            with profiling.span("tsv.write", rows=len(pkeys)):
                for k, cap in zip(pkeys, caps):
                    yield k, json_dump([{"caption": cap}])

        def rows():
            idxs = list(range(start, end))
            # host decode of the next chunks (thread pool) || the search of
            # this chunk || detokenization of the previous one (this thread)
            pending = None  # (keys, dispatch handle)
            # images: a batch a pool thread, four in flight (with two, the
            # card waits on the pool once the encoder replays from a graph);
            # clips: a batch spread over the pool, two in flight
            for batch_idxs, decoded in self._prefetched_chunks(image_tsv, idxs, self.batch_size,
                                                               depth=2 if frames else 4,
                                                               clips=frames):
                with profiling.span("tsv.assemble", items=len(batch_idxs)):
                    arrs, keys = [], []
                    for j, a in zip(batch_idxs, decoded):
                        if a is not None:
                            arrs.append(a)
                            keys.append(image_tsv.get_key(j))
                dispatch = self.dispatch_clips if frames else self.dispatch_varshape
                handle = dispatch(arrs, [[cls]] * len(arrs)) if arrs else None
                if pending is not None:
                    yield from written(pending)
                pending = (keys, handle) if handle is not None else None
            if pending is not None:
                yield from written(pending)

        tsv_writer(rows(), cur_out)
        finish_shards(out_tsv, rank, world_size, self.mesh and self.mesh.hosts_group)

    # -- TSV VQA pipeline ---------------------------------------------------
    def run_vqa_tsv(self, image_tsv_path, question_tsv_path, out_tsv,
                    rank=0, world_size=1):
        """Batched VQA over aligned image and question TSVs.  Images are
        decoded once each by the prefetching pool; (image, prefix) pairs
        are bucketed by (`whole_patches` grid, prefix length), so that a
        bucket that reaches `batch_size` dispatches at once as one device
        batch of real rows (profiling counter `full_buckets`); at most
        `max_inflight` batches stay unresolved.  At the pass's end the
        buckets left are flushed in (prefix length, grid) order, one
        padded batch each (`flushed_buckets`), under the same bound.  The
        answers are written in the reference's row order: image-major,
        question order within an image (inference.py:178-199); an
        undecodable image's questions are skipped with their slots
        consumed.

        Host memory: at most (grids x prefix lengths) x (batch_size - 1)
        pairs wait in buckets, each holding a reference to its image's
        decoded array, which the image's questions share."""
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
            buckets = {}  # (grid, tp) -> (arrays, prefixes, [(order, qid)])
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
                # the chunk's assembly is `tsv.assemble`, cut where a full
                # bucket is dispatched and drained (top-level spans of their own)
                assemble = profiling.span("tsv.assemble", items=len(batch_idxs))
                assemble.__enter__()
                try:
                    for i, arr in zip(batch_idxs, decoded):
                        ik = image_tsv.get_key(i)
                        qrow = question_tsv[i]
                        assert ik == qrow[0], (ik, qrow[0])  # key alignment (inference.py:176)
                        questions = json.loads(qrow[1])
                        if arr is None:
                            order += len(questions)
                            continue
                        grid = self.whole_patches(arr)
                        for q in questions:
                            prefix = self.encode_prefix(q["question"])
                            key = (grid, len(prefix))
                            b = buckets.setdefault(key, ([], [], []))
                            b[0].append(arr)
                            b[1].append(prefix)
                            b[2].append((order, q["question_id"]))
                            order += 1
                            if len(b[0]) == self.batch_size:
                                assemble.__exit__(None, None, None)
                                assemble = None
                                pending.append((self.dispatch_varshape(b[0], b[1]), b[2]))
                                profiling.count(full_buckets=1)
                                del buckets[key]
                                drain(max_inflight)
                                assemble = profiling.span("tsv.assemble", items=0)
                                assemble.__enter__()
                finally:
                    if assemble is not None:
                        assemble.__exit__(None, None, None)
            for grid, tp in sorted(buckets, key=lambda k: (k[1], k[0])):
                arrs, prefs, meta = buckets[grid, tp]
                pending.append((self.dispatch_varshape(arrs, prefs), meta))
                profiling.count(flushed_buckets=1)
                drain(max_inflight)
            drain(0)
            with profiling.span("tsv.write", rows=len(results)):
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
