"""The int8 tied output head fused with the beam prefilter's statistics.

Replaces the TPU kernel `gitax/ops/vocab_topk.py::_kernel` with a CUDA
kernel written for Hopper (`gitax_torch/csrc/vocab_topk.cu`, which carries
the design note: what it computes, its bound on the H100 and what the
design does about it).  Beside it, `vocab_logits_topk_reference` is the
plain PyTorch version of the same function.

    vocab_logits_topk(hidden [R, W], wq8t [W, V] int8, scale [V], bias [V])
        -> logits [R, NB*tile] f32, -inf in the columns V .. NB*tile - 1,
           bmax   [R, NB] f32, each tile's max of those logits,
           bsum   [R, NB] f32, each tile's sum of exp(logit - bmax)
with NB = ceil(V / tile).  The logits are the int8 head's,
(hidden @ wq8t) * scale + bias accumulated in f32, as
`models/textual.py::output_logits` computes them; decode/beam.py's
`vocab_stats` path reads the block maxima for its top-k prefilter and
`combine_lse` of the statistics for the logsumexp, so the beam step makes
no full pass over the logits.

For CPU tensors the wrapper runs the plain version; for CUDA tensors it
launches the kernel or raises.  There is no fallback.  The module-level
`launches` counts kernel launches.

What the bf16 kernel's design fixes outside the kernel is computed here and
tested on the CPU: the TMA tensor maps of the int8 matrix and of the hidden
states (`weight_map`, `hidden_map`), where a weight byte lies in a stage's
swizzled tile (`weight_smem_offset`) and the launch plan (`tile_plan`,
`cta_tile`, `stats_writer`).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

NEG_INF = float("-inf")

# the prefilter's block: the kernel's column tile, and the block that
# decode/beam.py's vocab_stats path hands `_top_k_blocked`
TILE = 512

launches = 0

# the smem per block a kernel launch may take on sm_90 (227 KB)
_MAX_SMEM = 232448
# bf16 kernel: hidden rows per CTA (wgmma's N; more rows take more row
# groups), vocab columns per CTA (two warpgroups of two m64 tiles), CTAs per
# statistics block (a cluster), values of W per ring stage, ring stages
ROWS, CTA_COLS, K_CHUNK, STAGES = 128, 256, 64, 6
CLUSTER = TILE // CTA_COLS
_THREADS = 288  # two consumer warpgroups and the producer warp


def weight_smem_offset(col, k):
    """Byte offset, within a stage's int8 tile [CTA_COLS, K_CHUNK], of the
    weight (k, col) as TMA's 64-byte swizzle lays it down: a column's 64
    bytes are contiguous, and its 16-byte piece p lies at piece
    p ^ ((col // 2) % 4).  The kernel's 4-byte reads of a warp's 8 columns
    then fall on 32 different banks."""
    return col * K_CHUNK + 16 * ((k // 16) ^ ((col // 2) % 4)) + k % 16


def weight_map(wq8t):
    """The TMA tensor-map parameters of the int8 matrix as it is stored, a
    row-major [V, W] table of bytes, as the kernel encodes them: dims (W,
    V), the byte stride of V, and the box (K_CHUNK bytes of W, CTA_COLS
    columns); rows past V read as zeros.  wq8t is the [W, V] view."""
    w, v = wq8t.shape
    _check(wq8t.stride() == (1, w) or (v == 1 and wq8t.stride(0) == 1),
           "wq8t must be vocab-major (the transpose of a row-major [V, W]), strides {}",
           wq8t.stride())
    _check(w % 16 == 0 and wq8t.data_ptr() % 16 == 0,
           "TMA needs 16-byte rows: W={} must be a multiple of 16 and the int8 data 16-byte "
           "aligned", w)
    return dict(dims=(w, v), strides=(w,), box=(K_CHUNK, CTA_COLS))


def hidden_map(hidden):
    """The TMA tensor-map parameters of the contiguous bf16 hidden [R, W]:
    dims (W, R) in elements, the byte stride of a row, and the box (K_CHUNK
    values of W, ROWS rows), which lands in wgmma's 128-byte swizzle; rows
    past R read as zeros."""
    r, w = hidden.shape
    _check(hidden.is_contiguous() and hidden.element_size() == 2,
           "hidden must be contiguous bf16 for TMA")
    _check(w % 8 == 0 and hidden.data_ptr() % 16 == 0,
           "TMA needs 16-byte rows: W={} must be a multiple of 8 and hidden 16-byte aligned", w)
    return dict(dims=(w, r), strides=(2 * w,), box=(K_CHUNK, ROWS))


def tile_plan(r, w, v):
    """The bf16 kernel's launch for hidden [r, w] against v vocab columns:
    a cluster of CLUSTER CTAs per statistics block and row group, each CTA
    CTA_COLS columns x ROWS rows, walking w in chunks of K_CHUNK through a
    ring of STAGES stages (int8 tile + hidden chunk).  The shared memory:
    1 KB of alignment slack, the ring (which the staged logits [ROWS,
    CTA_COLS + 4] f32 reuse), each row's (max, sum) of both CTAs of the
    cluster and two barriers per stage, the same formula as the C side's
    `gitax_vocab_topk_smem`."""
    nb = (v + TILE - 1) // TILE
    groups = (r + ROWS - 1) // ROWS
    ring = STAGES * (CTA_COLS * K_CHUNK + ROWS * K_CHUNK * 2)
    smem = 1024 + ring + 4 * ROWS * 4 + 8 * 2 * STAGES
    if 4 * ROWS * (CTA_COLS + 4) > ring or smem > _MAX_SMEM:
        raise ValueError("vocab_topk: the plan needs {} bytes of shared memory, or its staged "
                         "logits do not fit the ring".format(smem))
    return dict(blocks=nb, row_groups=groups, cluster=CLUSTER, grid=(CLUSTER * nb, groups),
                ctas=CLUSTER * nb * groups, threads=_THREADS, chunks=(w + K_CHUNK - 1) // K_CHUNK,
                stages=STAGES, loads_in_flight=STAGES * CTA_COLS * K_CHUNK, smem_bytes=smem)


def cta_tile(bx, by):
    """(first row, first column) of the [ROWS, CTA_COLS] tile of logits
    that CTA (bx, by) computes and writes."""
    return by * ROWS, bx * CTA_COLS


def stats_writer(row, block):
    """(blockIdx.x, blockIdx.y, threadIdx.x) of the one thread that writes
    bmax[row, block] and bsum[row, block]: rank 0 of the block's cluster,
    after it has merged the other CTAs' (max, sum)."""
    return CLUSTER * block, row // ROWS, row % ROWS


def block_stats(logits, tile=TILE):
    """Logits [R, V] (padded or not) -> (logits [R, NB*tile] padded with
    -inf, bmax [R, NB], bsum [R, NB]): the kernel's epilogue, gitax's
    `block_stats_xla`.  Also the step-0 statistics of the beam search,
    from the prefill's plain-head logits."""
    r, v = logits.shape
    nb = (v + tile - 1) // tile
    pad = nb * tile - v
    if pad:
        logits = torch.nn.functional.pad(logits, (0, pad), value=NEG_INF)
    xb = logits.reshape(r, nb, tile)
    bmax = xb.amax(dim=-1)
    e = torch.where(torch.isfinite(xb), torch.exp(xb - bmax[:, :, None]), 0.0)
    return logits, bmax, e.sum(dim=-1)


def combine_lse(bmax, bsum):
    """[R, NB] block statistics -> [R] logsumexp, the two-level form (exact
    in f32 up to summation order)."""
    m = bmax.amax(dim=1, keepdim=True)
    return (m + torch.log((bsum * torch.exp(bmax - m)).sum(dim=1, keepdim=True)))[:, 0]


def vocab_logits_topk_reference(hidden, wq8t, scale, bias, tile=TILE):
    """Plain PyTorch version: the int8 head as `output_logits` computes it
    (hidden and the int8 values cast up to f32, one f32 matmul, the scale
    and then the bias applied), then `block_stats`.  Any tile."""
    logits = torch.matmul(hidden.float(), wq8t.float())
    logits = logits * scale.float() + bias.float()
    return block_stats(logits, tile)


# the launch function, bound at the first launch
_KERNEL = None


def _bind():
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.load("vocab_topk")
        fn = lib.gitax_vocab_topk
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        lib.gitax_vocab_topk_tile.restype = ctypes.c_int
        _KERNEL = (fn, lib.gitax_vocab_topk_tile())
    return _KERNEL


def _check(cond, msg, *args):
    """Raise unless cond; the message is formatted only then (the beam step
    is bound by the host, so a passing check must cost next to nothing)."""
    if not cond:
        raise ValueError("vocab_topk: " + msg.format(*args))


def vocab_logits_topk_cuda(hidden, wq8t, scale, bias, tile=TILE):
    """Launch the CUDA kernel on PyTorch's current stream.  wq8t [W, V] is
    vocab-major: the transpose of a row-major [V, W], the layout the
    port's int8 Linear stores (`models/nn.py::Linear.set_int8`), with W a
    multiple of 16 and its data 16-byte aligned (the kernel's loads and its
    tensor map).  Validates device, dtypes, shapes and layout and raises on
    anything the kernel does not take; allocates the three outputs."""
    global launches
    dev = hidden.device
    for name, t in (("hidden", hidden), ("wq8t", wq8t), ("scale", scale), ("bias", bias)):
        _check(t.is_cuda and t.device == dev,
               "{} must be on the CUDA device of hidden, got {}", name, t.device)
        _check(t is wq8t or t.is_contiguous(), "{} must be contiguous", name)
    bf16 = hidden.dtype == torch.bfloat16
    _check(bf16 or hidden.dtype == torch.float32,
           "hidden must be float32 or bfloat16, got {}", hidden.dtype)
    _check(wq8t.dtype == torch.int8, "wq8t must be int8, got {}", wq8t.dtype)
    _check(scale.dtype == torch.float32 and bias.dtype == torch.float32,
           "scale and bias must be float32, got {} and {}", scale.dtype, bias.dtype)
    _check(hidden.dim() == 2 and wq8t.dim() == 2,
           "hidden [R, W] and wq8t [W, V], got {} and {}", hidden.shape, wq8t.shape)
    r, w = hidden.shape
    v = wq8t.shape[1]
    _check(wq8t.shape[0] == w, "wq8t has {} rows for a hidden width {}", wq8t.shape[0], w)
    _check(scale.shape == (v,) and bias.shape == (v,),
           "scale and bias must be [{}], got {} and {}", v, scale.shape, bias.shape)
    _check(r > 0 and w > 0 and v > 0, "empty input")
    wmap = weight_map(wq8t)
    launch, kernel_tile = _bind()
    _check(tile == kernel_tile, "tile {}: the kernel takes {}", tile, kernel_tile)
    nb = (v + tile - 1) // tile
    _check(nb <= 65535 and r <= 65535 * 32, "V={} or R={} above the grid limit", v, r)
    maps = None
    if bf16:
        hmap = hidden_map(hidden)
        maps = (ctypes.c_longlong * 10)(*wmap["dims"], *wmap["strides"], *wmap["box"],
                                        *hmap["dims"], *hmap["strides"], *hmap["box"])
    logits = torch.empty((r, nb * tile), dtype=torch.float32, device=dev)
    bmax = torch.empty((r, nb), dtype=torch.float32, device=dev)
    bsum = torch.empty((r, nb), dtype=torch.float32, device=dev)
    rc = launch(
        hidden.data_ptr(), wq8t.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        logits.data_ptr(), bmax.data_ptr(), bsum.data_ptr(),
        r, w, v, tile, int(bf16), maps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError("vocab_topk kernel launch failed: {}".format(
            "tensor map CUresult {}".format(rc - 10000) if rc >= 10000 else "cudaError {}".format(rc)))
    launches += 1
    return logits, bmax, bsum


def vocab_logits_topk(hidden, wq8t, scale, bias, tile=TILE):
    """hidden [R, W] (f32 or bf16), wq8t [W, V] int8, scale and bias [V]
    f32 -> (logits [R, NB*tile], bmax [R, NB], bsum [R, NB]), all f32.
    The plain version for CPU tensors (any layout); the kernel (tile 512,
    vocab-major wq8t only) for CUDA tensors."""
    if not hidden.is_cuda:
        return vocab_logits_topk_reference(hidden, wq8t, scale, bias, tile)
    return vocab_logits_topk_cuda(hidden, wq8t, scale, bias, tile)
