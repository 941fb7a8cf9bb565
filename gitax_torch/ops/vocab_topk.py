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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.gitax_vocab_topk_tile.restype = ctypes.c_int
        _KERNEL = (fn, lib.gitax_vocab_topk_tile())
    return _KERNEL


def _check(cond, msg):
    if not cond:
        raise ValueError("vocab_topk: " + msg)


def vocab_logits_topk_cuda(hidden, wq8t, scale, bias, tile=TILE):
    """Launch the CUDA kernel on PyTorch's current stream.  wq8t [W, V] is
    vocab-major: the transpose of a row-major [V, W], the layout the
    port's int8 Linear stores (`models/nn.py::Linear.set_int8`), with W a
    multiple of 16 and its data 16-byte aligned (the kernel's loads).
    Validates device, dtypes, shapes and layout and raises on anything the
    kernel does not take; allocates the three outputs."""
    global launches
    tensors = dict(hidden=hidden, wq8t=wq8t, scale=scale, bias=bias)
    for name, t in tensors.items():
        _check(t.is_cuda and t.device == hidden.device,
               "{} must be on the CUDA device of hidden, got {}".format(name, t.device))
        _check(name == "wq8t" or t.is_contiguous(), "{} must be contiguous".format(name))
    _check(hidden.dtype in (torch.float32, torch.bfloat16),
           "hidden must be float32 or bfloat16, got {}".format(hidden.dtype))
    _check(wq8t.dtype == torch.int8, "wq8t must be int8, got {}".format(wq8t.dtype))
    _check(scale.dtype == torch.float32 and bias.dtype == torch.float32,
           "scale and bias must be float32, got {} and {}".format(scale.dtype, bias.dtype))
    _check(hidden.dim() == 2 and wq8t.dim() == 2,
           "hidden [R, W] and wq8t [W, V], got {} and {}".format(
               tuple(hidden.shape), tuple(wq8t.shape)))
    r, w = hidden.shape
    v = wq8t.shape[1]
    _check(wq8t.shape[0] == w, "wq8t has {} rows for a hidden width {}".format(wq8t.shape[0], w))
    _check(tuple(scale.shape) == (v,) and tuple(bias.shape) == (v,),
           "scale and bias must be [{}], got {} and {}".format(
               v, tuple(scale.shape), tuple(bias.shape)))
    _check(r > 0 and w > 0 and v > 0, "empty input")
    _check(wq8t.t().is_contiguous(),
           "wq8t must be vocab-major (the transpose of a row-major [V, W]), strides {}".format(
               wq8t.stride()))
    _check(w % 16 == 0 and wq8t.data_ptr() % 16 == 0,
           "the kernel loads 16 bytes along W: W={} must be a multiple of 16 and the int8 data "
           "16-byte aligned".format(w))
    launch, kernel_tile = _bind()
    _check(tile == kernel_tile, "tile {}: the kernel takes {}".format(tile, kernel_tile))
    nb = (v + tile - 1) // tile
    _check(nb <= 65535 and r <= 65535 * 32, "V={} or R={} above the grid limit".format(v, r))
    logits = torch.empty((r, nb * tile), dtype=torch.float32, device=hidden.device)
    bmax = torch.empty((r, nb), dtype=torch.float32, device=hidden.device)
    bsum = torch.empty((r, nb), dtype=torch.float32, device=hidden.device)
    rc = launch(
        hidden.data_ptr(), wq8t.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        logits.data_ptr(), bmax.data_ptr(), bsum.data_ptr(),
        r, w, v, tile, int(hidden.dtype == torch.bfloat16),
        torch.cuda.current_stream(hidden.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError("vocab_topk kernel launch failed: cudaError {}".format(rc))
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
