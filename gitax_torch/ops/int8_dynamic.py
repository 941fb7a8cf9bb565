"""w8a8: the per-token dynamic int8 product of the encoder's GEMMs.

The counterpart of gitax's `_int8_dynamic_matmul` (gitax/models/nn.py:53-71),
which XLA compiles into fusions around an int8 dot; there is no Pallas
kernel behind it.  On the card it is three launches:

  1. `quantize_rows`: one pass over each row of x [M, K] that writes the
     int8 codes and the f32 row scale (`csrc/int8_dynamic.cu`,
     `gitax_int8_quantize_rows_kernel`):
         amax = max|x| (f32),  a_scale = max(amax, 1e-12) / 127,
         q = clip(round(x_f32 / a_scale), -127, 127)
     round halves to even (torch.round, jnp.round and CUDA's rintf), and
     the kernel divides where gitax divides, so every code equals
     gitax's.  Under tensor parallelism a row-parallel layer sees a shard
     of K; the caller then passes the row's amax all-reduced over the
     model group, and the kernel takes it in place of its own.
  2. `int_mm`: q [M, K] @ w [K, N] in int32, `torch._int_mm` (cuBLASLt's
     int8 tensor-core GEMM; gitax leaves the dot to XLA too).  It needs
     M > 16 and K and N multiples of 8; M <= 16 is padded with zero rows.
     The weight codes are stored out-major ([N, K] row-major seen as
     [K, N]), the layout `models/nn.py::Linear.set_int8` keeps.
  3. `scale_rows`: the epilogue, int32 -> (y * a_scale) * w_scale in f32,
     in that order and with no fused multiply-add -> the activation dtype
     -> + bias in the activation dtype (`gitax_int8_scale_rows_kernel`).

Each kernel has its plain PyTorch version beside it
(`quantize_rows_reference`, `scale_rows_reference`; `int_mm_reference`
for the product, exact in f64).  A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or the call raises, and the call raises
under autograd: w8a8 is an inference format.  `quantize_rows.launches`
and `scale_rows.launches` count the kernels' launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# the smallest M torch._int_mm takes is 17
_MIN_INT_MM_ROWS = 17


def _check(cond, msg):
    if not cond:
        raise ValueError("int8_dynamic: " + msg)


def row_amax(x2):
    """max|x| of each row of x2 [M, K], f32 [M] (exact: no rounding)."""
    return x2.abs().amax(dim=-1).float()


def quantize_rows_reference(x2, amax=None):
    """Plain version of kernel 1: (codes int8 [M, K], a_scale f32 [M]).
    amax: the rows' f32 max|x| [M] from outside (tensor parallelism), else
    each row's own."""
    if amax is None:
        amax = row_amax(x2)
    amax = torch.clamp(amax.float(), min=1e-12)
    # a true division: on CUDA, torch divides by a Python scalar as a
    # multiply by its reciprocal, which moves some scales by an ulp
    a_scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x2.float() / a_scale[:, None]), -127, 127)
    return q.to(torch.int8), a_scale


def int_mm_reference(q, w_q8_t):
    """q int8 [M, K] @ w int8 [K, N] -> int32 [M, N], exact: every product
    and partial sum is an integer below 2^53 in f64."""
    return torch.matmul(q.to(torch.float64), w_q8_t.to(torch.float64)).to(torch.int32)


def scale_rows_reference(y32, a_scale, w_scale, bias, dtype):
    """Plain version of kernel 3: ((y32 * a_scale) * w_scale) in f32, cast
    to `dtype`, then + bias in `dtype` (gitax nn.py:69-70, :44-50)."""
    y = (y32.float() * a_scale[:, None]) * w_scale.float()
    y = y.to(dtype)
    return y + bias.to(dtype) if bias is not None else y


# (quantize launch, scale launch), bound at the first launch
_KERNEL = None


def _bind():
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.load("int8_dynamic")
        quant = lib.gitax_int8_quantize_rows
        quant.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        quant.restype = ctypes.c_int
        scale = lib.gitax_int8_scale_rows
        scale.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        scale.restype = ctypes.c_int
        _KERNEL = (quant, scale)
    return _KERNEL


def _check_cuda(name, t, dev, dtype=None):
    _check(t.is_cuda and t.device == dev, "{} must be on {}, got {}".format(name, dev, t.device))
    _check(t.is_contiguous(), "{} must be contiguous".format(name))
    _check(t.data_ptr() % 16 == 0, "{} must be 16-byte aligned".format(name))
    if dtype is not None:
        _check(t.dtype == dtype, "{} must be {}, got {}".format(name, dtype, t.dtype))


def quantize_rows_cuda(x2, amax=None):
    """Launch kernel 1 on PyTorch's current stream: x2 [M, K] f32 or bf16,
    contiguous, K a multiple of 8; amax f32 [M] or None."""
    cuda_build.refuse_autograd("int8_dynamic.quantize_rows", x2)
    dev = x2.device
    _check(x2.dim() == 2, "x must be [M, K], got {}".format(tuple(x2.shape)))
    _check(x2.dtype in (torch.float32, torch.bfloat16),
           "x must be float32 or bfloat16, got {}".format(x2.dtype))
    _check_cuda("x", x2, dev)
    m, k = x2.shape
    _check(m >= 1 and k >= 8 and k % 8 == 0, "K={} must be a positive multiple of 8".format(k))
    if amax is not None:
        _check_cuda("amax", amax, dev, torch.float32)
        _check(amax.shape == (m,), "amax must be [M], got {}".format(tuple(amax.shape)))
    q = torch.empty((m, k), dtype=torch.int8, device=dev)
    a_scale = torch.empty((m,), dtype=torch.float32, device=dev)
    launch, _ = _bind()
    rc = launch(x2.data_ptr(), q.data_ptr(), a_scale.data_ptr(),
                None if amax is None else amax.data_ptr(), m, k,
                int(x2.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("int8 quantize_rows kernel launch failed: cudaError {}".format(rc))
    quantize_rows.launches += 1
    return q, a_scale


def scale_rows_cuda(y32, a_scale, w_scale, bias, dtype):
    """Launch kernel 3 on PyTorch's current stream: y32 int32 [M, N], N a
    multiple of 8; a_scale f32 [M]; w_scale f32 [N]; bias [N] of `dtype`
    or None; returns [M, N] of `dtype` (f32 or bf16)."""
    cuda_build.refuse_autograd("int8_dynamic.scale_rows", bias)
    dev = y32.device
    _check(dtype in (torch.float32, torch.bfloat16),
           "the activation dtype must be float32 or bfloat16, got {}".format(dtype))
    _check(y32.dim() == 2, "y must be [M, N], got {}".format(tuple(y32.shape)))
    _check_cuda("y", y32, dev, torch.int32)
    m, n = y32.shape
    _check(n % 8 == 0, "N={} must be a multiple of 8".format(n))
    _check_cuda("a_scale", a_scale, dev, torch.float32)
    _check_cuda("w_scale", w_scale, dev, torch.float32)
    _check(a_scale.shape == (m,) and w_scale.shape == (n,), "scales must be [M] and [N]")
    if bias is not None:
        _check_cuda("bias", bias, dev, dtype)
        _check(bias.shape == (n,), "bias must be [N]")
    out = torch.empty((m, n), dtype=dtype, device=dev)
    _, launch = _bind()
    rc = launch(y32.data_ptr(), a_scale.data_ptr(), w_scale.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(), m, n,
                int(dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("int8 scale_rows kernel launch failed: cudaError {}".format(rc))
    scale_rows.launches += 1
    return out


def quantize_rows(x2, amax=None):
    """Kernel 1 (see the module docstring): the plain version for a CPU
    tensor, the kernel for a CUDA one."""
    return (quantize_rows_cuda if x2.is_cuda else quantize_rows_reference)(x2, amax)


quantize_rows.launches = 0


def int_mm(q, w_q8_t):
    """The int32 product q [M, K] @ w [K, N]: torch._int_mm on the card
    (M <= 16 padded with zero rows), exact f64 on the CPU."""
    if not q.is_cuda:
        return int_mm_reference(q, w_q8_t)
    m, k = q.shape
    _check(k % 8 == 0 and w_q8_t.shape[1] % 8 == 0,
           "torch._int_mm needs K and N multiples of 8, got {} and {}".format(k, w_q8_t.shape[1]))
    if m < _MIN_INT_MM_ROWS:
        pad = torch.zeros((_MIN_INT_MM_ROWS, k), dtype=q.dtype, device=q.device)
        pad[:m] = q
        return torch._int_mm(pad, w_q8_t)[:m].contiguous()
    return torch._int_mm(q, w_q8_t)


def scale_rows(y32, a_scale, w_scale, bias, dtype):
    """Kernel 3 (see the module docstring): the plain version for a CPU
    tensor, the kernel for a CUDA one."""
    fn = scale_rows_cuda if y32.is_cuda else scale_rows_reference
    return fn(y32, a_scale, w_scale, bias, dtype)


scale_rows.launches = 0


def int8_dynamic_matmul(x, w_q8_t, w_scale, bias=None, tp_group=None):
    """x [..., K] (f32 or bf16) @ the int8 weight w_q8_t [K, N] with
    per-row dynamic activation scales, + bias, in x's dtype (gitax
    `linear` with `kernel_q8_dyn`).

    tp_group: the model group of a row-parallel layer whose rank holds a
    shard of K.  gitax's SPMD program computes one device's function, so
    the amax is the whole row's: each rank's row amax is all-reduced (MAX)
    before quantizing, the int32 partial products are summed over the
    group (exact: a sum of f32 partials would not be, as they reach
    127^2 * K / 2 > 2^24), and only then scaled; the bias is added once.
    Both are all-reduces, so one code path runs over NCCL and gloo."""
    from ..parallel import comm

    cuda_build.refuse_autograd("int8_dynamic_matmul", x)
    dtype = x.dtype
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k).contiguous()
    amax = None
    if tp_group is not None:
        amax = comm.all_reduce_max(row_amax(x2), tp_group)
    q, a_scale = quantize_rows(x2, amax)
    y32 = comm.all_reduce(int_mm(q, w_q8_t), tp_group)
    if bias is not None:
        bias = bias.to(dtype).contiguous()
    y = scale_rows(y32, a_scale, w_scale, bias, dtype)
    return y.reshape(*lead, w_q8_t.shape[1])
