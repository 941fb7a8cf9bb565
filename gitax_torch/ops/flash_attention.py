"""Fused attention for the ViT encoder and the decoder prefill.

Replaces the TPU kernel `gitax/ops/flash_attention.py::_attn_kernel` (run
by `_packed_attention` for both of gitax's entries) with a CUDA kernel
written for Hopper (`gitax_torch/csrc/flash_attention.cu`, which carries
the design note: what it computes, its bound on the H100 and what the
design does about it).  Beside it, `attention_reference` is the plain
PyTorch version of the same function.

The two entries keep gitax's layouts:
  flash_qkv_attention(qkv [B, S, 3D], num_heads) -> [B, S, D]
      full attention straight off the fused qkv projection, context in
      merge_heads order (the ViT encoder);
  fused_attention(q, k, v [B, H, T, Dh], num_memory, masked) -> [B, H, T, Dh]
      full attention, or GIT's unified block mask with `num_memory`
      leading memory tokens (the decoder prefill).
For CPU tensors they run the plain version; for CUDA tensors they launch
the kernel or raise.  There is no fallback.  The module-level `launches`
counts kernel launches of both entries.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

NEG_INF = -1e30

# the smem per block a kernel launch may take on sm_90 (227 KB)
_MAX_SMEM = 232448
# f32 kernel: query rows per block, K/V tokens per tile, shared row stride
# (Dh + 1, free of bank conflicts)
_F32_ROWS, _F32_COLS, _F32_LD = 64, 64, 65
# bf16 kernel: query rows per CTA (two warpgroups of 64), K/V tokens per
# TMA box, ring stages; its tiles are 1024-byte aligned by hand (1 KB of
# slack) and the ring has a full and an empty mbarrier per stage, plus q's
_TMA_ROWS, _TMA_COLS, _TMA_STAGES = 128, 64, 4

# gitax's auto-enable threshold, measured on a TPU v5e (gitax
# ops/flash_attention.py:272-281).  The port starts from it; PERF.md holds
# the H100 A/B that a later change of the threshold would rest on.
FLASH_AUTO_MIN_SEQ = 640

launches = 0


def auto_flash(seq_len: int, dtype, device) -> bool:
    """gitax's rule for flash=None: the kernel for sequences of at least
    FLASH_AUTO_MIN_SEQ in a production dtype (never f32, the parity mode)
    on a CUDA device."""
    return (
        seq_len >= FLASH_AUTO_MIN_SEQ
        and dtype != torch.float32
        and torch.device(device).type == "cuda"
    )


def attention_reference(q, k, v, num_memory=0, masked=False):
    """Plain PyTorch version with the kernel's numerics (gitax
    `_attn_kernel`): q scaled by 1/sqrt(Dh) in the activation dtype, f32
    scores, GIT's block mask from indices, an f32 softmax normalised by
    division, probabilities rounded to the activation dtype, P.V summed in
    f32 and cast once.  q, k, v: [B, H, T, Dh] -> [B, H, T, Dh]."""
    dt = q.dtype
    t, dh = q.shape[2], q.shape[3]
    scale = torch.tensor(1.0 / (dh ** 0.5), dtype=dt)  # 0-dim CPU: a scalar
    scores = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if masked:
        idx = torch.arange(t, device=q.device)
        row, col = idx[:, None], idx[None, :]
        blocked = (col >= num_memory) & ((row < num_memory) | (col > row))
        scores = scores.masked_fill(blocked, NEG_INF)
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dt)
    return torch.matmul(p.float(), v.float()).to(dt)


def smem_bytes(bf16):
    """Shared memory one block takes, the same for every S.  bf16: the
    alignment slack, the q tile, the K/V ring and its barriers; f32: the q
    tile, one K and one V tile and the f32 score tiles.  The same formula
    as the C side's `gitax_flash_attention_smem`."""
    if bf16:
        dh = 64
        return (1024 + 2 * _TMA_ROWS * dh + 2 * _TMA_STAGES * 2 * _TMA_COLS * dh
                + 8 * (2 * _TMA_STAGES + 1))
    return 4 * ((_F32_ROWS + 2 * _F32_COLS) * _F32_LD + _F32_ROWS * _F32_COLS)


def tensor_map(x, box_rows):
    """The TMA tensor-map parameters of a bf16 [B, H, T, Dh] view whose
    last dim is contiguous, as the kernel encodes them: dims (Dh, T, H, B)
    in elements, the byte strides of T, H and B, and the box (Dh,
    box_rows) (one head of one batch element).  Raises unless the base is
    16-byte aligned and every stride a multiple of 16 bytes, as TMA needs
    (a dim of size 1 is never stepped, so its stride is not read)."""
    b, h, t, dh = x.shape
    es = x.element_size()
    _check(x.stride(3) == 1, "the last dim must be contiguous for TMA")
    _check(x.data_ptr() % 16 == 0, "TMA needs a 16-byte aligned base")
    strides = []
    for n, st in ((t, x.stride(2)), (h, x.stride(1)), (b, x.stride(0))):
        nbytes = st * es if n > 1 else 16
        _check(nbytes > 0 and nbytes % 16 == 0 and nbytes < 2 ** 40,
               "TMA needs byte strides that are multiples of 16, got {}".format(nbytes))
        strides.append(nbytes)
    return dict(dims=(dh, t, h, b), strides=tuple(strides), box=(dh, box_rows))


def _tensor_maps(q, k, v):
    """The three maps flattened for the C entry: 9 int64 each."""
    flat = []
    for x, rows in ((q, _TMA_ROWS), (k, _TMA_COLS), (v, _TMA_COLS)):
        m = tensor_map(x, rows)
        flat += list(m["dims"]) + list(m["strides"]) + list(m["box"])
    return (ctypes.c_longlong * len(flat))(*flat)


# (launch function, the head dim the kernel takes), bound at the first launch
_KERNEL = None


def _bind():
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.load("flash_attention")
        fn = lib.gitax_flash_attention
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        lib.gitax_flash_attention_head_dim.restype = ctypes.c_int
        _KERNEL = (fn, lib.gitax_flash_attention_head_dim())
    return _KERNEL


def _check(cond, msg):
    if not cond:
        raise ValueError("flash_attention: " + msg)


def flash_attention_cuda(q, k, v, out, num_memory=0, masked=False):
    """Launch the CUDA kernel on PyTorch's current stream: q, k, v -> out,
    all [B, H, T, Dh] views whose last dim is contiguous (any batch, head
    and token strides).  Validates device, dtype, shape, strides and
    alignment and raises on anything the kernel does not take, and on
    inputs that autograd would track (`cuda_build.refuse_autograd`)."""
    global launches
    cuda_build.refuse_autograd("flash_attention", q, k, v)
    tensors = dict(q=q, k=k, v=v, out=out)
    for name, t in tensors.items():
        _check(t.is_cuda and t.device == q.device,
               "{} must be on the CUDA device of q, got {}".format(name, t.device))
    dt = q.dtype
    _check(dt in (torch.float32, torch.bfloat16),
           "activations must be float32 or bfloat16, got {}".format(dt))
    _check(q.dim() == 4, "q must be [B, H, T, Dh], got {}".format(tuple(q.shape)))
    b, h, t, dh = q.shape
    for name, x in tensors.items():
        _check(x.dtype == dt, "{} dtype {} != q's {}".format(name, x.dtype, dt))
        _check(tuple(x.shape) == (b, h, t, dh), "{} shape {}".format(name, tuple(x.shape)))
        _check(x.stride(3) == 1, "{} must have a contiguous last dim".format(name))
        vec = 16 // x.element_size()
        _check(x.data_ptr() % 16 == 0 and all(s % vec == 0 for s in x.stride()[:3]),
               "{} rows must be 16-byte aligned".format(name))
    bf16 = dt == torch.bfloat16
    maps = _tensor_maps(q, k, v) if bf16 else None
    _check(t > 0, "empty sequence")
    _check(b <= 65535 and h <= 65535, "B={} or H={} above the grid limit".format(b, h))
    if masked:
        _check(0 <= num_memory <= t, "num_memory {} outside [0, {}]".format(num_memory, t))
    launch, kernel_dh = _bind()
    _check(dh == kernel_dh, "head_dim {}: the kernel takes {}".format(dh, kernel_dh))
    _check(smem_bytes(bf16) <= _MAX_SMEM,
           "needs {} bytes of shared memory per block".format(smem_bytes(bf16)))
    rc = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        b, h, t, dh, int(num_memory), int(masked), int(bf16), maps,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed: {}".format(
            "tensor map CUresult {}".format(rc - 10000) if rc >= 10000 else "cudaError {}".format(rc)))
    launches += 1
    return out


def flash_qkv_attention(qkv, num_heads):
    """Full attention off the fused qkv projection: qkv [B, S, 3D] ->
    context [B, S, D] in merge_heads order.  On a CUDA device the kernel
    reads q, k and v in place and writes the context in place."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    y = qkv.unflatten(2, (3, num_heads, dh))
    q, k, v = (y[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, S, Dh] views
    if not qkv.is_cuda:
        return attention_reference(q, k, v).transpose(1, 2).reshape(b, t, d)
    out = torch.empty((b, t, d), dtype=qkv.dtype, device=qkv.device)
    flash_attention_cuda(q, k, v, out.view(b, t, num_heads, dh).transpose(1, 2))
    return out


def fused_attention(q, k, v, num_memory=0, masked=False):
    """q, k, v [B, H, T, Dh] -> [B, H, T, Dh].  masked=False: full
    attention; masked=True: GIT's unified mask with `num_memory` leading
    memory tokens.  On a CUDA device the result is a [B, H, T, Dh] view
    of a [B, T, H, Dh] buffer, so merge_heads needs no copy."""
    if not q.is_cuda:
        return attention_reference(q, k, v, num_memory, masked)
    b, h, t, dh = q.shape
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    return flash_attention_cuda(q, k, v, out, num_memory, masked)
