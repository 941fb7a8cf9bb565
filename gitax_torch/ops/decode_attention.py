"""Decode-step attention: one decoder layer's attention for one beam step.

Replaces the TPU kernel `gitax/ops/decode_attention.py::_kernel` with a
CUDA kernel written for Hopper (`gitax_torch/csrc/decode_attention.cu`,
which carries the design note: what it computes, its bound on the H100
and what the design does about it).  Beside it, `decode_attention_reference`
is the plain PyTorch version of the same function.

`decode_attention` is the public entry: for CPU tensors it runs the plain
version; for CUDA tensors it launches the kernel or raises.  There is no
fallback.  `decode_attention.launches` counts kernel launches made by the
wrapper; a CUDA graph that captured the call launches the kernel at each
replay without the wrapper (`decode.device_loop` adds those to the count).

Layouts are gitax's at the public function:
  q        [BK, H*Dh]      pre-scaled queries (no zero extension)
  kv_new   [BK, H*2Dh]     the step's k|v rows, interleaved per head
  txt_kv   [T, BK, H*2Dh]  time-major text cache, updated IN PLACE at pos
  anc      [BK, T] int32   beam ancestry: slot t of beam k reads row
                           b*K + anc[b*K+k, t]
  pos      [] int32        the text position, a 0-dim tensor on the
                           device of txt_kv (the kernel reads it from
                           device memory, so the launch does not depend on
                           it); the plain version also takes an int
  mem_kv   [B, H, M, 2Dh]  memory k|v shared by a batch element's beams;
                           the activation dtype, or int8 with
  mem_scale [B, H, 2] f32  per-(batch, head) k and v scales
  mem_bias [B, M] f32      additive memory bias, or None
Returns ctx [BK, H*Dh] in the activation dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

NEG_INF = -1e30

# the smem per block a kernel launch may take on sm_90 (227 KB)
_MAX_SMEM = 232448
# the kernel's plan: the portable cluster size, rows per bulk copy (one
# mbarrier each), the beams it takes, warps per CTA; the shared memory a
# CTA may take so that three share an SM (228 KB per SM, 1 KB of it
# reserved per CTA)
_MAX_CLUSTER = 8
_SUB_ROWS = 32
_MAX_BEAMS = 8
_WARPS = 8
_THIRD_OF_SM = 233472 // 3 - 1024


def decode_attention_reference(q, kv_new, txt_kv, anc, pos, mem_kv,
                               mem_bias=None, mem_scale=None, *, beams,
                               num_heads, head_dim):
    """Plain PyTorch version with the kernel's numerics: f32 scores, one
    f32 softmax over [memory ; live text], probabilities rounded to the
    activation dtype, both contexts summed in f32 and cast once.  Writes
    kv_new into txt_kv[pos] in place.  pos: a 0-dim integer tensor or an
    int, never read on the host."""
    t_max, bk, _ = txt_kv.shape
    b, k, h, dh = bk // beams, beams, num_heads, head_dim
    dt = q.dtype
    dev = txt_kv.device
    pos = torch.as_tensor(pos, device=dev).long()
    txt_kv.index_copy_(0, pos.reshape(1), kv_new[None])
    qf = q.float().reshape(b, k, h, dh)
    if mem_kv.dtype == torch.int8:
        scale = mem_scale.to(dt)  # [B, H, 2]
        scl = torch.cat(
            [scale[..., :1].expand(b, h, dh), scale[..., 1:].expand(b, h, dh)], -1
        )
        mem = (mem_kv.to(dt) * scl[:, :, None, :]).float()
    else:
        mem = mem_kv.float()
    m = mem.shape[2]
    mem_s = torch.einsum("bkhd,bhmd->bkhm", qf, mem[..., :dh])
    if mem_bias is not None:
        mem_s = mem_s + mem_bias.float()[:, None, None, :]
    # the ancestry-selected text rows: sel[b, k, t] = cache[t, b*K + anc]
    rows = (torch.arange(b, device=dev)[:, None, None] * k
            + anc.long().reshape(b, k, t_max))
    sel = txt_kv[torch.arange(t_max, device=dev)[None, None, :], rows]
    sel = sel.reshape(b, k, t_max, h, 2 * dh).float()
    txt_s = torch.einsum("bkhd,bkthd->bkht", qf, sel[..., :dh])
    live = torch.arange(t_max, device=dev) <= pos
    txt_s = txt_s.masked_fill(~live, NEG_INF)
    scores = torch.cat([mem_s, txt_s], -1)
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = (e * (1.0 / e.sum(-1, keepdim=True))).to(dt).float()
    ctx = torch.einsum("bkhm,bhmd->bkhd", p[..., :m], mem[..., dh:])
    ctx = ctx + torch.einsum("bkht,bkthd->bkhd", p[..., m:], sel[..., dh:])
    return ctx.to(dt).reshape(bk, h * dh)


def smem_bytes(beams, head_dim, chunk, t_max, mem_bytes, cluster):
    """Shared memory one CTA of the kernel takes for `chunk` memory rows
    of `mem_bytes`-byte elements in a cluster of `cluster` CTAs, each
    taking up to ceil(T / C) text slots: the k|v rows [chunk, 2Dh] (padded
    to 16 bytes), whose space the 8 warps' f32 partial contexts [8, K, Dh]
    take once the rows are read; one mbarrier per 32 rows; f32 queries
    [K, Dh]; f32 scores [K, chunk + slots]; int32 cache rows [K, slots];
    the f32 max and sum per beam; the cluster's f32 contexts [C, K, Dh].
    The same formula as the C side's `gitax_decode_attention_smem`."""
    rows = -(-chunk * 2 * head_dim * mem_bytes // 16) * 16
    parts = 4 * _WARPS * beams * head_dim
    nsub = -(-chunk // _SUB_ROWS)
    slots = -(-t_max // cluster)
    return max(rows, parts) + 8 * nsub + 4 * (
        beams * head_dim + beams * (chunk + slots) + beams * slots + 2 * beams
        + cluster * beams * head_dim)


@functools.lru_cache(maxsize=64)
def cluster_plan(mem_len, beams, head_dim, t_max, mem_bytes):
    """The kernel's launch plan for each (batch element, head): a cluster
    of C <= 8 CTAs, the smallest whose CTAs fit three to an SM (C = 8
    where none does); the kernel's CTA r owns memory rows [r * chunk,
    min(M, (r + 1) * chunk)) and the text slots r, r + C, ....  Fewer,
    fuller CTAs carry more bytes per cluster barrier, as long as three
    still share an SM (the sweep in PERF.md §6).  Returns (cluster,
    chunk, smem_bytes); cached, as the decode loop repeats one shape per
    layer and step."""
    for cluster in range(1, _MAX_CLUSTER + 1):
        chunk = -(-mem_len // cluster)
        smem = smem_bytes(beams, head_dim, chunk, t_max, mem_bytes, cluster)
        if smem <= _THIRD_OF_SM:
            break
    return cluster, chunk, smem


# (launch function, the head dim the kernel takes), bound at the first launch
_KERNEL = None
# device -> the kernel's error flag: one int32 the kernel sets to 1 when a
# launch's pos lies outside [0, T)
_ERRORS = {}


def _bind():
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.load("decode_attention")
        fn = lib.gitax_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.gitax_decode_attention_head_dim.restype = ctypes.c_int
        _KERNEL = (fn, lib.gitax_decode_attention_head_dim())
    return _KERNEL


def error_flag(device) -> torch.Tensor:
    """The kernel's error flag on a CUDA device: a [1] int32 tensor that
    any launch whose pos lies outside [0, T) sets to 1 (and then writes
    nothing).  The range check moved onto the card with pos: read the flag
    where a host wait is acceptable (`int(error_flag(dev)[0])`, as
    chip_smoke.py does) and zero it with `.zero_()`.  Allocated at the
    first launch on the device, which is eager (a graph's capture follows
    a warm-up step)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _ERRORS:
        with torch.inference_mode(False):  # a normal tensor: zero_() works anywhere
            _ERRORS[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _ERRORS[device]


def _check(cond, msg):
    if not cond:
        raise ValueError("decode_attention: " + msg)


def decode_attention_cuda(q, kv_new, txt_kv, anc, pos, mem_kv, mem_bias=None,
                          mem_scale=None, *, beams, num_heads, head_dim):
    """Launch the CUDA kernel on PyTorch's current stream.  Validates
    device, dtypes, shapes, contiguity and alignment and raises on
    anything the kernel does not take, and on inputs that autograd would
    track (`cuda_build.refuse_autograd`)."""
    cuda_build.refuse_autograd("decode_attention", q, kv_new, txt_kv, mem_kv, mem_bias,
                               mem_scale)
    t_max, bk, width = txt_kv.shape
    k, h, dh = beams, num_heads, head_dim
    _check(bk % k == 0, "B*K={} rows do not split into beams={}".format(bk, k))
    b = bk // k
    dev = txt_kv.device
    for name, t in (("q", q), ("kv_new", kv_new), ("txt_kv", txt_kv), ("anc", anc),
                    ("mem_kv", mem_kv), ("mem_bias", mem_bias), ("mem_scale", mem_scale)):
        if t is not None:
            _check(t.is_cuda and t.device == dev,
                   "{} must be on the CUDA device of txt_kv, got {}".format(name, t.device))
            _check(t.is_contiguous(), "{} must be contiguous".format(name))
    dt = txt_kv.dtype
    _check(dt in (torch.float32, torch.bfloat16),
           "activations must be float32 or bfloat16, got {}".format(dt))
    _check(q.dtype == dt and kv_new.dtype == dt, "q, kv_new and txt_kv dtypes differ")
    _check(width == h * 2 * dh, "txt_kv width {} != H*2Dh".format(width))
    _check(q.shape == (bk, h * dh), "q shape {}".format(tuple(q.shape)))
    _check(kv_new.shape == (bk, width), "kv_new shape {}".format(tuple(kv_new.shape)))
    _check(anc.dtype == torch.int32 and anc.shape == (bk, t_max), "anc must be int32 [BK, T]")
    _check(mem_kv.dim() == 4 and mem_kv.shape[:2] == (b, h) and mem_kv.shape[3] == 2 * dh,
           "mem_kv shape {}".format(tuple(mem_kv.shape)))
    m = mem_kv.shape[2]
    mem_int8 = mem_kv.dtype == torch.int8
    if mem_int8:
        _check(mem_scale is not None and mem_scale.dtype == torch.float32
               and mem_scale.shape == (b, h, 2), "int8 mem_kv needs f32 mem_scale [B, H, 2]")
    else:
        _check(mem_kv.dtype == dt, "mem_kv dtype {} != activations".format(mem_kv.dtype))
    if mem_bias is not None:
        _check(mem_bias.dtype == torch.float32 and mem_bias.shape == (b, m),
               "mem_bias must be f32 [B, M]")
    if not (torch.is_tensor(pos) and pos.dim() == 0 and pos.dtype == torch.int32
            and pos.device == dev):
        # the message names pos's kind, never its value (a read of the card)
        _check(False, "pos must be a 0-dim int32 tensor on the device of txt_kv, got {}".format(
            "a tensor {} {} on {}".format(tuple(pos.shape), pos.dtype, pos.device)
            if torch.is_tensor(pos) else type(pos).__name__))
    _check(1 <= k <= _MAX_BEAMS, "beams={}: the kernel takes 1 to {}".format(k, _MAX_BEAMS))
    _check(m >= 1, "no memory rows")
    # the memory rows arrive by bulk copies and the text rows by 16-byte loads
    _check(txt_kv.data_ptr() % 16 == 0 and mem_kv.data_ptr() % 16 == 0,
           "txt_kv and mem_kv must be 16-byte aligned")
    launch, kernel_dh = _bind()
    _check(dh == kernel_dh, "head_dim {}: the kernel takes {}".format(dh, kernel_dh))
    cluster, chunk, smem = cluster_plan(m, k, dh, t_max, mem_kv.element_size())
    _check(smem <= _MAX_SMEM, "needs {} bytes of shared memory per CTA".format(smem))

    ctx = torch.empty((bk, h * dh), dtype=dt, device=dev)
    rc = launch(
        q.data_ptr(), kv_new.data_ptr(), txt_kv.data_ptr(), anc.data_ptr(), mem_kv.data_ptr(),
        None if mem_bias is None else mem_bias.data_ptr(),
        None if mem_scale is None else mem_scale.data_ptr(), ctx.data_ptr(),
        pos.data_ptr(), error_flag(dev).data_ptr(),
        b, k, h, dh, m, t_max, int(dt == torch.bfloat16), int(mem_int8), cluster, chunk,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError("decode_attention kernel launch failed: cudaError {}".format(rc))
    decode_attention.launches += 1
    return ctx


def decode_attention(q, kv_new, txt_kv, anc, pos, mem_kv, mem_bias=None,
                     mem_scale=None, *, beams, num_heads, head_dim):
    """Fused decode attention (see the module docstring).  CPU tensors
    run the plain version; CUDA tensors launch the kernel."""
    fn = decode_attention_cuda if txt_kv.is_cuda else decode_attention_reference
    return fn(q, kv_new, txt_kv, anc, pos, mem_kv, mem_bias, mem_scale,
              beams=beams, num_heads=num_heads, head_dim=head_dim)


decode_attention.launches = 0


def quantize_memory(mem_kv):
    """[B, H, M, 2Dh] float memory k|v -> (int8 values, [B, H, 2] f32
    per-(batch, head) scales for the k and v halves); gitax's rule."""
    dh = mem_kv.shape[-1] // 2
    x = mem_kv.float()
    kk, vv = x[..., :dh], x[..., dh:]
    sk = torch.clamp(kk.abs().amax(dim=(2, 3)), min=1e-12) / 127.0
    sv = torch.clamp(vv.abs().amax(dim=(2, 3)), min=1e-12) / 127.0
    qk = torch.clamp(torch.round(kk / sk[:, :, None, None]), -127, 127)
    qv = torch.clamp(torch.round(vv / sv[:, :, None, None]), -127, 127)
    q = torch.cat([qk, qv], dim=-1).to(torch.int8)
    return q, torch.stack([sk, sv], dim=-1)
