"""The port's fused attention (ops/flash_attention.py) against gitax's
(CPU): the plain version of both entries against gitax's Pallas kernel in
interpret mode and its XLA reference, in f32 and bf16; the auto rule; and
the CPU boundary (no build, no launch).  The same numpy inputs go through
both."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gitax.models.textual import build_unified_mask as gx_build_unified_mask
from gitax.ops import flash_attention as gfa
from gitax_torch.ops import cuda_build
from gitax_torch.ops import flash_attention as pfa

F32_TOL = dict(atol=2e-5, rtol=2e-5)
H, DH = 3, 64
# (T, num_memory) of the masked cases; T=77 leaves a ragged 16-row tile
SHAPES = [(37, 20), (77, 60)]


def _qkv(b, t, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(b, H, t, DH) * scale).astype(np.float32) for _ in range(3))


def _bf16_tol(ours, ref, v):
    """2^-7 of max|v| abs + 2^-7 rel: the probabilities and the context
    are each rounded to bf16 once (2^-9 rel), in other places on the two
    sides."""
    vmax = float(np.abs(v).max())
    np.testing.assert_allclose(ours, ref, atol=vmax / 128, rtol=1 / 128)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "git_mask"])
@pytest.mark.parametrize("t,m", SHAPES)
def test_fused_attention_matches_gitax_f32(t, m, masked):
    q, k, v = _qkv(2, t, seed=t)
    num_memory = m if masked else 0
    ref_kernel = gfa.fused_attention(*map(jnp.asarray, (q, k, v)), num_memory=num_memory,
                                     masked=masked, interpret=True)
    mask = gx_build_unified_mask(m, t - m, batch=2) if masked else None
    ref_xla = gfa.attention_xla(*map(jnp.asarray, (q, k, v)), mask=mask)
    ours = pfa.fused_attention(*map(torch.from_numpy, (q, k, v)), num_memory=num_memory,
                               masked=masked)
    assert ours.shape == (2, H, t, DH) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref_kernel), **F32_TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref_xla), **F32_TOL)


@pytest.mark.parametrize("t", [37, 77])
def test_flash_qkv_attention_matches_gitax_f32(t):
    qkv = (np.random.RandomState(t).randn(2, t, 3 * H * DH) * 0.5).astype(np.float32)
    ref = gfa.flash_qkv_attention(jnp.asarray(qkv), H, interpret=True)
    y = qkv.reshape(2, t, 3, H, DH)
    q, k, v = (jnp.asarray(y[:, :, i].transpose(0, 2, 1, 3)) for i in range(3))
    ref_xla = np.asarray(gfa.attention_xla(q, k, v)).transpose(0, 2, 1, 3).reshape(2, t, H * DH)
    ours = pfa.flash_qkv_attention(torch.from_numpy(qkv), H)
    assert ours.shape == (2, t, H * DH)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **F32_TOL)
    np.testing.assert_allclose(ours.numpy(), ref_xla, **F32_TOL)


@pytest.mark.parametrize("entry", ["fused_full", "fused_masked", "qkv"])
def test_both_entries_match_gitax_bf16(entry):
    t, m = 77, 60
    q, k, v = _qkv(2, t, seed=3, scale=0.5)
    if entry == "qkv":
        qkv = np.concatenate([x.transpose(0, 2, 1, 3).reshape(2, t, H * DH) for x in (q, k, v)], -1)
        ref = gfa.flash_qkv_attention(jnp.asarray(qkv, jnp.bfloat16), H, interpret=True)
        ours = pfa.flash_qkv_attention(torch.from_numpy(qkv).bfloat16(), H)
    else:
        masked = entry == "fused_masked"
        ref = gfa.fused_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                  num_memory=m if masked else 0, masked=masked, interpret=True)
        ours = pfa.fused_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                                   num_memory=m if masked else 0, masked=masked)
    assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _bf16_tol(ours.float().numpy(), np.asarray(ref, np.float32),
              np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32))


def test_auto_flash_rule():
    """gitax's rule (tests/test_flash_attention.py::test_auto_flash_rule)
    with "a CUDA device" in place of a Pallas backend: on only at S >=
    640 in a dtype other than f32 on CUDA."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert pfa.FLASH_AUTO_MIN_SEQ == gfa.FLASH_AUTO_MIN_SEQ == 640
    assert pfa.auto_flash(pfa.FLASH_AUTO_MIN_SEQ, torch.bfloat16, cuda)
    assert pfa.auto_flash(1601, torch.bfloat16, "cuda")
    assert pfa.auto_flash(1201, torch.float16, cuda)
    assert not pfa.auto_flash(pfa.FLASH_AUTO_MIN_SEQ - 1, torch.bfloat16, cuda)
    assert not pfa.auto_flash(257, torch.bfloat16, cuda)
    # f32 parity mode never auto-enables, any length
    assert not pfa.auto_flash(1601, torch.float32, cuda)
    # nor does a CPU device
    assert not pfa.auto_flash(1601, torch.bfloat16, cpu)
    assert not pfa.auto_flash(1601, torch.bfloat16, "cpu")


def test_reference_rounds_probabilities_before_the_value_product():
    """bf16: the plain version rounds each probability to bf16 after
    normalising (the kernel's order), so it differs from the same
    function run in f32 but equals an explicit rounding."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(1, 37, seed=4))
    scores = torch.matmul((q * 0.125).float(), k.float().transpose(-1, -2))
    p = torch.softmax(scores, -1).bfloat16().float()
    want = torch.matmul(p, v.float()).bfloat16()
    torch.testing.assert_close(pfa.attention_reference(q, k, v), want, atol=0, rtol=0)


def test_smem_formula_is_the_kernels_constant():
    # the C side's formula, checked equal on the card by chip_smoke.py.
    # bf16: 1 KB alignment slack, the 128-row q tile, 4 stages of 64-token
    # K and V tiles, 9 mbarriers; f32: q + K + V tiles, f32 score tiles
    assert pfa.smem_bytes(True) == 1024 + 2 * 128 * 64 + 4 * 2 * 2 * 64 * 64 + 8 * 9 == 83016
    assert pfa.smem_bytes(False) == 4 * (64 + 128) * 65 + 4 * 64 * 64 == 66304
    # two bf16 CTAs fit on one SM
    assert 2 * pfa.smem_bytes(True) <= pfa._MAX_SMEM
    assert max(pfa.smem_bytes(True), pfa.smem_bytes(False)) <= pfa._MAX_SMEM


# ---------------------------------------------------------------------------
# the CPU boundary: the plain version, no build, no launch
# ---------------------------------------------------------------------------


def test_cpu_entries_never_build_or_launch(monkeypatch):
    def no_build(name):
        raise AssertionError("cuda_build.load({!r}) called for CPU tensors".format(name))

    monkeypatch.setattr(cuda_build, "load", no_build)
    monkeypatch.setattr(pfa, "_KERNEL", None)
    before = pfa.launches
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 37, seed=5))
    assert pfa.fused_attention(q, k, v, num_memory=20, masked=True).shape == (1, H, 37, DH)
    assert pfa.fused_attention(q.bfloat16(), k.bfloat16(), v.bfloat16()).dtype == torch.bfloat16
    assert pfa.flash_qkv_attention(torch.zeros(1, 37, 3 * H * DH), H).shape == (1, 37, H * DH)
    assert pfa.launches == before


def test_cuda_entry_raises_on_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, seed=6))
    with pytest.raises(ValueError, match="CUDA device"):
        pfa.flash_attention_cuda(q, k, v, torch.empty_like(q))


# ---------------------------------------------------------------------------
# the bf16 kernel's TMA tensor maps, computed in Python from the views
# ---------------------------------------------------------------------------


def _encoder_views(b=2, s=37, h=4):
    """q, k, v as flash_qkv_attention takes them: [B, H, S, Dh] views of
    the fused [B, S, 3, H, Dh] projection."""
    qkv = torch.zeros(b, s, 3 * h * DH, dtype=torch.bfloat16)
    return qkv, [x.transpose(1, 2) for x in qkv.unflatten(2, (3, h, DH)).unbind(2)]


@pytest.mark.parametrize("which", [0, 1, 2], ids=["q", "k", "v"])
def test_tensor_map_of_the_fused_projection(which):
    b, s, h = 2, 37, 4
    qkv, views = _encoder_views(b, s, h)
    x = views[which]
    rows = pfa._TMA_ROWS if which == 0 else pfa._TMA_COLS
    m = pfa.tensor_map(x, rows)
    # dims (Dh, S, H, B); the token stride is the whole 3D row, 6144 bytes
    # at ViT-L's D = 1024 (here 3 * 4 * 64 * 2 = 1536), the head stride
    # 128 bytes, the batch stride S rows
    assert m["dims"] == (DH, s, h, b)
    assert m["strides"] == (3 * h * DH * 2, DH * 2, s * 3 * h * DH * 2)
    assert m["box"] == (DH, rows)
    assert x.data_ptr() - qkv.data_ptr() == which * h * DH * 2


def test_tensor_map_of_the_vit_l_encoder_row():
    # GIT_LARGE's ViT-L/14: D = 1024, 16 heads; the 6144-byte token stride
    _, (q, _, _) = _encoder_views(1, 5, 16)
    assert pfa.tensor_map(q, pfa._TMA_ROWS)["strides"][:2] == (6144, 128)


@pytest.mark.parametrize("t", [13, 1215])
def test_tensor_map_of_split_heads_views(t):
    """The prefill's q, k, v: split_heads views of [B, T, D] projections."""
    from gitax_torch.models.nn import split_heads

    b, h = 2, 12
    x = split_heads(torch.zeros(b, t, h * DH, dtype=torch.bfloat16), h)
    m = pfa.tensor_map(x, pfa._TMA_COLS)
    assert m["dims"] == (DH, t, h, b)
    assert m["strides"] == (h * DH * 2, DH * 2, t * h * DH * 2)
    assert m["box"] == (DH, pfa._TMA_COLS)
    # a batch of one: its stride is never stepped, so any multiple of 16
    one = split_heads(torch.zeros(1, t, h * DH, dtype=torch.bfloat16), h)
    assert pfa.tensor_map(one, pfa._TMA_COLS)["strides"][2] % 16 == 0


@pytest.mark.parametrize("fault", ["token_stride", "head_stride", "base", "last_dim"])
def test_tensor_map_rejects_what_tma_cannot_take(fault):
    if fault == "token_stride":  # tokens 65 elements apart: 130 bytes
        x = torch.zeros(2, 1, 5, 65, dtype=torch.bfloat16)[..., :DH]
    elif fault == "head_stride":  # heads 68 elements apart: 136 bytes
        x = torch.zeros(1, 5, 4, 68, dtype=torch.bfloat16)[..., :DH].transpose(1, 2)
    elif fault == "base":  # one element past an aligned base
        x = torch.zeros(2 * 5 * DH + 1, dtype=torch.bfloat16)[1:].view(2, 1, 5, DH)
    else:
        x = torch.zeros(2, 1, DH, 5, dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="TMA|contiguous"):
        pfa.tensor_map(x, pfa._TMA_COLS)
