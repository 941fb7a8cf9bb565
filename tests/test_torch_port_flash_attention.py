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
    # the C side's formula, checked equal on the card by chip_smoke.py:
    # q + K + V tiles, f32 score tiles, bf16 probability tiles
    assert pfa.smem_bytes(True) == 2 * (64 + 128) * 72 + 4 * 64 * 64 + 2 * 64 * 72 == 53248
    assert pfa.smem_bytes(False) == 4 * (64 + 128) * 65 + 4 * 64 * 64 == 66304
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
