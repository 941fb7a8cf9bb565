"""The fused vocab-head module (gitax_torch/ops/vocab_topk.py) and the
blocked top-k against gitax (CPU, f32): the plain version against gitax's
Pallas kernel in interpret mode, as gitax's own tests run it; the block
statistics and the two-level logsumexp against gitax's; the blocked
top-k's indices on inputs full of ties; and the wrapper's CPU routing."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gitax.decode.beam import _top_k_blocked as gx_top_k_blocked
from gitax.ops.vocab_topk import block_stats_xla, vocab_logits_topk as gx_vocab_logits_topk
from gitax.ops.vocab_topk import combine_lse as gx_combine_lse
from gitax_torch.decode.beam import _top_k_blocked, top_k_stable
from gitax_torch.ops import vocab_topk as vt


def _head_inputs(r, v, w_dim=64, seed=0):
    """gitax tests/test_vocab_topk.py's inputs: f32 hidden, int8 values,
    small positive scales, small biases."""
    rng = np.random.RandomState(seed)
    return (rng.randn(r, w_dim).astype(np.float32),
            rng.randint(-127, 128, (w_dim, v)).astype(np.int8),
            (rng.rand(v) * 0.01).astype(np.float32),
            (rng.randn(v) * 0.1).astype(np.float32))


@pytest.mark.parametrize("r,v", [(12, 1100), (8, 1024), (3, 700)])
def test_reference_matches_gitax_kernel_interpret(r, v):
    """Logits within 1e-5 of gitax's interpret-mode kernel with the same
    -inf padding; bmax bit-equal to the block maxima of its own logits;
    bsum and the two-level logsumexp within 1e-6."""
    tile = 128
    args = _head_inputs(r, v)
    lk, bmax_k, bsum_k = gx_vocab_logits_topk(*map(jnp.asarray, args), tile=tile,
                                              interpret=True)
    logits, bmax, bsum = vt.vocab_logits_topk_reference(*map(torch.from_numpy, args), tile=tile)
    nb = -(-v // tile)
    assert logits.shape == (r, nb * tile) and bmax.shape == bsum.shape == (r, nb)
    assert logits.dtype == bmax.dtype == bsum.dtype == torch.float32
    np.testing.assert_array_equal(logits[:, v:].numpy(), np.asarray(lk[:, v:]))
    assert torch.isneginf(logits[:, v:]).all()
    np.testing.assert_allclose(logits[:, :v].numpy(), np.asarray(lk[:, :v]), rtol=1e-5, atol=1e-5)
    _, bmax_self, bsum_self = vt.block_stats(logits[:, :v], tile)
    assert torch.equal(bmax, bmax_self)
    np.testing.assert_allclose(bsum.numpy(), bsum_self.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bsum.numpy(), np.asarray(bsum_k), rtol=1e-6, atol=1e-6)
    lse = vt.combine_lse(bmax, bsum)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(logits[:, :v], -1).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(gx_combine_lse(bmax_k, bsum_k)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("r,v,tile", [(5, 3000, 512), (4, 1024, 128), (2, 130, 128)])
def test_block_stats_and_combine_lse_match_gitax(r, v, tile):
    x = (np.random.RandomState(v).randn(r, v) * 4).astype(np.float32)
    ref_pad, ref_max, ref_sum = block_stats_xla(jnp.asarray(x), tile=tile)
    pad, bmax, bsum = vt.block_stats(torch.from_numpy(x), tile)
    np.testing.assert_array_equal(pad.numpy(), np.asarray(ref_pad))
    np.testing.assert_array_equal(bmax.numpy(), np.asarray(ref_max))
    np.testing.assert_allclose(bsum.numpy(), np.asarray(ref_sum), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vt.combine_lse(bmax, bsum).numpy(),
                               np.asarray(gx_combine_lse(ref_max, ref_sum)), rtol=1e-6, atol=1e-6)
    # padded input: the statistics do not change
    again = vt.block_stats(pad, tile)
    assert torch.equal(again[0], pad) and torch.equal(again[1], bmax)


@pytest.mark.parametrize("n,k,block", [(3000, 5, 512), (3000, 8, 128), (4096, 8, 512),
                                       (1000, 5, 512), (700, 3, 128)])
@pytest.mark.parametrize("given_bmax", [False, True], ids=["own_max", "given_max"])
def test_top_k_blocked_matches_gitax_on_ties(n, k, block, given_bmax):
    """Small integers as floats: most of the top-k are ties, broken
    toward the lowest index on both sides.  With the block maxima given,
    the padded input comes with them, as the vocab-head kernel hands it."""
    x = np.random.RandomState(n + k).randint(0, 6, (6, n)).astype(np.float32)
    x[1, :] = 3.0  # a row of nothing but ties
    if given_bmax:
        xp, bmax, _ = block_stats_xla(jnp.asarray(x), tile=block)
        xp_t, bmax_t = torch.from_numpy(np.array(xp)), torch.from_numpy(np.array(bmax))
        if bmax.shape[1] < k:  # fewer blocks than k: an invalid ask on both sides
            with pytest.raises(AssertionError):
                gx_top_k_blocked(xp, k, block=block, bmax=bmax)
            with pytest.raises(ValueError, match="cannot cover"):
                _top_k_blocked(xp_t, k, block=block, bmax=bmax_t)
            return
        ref_v, ref_i = gx_top_k_blocked(xp, k, block=block, bmax=bmax)
        v, i = _top_k_blocked(xp_t, k, block=block, bmax=bmax_t)
    else:
        ref_v, ref_i = gx_top_k_blocked(jnp.asarray(x), k, block=block)
        v, i = _top_k_blocked(torch.from_numpy(x), k, block=block)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    # the plain full sort gives the same indices
    np.testing.assert_array_equal(i.numpy(), top_k_stable(torch.from_numpy(x), k)[1].numpy())


def test_top_k_blocked_rejects_bmax_of_another_shape():
    x = torch.zeros(2, 1024)
    with pytest.raises(ValueError, match="bmax"):
        _top_k_blocked(x, 4, block=512, bmax=torch.zeros(2, 3))


def test_wrapper_runs_plain_version_on_cpu_without_launching():
    args = [torch.from_numpy(a) for a in _head_inputs(3, 1100, seed=1)]
    before = vt.launches
    out = vt.vocab_logits_topk(*args)
    ref = vt.vocab_logits_topk_reference(*args)
    assert vt.launches == before
    assert out[0].shape == (3, 3 * vt.TILE) and vt.TILE == 512
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    # bf16 hidden: the products of the cast-up operands, as the plain head
    h16 = args[0].to(torch.bfloat16)
    lg16, _, _ = vt.vocab_logits_topk(h16, *args[1:])
    want = torch.matmul(h16.float(), args[1].float()) * args[2] + args[3]
    assert torch.equal(lg16[:, :1100], want)


def test_cuda_entry_raises_on_cpu_tensors():
    args = [torch.from_numpy(a) for a in _head_inputs(2, 600)]
    with pytest.raises(ValueError, match="CUDA device"):
        vt.vocab_logits_topk_cuda(*args)
