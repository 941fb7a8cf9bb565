"""The fused vocab-head module (gitax_torch/ops/vocab_topk.py) and the
blocked top-k against gitax (CPU, f32): the plain version against gitax's
Pallas kernel in interpret mode, as gitax's own tests run it; the block
statistics and the two-level logsumexp against gitax's; the blocked
top-k's indices on inputs full of ties; the wrapper's CPU routing; and what
the bf16 kernel's design computes in Python: the TMA tensor maps, the
swizzled shared-memory offsets its loads use, and the launch plan."""

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
                                       (1000, 5, 512), (700, 3, 128),
                                       # the beam step's: top-2K of the GIT vocab; and as
                                       # many blocks as the prefilter needs, no more
                                       (30522, 8, 512), (2048, 4, 512)])
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


def _vocab_major(v, w):
    """An int8 [W, V] view of a row-major [V, W] table, as Linear.set_int8
    stores the head."""
    return torch.zeros((v, w), dtype=torch.int8).t()


@pytest.mark.parametrize("w", [768, 1024])
@pytest.mark.parametrize("v", [30522, 1100])
def test_weight_map_parameters(v, w):
    """The int8 matrix as stored: W bytes contiguous per vocab column, V
    columns W bytes apart, boxes of 64 bytes of W x 256 columns."""
    m = vt.weight_map(_vocab_major(v, w))
    assert m == dict(dims=(w, v), strides=(w,), box=(64, 256))
    assert m["box"] == (vt.K_CHUNK, vt.CTA_COLS) and m["strides"][0] % 16 == 0
    # a box is one ring stage's tile; the last box of a ragged vocab reaches
    # past V, where TMA fills zeros
    plan = vt.tile_plan(128, w, v)
    assert plan["grid"][0] * m["box"][1] >= v > (plan["blocks"] - 1) * vt.TILE
    assert plan["chunks"] * m["box"][0] == w


@pytest.mark.parametrize("w", [768, 1024])
@pytest.mark.parametrize("r", [1, 128, 200])
def test_hidden_map_parameters(r, w):
    """hidden [R, W] bf16: W values contiguous, rows 2W bytes apart, boxes
    of 64 values (one 128-byte swizzle row) x 128 rows."""
    m = vt.hidden_map(torch.zeros((r, w), dtype=torch.bfloat16))
    assert m == dict(dims=(w, r), strides=(2 * w,), box=(64, 128))
    assert m["box"] == (vt.K_CHUNK, vt.ROWS) and 2 * m["box"][0] == 128
    assert vt.tile_plan(r, w, 30522)["row_groups"] * m["box"][1] >= r


def test_maps_reject_what_tma_cannot_take():
    with pytest.raises(ValueError, match="vocab-major"):
        vt.weight_map(torch.zeros((768, 1100), dtype=torch.int8))  # row-major [W, V]
    with pytest.raises(ValueError, match="multiple of 16"):
        vt.weight_map(_vocab_major(1100, 24))
    with pytest.raises(ValueError, match="contiguous bf16"):
        vt.hidden_map(torch.zeros((4, 1536), dtype=torch.bfloat16)[:, ::2])
    with pytest.raises(ValueError, match="contiguous bf16"):
        vt.hidden_map(torch.zeros((4, 768), dtype=torch.float32))
    with pytest.raises(ValueError, match="16-byte"):
        vt.hidden_map(torch.zeros(4 * 768 + 4, dtype=torch.bfloat16)[4:].view(4, 768))


@pytest.mark.parametrize("r,w,v,ctas", [(128, 768, 30522, 120), (128, 1024, 30522, 120),
                                        (1, 768, 1100, 6), (200, 768, 30522, 240),
                                        (3, 1024, 512, 2), (128, 768, 513, 4)])
def test_tile_plan(r, w, v, ctas):
    """A cluster of 2 CTAs per 512-column block and 128-row group; the ring
    keeps 64 KB or more of weight loads in flight within the 227 KB of
    shared memory a block may take."""
    p = vt.tile_plan(r, w, v)
    nb = -(-v // vt.TILE)
    assert p["blocks"] == nb and p["cluster"] == 2 and p["ctas"] == ctas
    assert p["grid"] == (2 * nb, -(-r // 128)) and p["grid"][0] % p["cluster"] == 0
    assert p["chunks"] == w // 64 and p["stages"] >= 4
    assert p["loads_in_flight"] >= 64 * 1024
    assert p["smem_bytes"] <= 232448
    assert p["smem_bytes"] == 1024 + p["stages"] * 2 * 16384 + 4 * 128 * 4 + 16 * p["stages"]
    # the staged logits [128, 256 + 4] f32 reuse the ring
    assert 4 * 128 * 260 <= p["stages"] * 2 * 16384


def test_tile_plan_fills_the_card_at_the_beam_step():
    """One wave over at least 90% of the H100's 132 SMs."""
    p = vt.tile_plan(128, 768, 30522)
    assert 0.9 * 132 <= p["ctas"] <= 132


@pytest.mark.parametrize("r,v", [(128, 30522), (200, 1100), (1, 513), (3, 512)])
def test_every_logit_and_statistic_has_one_writer(r, v):
    p = vt.tile_plan(r, 768, v)
    nb = p["blocks"]
    written = np.zeros((p["row_groups"] * vt.ROWS, nb * vt.TILE), dtype=np.int32)
    for bx in range(p["grid"][0]):
        for by in range(p["grid"][1]):
            r0, c0 = vt.cta_tile(bx, by)
            written[r0:r0 + vt.ROWS, c0:c0 + vt.CTA_COLS] += 1
    assert (written == 1).all() and written.shape[0] >= r
    writers = {}
    for row in range(r):
        for block in range(nb):
            bx, by, thread = vt.stats_writer(row, block)
            # rank 0 of the block's cluster, in the grid, one of its threads
            assert bx % p["cluster"] == 0 and bx // p["cluster"] == block
            assert 0 <= bx < p["grid"][0] and 0 <= by < p["grid"][1]
            assert 0 <= thread < p["threads"]
            r0, c0 = vt.cta_tile(bx, by)
            assert r0 <= row < r0 + vt.ROWS and c0 == block * vt.TILE
            writers.setdefault((bx, by, thread), []).append((row, block))
    assert all(len(owned) == 1 for owned in writers.values())
    assert len(writers) == r * nb


def test_weight_smem_offset_is_the_64_byte_swizzle():
    """A bijection on the stage's 16 KB that keeps each column's 64 bytes
    together and each 16-byte piece whole, moved by (column / 2) % 4."""
    offs = np.array([[vt.weight_smem_offset(c, k) for k in range(64)] for c in range(256)])
    assert sorted(offs.ravel().tolist()) == list(range(256 * 64))
    assert (offs // 64 == np.arange(256)[:, None]).all()
    assert (offs % 16 == np.arange(64)[None, :] % 16).all()
    piece = (offs % 64) // 16
    want = (np.arange(64)[None, :] // 16) ^ ((np.arange(256)[:, None] // 2) % 4)
    np.testing.assert_array_equal(piece, want)


@pytest.mark.parametrize("ks", [0, 1, 2, 3])
def test_a_fragment_loads_are_right_and_conflict_free(ks):
    """The kernel's reads as a warp makes them: lane (g, t) loads the words
    at k = 16 ks + 4 (t / 2) and 8 bytes on of column g (and g + 8), and
    keeps bytes 2 (t % 2), +1 of each: wgmma's A fragment k = 2t, 2t+1,
    2t+8, 2t+9.  The 32 lanes' words fall on 32 banks, or coincide."""
    rng = np.random.RandomState(ks)
    tile = rng.randint(-128, 128, (256, 64)).astype(np.int8)
    smem = np.zeros(256 * 64, dtype=np.int8)
    for c in range(256):
        for k in range(64):
            smem[vt.weight_smem_offset(c, k)] = tile[c, k]
    for col_base in (0, 8, 64, 128 + 16 * 3):
        for second in (0, 8):
            banks = {}
            for lane in range(32):
                g, t = lane // 4, lane % 4
                col = col_base + g
                at = col * 64 + 16 * (ks ^ ((g // 2) % 4)) + 4 * (t // 2) + second
                assert at == vt.weight_smem_offset(col, 16 * ks + 4 * (t // 2) + second)
                banks.setdefault((at // 4) % 32, set()).add(at)
                lo = 2 * (t % 2)
                got = smem[at + lo:at + lo + 2]
                k0 = 16 * ks + second + 2 * t
                np.testing.assert_array_equal(got, tile[col, k0:k0 + 2])
            assert all(len(words) == 1 for words in banks.values())


def test_int8_widening_through_the_mantissa_is_exact():
    """The kernel's int8 -> bf16: the byte with its sign bit flipped in the
    low mantissa of 2^23, less 2^23 + 128, is the signed value as an f32
    whose low 16 bits are zero, so its high half is its bf16."""
    q = np.arange(-128, 128, dtype=np.int8)
    u = q.view(np.uint8) ^ np.uint8(0x80)
    f = (np.uint32(0x4B000000) | u.astype(np.uint32)).view(np.float32) - np.float32(8388736.0)
    np.testing.assert_array_equal(f, q.astype(np.float32))
    assert (f.view(np.uint32) & 0xFFFF == 0).all()
    bf16 = torch.from_numpy(q.astype(np.float32)).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal((f.view(np.uint32) >> 16).astype(np.uint16).view(np.int16), bf16)


def test_timeline_tool_still_fits_the_kernel_source():
    """tools/vocab_topk_timeline.py stamps a copy of the kernel by text
    substitution; every piece of text it looks for is in the source once,
    so the stamped kernel and its three ablations can be made."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tools", "vocab_topk_timeline.py")
    spec = importlib.util.spec_from_file_location("vocab_topk_timeline", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    made = tool.variants()
    assert sorted(made) == ["kernel", "noconv", "nolds", "nomma"]
    assert all(text.count("stamp(") == 12 for text in made.values())  # 11 stamps and the helper
    assert "wgmma_rs(acc[mt], a[mt], db);" not in made["nomma"]
    assert "lds32(at)" not in made["nolds"] and "widen4(x[mt][i]" not in made["noconv"]
