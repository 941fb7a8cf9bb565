"""The port's decode attention (its plain PyTorch version, which the CPU
runs) against gitax: the Pallas kernel in interpret mode, and gitax's
decode_step on its XLA path.  The text cache must come out bit-equal,
the context within 1e-5.  (The CUDA kernel itself is compared with the
plain version on the card by chip_smoke.py.)"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gitax.decode.beam import _tile_beams as gx_tile_beams
from gitax.models import GitConfig, GitModel, ViTConfig
from gitax.ops.decode_attention import decode_attention as gx_decode_attention
from gitax.ops.decode_attention import quantize_memory as gx_quantize_memory
from gitax_torch import ckpt
from gitax_torch.decode.beam import _tile_beams
from gitax_torch.ops import decode_attention as pda
from gitax_torch.ops.decode_attention import decode_attention, decode_attention_reference


def _inputs(B, K, seed, H=2, Dh=64, M=17, T=9):
    rng = np.random.RandomState(seed)
    BK = B * K
    r = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)  # noqa: E731
    return dict(
        q=r(BK, H, Dh), kn=r(BK, H, Dh), vn=r(BK, H, Dh), kv=r(T, BK, H * 2 * Dh),
        anc=rng.randint(0, K, (BK, T)).astype(np.int32), mem_k=r(B, H, M, Dh),
        mem_v=r(B, H, M, Dh), mem_bias=rng.randn(B, M).astype(np.float32),
        B=B, K=K, H=H, Dh=Dh, M=M, T=T,
    )


def _compare(i, pos, mem_int8, with_bias=True):
    B, K, H, Dh = i["B"], i["K"], i["H"], i["Dh"]
    BK = B * K
    mem_kv = np.concatenate([i["mem_k"], i["mem_v"]], -1)
    bias = i["mem_bias"] if with_bias else np.zeros_like(i["mem_bias"])
    mem_scale = None
    if mem_int8:
        q8, sc = gx_quantize_memory(jnp.asarray(mem_kv))
        mem_kv, mem_scale = np.array(q8), np.array(sc)
    qz = np.concatenate([i["q"], np.zeros_like(i["q"])], -1).reshape(BK, H * 2 * Dh)
    kvn = np.concatenate([i["kn"], i["vn"]], -1).reshape(BK, H * 2 * Dh)
    ctx128, kv_ref = gx_decode_attention(
        jnp.asarray(qz), jnp.asarray(kvn), jnp.asarray(i["kv"]), jnp.asarray(i["anc"]),
        pos, jnp.asarray(mem_kv), jnp.asarray(bias),
        None if mem_scale is None else jnp.asarray(mem_scale),
        beams=K, num_heads=H, head_dim=Dh, interpret=True,
    )
    ctx_ref = np.asarray(ctx128).reshape(BK, H, 2 * Dh)[..., Dh:].reshape(BK, H * Dh)

    txt_kv = torch.from_numpy(i["kv"].copy())
    ctx = decode_attention(
        torch.from_numpy(i["q"].reshape(BK, H * Dh)), torch.from_numpy(kvn), txt_kv,
        torch.from_numpy(i["anc"]), pos, torch.from_numpy(mem_kv),
        torch.from_numpy(i["mem_bias"]) if with_bias else None,
        None if mem_scale is None else torch.from_numpy(mem_scale),
        beams=K, num_heads=H, head_dim=Dh,
    )
    np.testing.assert_array_equal(txt_kv.numpy(), np.asarray(kv_ref))
    np.testing.assert_allclose(ctx.numpy(), ctx_ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mem_int8", [False, True], ids=["f32_mem", "int8_mem"])
@pytest.mark.parametrize("B,K", [(4, 4), (4, 2), (8, 1), (2, 8)])
def test_plain_matches_pallas_interpret(B, K, mem_int8):
    _compare(_inputs(B, K, seed=B * 10 + K), pos=5, mem_int8=mem_int8)


@pytest.mark.parametrize("pos", [0, 8])
def test_plain_matches_pallas_interpret_edge_positions(pos):
    _compare(_inputs(4, 4, seed=pos + 1), pos=pos, mem_int8=False)


def test_plain_matches_pallas_interpret_without_bias():
    _compare(_inputs(4, 4, seed=3), pos=4, mem_int8=False, with_bias=False)


def test_reference_keeps_bf16_numerics():
    """bf16 inputs: scores and contexts accumulate in f32, probabilities
    round to bf16, the context is cast once; held against the same
    computation written out by hand in f32."""
    i = _inputs(2, 4, seed=9)
    B, K, H, Dh, M, T = i["B"], i["K"], i["H"], i["Dh"], i["M"], i["T"]
    BK, pos = B * K, 6
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    q, kvn = bf(i["q"].reshape(BK, H * Dh)), bf(np.concatenate([i["kn"], i["vn"]], -1).reshape(BK, -1))
    txt = bf(i["kv"])
    mem = bf(np.concatenate([i["mem_k"], i["mem_v"]], -1))
    anc = torch.from_numpy(i["anc"])
    ctx = decode_attention_reference(q, kvn, txt.clone(), anc, pos, mem,
                                     beams=K, num_heads=H, head_dim=Dh)
    assert ctx.dtype == torch.bfloat16
    txt2 = txt.clone()
    txt2[pos] = kvn
    out = torch.empty(BK, H, Dh)
    for r in range(BK):
        b, k = divmod(r, K)
        for h in range(H):
            qv = q[r, h * Dh:(h + 1) * Dh].float()
            keys = [mem[b, h, m, :Dh].float() for m in range(M)]
            vals = [mem[b, h, m, Dh:].float() for m in range(M)]
            for t in range(pos + 1):
                row = txt2[t, b * K + int(anc[r, t]), h * 2 * Dh:(h + 1) * 2 * Dh].float()
                keys.append(row[:Dh])
                vals.append(row[Dh:])
            s = torch.stack([qv @ kk for kk in keys])
            e = torch.exp(s - s.max())
            p = (e / e.sum()).to(torch.bfloat16).float()
            out[r, h] = sum(pj * vj for pj, vj in zip(p, vals))
    np.testing.assert_allclose(ctx.float().numpy(), out.to(torch.bfloat16).float()
                               .reshape(BK, H * Dh).numpy(), atol=1e-2, rtol=1e-2)


# ---------------------------------------------------------------------------
# the port's decode_step (both paths) against gitax's decode_step(kernel=False)
# ---------------------------------------------------------------------------

CFG = GitConfig(
    encoder=ViTConfig(16, 32, 1, 2, 32),
    visual_feature_size=32,
    vocab_size=64,
    hidden_size=32,
    num_layers=2,
    num_heads=2,
    feedforward_size=64,
    max_caption_length=32,
)


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel_path", "plain_path"])
@pytest.mark.parametrize("B,K", [(4, 4), (2, 8), (8, 1)])
def test_decode_step_matches_gitax_xla_path(B, K, kernel):
    gx = GitModel(CFG)
    params = gx.init_params(jax.random.PRNGKey(B + K))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    port = ckpt.params_from_gitax(tree, CFG, device="cpu")
    rng = np.random.RandomState(B * K)
    feats = rng.randn(B, 5, 32).astype(np.float32)
    prefix = np.full((B, 1), 1, np.int64)
    t_max = 8

    lg, cache = gx.prefill(params, jnp.asarray(feats), jnp.asarray(prefix, jnp.int32), t_max)
    cache = gx_tile_beams(cache, K)
    with torch.inference_mode():
        lp, pcache = port.prefill(torch.from_numpy(feats), torch.from_numpy(prefix), t_max)
        pcache = _tile_beams(pcache, K)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lg), atol=1e-4, rtol=1e-4)
    for step in range(4):
        anc = rng.randint(0, K, (B * K, t_max)).astype(np.int32)
        tokens = rng.randint(0, 64, (B * K,))
        cache = cache._replace(anc=jnp.asarray(anc))
        lg, cache = gx.decode_step(params, jnp.asarray(tokens, jnp.int32), cache)
        with torch.inference_mode():
            pcache.anc = torch.from_numpy(anc)
            lp, pcache = port.decode_step(torch.from_numpy(tokens), pcache, kernel=kernel)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lg), atol=1e-4, rtol=1e-4)
        for a, b in zip(pcache.txt_kv, cache.txt_kv):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    assert pcache.length == int(cache.length)


@pytest.mark.parametrize("K", [1, 3])
def test_decode_step_kernel_flag_without_ancestry_runs_kernel_path(K, monkeypatch):
    """kernel=True on a cache with no ancestry table (a plain prefill, or
    beams tiled and the table dropped) still goes through the kernel
    wrapper, with each row reading its own slots: the same logits and
    cache as the plain path, and as gitax's decode_step for one beam."""
    import gitax_torch.models.textual as textual

    B, t_max = 2, 6
    gx = GitModel(CFG)
    params = gx.init_params(jax.random.PRNGKey(7))
    port = ckpt.params_from_gitax(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                                         params), CFG, device="cpu")
    rng = np.random.RandomState(K)
    feats = rng.randn(B, 5, 32).astype(np.float32)
    prefix = np.full((B, 1), 1, np.int64)
    calls = []

    def spy(*a, **kw):
        calls.append(kw["beams"])
        assert a[3].shape == (B * K, t_max) and a[3].dtype == torch.int32
        return decode_attention(*a, **kw)

    monkeypatch.setattr(textual, "decode_attention", spy)
    with torch.inference_mode():
        caches = {}
        for kernel in (True, False):
            _, c = port.prefill(torch.from_numpy(feats), torch.from_numpy(prefix), t_max)
            c = _tile_beams(c, K)
            c.anc = None
            caches[kernel] = c
        gcache = gx.prefill(params, jnp.asarray(feats), jnp.asarray(prefix, jnp.int32), t_max)[1]
        for step in range(3):
            tokens = rng.randint(0, 64, (B * K,))
            lk, caches[True] = port.decode_step(torch.from_numpy(tokens), caches[True], kernel=True)
            lp, caches[False] = port.decode_step(torch.from_numpy(tokens), caches[False])
            np.testing.assert_allclose(lk.numpy(), lp.numpy(), atol=1e-5, rtol=1e-5)
            if K == 1:
                lg, gcache = gx.decode_step(params, jnp.asarray(tokens, jnp.int32), gcache)
                np.testing.assert_allclose(lk.numpy(), np.asarray(lg), atol=1e-4, rtol=1e-4)
    for a, b in zip(caches[True].txt_kv, caches[False].txt_kv):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)
    assert calls == [K] * (3 * CFG.num_layers)


# ---------------------------------------------------------------------------
# the CUDA kernel's launch plan: one cluster of CTAs per (batch, head)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mem_bytes", [2, 4, 1], ids=["bf16", "f32", "int8"])
@pytest.mark.parametrize("m", [1, 257, 901, 1201, 1542])
def test_cluster_plan_owns_every_memory_row_once(m, mem_bytes):
    c, chunk, smem = pda.cluster_plan(m, 4, 64, 41, mem_bytes)
    assert 1 <= c <= 8
    # the rows the kernel's CTA r takes: m0 = min(M, r * chunk), up to
    # min(M, m0 + chunk)
    bounds = []
    for r in range(c):
        m0 = min(m, r * chunk)
        bounds.append((m0, min(m, m0 + chunk)))
    owned = [i for lo, hi in bounds for i in range(lo, hi)]
    assert owned == list(range(m))  # every row once, in rank order
    assert all(hi > lo for lo, hi in bounds)  # no idle CTA
    assert smem <= pda._MAX_SMEM
    assert smem == pda.smem_bytes(4, 64, chunk, 41, mem_bytes, c)


def test_cluster_plan_sizes_at_the_paths_memory():
    # the smallest cluster whose CTAs fit three to an SM: COCO's 257 rows
    # on one CTA, the VQA grid's 1201 on 5, the video's 1542 on 7 (6 would
    # need 77400 bytes a CTA, past the third of an SM)
    want = {257: (1, 257), 1201: (5, 241), 1542: (7, 221)}
    for m, (c, chunk) in want.items():
        plan = pda.cluster_plan(m, 4, 64, 41, 2)
        assert plan[:2] == (c, chunk)
        assert 3 * (plan[2] + 1024) <= 233472
    assert pda.smem_bytes(4, 64, 257, 41, 2, 6) > pda._THIRD_OF_SM
    # f32 memory takes more CTAs for the same rows; past 8 CTAs' worth the
    # cluster stays at 8 and the chunk grows
    assert pda.cluster_plan(1542, 4, 64, 41, 4)[0] == 8
    assert pda.cluster_plan(4096, 4, 64, 41, 2)[0] == 8


def test_smem_formula_counts_every_region():
    # k|v rows (padded to 16 bytes, and at least the warps' partial
    # contexts [8, K, Dh] f32 that take their place), 1 mbarrier per 32
    # rows, then f32 q, scores [K, chunk + slots], int32 rows [K, slots],
    # max and sum, the C CTAs' contexts; slots = ceil(T / C) text slots
    k, dh, chunk, t, c = 4, 64, 193, 41, 8
    slots = 6
    tail = 4 * (k * dh + k * (chunk + slots) + k * slots + 2 * k + c * k * dh)
    assert pda.smem_bytes(k, dh, chunk, t, 2, c) == 193 * 128 * 2 + 8 * 7 + tail
    # int8 rows: 128 bytes each, no padding
    assert pda.smem_bytes(k, dh, chunk, t, 1, c) == 193 * 128 + 8 * 7 + tail
    # one row, one CTA: the partial contexts set the size, all T slots
    assert pda.smem_bytes(k, dh, 1, t, 2, 1) == 8 * k * dh * 4 + 8 + 4 * (
        k * dh + k * (1 + t) + k * t + 2 * k + k * dh)
