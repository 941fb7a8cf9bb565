"""Sampling, the repetition penalty and num_return_sequences of the port
against gitax (CPU, f32, a small config on the same weights).

* `top_k_top_p_filter` equals gitax's exactly, ties included.
* The repetition penalty in plain beam search: tokens exact, logprobs
  within 1e-4.
* The sampled search: RNG streams cannot match jax.random, so the port's
  `decode.beam.gumbel_noise` is replaced by a replay of gitax's own draws
  (the `split` and `gumbel` calls of gitax's loop body, beam.py:325-326,
  in the same order, computed eagerly with JAX); the tokens are then
  gitax's exactly and the logprobs within 1e-4.
* `num_return_sequences` in beam, greedy and trie: gitax's shapes and rows.
* The guards: sampling without a generator, `vocab_stats` with sampling or
  a penalty, and `vocab_kernel_applies` under both."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gitax.decode import BeamSearchConfig as GxBeam
from gitax.decode import build_vocab_trie as gx_build_vocab_trie
from gitax.decode.beam import beam_search as gx_beam_search
from gitax.decode.beam import top_k_top_p_filter as gx_filter
from gitax.models.textual import KVCache as GxKVCache
from gitax.models import GitConfig, GitModel, ViTConfig
from gitax.tokenization import BertTokenizer as GxTokenizer
from gitax.tokenization import build_tiny_vocab as gx_tiny_vocab
from gitax_torch import ckpt
from gitax_torch.decode import beam as pt_beam
from gitax_torch.decode.beam import BeamSearchConfig, beam_search, top_k_top_p_filter
from gitax_torch.decode.trie import build_vocab_trie
from gitax_torch.models.textual import KVCache
from gitax_torch.ops.quant import quantize_git_model_
from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

TOL = dict(atol=1e-4, rtol=1e-4)

CFG = GitConfig(
    encoder=ViTConfig(16, 32, 2, 2, 32),
    visual_feature_size=32,
    vocab_size=64,
    hidden_size=32,
    num_layers=2,
    num_heads=2,
    feedforward_size=64,
    max_caption_length=32,
)
# the tiny vocabulary's config for trie mode (its ids reach 30521)
TRIE_CFG = GitConfig(
    encoder=ViTConfig(16, 32, 2, 2, 32),
    visual_feature_size=32,
    vocab_size=30522,
    hidden_size=32,
    num_layers=2,
    num_heads=2,
    feedforward_size=64,
    max_caption_length=32,
)
CLASSES = ["hot dog", "hot pot", "red fox", "dog"]
WORDS = ["hot", "dog", "pot", "red", "fox"]


@functools.lru_cache(maxsize=None)
def weights(cfg=CFG, seed=0):
    """gitax params and the port model on the same numbers, the visual
    projection x10 so that outputs depend on the image.  No EOS gate:
    sampled outputs then end at varied lengths."""
    params = GitModel(cfg).init_params(jax.random.PRNGKey(seed))
    tx = params["textual"]
    tx["visual_projection"]["linear"]["kernel"] = tx["visual_projection"]["linear"]["kernel"] * 10
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return params, ckpt.params_from_gitax(np_params, cfg, device="cpu")


def images(n=3, seed=0):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def replayed_gitax_noise(key):
    """A stand-in for `gumbel_noise` that draws gitax's noise: each call
    splits the carried key and draws `jax.random.gumbel` from the subkey,
    as each iteration of gitax's loop body does."""
    state = {"key": key}

    def noise(shape, generator):
        assert isinstance(generator, torch.Generator)
        state["key"], sub = jax.random.split(state["key"])
        return torch.from_numpy(np.array(jax.random.gumbel(sub, tuple(shape), jnp.float32)))

    return noise


def gitax_generate(cfg, params, imgs, prefix, beam, **kw):
    gm = GitModel(cfg)

    @jax.jit
    def gen(p, im, pr, rng):
        return gm.generate(p, im, pr, beam=beam, sos_id=1, rng=rng, **kw)

    pref = None if prefix is None else jnp.asarray(prefix, jnp.int32)
    seqs, lp = gen(params, jnp.asarray(imgs), pref, jax.random.PRNGKey(7))
    return np.asarray(seqs), np.asarray(lp)


# ---------------------------------------------------------------------------
# the filter
# ---------------------------------------------------------------------------


def filter_inputs():
    """Rows of logits from a few levels, so ties abound (several columns
    share the k-th value and the last kept value), and the cumulative
    softmax of each sorted row stays more than 1e-6 from every top_p
    tested: XLA and torch may round a cumsum differently, and only inputs
    away from the boundary can be held to an exact comparison."""
    rng = np.random.RandomState(3)
    levels = np.array([2.0, 1.0, 0.5, 0.0, -1.0, -3.0], np.float32)
    x = levels[rng.randint(0, len(levels), (6, 40))]
    x[0, :] = 0.0  # one row all tied
    x[1, 5] = 9.0  # one row with one dominant column
    return x


@pytest.mark.parametrize("top_k,top_p,min_keep", [
    (0, None, 1), (5, None, 1), (40, None, 1), (3, None, 4), (0, 0.51, 1), (0, 0.91, 1),
    (0, 0.33, 3), (7, 0.81, 2), (0, 1.0, 1)])
def test_filter_matches_gitax_exactly(top_k, top_p, min_keep):
    x = filter_inputs()
    if top_p is not None and top_p < 1.0:
        srt = -np.sort(-x, axis=-1)
        cum = np.cumsum(np.exp(srt - srt[:, :1]) / np.exp(srt - srt[:, :1]).sum(-1, keepdims=True),
                        axis=-1)
        assert np.abs(cum - top_p).min() > 1e-6, "inputs too close to the top_p boundary"
    want = np.asarray(gx_filter(jnp.asarray(x), top_k, top_p, min_tokens_to_keep=min_keep))
    got = top_k_top_p_filter(torch.from_numpy(x), top_k, top_p, min_tokens_to_keep=min_keep)
    np.testing.assert_array_equal(got.numpy(), want)


def test_filter_top_p_is_positional_on_ties():
    """Tokens tied with the last kept logit are removed (by rank), not
    kept by a value threshold."""
    x = torch.tensor([[3.0, 1.0, 1.0, 1.0, -2.0]])
    got = top_k_top_p_filter(x, top_p=0.75)  # cumulative 0.708, 0.804, ...
    assert torch.isfinite(got).tolist() == [[True, True, False, False, False]]


# ---------------------------------------------------------------------------
# the repetition penalty and the sampled search against gitax
# ---------------------------------------------------------------------------


def bigram_search(framework, table, prefix, kw):
    """Beam search over a bigram model: each step's logits are the table's
    row of the token just fed (the cache only carries the shapes the
    search reads), so the penalty's effect is not drowned by the random
    decoder's one dominant token."""
    b, tp = prefix.shape
    t_max = kw["max_steps"]
    if framework == "gitax":
        tab = jnp.asarray(table)
        cache = GxKVCache(mem_k=(), mem_v=(), txt_kv=(jnp.zeros((t_max, b, 2)),),
                          memory_valid=None, length=jnp.int32(tp))
        seqs, lp = jax.jit(lambda lg, pr: gx_beam_search(
            lambda tok, c: (tab[tok], c), lg, cache, pr, GxBeam(**kw)))(
                tab[prefix[:, -1]], jnp.asarray(prefix, jnp.int32))
        return np.asarray(seqs), np.asarray(lp)
    tab = torch.from_numpy(table)
    cache = KVCache(mem_kv=[torch.zeros(b, 1, 1, 2)], txt_kv=[torch.zeros(t_max, b, 2)],
                    length=tp)
    pref = torch.from_numpy(prefix).long()
    seqs, lp = beam_search(lambda tok, c: (tab[tok], c), tab[pref[:, -1]], cache, pref,
                           BeamSearchConfig(**kw))
    return seqs.numpy(), lp.numpy()


@pytest.mark.parametrize("with_prefix", [False, True], ids=["caption", "prefix"])
@pytest.mark.parametrize("penalty", [1.2, 0.8])
def test_repetition_penalty_matches_gitax(penalty, with_prefix):
    """Plain beam search with the penalty, on a bigram model with N(0, 1)
    logits over 64 words: gitax's tokens, logprobs within 1e-4."""
    table = np.random.RandomState(4).randn(64, 64).astype(np.float32)
    prefix = np.array([[1, 7, 9], [1, 5, 5], [1, 30, 7]]) if with_prefix else np.ones((3, 1), int)
    kw = dict(num_beams=4, max_steps=12, eos_id=2, num_keep_best=2, repetition_penalty=penalty)
    ref_seqs, ref_lp = bigram_search("gitax", table, prefix, kw)
    base_seqs, _ = bigram_search("gitax", table, prefix, dict(kw, repetition_penalty=1.0))
    assert not np.array_equal(ref_seqs, base_seqs), "the penalty changed nothing"
    seqs, lp = bigram_search("port", table, prefix, kw)
    np.testing.assert_array_equal(seqs, ref_seqs)
    np.testing.assert_allclose(lp, ref_lp, **TOL)


@pytest.mark.parametrize("beams,temperature,top_k,top_p,penalty", [
    (1, 1.0, 0, None, 1.0), (4, 0.7, 0, None, 1.0), (4, 0.7, 10, 0.9, 1.0),
    (1, 1.3, 5, 0.8, 1.0), (4, 1.5, 0, 0.95, 1.2)])
def test_sampled_search_matches_gitax_with_replayed_noise(beams, temperature, top_k, top_p,
                                                          penalty, monkeypatch):
    params, model = weights()
    kw = dict(num_beams=beams, max_steps=12, eos_id=2, do_sample=True, temperature=temperature,
              top_k=top_k, top_p=top_p, repetition_penalty=penalty)
    ref_seqs, ref_lp = gitax_generate(CFG, params, images(4, seed=2), None, GxBeam(**kw))
    assert len({tuple(r) for r in ref_seqs.tolist()}) > 1
    monkeypatch.setattr(pt_beam, "gumbel_noise", replayed_gitax_noise(jax.random.PRNGKey(7)))
    seqs, lp = model.generate(torch.from_numpy(images(4, seed=2)), beam=BeamSearchConfig(**kw),
                              sos_id=1, rng=torch.Generator(), decode_kernel=True)
    np.testing.assert_array_equal(seqs.numpy(), ref_seqs)
    np.testing.assert_allclose(lp.numpy(), ref_lp, **TOL)


def test_generator_seeds_the_draws():
    """With the port's own noise: one seed, one output; another seed,
    another set."""
    _, model = weights()
    beam = BeamSearchConfig(num_beams=2, max_steps=12, eos_id=2, do_sample=True, temperature=1.5)
    x = torch.from_numpy(images(4, seed=2))

    def run(seed):
        return model.generate(x, beam=beam, sos_id=1, num_return_sequences=3,
                              rng=torch.Generator().manual_seed(seed))[0]

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)


# ---------------------------------------------------------------------------
# num_return_sequences
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["beam", "beam_sampled", "greedy", "trie"])
def test_num_return_sequences_matches_gitax(mode, monkeypatch):
    cfg = TRIE_CFG if mode == "trie" else CFG
    params, model = weights(cfg)
    gx_trie = pt_trie = None
    kw = dict(mode="beam" if mode.startswith("beam") else mode)
    beam = None
    if mode.startswith("beam"):
        sampled = mode == "beam_sampled"
        beam_kw = dict(num_beams=2, max_steps=10, eos_id=2, do_sample=sampled)
        beam = BeamSearchConfig(**beam_kw)
        kw["beam"] = GxBeam(**beam_kw)
        if sampled:
            monkeypatch.setattr(pt_beam, "gumbel_noise",
                                replayed_gitax_noise(jax.random.PRNGKey(7)))
    else:
        kw["max_steps"] = 8
    if mode == "trie":
        gx_trie = gx_build_vocab_trie(GxTokenizer(gx_tiny_vocab(WORDS)), CLASSES)
        pt_trie = build_vocab_trie(BertTokenizer(build_tiny_vocab(WORDS)), CLASSES)
    gm = GitModel(cfg)
    gx_kw = dict(kw, beam=kw.get("beam"), trie=gx_trie)

    @jax.jit
    def gen(p, im, rng):
        return gm.generate(p, im, None, sos_id=1, num_return_sequences=3, rng=rng, **gx_kw)

    want_seqs, want_lp = gen(params, jnp.asarray(images(2)), jax.random.PRNGKey(7))
    pt_kw = dict(kw, beam=beam, trie=pt_trie)
    seqs, lp = model.generate(torch.from_numpy(images(2)), sos_id=1, num_return_sequences=3,
                              rng=torch.Generator(), **pt_kw)
    assert seqs.shape == np.asarray(want_seqs).shape and seqs.shape[0] == 6
    assert lp.shape == np.asarray(want_lp).shape == (6,)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), **TOL)
    if mode != "beam_sampled":  # deterministic modes repeat each input's row
        assert torch.equal(seqs[0], seqs[1]) and torch.equal(seqs[3], seqs[5])


# ---------------------------------------------------------------------------
# guards and gates
# ---------------------------------------------------------------------------


def test_sampling_without_a_generator_raises():
    _, model = weights()
    with pytest.raises(ValueError, match="torch.Generator"):
        model.generate(torch.from_numpy(images(1)), sos_id=1, beam=BeamSearchConfig(
            num_beams=2, max_steps=6, eos_id=2, do_sample=True))


@pytest.mark.parametrize("cfg", [dict(do_sample=True), dict(repetition_penalty=1.2)],
                         ids=["sampling", "penalty"])
def test_vocab_stats_with_sampling_or_penalty_raises(cfg):
    beam = BeamSearchConfig(num_beams=2, max_steps=6, **cfg)

    def step(tokens, cache):
        raise AssertionError("not reached")

    with pytest.raises(ValueError, match="vocab_stats"):
        beam_search(step, torch.zeros(1, 1024), None, torch.ones(1, 1, dtype=torch.long), beam,
                    rng=torch.Generator(), vocab_stats=True)


@pytest.mark.parametrize("cfg,applies", [
    (dict(), True), (dict(do_sample=True), False), (dict(repetition_penalty=1.2), False),
    (dict(repetition_penalty=0.8), False)])
def test_vocab_kernel_applies_has_gitax_gates(cfg, applies):
    _, model = weights(TRIE_CFG)
    import copy

    model = quantize_git_model_(copy.deepcopy(model))
    assert model.vocab_kernel_applies(BeamSearchConfig(num_beams=4, **cfg)) is applies
