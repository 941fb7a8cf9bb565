"""The device-side search's step form (`gitax_torch/decode/device_loop.py`)
against gitax on the CPU (f32, a small config on the same weights).

The card replays one captured step under an IF node whose predicate the
last step computed; here `device_loop.run_on_host` runs that schedule on
the host (every one of the max_len - Tp launches, the body only where
the predicate holds), through `GitModel.generate`'s own plumbing (its
`_search_run` is pointed at it).  Held to gitax's jitted `generate`:

* beam search with a [CLS] prefix and a question prefix, with the fused
  vocab head's block statistics (`vocab_kernel=True`, the plain version
  of kernel 3 on the CPU), the repetition penalty, num_keep_best > 1 and
  sampling (gitax's own draws replayed through `gumbel_noise`), greedy
  and trie: tokens exact, logprobs within 1e-4;
* `decode_step` with the cache position as a 0-dim tensor equals the
  step at an int position within 1e-6, on both attention paths;
* the length-norm table is the host formula, bit for bit;
* `device_loop.run` refuses CPU tensors, and `generate` takes the eager
  loop there;
* the engine's dispatch -> resolve keeps its order and strings.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gitax.decode import BeamSearchConfig as GxBeam
from gitax.decode import build_vocab_trie as gx_build_vocab_trie
from gitax.models import GitConfig, GitModel, ViTConfig
from gitax.ops.quant import quantize_git_params as gx_quantize
from gitax.tokenization import BertTokenizer as GxTokenizer
from gitax.tokenization import build_tiny_vocab as gx_tiny_vocab
from gitax_torch import ckpt
from gitax_torch.decode import beam as pt_beam
from gitax_torch.decode import device_loop
from gitax_torch.decode.beam import BeamSearchConfig, _length_norm, length_norm_table
from gitax_torch.decode.trie import build_vocab_trie
from gitax_torch.models.git import GitModel as PortModel
from gitax_torch.models.git import eos_gate_params
from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

TOL = dict(atol=1e-4, rtol=1e-4)

# vocab 30522 so that the tiny vocabulary's ids (trie mode) fit and the
# fused head has enough 512-column blocks for its gate
CFG = GitConfig(
    encoder=ViTConfig(16, 64, 2, 2, 32),
    visual_feature_size=64,
    vocab_size=30522,
    hidden_size=48,
    num_layers=2,
    num_heads=4,
    feedforward_size=96,
    max_caption_length=48,
)
CLASSES = ["hot dog", "hot pot", "red fox", "dog"]
WORDS = ["hot", "dog", "pot", "red", "fox"]
PREFIX = np.array([[101, 7, 9], [101, 5, 5], [101, 30, 7]])
GATE = 6


@functools.lru_cache(maxsize=None)
def weights(int8=False):
    """gitax params and the port model on the same numbers, the visual
    projection x10 so that outputs depend on the image, and the EOS gate
    (`eos_gate_params`) so that searches end before their last step and
    the predicate skips the rest."""
    params = GitModel(CFG).init_params(jax.random.PRNGKey(1))
    tx = params["textual"]
    tx["visual_projection"]["linear"]["kernel"] = tx["visual_projection"]["linear"]["kernel"] * 10
    emb = tx["embedding"]
    emb["words"] = jnp.asarray(eos_gate_params(np.asarray(emb["words"]) * 3.0,
                                               np.asarray(emb["positions"]), gate=GATE))
    if int8:
        params = gx_quantize(params)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return params, ckpt.params_from_gitax(np_params, CFG, device="cpu")


def images(n=3, seed=2):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def replayed_gitax_noise(key):
    """`gumbel_noise` drawing gitax's noise: each call splits the carried
    key and draws from the subkey, as gitax's loop body does."""
    state = {"key": key}

    def noise(shape, generator):
        state["key"], sub = jax.random.split(state["key"])
        return torch.from_numpy(np.array(jax.random.gumbel(sub, tuple(shape), jnp.float32)))

    return noise


def host_schedule(launches, bodies=None):
    """A `_search_run` that runs the card's schedule on the host
    (`device_loop.run_on_host`), recording each search's launch count and
    the steps its bodies ran."""

    def search_run(self, visual, eager_loop, key):
        def run(state, step, running, result, replays, draw=None, rng=None):
            launches.append(replays)

            def counted(st, noise):
                if bodies is not None:
                    bodies.append(1)
                step(st, noise)

            return device_loop.run_on_host(state, counted, running, result, replays, draw, rng)

        return run

    return search_run


CASES = {
    "beam_cls": dict(beam=dict(num_beams=4, max_steps=16)),
    "beam_prefix": dict(beam=dict(num_beams=4, max_steps=16), prefix=True),
    "beam_vocab_stats": dict(beam=dict(num_beams=4, max_steps=16), int8=True,
                             port=dict(vocab_kernel=True)),
    "beam_penalty": dict(beam=dict(num_beams=4, max_steps=10, repetition_penalty=1.3),
                         prefix=True),
    "beam_keep_best": dict(beam=dict(num_beams=4, max_steps=10, num_keep_best=2)),
    "beam_sampled": dict(beam=dict(num_beams=4, max_steps=10, do_sample=True, temperature=0.7,
                                   top_k=50, top_p=0.9, repetition_penalty=1.2)),
    "greedy": dict(mode="greedy", max_steps=14),
    "greedy_prefix": dict(mode="greedy", max_steps=14, prefix=True),
    "trie": dict(mode="trie", max_steps=10),
}


# cases whose searches end before their last step on these weights
EARLY = {"beam_cls", "beam_prefix", "beam_vocab_stats", "greedy", "trie"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_schedule_matches_gitax(case, monkeypatch):
    c = CASES[case]
    params, model = weights(c.get("int8", False))
    x = images()
    prefix = PREFIX if c.get("prefix") else None
    mode = c.get("mode", "beam")
    gx_kw, pt_kw = dict(mode=mode), dict(mode=mode, **c.get("port", {}))
    if mode == "beam":
        gx_kw["beam"], pt_kw["beam"] = GxBeam(**c["beam"]), BeamSearchConfig(**c["beam"])
    else:
        gx_kw["max_steps"] = pt_kw["max_steps"] = c["max_steps"]
    if mode == "trie":
        gx_kw["trie"] = gx_build_vocab_trie(GxTokenizer(gx_tiny_vocab(WORDS)), CLASSES)
        pt_kw["trie"] = build_vocab_trie(BertTokenizer(build_tiny_vocab(WORDS)), CLASSES)
    sampled = mode == "beam" and c["beam"].get("do_sample")
    gm = GitModel(CFG)

    @jax.jit
    def gen(p, im, pr, rng):
        return gm.generate(p, im, pr, rng=rng, **gx_kw)

    ref_seqs, ref_lp = gen(params, jnp.asarray(x),
                           None if prefix is None else jnp.asarray(prefix, jnp.int32),
                           jax.random.PRNGKey(7))
    launches, bodies = [], []
    monkeypatch.setattr(PortModel, "_search_run", host_schedule(launches, bodies))
    if sampled:
        monkeypatch.setattr(pt_beam, "gumbel_noise", replayed_gitax_noise(jax.random.PRNGKey(7)))
        pt_kw["rng"] = torch.Generator()
    seqs, lp = model.generate(torch.from_numpy(x),
                              None if prefix is None else torch.from_numpy(prefix), **pt_kw)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(ref_seqs))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), **TOL)
    tp = 1 if prefix is None else prefix.shape[1]
    # every launch the card would get: max_len - Tp beam steps, or the steps
    # after the prefill's pick
    assert launches == [c["beam"]["max_steps"] - tp if mode == "beam"
                        else c["max_steps"] - tp - 1]
    if case in EARLY:  # the search ended early: the rest of the launches skip
        assert 0 < len(bodies) < launches[0]


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel1_plain_version"])
def test_decode_step_position_on_device_equals_int_position(kernel):
    """The cache's length as a 0-dim int32 tensor (what prefill gives now)
    against the same step at an int position: logits and caches within
    1e-6, three steps over a beam-tiled cache with an ancestry table."""
    _, model = weights()
    rng = np.random.RandomState(5)
    b, k, t_max = 3, 2, 8
    with torch.inference_mode():
        visual = model.encode_images(torch.from_numpy(images(b)))
        _, cache = model.prefill(visual, torch.from_numpy(PREFIX), t_max)
        assert torch.is_tensor(cache.length) and cache.length.dtype == torch.int32
        cache = pt_beam._tile_beams(cache, k)
        as_int = dataclasses.replace(cache, length=int(cache.length),
                                     txt_kv=[kv.clone() for kv in cache.txt_kv])
        for _ in range(3):
            anc = torch.from_numpy(rng.randint(0, k, (b * k, t_max)).astype(np.int32))
            tokens = torch.from_numpy(rng.randint(0, 30522, (b * k,)))
            cache.anc, as_int.anc = anc, anc.clone()
            lg, cache = model.decode_step(tokens, cache, kernel=kernel)
            lg_int, as_int = model.decode_step(tokens, as_int, kernel=kernel)
            np.testing.assert_allclose(lg.numpy(), lg_int.numpy(), atol=1e-6, rtol=1e-6)
            for a, b_ in zip(cache.txt_kv, as_int.txt_kv):
                np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-6, rtol=1e-6)
        assert int(cache.length) == int(as_int.length) == PREFIX.shape[1] + 3


@pytest.mark.parametrize("alpha", [0.6, 1.0, 0.0])
def test_length_norm_table_is_the_host_formula(alpha):
    table = length_norm_table(1024, alpha, torch.device("cpu"))
    want = torch.stack([_length_norm(t, alpha) for t in range(1024)])
    assert table.dtype == torch.float32 and torch.equal(table, want)


def test_device_loop_refuses_cpu_and_generate_takes_the_eager_loop(monkeypatch):
    _, model = weights()
    with pytest.raises(ValueError, match="CUDA device"):
        device_loop.run(model, "k", [torch.zeros(1)], None, None, None, 1)
    x = torch.from_numpy(images())
    assert model._search_run(x, False, "k") is None

    def refused(*a, **kw):
        raise AssertionError("the device loop ran on the CPU")

    monkeypatch.setattr(device_loop, "run", refused)
    for mode in ("beam", "greedy"):
        seqs, _ = model.generate(x, mode=mode, max_steps=6,
                                 beam=BeamSearchConfig(num_beams=2, max_steps=6))
        assert seqs.shape[0] == 3


def test_engine_dispatch_then_resolve_keeps_order_and_strings(monkeypatch):
    """Two dispatches in flight, resolved in turn, on the card's schedule:
    the strings of gitax's engine, in the order the images were given."""
    from gitax.preprocess import TestTransform
    from gitax.runtime import CaptionEngine as GxEngine
    from gitax_torch.runtime.engine import CaptionEngine

    params, model = weights()
    tok = BertTokenizer(build_tiny_vocab())
    imgs = [np.random.RandomState(i).randint(0, 255, (32, 32, 3)).astype(np.uint8)
            for i in range(5)]
    prefixes = [[tok.cls_token_id]] * len(imgs)
    kw = dict(batch_size=3, max_text_len=8)
    ref = GxEngine(GitModel(CFG), params, GxTokenizer(gx_tiny_vocab()),
                   TestTransform(crop_size=32), dtype=jnp.float32,
                   beam=GxBeam(num_beams=2, max_steps=8), use_native=False, **kw)
    want = ref.generate_batch(imgs, prefixes) + ref.generate_batch(imgs[::-1], prefixes)
    launches = []
    monkeypatch.setattr(PortModel, "_search_run", host_schedule(launches))
    ours = CaptionEngine(model, tok, dtype=torch.float32, use_native=False,
                         beam=BeamSearchConfig(num_beams=2, max_steps=8), **kw)
    first = ours.dispatch(imgs, prefixes)
    second = ours.dispatch(imgs[::-1], prefixes)
    got = ours.resolve(first) + ours.resolve(second)
    assert got == want
    # two batches of 3 a dispatch, each max_steps 9 (beam_for: 1 + 8) - Tp 1
    assert launches == [8] * 4
