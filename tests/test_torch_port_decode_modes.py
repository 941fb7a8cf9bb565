"""Greedy and trie-constrained greedy decoding of the port against gitax
(CPU, f32, gitax tests/test_pipeline.py's TINY config on the same
weights): identical tokens and log-probabilities within 1e-4 through
`generate(mode='greedy' | 'trie')`, at max_steps 8 and 40, with and
without a question prefix; the trie over class names with shared
prefixes and a one-token name; the trie's dense arrays; and the kernel
switches that these modes refuse."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gitax.decode import build_vocab_trie as gx_build_vocab_trie
from gitax.models import GitConfig, GitModel, ViTConfig
from gitax.tokenization import BertTokenizer as GxTokenizer
from gitax.tokenization import build_tiny_vocab as gx_tiny_vocab
from gitax_torch import ckpt
from gitax_torch.decode.trie import TokenTrie, build_vocab_trie
from gitax_torch.models.git import eos_gate_params
from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

TINY = GitConfig(
    encoder=ViTConfig(16, 64, 2, 2, 32),
    visual_feature_size=64,
    vocab_size=30522,
    hidden_size=48,
    num_layers=2,
    num_heads=4,
    feedforward_size=96,
    max_caption_length=48,
)
CLASSES = ["hot dog", "hot pot", "hot dog stand", "dog", "red fox", "red"]
WORDS = ["hot", "dog", "pot", "stand", "red", "fox", "what", "is", "it"]


@functools.lru_cache(maxsize=None)
def weights(gate):
    """gitax params and the port model on the same numbers; gate=None
    keeps the random table (greedy then runs every step), else the EOS
    gate ends the captions at that position."""
    params = GitModel(TINY).init_params(jax.random.PRNGKey(1))
    tx = params["textual"]
    tx["visual_projection"]["linear"]["kernel"] = tx["visual_projection"]["linear"]["kernel"] * 10
    emb = tx["embedding"]
    if gate is not None:
        emb["words"] = jnp.asarray(eos_gate_params(np.asarray(emb["words"]) * 3.0,
                                                   np.asarray(emb["positions"]), gate=gate))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return params, ckpt.params_from_gitax(np_params, TINY, device="cpu")


def images(n=3, seed=0):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def prefix_ids(n, with_prefix):
    if not with_prefix:
        return None
    tok = BertTokenizer(build_tiny_vocab(WORDS))
    return np.asarray([[101] + tok.encode("what is it")] * n, np.int64)


def run_both(mode, max_steps, with_prefix, gate, trie_names=None):
    params, model = weights(gate)
    imgs = images()
    pref = prefix_ids(len(imgs), with_prefix)
    gx_trie = pt_trie = None
    if trie_names is not None:
        gx_trie = gx_build_vocab_trie(GxTokenizer(gx_tiny_vocab(WORDS)), trie_names)
        pt_trie = build_vocab_trie(BertTokenizer(build_tiny_vocab(WORDS)), trie_names)
    gm = GitModel(TINY)

    @jax.jit
    def gen(p, im, pr):
        return gm.generate(p, im, pr, mode=mode, max_steps=max_steps, trie=gx_trie)

    want = gen(params, jnp.asarray(imgs), None if pref is None else jnp.asarray(pref, jnp.int32))
    got = model.generate(torch.from_numpy(imgs), None if pref is None else torch.from_numpy(pref),
                         mode=mode, max_steps=max_steps, trie=pt_trie)
    return want, got


@pytest.mark.parametrize("with_prefix", [False, True], ids=["caption", "prefix"])
@pytest.mark.parametrize("max_steps", [8, 40])
@pytest.mark.parametrize("gate", [None, 6], ids=["random", "eos_gate"])
def test_greedy_matches_gitax(max_steps, with_prefix, gate):
    (ref_seqs, ref_lp), (seqs, lp) = run_both("greedy", max_steps, with_prefix, gate)
    tp = 4 if with_prefix else 0
    assert seqs.shape == (3, max_steps - tp) and lp.shape == (3,)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(ref_seqs))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), atol=1e-4, rtol=1e-4)
    if gate is not None and max_steps == 40:
        # EOS-padded after the gate
        assert (seqs[:, -1] == 102).all()


@pytest.mark.parametrize("with_prefix", [False, True], ids=["caption", "prefix"])
@pytest.mark.parametrize("max_steps", [8, 40])
def test_trie_matches_gitax(max_steps, with_prefix):
    (ref_seqs, ref_lp), (seqs, lp) = run_both("trie", max_steps, with_prefix, gate=None,
                                              trie_names=CLASSES)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(ref_seqs))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), atol=1e-4, rtol=1e-4)
    # every output decodes to a member of the list (max_steps leaves room)
    tok = BertTokenizer(build_tiny_vocab(WORDS))
    start = 0 if with_prefix else 1  # the [CLS] stays in a caption's output
    for row in seqs.tolist():
        assert tok.decode(row[start:], skip_special_tokens=True) in CLASSES


def test_trie_arrays_match_gitax():
    gx = gx_build_vocab_trie(GxTokenizer(gx_tiny_vocab(WORDS)), CLASSES)
    pt = build_vocab_trie(BertTokenizer(build_tiny_vocab(WORDS)), CLASSES)
    for a, b in zip(gx.as_arrays(), pt.as_arrays()):
        np.testing.assert_array_equal(a, b)
    assert pt.num_nodes == gx.num_nodes
    assert pt.get_valid([]) == gx.get_valid([])
    hot = BertTokenizer(build_tiny_vocab(WORDS)).encode("hot")
    assert pt.get_valid(hot) == gx.get_valid(hot) and len(pt.get_valid(hot)) == 2
    assert TokenTrie.construct([[5, 6], [5, 7]]).get_valid([5]) == [6, 7]


@pytest.mark.parametrize("mode", ["greedy", "trie"])
@pytest.mark.parametrize("switch", [dict(decode_kernel=True), dict(decode_kernel="int8"),
                                    dict(vocab_kernel=True), dict(fast_prefill=True)],
                         ids=["decode_kernel", "decode_kernel_int8", "vocab_kernel",
                              "fast_prefill"])
def test_modes_reject_beam_only_switches(mode, switch):
    _, model = weights(None)
    trie = build_vocab_trie(BertTokenizer(build_tiny_vocab(WORDS)), CLASSES)
    with pytest.raises(ValueError, match="mode='beam' only"):
        model.generate(torch.from_numpy(images(1)), mode=mode, trie=trie, **switch)


def test_trie_mode_needs_a_trie_and_modes_are_named():
    _, model = weights(None)
    with pytest.raises(ValueError, match="TokenTrie"):
        model.generate(torch.from_numpy(images(1)), mode="trie")
    with pytest.raises(ValueError, match="generate mode"):
        model.generate(torch.from_numpy(images(1)), mode="sample")


@pytest.mark.parametrize("mode", ["greedy", "trie", "beam"])
def test_float64_activations_accumulate_in_float64(mode):
    """A float64 model, the rounding reference the card's f32 is held to:
    its logits and score math stay float64 (f32 would round them), its
    prefill logits are within 1e-4 of the f32 model's, and its tokens
    equal the f32 model's."""
    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.models.git import GitModel as PtModel

    _, m32 = weights(6)
    m64 = PtModel(m32.cfg, device="cpu", dtype=torch.float64)
    m64.load_state_dict(m32.state_dict())
    x = torch.from_numpy(images())
    trie = build_vocab_trie(BertTokenizer(build_tiny_vocab(WORDS)), CLASSES)
    out = {}
    for model, dtype in ((m32, torch.float32), (m64, torch.float64)):
        visual, valid = model.build_memory(x.to(dtype), dtype=dtype)
        prefix = torch.full((x.shape[0], 1), 101, dtype=torch.long)
        logits, cache = model.prefill(visual, prefix, 8, valid, dtype)
        step, _ = model.decode_step(torch.full((x.shape[0],), 2000), cache, dtype)
        assert logits.dtype == step.dtype == dtype
        kw = dict(beam=BeamSearchConfig(num_beams=2, max_steps=8)) if mode == "beam" else \
            dict(mode=mode, trie=trie, max_steps=8)
        out[dtype] = logits, model.generate(x.to(dtype), dtype=dtype, **kw)[0]
    np.testing.assert_allclose(out[torch.float64][0].numpy(), out[torch.float32][0].numpy(),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(out[torch.float64][1], out[torch.float32][1])
