"""Text context and memory_valid of the port against gitax (CPU, f32, a
small config whose visual width equals the decoder's, as the context
needs): `append_text_context` and `build_memory` within 1e-4 with one
context and with a list of ragged ones; `generate` with context against
gitax's jitted `generate`, tokens exact and logprobs within 1e-4, in beam
(1 and 4 beams, both decode paths: the decode-attention kernel's plain
version reads the padded memory through `mem_bias`), greedy and trie
mode; memory_valid passed directly; and the two refusals."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gitax.decode import BeamSearchConfig as GxBeam
from gitax.decode import build_vocab_trie as gx_build_vocab_trie
from gitax.models import GitConfig, GitModel, ViTConfig
from gitax.tokenization import BertTokenizer as GxTokenizer
from gitax.tokenization import build_tiny_vocab as gx_tiny_vocab
from gitax_torch import ckpt
from gitax_torch.decode.beam import BeamSearchConfig
from gitax_torch.decode.trie import build_vocab_trie
from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

TOL = dict(atol=1e-4, rtol=1e-4)

# the tiny vocabulary's ids reach 30521; visual width = hidden width
CFG = GitConfig(
    encoder=ViTConfig(16, 32, 2, 2, 32),
    visual_feature_size=32,
    vocab_size=30522,
    hidden_size=32,
    num_layers=2,
    num_heads=2,
    feedforward_size=64,
    max_caption_length=48,
)
M = 5  # image tokens: a 2 x 2 grid of 16 px patches and the class token
CLASSES = ["hot dog", "hot pot", "red fox", "dog", "red"]
WORDS = ["hot", "dog", "pot", "red", "fox", "what", "is", "it"]


@functools.lru_cache(maxsize=None)
def weights(cfg=CFG):
    """gitax params and the port model on the same numbers; the visual
    projection and the attention x10 so that outputs depend on the memory
    (the context included)."""
    params = GitModel(cfg).init_params(jax.random.PRNGKey(2))
    tx = params["textual"]
    tx["visual_projection"]["linear"]["kernel"] = tx["visual_projection"]["linear"]["kernel"] * 10
    for name in ("qkv", "out"):
        tx["blocks"]["attn"][name]["kernel"] = tx["blocks"]["attn"][name]["kernel"] * 10
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return params, ckpt.params_from_gitax(np_params, cfg, device="cpu")


def images(n=3, seed=0):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def contexts(n=3, kind="one"):
    """One context [n, 6] or a list of two ([n, 6], [n, 4]) with ragged
    lengths (1 to the full width) and word ids past each length that the
    mask must hide."""
    rng = np.random.RandomState(5)
    tok = BertTokenizer(build_tiny_vocab(WORDS))
    ids = [tok.vocab[w] for w in WORDS]
    widths = [6] if kind == "one" else [6, 4]
    out = []
    for i, tc in enumerate(widths):
        toks = np.asarray(rng.choice(ids, (n, tc)), np.int64)
        lengths = np.asarray([tc, 1, 3][:n] if i == 0 else [2, tc, 1][:n], np.int64)
        out.append((toks, lengths))
    return out


def as_args(ctx, framework):
    to = (lambda a: jnp.asarray(a, jnp.int32)) if framework == "gitax" else torch.from_numpy
    toks = [to(t) for t, _ in ctx]
    lens = [to(l) for _, l in ctx]
    if len(ctx) == 1:
        return toks[0], lens[0]
    return toks, lens


@pytest.mark.parametrize("kind", ["one", "list"])
def test_append_text_context_and_build_memory_match_gitax(kind):
    params, model = weights()
    gm = GitModel(CFG)
    ctx = contexts(3, kind)
    x = images()
    want_mem, want_valid = gm.build_memory(params, jnp.asarray(x), *as_args(ctx, "gitax"))
    mem, valid = model.build_memory(torch.from_numpy(x), *as_args(ctx, "port"))
    assert mem.shape == want_mem.shape == (3, M + sum(t.shape[1] for t, _ in ctx), 32)
    np.testing.assert_allclose(mem.numpy(), np.asarray(want_mem), **TOL)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    visual = model.encode_images(torch.from_numpy(x))
    again, valid2 = model.append_text_context(visual, *as_args(ctx, "port"))
    np.testing.assert_array_equal(again.numpy(), mem.numpy())
    assert torch.equal(valid2, valid)
    assert model.build_memory(torch.from_numpy(x))[1] is None


def gitax_generate(ctx, mode, beam=None, trie=None, memory_valid=None, max_steps=None):
    params, _ = weights()
    gm = GitModel(CFG)

    @jax.jit
    def gen(p, im, ct, cl, mv):
        return gm.generate(p, im, None, beam=beam, memory_valid=mv, sos_id=101, mode=mode,
                           max_steps=max_steps, trie=trie, context_tokens=ct,
                           context_lengths=cl)

    ct, cl = as_args(ctx, "gitax") if ctx is not None else (None, None)
    seqs, lp = gen(params, jnp.asarray(images()), ct, cl,
                   None if memory_valid is None else jnp.asarray(memory_valid))
    return np.asarray(seqs), np.asarray(lp)


@pytest.mark.parametrize("kind", ["one", "list"])
@pytest.mark.parametrize("beams", [1, 4])
def test_generate_beam_with_context_matches_gitax(beams, kind):
    _, model = weights()
    ctx = contexts(3, kind)
    kw = dict(num_beams=beams, max_steps=12, eos_id=102)
    want_seqs, want_lp = gitax_generate(ctx, "beam", beam=GxBeam(**kw))
    ct, cl = as_args(ctx, "port")
    for kernel in (False, True):
        seqs, lp = model.generate(torch.from_numpy(images()), beam=BeamSearchConfig(**kw),
                                  decode_kernel=kernel, context_tokens=ct, context_lengths=cl)
        np.testing.assert_array_equal(seqs.numpy(), want_seqs)
        np.testing.assert_allclose(lp.numpy(), want_lp, **TOL)


def test_context_changes_the_output():
    """The context reaches the decoder: other context words, other
    captions (gitax's and the port's alike)."""
    ctx = contexts(3, "one")
    other = [(np.roll(ctx[0][0], 1, axis=1), ctx[0][1])]
    beam = GxBeam(num_beams=4, max_steps=12, eos_id=102)
    assert not np.array_equal(gitax_generate(ctx, "beam", beam=beam)[0],
                              gitax_generate(other, "beam", beam=beam)[0])


@pytest.mark.parametrize("mode", ["greedy", "trie"])
def test_generate_greedy_and_trie_with_context_match_gitax(mode):
    _, model = weights()
    ctx = contexts(3, "list")
    gx_trie = pt_trie = None
    if mode == "trie":
        gx_trie = gx_build_vocab_trie(GxTokenizer(gx_tiny_vocab(WORDS)), CLASSES)
        pt_trie = build_vocab_trie(BertTokenizer(build_tiny_vocab(WORDS)), CLASSES)
    want_seqs, want_lp = gitax_generate(ctx, mode, trie=gx_trie, max_steps=10)
    ct, cl = as_args(ctx, "port")
    seqs, lp = model.generate(torch.from_numpy(images()), mode=mode, trie=pt_trie, max_steps=10,
                              context_tokens=ct, context_lengths=cl)
    np.testing.assert_array_equal(seqs.numpy(), want_seqs)
    np.testing.assert_allclose(lp.numpy(), want_lp, **TOL)


def test_memory_valid_passed_directly_matches_gitax():
    """A caller's memory_valid over the image tokens (two of the 5 masked
    in two rows): gitax's tokens on the plain step, on the kernel path
    (the kernel's plain version with mem_bias), and the two paths'
    logprobs within 1e-4."""
    _, model = weights()
    valid = np.ones((3, M), bool)
    valid[1, -2:] = False
    valid[2, 1:3] = False
    kw = dict(num_beams=4, max_steps=12, eos_id=102)
    want_seqs, want_lp = gitax_generate(None, "beam", beam=GxBeam(**kw), memory_valid=valid)
    unmasked, _ = gitax_generate(None, "beam", beam=GxBeam(**kw))
    assert not np.array_equal(want_seqs, unmasked), "the mask changed nothing"
    for kernel in (False, True):
        seqs, lp = model.generate(torch.from_numpy(images()), beam=BeamSearchConfig(**kw),
                                  memory_valid=torch.from_numpy(valid), decode_kernel=kernel)
        np.testing.assert_array_equal(seqs.numpy(), want_seqs)
        np.testing.assert_allclose(lp.numpy(), want_lp, **TOL)


def test_decode_kernel_path_reads_mem_bias_as_the_plain_step():
    """One prefill over a padded context memory, then steps on the kernel
    path (the decode-attention kernel's plain version, which reads the
    cache's mem_bias) and on the plain step: logits within 1e-5."""
    _, model = weights()
    ct, cl = as_args(contexts(3, "list"), "port")
    with torch.inference_mode():
        memory, valid = model.build_memory(torch.from_numpy(images()), ct, cl)
        prefix = torch.full((3, 1), 101, dtype=torch.long)
        out = {}
        for kernel in (False, True):
            logits, cache = model.prefill(memory, prefix, 8, valid)
            assert cache.mem_bias is not None and cache.mem_bias.shape == valid.shape
            steps = [logits]
            tok = prefix[:, 0]
            for _ in range(4):
                tok = steps[-1].argmax(-1)
                logits, cache = model.decode_step(tok, cache, kernel=kernel)
                steps.append(logits)
            out[kernel] = torch.stack(steps)
    torch.testing.assert_close(out[True], out[False], atol=1e-5, rtol=1e-5)


def test_context_refusals():
    _, model = weights()
    ct, cl = as_args(contexts(3, "one"), "port")
    with pytest.raises(ValueError, match="not both"):
        model.generate(torch.from_numpy(images()), context_tokens=ct, context_lengths=cl,
                       memory_valid=torch.ones(3, M + 6, dtype=torch.bool))
    wide = GitConfig(encoder=ViTConfig(16, 48, 2, 2, 32), visual_feature_size=48,
                     vocab_size=30522, hidden_size=32, num_layers=2, num_heads=2,
                     feedforward_size=64, max_caption_length=48)
    _, other = weights(wide)
    with pytest.raises(ValueError, match="visual_feature_size == hidden_size"):
        other.build_memory(torch.from_numpy(images()), ct, cl)
