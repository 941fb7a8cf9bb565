"""The port's high-res VQA slice against gitax on the same weights (CPU,
f32, small configs): the ViT at non-square grids with the interpolated
positional table, with and without the fused attention; the prefill's
fused-attention entry; the question prefix and the MinMax size rule; and
the engine's variable-resolution buckets end to end.  gitax's Pallas
kernel runs in interpret mode, as its own tests run it."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from gitax.decode import BeamSearchConfig as GxBeam
from gitax.models import GitConfig, GitModel, ViTConfig
from gitax.models.textual import prefill as gx_prefill
from gitax.models.vit import _pos_embed_for as gx_pos_embed_for
from gitax.models.vit import vit_forward as gx_vit_forward
from gitax_torch import ckpt
from gitax_torch.decode.beam import BeamSearchConfig
from gitax_torch.models import textual as ptextual
from gitax_torch.models.vit import _pos_embed_for, vit_forward

VIT = ViTConfig(16, 64, 2, 2, 32)  # gitax's own flash-test encoder (Dh 32)
ENC_CFG = GitConfig(encoder=VIT, visual_feature_size=64, vocab_size=97, hidden_size=32,
                    num_layers=2, num_heads=2, feedforward_size=64, max_caption_length=64)
# tests/test_flash_attention.py:114-118
PREFILL_CFG = GitConfig(
    encoder=ViTConfig(16, 32, 1, 2, 32), visual_feature_size=32,
    vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
    feedforward_size=64, max_caption_length=64,
)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _weights(cfg, seed=0):
    params = GitModel(cfg).init_params(jax.random.PRNGKey(seed))
    return params, ckpt.params_from_gitax(_np_tree(params), cfg, device="cpu")


def _images(h, w, n=2, seed=0):
    return np.random.RandomState(seed).randn(n, h, w, 3).astype(np.float32)


# ---------------------------------------------------------------------------
# encoder: non-square grids and the fused attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(32, 32), (32, 48), (48, 32), (64, 16)])
def test_pos_embed_for_matches_gitax(hw):
    params, model = _weights(ENC_CFG)
    gh, gw = hw[0] // 16, hw[1] // 16
    ref = gx_pos_embed_for(params["image_encoder"], VIT, gh, gw, jnp.float32)
    ours = _pos_embed_for(model.image_encoder, gh, gw, torch.float32)
    assert ours.shape == (1 + gh * gw, VIT.width)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    if hw == (32, 32):  # the configured grid takes the stored table as is
        assert torch.equal(ours, model.image_encoder.positional_embedding)


@pytest.mark.parametrize("hw", [(32, 48), (48, 32)])
def test_vit_forward_non_square_matches_gitax(hw):
    params, model = _weights(ENC_CFG)
    img = _images(*hw)
    ref = gx_vit_forward(params["image_encoder"], jnp.asarray(img), VIT, flash=False)
    ours = vit_forward(model.image_encoder, torch.from_numpy(img), flash=False)
    assert ours.shape == (2, 1 + (hw[0] // 16) * (hw[1] // 16), VIT.width)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    # flash=None on the CPU is the plain path, as gitax's auto rule off a TPU
    assert torch.equal(vit_forward(model.image_encoder, torch.from_numpy(img)), ours)


@pytest.mark.parametrize("hw", [(32, 48), (48, 32)])
def test_vit_forward_flash_matches_gitax_interpret(hw):
    params, model = _weights(ENC_CFG)
    img = _images(*hw, seed=1)
    with pltpu.force_tpu_interpret_mode():
        ref = gx_vit_forward(params["image_encoder"], jnp.asarray(img), VIT, flash=True)
    ours = vit_forward(model.image_encoder, torch.from_numpy(img), flash=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_vit_flash_ignores_fast_softmax():
    """gitax's flash branch never reads `fast` (nn.py:127-133): the
    kernel's softmax is f32 whatever the encoder's fast_softmax."""
    _, model = _weights(ENC_CFG)
    img = torch.from_numpy(_images(32, 48, seed=2))
    slow = vit_forward(model.image_encoder, img, flash=True, fast=False)
    assert torch.equal(vit_forward(model.image_encoder, img, flash=True, fast=True), slow)


# ---------------------------------------------------------------------------
# prefill: the fused-attention entry
# ---------------------------------------------------------------------------


def test_prefill_flash_matches_gitax_interpret(monkeypatch):
    """tests/test_flash_attention.py::test_prefill_flash_matches_xla on the
    port: logits within 2e-4 of gitax's interpret-mode kernel, the cache
    within 2e-4, and no additive mask built on the flash path."""
    params, model = _weights(PREFILL_CFG)
    rng = np.random.RandomState(0)
    vis = rng.randn(2, 7, 32).astype(np.float32)
    prefix = rng.randint(0, 97, (2, 3))
    with pltpu.force_tpu_interpret_mode():
        ref_logits, ref_cache = gx_prefill(params["textual"], jnp.asarray(vis),
                                           jnp.asarray(prefix, jnp.int32), PREFILL_CFG, 8,
                                           flash=True)
    plain_logits, plain_cache = model.prefill(torch.from_numpy(vis), torch.from_numpy(prefix), 8,
                                              flash=False)

    def no_mask(*a, **kw):
        raise AssertionError("build_unified_mask called on the flash path")

    monkeypatch.setattr(ptextual, "build_unified_mask", no_mask)
    logits, cache = model.prefill(torch.from_numpy(vis), torch.from_numpy(prefix), 8, flash=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=2e-4, rtol=2e-4)
    dh = PREFILL_CFG.head_dim
    for li in range(PREFILL_CFG.num_layers):
        mem = cache.mem_kv[li]
        np.testing.assert_allclose(mem[..., :dh].numpy(), np.asarray(ref_cache.mem_k[li]),
                                   atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(mem[..., dh:].numpy(), np.asarray(ref_cache.mem_v[li]),
                                   atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(cache.txt_kv[li].numpy(), np.asarray(ref_cache.txt_kv[li]),
                                   atol=2e-4, rtol=2e-4)
    # the first layer's k and v come before any attention: both paths
    # cache the same rows, bit for bit
    assert torch.equal(cache.txt_kv[0], plain_cache.txt_kv[0])
    assert torch.equal(cache.mem_kv[0], plain_cache.mem_kv[0])
    np.testing.assert_allclose(logits.numpy(), plain_logits.numpy(), atol=2e-4, rtol=2e-4)


def test_prefill_flash_needs_a_fully_valid_memory(monkeypatch):
    """flash=True with a memory_valid mask takes the plain path (gitax
    textual.py:372-374): the kernel has no validity input."""
    _, model = _weights(PREFILL_CFG)
    vis = torch.from_numpy(np.random.RandomState(1).randn(2, 7, 32).astype(np.float32))
    prefix = torch.tensor([[1, 5, 9], [1, 6, 2]])
    valid = torch.tensor([[True] * 5 + [False] * 2, [True] * 7])

    def no_flash(*a, **kw):
        raise AssertionError("fused_attention called with a padded memory")

    monkeypatch.setattr(ptextual, "fused_attention", no_flash)
    logits, _ = model.prefill(vis, prefix, 8, memory_valid=valid, flash=True)
    want, _ = model.prefill(vis, prefix, 8, memory_valid=valid, flash=False)
    assert torch.equal(logits, want)


# ---------------------------------------------------------------------------
# question prefix and MinMax sizing
# ---------------------------------------------------------------------------

QUESTIONS = [
    "what color is the man's shirt?",
    "How many people are riding the waves?",
    " ".join(["what is the color of the boat"] * 8) + "?",  # 57 tokens: tail kept
    "",
]


@pytest.mark.parametrize("max_text_len", [40, 8])
def test_encode_prefix_matches_gitax(max_text_len):
    from gitax import tokenization as gx_tok
    from gitax_torch import tokenization as pt_tok

    words = ["what", "color", "is", "the", "man", "shirt", "how", "many", "people", "are"]
    vocab = pt_tok.build_tiny_vocab(words)
    ours, ref = pt_tok.BertTokenizer(vocab), gx_tok.BertTokenizer(vocab)
    for q in QUESTIONS:
        got = pt_tok.encode_prefix(ours, q, max_text_len)
        assert got == gx_tok.encode_prefix(ref, q, max_text_len), q
        assert got[0] == pt_tok.CLS_ID and len(got) <= max_text_len - 1
    assert len(pt_tok.encode_prefix(ours, QUESTIONS[2], max_text_len)) == max_text_len - 1


@pytest.mark.parametrize("size,want", [
    ((1920, 1080), (315, 560)),  # 16:9 -> 308x560 once cut to 14-px patches
    ((640, 480), (420, 560)),
    ((480, 640), (560, 420)),
    ((500, 500), (420, 420)),
    ((420, 300), (400, 560)),  # the long side bounds it
    ((1000, 200), (112, 560)),
    ((300, 301), (421, 420)),
])
def test_min_max_resize_size_matches_gitax(size, want):
    from gitax.preprocess.transforms import min_max_resize_size as gx_size
    from gitax_torch.preprocess.transforms import min_max_resize_size

    assert min_max_resize_size(size, 420, 560) == gx_size(size, 420, 560) == want


# ---------------------------------------------------------------------------
# the slice: the engine's variable-resolution VQA buckets
# ---------------------------------------------------------------------------

VQA_CFG = GitConfig(
    encoder=ViTConfig(16, 64, 2, 2, 48),  # a 48-px config: a 3x3 grid, 10-row table
    visual_feature_size=64,
    vocab_size=30522,
    hidden_size=48,
    num_layers=2,
    num_heads=4,
    feedforward_size=96,
    max_caption_length=48,
)
WORDS = ["what", "is", "the", "man", "holding", "how", "many", "dogs"]


def _vqa_pairs(cls_id, tok_encode):
    """uint8 images of three grids, one of them cut to whole patches
    (45x70 -> 32x64), with questions of two prefix lengths."""
    rng = np.random.RandomState(7)
    shapes = [(48, 48), (48, 64), (45, 70), (48, 64), (48, 48), (45, 70), (48, 48)]
    images = [rng.randint(0, 256, s + (3,)).astype(np.uint8) for s in shapes]
    questions = ["what is the man holding?", "how many dogs?"] * 4
    prefixes = [tok_encode(q) for q in questions[:len(images)]]
    assert {len(p) for p in prefixes} == {7, 5} and all(p[0] == cls_id for p in prefixes)
    return images, prefixes


def test_generate_varshape_matches_gitax():
    from gitax.preprocess import TestTransform
    from gitax.runtime import CaptionEngine as GxEngine
    from gitax.tokenization import BertTokenizer as GxTokenizer
    from gitax.tokenization import build_tiny_vocab as gx_tiny_vocab
    from gitax_torch.runtime.engine import CaptionEngine
    from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

    params = GitModel(VQA_CFG).init_params(jax.random.PRNGKey(4))
    # image-dependent answers: a stronger visual projection and attention
    tx = params["textual"]
    tx["visual_projection"]["linear"]["kernel"] = tx["visual_projection"]["linear"]["kernel"] * 10
    for name in ("qkv", "out"):
        tx["blocks"]["attn"][name]["kernel"] = tx["blocks"]["attn"][name]["kernel"] * 10
    tok = BertTokenizer(build_tiny_vocab(WORDS))
    kw = dict(batch_size=2, max_text_len=8)
    ref = GxEngine(GitModel(VQA_CFG), params, GxTokenizer(gx_tiny_vocab(WORDS)),
                   TestTransform(crop_size=48), dtype=jnp.float32,
                   beam=GxBeam(num_beams=2, max_steps=8), use_native=False, **kw)
    ours = CaptionEngine(ckpt.params_from_gitax(_np_tree(params), VQA_CFG, device="cpu"), tok,
                         dtype=torch.float32, beam=BeamSearchConfig(num_beams=2, max_steps=8), **kw)
    images, prefixes = _vqa_pairs(tok.cls_token_id, ours.encode_prefix)
    assert [ours.encode_prefix(q) for q in ("how many dogs?",)] == \
        [ref.encode_prefix(q) for q in ("how many dogs?",)]
    answers = [None] * len(images)
    for tp in sorted({len(p) for p in prefixes}):  # one prefix length per dispatch
        idx = [i for i, p in enumerate(prefixes) if len(p) == tp]
        imgs, prefs = [images[i] for i in idx], [prefixes[i] for i in idx]
        n_ref, want = ref.dispatch_varshape(imgs, prefs)
        n_ours, got = ours.dispatch_varshape(imgs, prefs)
        assert n_ours == n_ref == len(idx)
        assert [g[0] for g in got] == [w[0] for w in want]  # the same grid buckets
        for (_, seqs), (_, ref_seqs) in zip(got, want):
            np.testing.assert_array_equal(torch.cat(seqs).numpy(),
                                          np.concatenate([np.asarray(s) for s in ref_seqs]))
        strings = ours.resolve((n_ours, got))
        assert strings == ref.resolve((n_ref, want)) == ours.generate_varshape(imgs, prefs)
        for i, s in zip(idx, strings):
            answers[i] = s
    assert all(isinstance(a, str) for a in answers)
    assert len(set(answers)) > 1  # the answers depend on the image and question


def test_dispatch_varshape_cuts_to_whole_patches_and_buckets(monkeypatch):
    """Each image is cut to whole patches and dispatched in its grid's
    bucket; `resolve` returns the answers in the order given, for this
    handle and for `dispatch`'s."""
    from gitax_torch.runtime.engine import CaptionEngine

    _, model = _weights(ENC_CFG)
    eng = CaptionEngine(model, tokenizer=None, batch_size=2, dtype=torch.float32)
    seen = []

    def fake_batch(imgs, pref):
        seen.append(imgs.shape)
        # each row answers with its image's first pixel value
        return torch.from_numpy(imgs[:, 0, 0, :1].astype(np.int64))

    class Tok:
        @staticmethod
        def decode(ids, skip_special_tokens):
            return str(ids[0])

    monkeypatch.setattr(eng, "dispatch_device_batch", fake_batch)
    eng.tokenizer = Tok()
    images = [np.full(s + (3,), i, np.uint8) for i, s in
              enumerate([(45, 70), (32, 48), (47, 70), (32, 48), (32, 48)])]
    handle = eng.dispatch_varshape(images, [[101, 7]] * 5)
    assert sorted(seen) == [(2, 32, 48, 3), (2, 32, 48, 3), (2, 32, 64, 3)]
    assert [idxs for idxs, _ in handle[1]] == [[1, 3, 4], [0, 2]]
    assert eng.resolve(handle) == ["0", "1", "2", "3", "4"]
    same = [np.full((32, 32, 3), i, np.uint8) for i in range(3)]
    assert eng.generate_batch(same, [[101]] * 3) == ["0", "1", "2"]


def test_params_from_gitax_at_a_high_res_config():
    """The bridge fills a non-224 config (its stored table is that grid's,
    as GIT_LARGE_VQAv2's 901 rows at 420 px) and rejects a table of
    another grid."""
    params, model = _weights(VQA_CFG)
    pos = model.image_encoder.positional_embedding
    assert pos.shape == (VQA_CFG.encoder.num_tokens, 64) == (10, 64)
    np.testing.assert_array_equal(pos.numpy(),
                                  np.asarray(params["image_encoder"]["positional_embedding"]))
    tree = _np_tree(params)
    tree["image_encoder"]["positional_embedding"] = np.zeros((5, 64), np.float32)
    with pytest.raises(ValueError, match="positional table"):
        ckpt.params_from_gitax(tree, VQA_CFG, device="cpu")
