"""The port's captioning slice against gitax on the same weights (CPU, f32,
small configs): the encoder, the full decoder forward, prefill plus
decode steps, beam-search tokens, and the engine's strings."""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gitax.decode import BeamSearchConfig as GxBeam
from gitax.models import GitConfig, GitModel, ViTConfig
from gitax.models.textual import textual_forward as gx_textual_forward
from gitax.models.vit import vit_forward as gx_vit_forward
from gitax.ops.quant import quantize_git_params as gx_quantize
from gitax_torch import ckpt
from gitax_torch.decode.beam import BeamSearchConfig
from gitax_torch.models.git import eos_gate_params
from gitax_torch.models.textual import textual_forward
from gitax_torch.models.vit import vit_forward

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


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _weights(seed=0, sharpen=True):
    """gitax params (jax) and the port model on the same numbers."""
    params = GitModel(CFG).init_params(jax.random.PRNGKey(seed))
    if sharpen:
        # decisive, image-dependent beams that end early: stronger visual
        # projection and attention, a sharper tied table, and the EOS gate
        tx = params["textual"]
        tx["visual_projection"]["linear"]["kernel"] = tx["visual_projection"]["linear"]["kernel"] * 10
        for name in ("qkv", "out"):
            tx["blocks"]["attn"][name]["kernel"] = tx["blocks"]["attn"][name]["kernel"] * 10
        emb = tx["embedding"]
        emb["words"] = jnp.asarray(eos_gate_params(
            np.asarray(emb["words"]) * 3.0, np.asarray(emb["positions"]), eos_id=2, gate=5
        ))
    return params, ckpt.params_from_gitax(_np_tree(params), CFG, device="cpu")


def _images(n, seed=0, size=32):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


@pytest.mark.parametrize("fast", [False, True], ids=["f32_softmax", "fast_softmax"])
def test_vit_forward_matches_gitax(fast):
    params, model = _weights(sharpen=False)
    img = _images(3)
    ref = gx_vit_forward(params["image_encoder"], jnp.asarray(img), CFG.encoder, fast=fast)
    ours = vit_forward(model.image_encoder, torch.from_numpy(img), fast=fast)
    assert ours.shape == (3, CFG.encoder.num_tokens, CFG.encoder.width)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_vit_forward_rejects_other_grids():
    """Any grid of whole patches runs (non-square ones interpolate the
    positional table); an image that is not whole patches raises."""
    _, model = _weights(sharpen=False)
    assert vit_forward(model.image_encoder, torch.zeros(1, 48, 32, 3)).shape == (1, 7, 32)
    for h, w in ((40, 32), (32, 47)):
        with pytest.raises(ValueError, match="whole 16-pixel patches"):
            vit_forward(model.image_encoder, torch.zeros(1, h, w, 3))


@pytest.mark.parametrize("masks", ["none", "memory_valid", "bi_valid"])
def test_textual_forward_matches_gitax(masks):
    params, model = _weights(sharpen=False)
    rng = np.random.RandomState(1)
    feats = rng.randn(2, 5, 32).astype(np.float32)
    tokens = rng.randint(0, 64, (2, 6))
    mv = bv = None
    if masks == "memory_valid":
        mv = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    if masks == "bi_valid":
        bv = np.array([[1, 1, 0], [1, 0, 0]], bool)
    ref = gx_textual_forward(
        params["textual"], jnp.asarray(feats), jnp.asarray(tokens, jnp.int32), CFG,
        memory_valid=None if mv is None else jnp.asarray(mv),
        bi_valid_mask=None if bv is None else jnp.asarray(bv),
    )
    ours = textual_forward(
        model.textual, torch.from_numpy(feats), torch.from_numpy(tokens), CFG,
        memory_valid=None if mv is None else torch.from_numpy(mv),
        bi_valid_mask=None if bv is None else torch.from_numpy(bv),
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_prefill_and_steps_match_gitax_and_full_forward():
    """[CLS]+2-token prefix with a padded memory, then 4 cached steps
    (no beams): each step's logits match gitax's step and the full
    forward over the grown sequence."""
    params, model = _weights(sharpen=False)
    gx = GitModel(CFG)
    rng = np.random.RandomState(2)
    feats = rng.randn(2, 5, 32).astype(np.float32)
    mv = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 1]], bool)
    seq = rng.randint(3, 64, (2, 7))
    seq[:, 0] = 1
    tp, t_max = 3, 8
    lg, cache = gx.prefill(params, jnp.asarray(feats), jnp.asarray(seq[:, :tp], jnp.int32),
                           t_max, memory_valid=jnp.asarray(mv))
    with torch.inference_mode():
        lp, pcache = model.prefill(torch.from_numpy(feats), torch.from_numpy(seq[:, :tp]),
                                   t_max, memory_valid=torch.from_numpy(mv))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lg), **TOL)
    for t in range(tp, seq.shape[1]):
        lg, cache = gx.decode_step(params, jnp.asarray(seq[:, t], jnp.int32), cache)
        with torch.inference_mode():
            lp, pcache = model.decode_step(torch.from_numpy(seq[:, t]), pcache)
            full = textual_forward(model.textual, torch.from_numpy(feats),
                                   torch.from_numpy(seq[:, :t + 1]), CFG,
                                   memory_valid=torch.from_numpy(mv))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lg), **TOL)
        np.testing.assert_allclose(lp.numpy(), full[:, -1].numpy(), **TOL)


@functools.lru_cache(maxsize=None)
def _gitax_generate(beams, int8, prefix):
    params, _ = _weights()
    if int8:
        params = gx_quantize(params)
    beam = GxBeam(num_beams=beams, max_steps=10, eos_id=2)
    pref = None if prefix is None else jnp.asarray(prefix, jnp.int32)
    seqs, lp = GitModel(CFG).generate(params, jnp.asarray(_images(3, seed=5)), pref,
                                      beam=beam, sos_id=1)
    return np.asarray(seqs), np.asarray(lp)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("beams", [1, 2, 4])
def test_generate_beam_tokens_match_gitax(beams, int8):
    """Token-exact beam search in f32, through both decode paths of the
    port (the kernel path runs the kernel's plain version on the CPU)."""
    params, model = _weights()
    if int8:
        model = ckpt.params_from_gitax(_np_tree(gx_quantize(params)), CFG, device="cpu")
    ref_seqs, ref_lp = _gitax_generate(beams, int8, None)
    if beams == 4:  # the weights condition the captions on the image
        assert len({tuple(r) for r in ref_seqs.tolist()}) > 1
    beam = BeamSearchConfig(num_beams=beams, max_steps=10, eos_id=2)
    for kernel in (False, True):
        seqs, lp = model.generate(torch.from_numpy(_images(3, seed=5)), beam=beam,
                                  sos_id=1, decode_kernel=kernel)
        np.testing.assert_array_equal(seqs.numpy(), ref_seqs)
        np.testing.assert_allclose(lp.numpy(), ref_lp, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("max_steps", [5, 10], ids=["forced_add", "early_stop"])
def test_generate_with_prefix_matches_gitax(max_steps):
    """An explicit 3-token prefix (stripped from the output), and a
    buffer so short that the last step force-adds every beam."""
    params, model = _weights(seed=1)
    prefix = np.array([[1, 7, 9]] * 3)
    beam_kw = dict(num_beams=4, max_steps=max_steps, eos_id=2)
    ref_seqs, ref_lp = GitModel(CFG).generate(
        params, jnp.asarray(_images(3, seed=6)), jnp.asarray(prefix, jnp.int32),
        beam=GxBeam(**beam_kw), sos_id=1,
    )
    seqs, lp = model.generate(torch.from_numpy(_images(3, seed=6)), torch.from_numpy(prefix),
                              beam=BeamSearchConfig(**beam_kw), decode_kernel=True)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(ref_seqs))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), atol=1e-4, rtol=1e-4)


def test_generate_int8_memory_close_to_gitax():
    """decode_kernel='int8' (int8 memory K/V, kernel path only) emits the
    tokens of gitax's int8-memory kernel run at these scales."""
    from jax.experimental.pallas import tpu as pltpu

    params, model = _weights()
    beam_kw = dict(num_beams=4, max_steps=10, eos_id=2)
    with pltpu.force_tpu_interpret_mode():
        ref_seqs, ref_lp = GitModel(CFG).generate(
            params, jnp.asarray(_images(2, seed=7)), beam=GxBeam(**beam_kw), sos_id=1,
            decode_kernel="int8",
        )
    seqs, lp = model.generate(torch.from_numpy(_images(2, seed=7)),
                              beam=BeamSearchConfig(**beam_kw), sos_id=1, decode_kernel="int8")
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(ref_seqs))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_caption_engine_strings_match_gitax(int8):
    from gitax.preprocess import TestTransform
    from gitax.runtime import CaptionEngine as GxEngine
    from gitax.tokenization import BertTokenizer as GxTokenizer
    from gitax.tokenization import build_tiny_vocab as gx_tiny_vocab
    from gitax_torch.runtime.engine import CaptionEngine
    from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

    params = GitModel(TINY).init_params(jax.random.PRNGKey(3))
    tok = BertTokenizer(build_tiny_vocab())
    imgs = [np.random.RandomState(i).randint(0, 255, (32, 32, 3)).astype(np.uint8)
            for i in range(5)]
    prefixes = [[tok.cls_token_id]] * len(imgs)
    kw = dict(batch_size=3, max_text_len=8, int8=int8)
    ref = GxEngine(GitModel(TINY), params, GxTokenizer(gx_tiny_vocab()),
                   TestTransform(crop_size=32), dtype=jnp.float32,
                   beam=GxBeam(num_beams=2, max_steps=8), use_native=False, **kw)
    ours = CaptionEngine(ckpt.params_from_gitax(_np_tree(params), TINY, device="cpu"), tok,
                         dtype=torch.float32, beam=BeamSearchConfig(num_beams=2, max_steps=8),
                         **kw)
    assert ours._fast_prefill == ref._fast_prefill
    want = ref.generate_batch(imgs, prefixes)
    got = ours.generate_batch(imgs, prefixes)
    assert got == want
    assert all(isinstance(s, str) for s in got)


def test_caption_engine_beam_rules_follow_gitax(monkeypatch):
    from gitax_torch.runtime.engine import CaptionEngine

    _, model = _weights()
    eng = CaptionEngine(model, tokenizer=None, beam=BeamSearchConfig(num_beams=4, max_steps=24))
    assert eng._fast_prefill is False and eng._decode_kernel is True
    seen = {}

    def fake_generate(images, prefix, beam, **kw):
        seen.update(beam=beam, **kw)
        return torch.zeros(images.shape[0], 3, dtype=torch.long), None

    monkeypatch.setattr(model, "generate", fake_generate)
    eng._caption_fn(1)(torch.zeros(2, 32, 32, 3, dtype=torch.uint8), torch.ones(2, 1))
    # beam buffer: prefix + max_text_len (1 + 40 = 41); is_done norm 1024
    assert seen["beam"] == dataclasses.replace(
        BeamSearchConfig(num_beams=4, max_steps=24), max_steps=41, norm_max_length=1024
    )
    assert seen["decode_kernel"] is True and seen["dtype"] == torch.bfloat16


def test_caption_engine_takes_only_uint8_images(monkeypatch):
    """uint8 images are normalised on the device (CLIP's constants without
    a transform); float images, already normalised, go in as they are, as
    in gitax (pipeline.py:346-358); anything but [B, H, W, 3] images or
    [B, F, H, W, 3] clips raises."""
    from gitax_torch.runtime.engine import CaptionEngine

    _, model = _weights()
    eng = CaptionEngine(model, tokenizer=None, dtype=torch.float32)
    seen = []

    def fake_generate(images, prefix, **kw):
        seen.append(images)
        return torch.zeros(images.shape[0], 1, dtype=torch.long), None

    monkeypatch.setattr(model, "generate", fake_generate)
    u8 = np.random.RandomState(0).randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    eng.dispatch_device_batch(u8, np.ones((2, 1)))
    mean = torch.tensor([0.48145466, 0.4578275, 0.40821073])
    std = torch.tensor([0.26862954, 0.26130258, 0.27577711])
    assert torch.equal(seen[0], (torch.from_numpy(u8).float() / 255.0 - mean) / std)
    f32 = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    eng.dispatch_device_batch(f32, np.ones((2, 1)))
    assert torch.equal(seen[1], torch.from_numpy(f32))
    with pytest.raises(ValueError, match="images"):
        eng.dispatch_device_batch(np.zeros((2, 32, 32), np.uint8), np.ones((2, 1)))
    eng.close()


def test_generate_rejects_modes_not_ported():
    """'beam', 'greedy' and 'trie' are ported; any other mode raises, and
    so do the beam-only kernel switches in greedy mode."""
    _, model = _weights()
    with pytest.raises(ValueError, match="generate mode"):
        model.generate(torch.from_numpy(_images(1)), mode="sample")
    with pytest.raises(ValueError, match="mode='beam' only"):
        model.generate(torch.from_numpy(_images(1)), mode="greedy", decode_kernel=True)
    seqs, lp = model.generate(torch.from_numpy(_images(1)), mode="greedy", max_steps=6, sos_id=1)
    assert seqs.shape == (1, 6) and lp.shape == (1,)
