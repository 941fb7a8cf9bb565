"""The port's video-captioning slice against gitax on the same weights (CPU,
f32, small configs): frame stacks through `encode_images` (the temporal
embeddings, dropped frames, average pooling), the weight bridge of the
temporal embeddings, beam search with the fused vocab head
(`vocab_kernel`) and its gates, and the engine on clip items.  gitax's
Pallas kernel runs in interpret mode, as its own tests run it.

Token equality alone is weak at these sizes (two clips can decode to the
same tokens), so the memory and the prefill logits are held against gitax
too."""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gitax.ckpt.torch_convert import export_git_state_dict
from gitax.decode import BeamSearchConfig as GxBeam
from gitax.models import GitConfig, GitModel, ViTConfig
from gitax.ops.quant import quantize_git_params as gx_quantize
from gitax_torch import ckpt
from gitax_torch.decode.beam import BeamSearchConfig
from gitax_torch.models import textual as ptextual
from gitax_torch.models.git import GitModel as PortModel

TOL = dict(atol=1e-4, rtol=1e-4)
FRAMES = 3
# gitax tests/test_vocab_topk.py's decoder (9 vocab blocks of 512) with a
# 3-frame video encoder
CFG = GitConfig(
    encoder=ViTConfig(16, 32, 1, 2, 32),
    visual_feature_size=32,
    vocab_size=4608,
    hidden_size=32,
    num_layers=2,
    num_heads=2,
    feedforward_size=64,
    max_caption_length=32,
    num_image_with_embedding=FRAMES,
)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _weights(cfg=CFG, seed=0):
    """gitax params with random (non-zero) temporal embeddings and a
    stronger visual projection and decoder attention, so that the tokens
    depend on the clip and on its frame order."""
    params = GitModel(cfg).init_params(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    params["img_temporal_embedding"] = jnp.asarray(
        rng.randn(cfg.num_image_with_embedding, cfg.visual_feature_size).astype(np.float32))
    tx = params["textual"]
    tx["visual_projection"]["linear"]["kernel"] = tx["visual_projection"]["linear"]["kernel"] * 10
    for name in ("qkv", "out"):
        tx["blocks"]["attn"][name]["kernel"] = tx["blocks"]["attn"][name]["kernel"] * 10
    return params


def _clips(n, frames=FRAMES, seed=0, size=32):
    return np.random.RandomState(seed).randn(n, frames, size, size, 3).astype(np.float32)


# ---------------------------------------------------------------------------
# encoder on frame stacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frames,pooling", [(FRAMES, None), (5, None), (FRAMES, "avg")],
                         ids=["all_frames", "extra_frames_dropped", "avg_pooling"])
def test_encode_images_on_clips_matches_gitax(frames, pooling):
    cfg = dataclasses.replace(CFG, pooling_images=pooling)
    params = _weights()
    model = ckpt.params_from_gitax(_np_tree(params), cfg, device="cpu")
    clips = _clips(2, frames, seed=1)
    ref = GitModel(cfg).encode_images(params, jnp.asarray(clips))
    ours = model.encode_images(torch.from_numpy(clips))
    s = cfg.encoder.num_tokens
    assert ours.shape == ((2, s, 32) if pooling else (2, FRAMES * s, 32))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    if frames > FRAMES:  # the frames past the embeddings are dropped
        assert torch.equal(ours, model.encode_images(torch.from_numpy(clips[:, :FRAMES])))


def test_reversed_frames_change_the_memory():
    """Frame order reaches the memory through the temporal embeddings, on
    both sides alike (gitax tests/test_e2e_dual_framework.py:258-278)."""
    params = _weights()
    model = ckpt.params_from_gitax(_np_tree(params), CFG, device="cpu")
    clips = _clips(2, seed=2)
    rev = np.ascontiguousarray(clips[:, ::-1])
    fwd_ours = model.encode_images(torch.from_numpy(clips))
    rev_ours = model.encode_images(torch.from_numpy(rev))
    assert (fwd_ours - rev_ours).abs().max().item() > 0.1
    np.testing.assert_allclose(rev_ours.numpy(),
                               np.asarray(GitModel(CFG).encode_images(params, jnp.asarray(rev))),
                               **TOL)


def test_encode_images_rejects_other_ranks():
    model = ckpt.params_from_gitax(_np_tree(_weights()), CFG, device="cpu")
    with pytest.raises(ValueError, match=r"\[B, F, H, W, 3\]"):
        model.encode_images(torch.zeros(1, 1, 2, 32, 32, 3))


# ---------------------------------------------------------------------------
# weight bridge
# ---------------------------------------------------------------------------


def test_params_from_gitax_video_matches_export_state_dict():
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), _weights())
    ref = export_git_state_dict(tree, CFG)
    sd = ckpt.params_from_gitax(tree, CFG, device="cpu").state_dict()
    assert set(sd) == set(ref)
    assert {"img_temperal_embedding.{}".format(i) for i in range(FRAMES)} <= set(sd)
    for key, val in ref.items():
        np.testing.assert_array_equal(sd[key].numpy(), val, err_msg=key)
    # the reference-named state dict loads into a fresh model as is
    fresh = PortModel(CFG, device="cpu")
    fresh.load_state_dict({k: torch.tensor(v) for k, v in ref.items()})
    assert torch.equal(fresh.img_temperal_embedding[1], sd["img_temperal_embedding.1"])


def test_params_from_gitax_rejects_a_temporal_table_that_does_not_fit():
    tree = _np_tree(_weights())
    for bad in (np.zeros((2, 32), np.float32), np.zeros((FRAMES, 16), np.float32)):
        with pytest.raises(ValueError, match="temporal embedding"):
            ckpt.params_from_gitax(dict(tree, img_temporal_embedding=bad), CFG, device="cpu")
    with pytest.raises(ValueError, match="temporal embedding"):
        ckpt.params_from_gitax({k: v for k, v in tree.items() if k != "img_temporal_embedding"},
                               CFG, device="cpu")
    image_cfg = dataclasses.replace(CFG, num_image_with_embedding=0)
    with pytest.raises(ValueError, match="temporal embedding"):
        ckpt.params_from_gitax(tree, image_cfg, device="cpu")


def test_init_params_zeroes_the_temporal_embeddings():
    model = PortModel(CFG, device="cpu").init_params(torch.Generator().manual_seed(0))
    assert len(model.img_temperal_embedding) == FRAMES
    for p in model.img_temperal_embedding:
        assert p.shape == (1, 1, 32) and not p.requires_grad and not p.any()


# ---------------------------------------------------------------------------
# generate with the fused vocab head
# ---------------------------------------------------------------------------

BEAM = dict(num_beams=4, max_steps=10, eos_id=2)


@functools.lru_cache(maxsize=None)
def _gitax_generate(vocab_kernel, cfg=CFG, int8=True):
    params = _weights(cfg)
    if int8:
        params = gx_quantize(params)
    seqs, lp = GitModel(cfg).generate(params, jnp.asarray(_clips(3, seed=5)), beam=GxBeam(**BEAM),
                                      sos_id=1, vocab_kernel=vocab_kernel)
    return np.asarray(seqs), np.asarray(lp)


def _port_model(cfg=CFG, int8=True):
    params = _weights(cfg)
    return ckpt.params_from_gitax(_np_tree(gx_quantize(params) if int8 else params), cfg,
                                  device="cpu")


def _count_head_calls(monkeypatch):
    calls = []
    real = ptextual.vocab_logits_topk

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(ptextual, "vocab_logits_topk", counted)
    return calls


def test_generate_vocab_kernel_matches_gitax(monkeypatch):
    """The port with vocab_kernel=True against gitax with
    vocab_kernel='interpret', and both against their plain heads: tokens
    equal, logprobs within 1e-5; every beam step went through the fused
    head; the prefill logits within 1e-4 of gitax's."""
    model = _port_model()
    clips = torch.from_numpy(_clips(3, seed=5))
    ref_k = _gitax_generate("interpret")
    ref_p = _gitax_generate(False)
    calls = _count_head_calls(monkeypatch)
    model.decode_step_calls = 0
    seqs_k, lp_k = model.generate(clips, beam=BeamSearchConfig(**BEAM), sos_id=1, vocab_kernel=True)
    assert len(calls) == model.decode_step_calls > 0 and calls[0] == (12, 32)
    seqs_p, lp_p = model.generate(clips, beam=BeamSearchConfig(**BEAM), sos_id=1)
    assert 2 * len(calls) == model.decode_step_calls
    for seqs, lp in ((seqs_k, lp_k), (seqs_p, lp_p)):
        for ref_seqs, ref_lp in (ref_k, ref_p):
            np.testing.assert_array_equal(seqs.numpy(), ref_seqs)
            np.testing.assert_allclose(lp.numpy(), ref_lp, atol=1e-5, rtol=1e-5)
    assert len({tuple(r) for r in seqs_k.tolist()}) == 3  # the clips decode differently
    rev = torch.from_numpy(np.ascontiguousarray(_clips(3, seed=5)[:, ::-1]))
    seqs_r, _ = model.generate(rev, beam=BeamSearchConfig(**BEAM), sos_id=1, vocab_kernel=True)
    assert not torch.equal(seqs_r, seqs_k)  # and so does the frame order

    # the prefill over the clip memory, against gitax's
    params = gx_quantize(_weights())
    gx = GitModel(CFG)
    vis = gx.encode_images(params, jnp.asarray(_clips(3, seed=5)))
    prefix = np.ones((3, 1), np.int64)
    ref_lg, _ = gx.prefill(params, vis, jnp.asarray(prefix, jnp.int32), 10)
    with torch.inference_mode():
        lg, _ = model.prefill(model.encode_images(clips), torch.from_numpy(prefix), 10)
    np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), **TOL)


@pytest.mark.parametrize("case", ["fp_head", "small_vocab"])
def test_vocab_kernel_gates_fall_back_to_the_plain_head(case, monkeypatch):
    """gitax's gates (tests/test_vocab_topk.py:105-131): with the fp head,
    or with fewer than max(C, 4) = 8 vocab blocks, vocab_kernel=True runs
    the plain head and gives its tokens; the fused head is never called."""
    cfg = dataclasses.replace(CFG, vocab_size=640) if case == "small_vocab" else CFG
    int8 = case == "small_vocab"
    model = _port_model(cfg, int8=int8)
    assert not model.vocab_kernel_applies(BeamSearchConfig(**BEAM))
    calls = _count_head_calls(monkeypatch)
    seqs, lp = model.generate(torch.from_numpy(_clips(3, seed=5)), beam=BeamSearchConfig(**BEAM),
                              sos_id=1, vocab_kernel=True)
    assert calls == []
    ref_seqs, ref_lp = _gitax_generate(True, cfg, int8)
    np.testing.assert_array_equal(seqs.numpy(), ref_seqs)
    np.testing.assert_allclose(lp.numpy(), ref_lp, **TOL)


def test_decode_step_vocab_kernel_needs_the_int8_head():
    model = _port_model(int8=False)
    with torch.inference_mode():
        _, cache = model.prefill(model.encode_images(torch.from_numpy(_clips(1))),
                                 torch.ones((1, 1), dtype=torch.long), 4)
        with pytest.raises(ValueError, match="int8 output head"):
            model.decode_step(torch.ones(1, dtype=torch.long), cache, vocab_kernel=True)


# ---------------------------------------------------------------------------
# the engine on clip items
# ---------------------------------------------------------------------------

ENGINE_CFG = GitConfig(
    encoder=ViTConfig(16, 64, 2, 2, 32),
    visual_feature_size=64,
    vocab_size=30522,
    hidden_size=48,
    num_layers=2,
    num_heads=4,
    feedforward_size=96,
    max_caption_length=48,
    num_image_with_embedding=2,
)


def _uint8_clips(n, frames=2, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (frames, 32, 32, 3)).astype(np.uint8) for _ in range(n)]


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_caption_engine_on_clips_matches_gitax(int8):
    """uint8 clips [F, H, W, 3] through both engines (3 clips in batches
    of 2: the tail is padded): the same strings."""
    from gitax.preprocess import TestTransform
    from gitax.runtime import CaptionEngine as GxEngine
    from gitax.tokenization import BertTokenizer as GxTokenizer
    from gitax.tokenization import build_tiny_vocab as gx_tiny_vocab
    from gitax_torch.runtime.engine import CaptionEngine
    from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

    params = _weights(ENGINE_CFG, seed=3)
    tok = BertTokenizer(build_tiny_vocab())
    clips = _uint8_clips(3, seed=4)
    prefixes = [[tok.cls_token_id]] * len(clips)
    kw = dict(batch_size=2, max_text_len=8, int8=int8)
    ref = GxEngine(GitModel(ENGINE_CFG), params, GxTokenizer(gx_tiny_vocab()),
                   TestTransform(crop_size=32), dtype=jnp.float32,
                   beam=GxBeam(num_beams=2, max_steps=8), use_native=False, **kw)
    ours = CaptionEngine(ckpt.params_from_gitax(_np_tree(params), ENGINE_CFG, device="cpu"), tok,
                         dtype=torch.float32, beam=BeamSearchConfig(num_beams=2, max_steps=8), **kw)
    want = ref.generate_batch(clips, prefixes)
    got = ours.resolve(ours.dispatch(clips, prefixes))
    assert got == want == ours.generate_batch(clips, prefixes)
    assert all(isinstance(s, str) for s in got)


@pytest.mark.parametrize("items,match", [
    ([np.zeros((32, 32), np.uint8)], "image"),
    ([np.zeros((1, 2, 32, 32, 3), np.uint8)], "image"),
    ([np.zeros((2, 32, 32, 3), np.uint8), np.zeros((32, 32, 3), np.uint8)], "one shape"),
    ([np.zeros((2, 32, 32, 3), np.uint8), np.zeros((3, 32, 32, 3), np.uint8)], "one shape"),
], ids=["rank2", "rank5", "clip_and_image", "two_clip_lengths"])
def test_engine_rejects_items_of_another_rank_or_mixed_shapes(items, match):
    from gitax_torch.runtime.engine import CaptionEngine

    model = ckpt.params_from_gitax(_np_tree(_weights(ENGINE_CFG, seed=3)), ENGINE_CFG, device="cpu")
    eng = CaptionEngine(model, tokenizer=None, dtype=torch.float32)
    with pytest.raises(ValueError, match=match):
        eng.dispatch(items, [[101]] * len(items))
    with pytest.raises(ValueError, match=r"\[B, H, W, 3\] images or \[B, F, H, W, 3\] clips"):
        eng.dispatch_device_batch(np.zeros((1, 1, 2, 32, 32, 3), np.uint8), np.ones((1, 1)))
    with pytest.raises(ValueError, match="dispatch_varshape takes images"):
        eng.dispatch_varshape(_uint8_clips(1), [[101]])
