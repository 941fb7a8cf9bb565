"""The CLIP towers of the port against gitax's (CPU, f32): CLIP's
ModifiedResNet (`models/resnet.py`), the text tower and
`clip_similarity` (`models/clip.py`), the ViT's image-embedding mode
(`vit_forward(output_grid=False)` with `proj`), the visual-config
inference and the loaders (`ckpt`), and the CLIP archive loader
(`ckpt/clip_archive.py`) on synthesised archives.

Every case draws one reference-named state dict from a numpy seed; gitax
converts it with its own converters, the port loads it by name (and, for
the ResNet and the text tower, also from gitax's numpy tree).  The
reference's CLIP class is absent here, so the archives are written by
`clip_archive.save_clip_archive` (a scripted module tree holding CLIP's
keys and the three int buffers), which both loaders read.
"""

import dataclasses
import os.path as op

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gitax.ckpt.clip_archive as gx_archive
from gitax.ckpt import torch_convert as gx_convert
from gitax.models import clip as gx_clip
from gitax.models import resnet as gx_resnet
from gitax.models.config import ViTConfig as GxViT
from gitax.models.vit import vit_forward as gx_vit_forward
from gitax.ops.interp import resize_pos_embed_grid
from gitax_torch import ckpt
from gitax_torch.ckpt import clip_archive
from gitax_torch.models import clip, resnet
from gitax_torch.models.config import ViTConfig
from gitax_torch.models.vit import VisualTransformer, vit_forward

RN = resnet.ResNetConfig(layers=(1, 1, 1, 1), width=8, output_dim=32, heads=4,
                         input_resolution=32)
TXT = clip.CLIPTextConfig(context_length=16, vocab_size=100, width=32, heads=2, layers=2)
# an archive's text tower: the loaders infer heads = width // 64
TXT_ARCHIVE = dataclasses.replace(TXT, width=64, heads=1)
VIT = ViTConfig(patch_size=16, width=64, layers=2, heads=1, input_resolution=96)
EMBED = 24
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(t):
    return np.asarray(t.detach().float().numpy() if hasattr(t, "detach") else t, np.float32)


def random_state_dict(module, seed, prefix=""):
    """A reference-named state dict for `module`'s keys from a numpy seed:
    He-normal convs, BatchNorm weights U(0.5, 1.5), running means U(-0.3,
    0.3), running variances U(0.7, 1.4), LayerNorm weights around 1,
    other matrices N(0, 1/fan_in), vectors and scalars N(0, 0.05)."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, t in module.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("running_var"):
            v = rng.uniform(0.7, 1.4, shape)
        elif name.endswith("running_mean"):
            v = rng.uniform(-0.3, 0.3, shape)
        elif ".bn" in "." + name or "downsample.1" in name:
            v = rng.uniform(0.5, 1.5, shape) if name.endswith("weight") else \
                rng.uniform(-0.1, 0.1, shape)
        elif len(shape) >= 2:
            fan_in = int(np.prod(shape[1:])) if len(shape) == 4 else shape[-1]
            std = (2.0 / fan_in) ** 0.5 if len(shape) == 4 else fan_in ** -0.5
            v = rng.randn(*shape) * std
        elif ("ln" in name or name.startswith("ln")) and name.endswith("weight"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:
            v = 0.05 * rng.randn(*shape)
        out[prefix + name] = torch.from_numpy(np.asarray(v, np.float32))
    return out


def images(seed, n=2, size=32):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def tokens(seed, n=3, t=10):
    """Token rows with the EOT (the highest id) in each; the last row holds
    it twice, where the first position must pool."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(1, TXT.vocab_size - 1, (n, t))
    for i, pos in enumerate(rng.randint(2, t, n)):
        tok[i, pos] = TXT.vocab_size - 1
    tok[-1, 3] = tok[-1, 7] = TXT.vocab_size - 1
    return tok


# ---------------------------------------------------------------------------
# ModifiedResNet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rn_sd():
    return random_state_dict(resnet.ModifiedResNet(RN, device="cpu"), 0)


@pytest.mark.parametrize("mode,size", [("grid", 32), ("grid", 64), ("pooled", 32)])
@pytest.mark.parametrize("source", ["state_dict", "gitax_tree"])
def test_resnet_matches_gitax(rn_sd, mode, size, source):
    """Grid tokens [B, (H/32)*(W/32), width*32] and the attention pool's
    [B, output_dim] within 1e-4 of gitax's `resnet_forward`, the port's
    model loaded by reference names or from gitax's numpy tree."""
    tree = gx_resnet.convert_resnet_state_dict(rn_sd, RN)
    if source == "state_dict":
        model = ckpt.load_resnet_state_dict(resnet.ModifiedResNet(RN, device="cpu"), rn_sd)
    else:
        model = ckpt.resnet_params_from_gitax(tree, RN, device="cpu")
    x = images(size, size=size)
    grid = mode == "grid"
    want = np.asarray(gx_resnet.resnet_forward(tree, jnp.asarray(x), RN, output_grid=grid))
    with torch.no_grad():
        got = resnet.resnet_forward(model, torch.from_numpy(x), output_grid=grid).numpy()
    assert got.shape == want.shape == ((2, (size // 32) ** 2, RN.embed_dim) if grid
                                       else (2, RN.output_dim))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(want).max() > 0.1


def test_resnet_state_dict_keys_are_the_references(rn_sd):
    """The port's names are the reference ModifiedResNet's (less BatchNorm's
    `num_batches_tracked`, which the loader drops); a reference state dict
    with it loads."""
    keys = set(rn_sd)
    assert {"conv1.weight", "bn3.running_var", "layer2.0.downsample.0.weight",
            "layer2.0.downsample.1.running_mean", "attnpool.positional_embedding",
            "attnpool.c_proj.bias"} <= keys
    with_tracked = dict(rn_sd, **{"bn1.num_batches_tracked": torch.tensor(3)})
    model = ckpt.load_resnet_state_dict(resnet.ModifiedResNet(RN, device="cpu"),
                                        {"visual." + k: v for k, v in with_tracked.items()},
                                        "visual.")
    assert torch.equal(model.bn1.running_var, rn_sd["bn1.running_var"])


# ---------------------------------------------------------------------------
# the text tower and the similarity head
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def text_sd():
    sd = random_state_dict(clip.TextTransformer(TXT, EMBED, device="cpu"), 1)
    sd["logit_scale"] = torch.tensor(np.log(1 / 0.07), dtype=torch.float32)
    return sd


@pytest.mark.parametrize("source", ["state_dict", "gitax_tree"])
def test_text_tower_and_similarity_match_gitax(text_sd, source):
    """`text_forward` (causal blocks, pooled at the first EOT) and
    `clip_similarity` within 1e-4 of gitax's."""
    tree = gx_clip.convert_clip_text_state_dict(text_sd, TXT)
    if source == "state_dict":
        model = ckpt.load_clip_text_state_dict(clip.TextTransformer(TXT, EMBED, device="cpu"),
                                               text_sd)
    else:
        model = ckpt.clip_text_params_from_gitax(tree, TXT, device="cpu")
    tok = tokens(2)
    want = np.asarray(gx_clip.text_forward(tree, jnp.asarray(tok, jnp.int32), TXT))
    with torch.no_grad():
        got = clip.text_forward(model, torch.from_numpy(tok)).numpy()
    assert got.shape == want.shape == (3, EMBED)
    np.testing.assert_allclose(got, want, **TOL)
    feats = images(3, n=2).reshape(2, -1)[:, :EMBED]
    gx_pi, gx_pt = gx_clip.clip_similarity(jnp.asarray(feats), jnp.asarray(want),
                                           jnp.asarray(tree["logit_scale"]))
    pi, pt = clip.clip_similarity(torch.from_numpy(feats), torch.from_numpy(got),
                                  model.logit_scale)
    np.testing.assert_allclose(pi.numpy(), np.asarray(gx_pi), **TOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(gx_pt), **TOL)


def test_text_tower_pools_at_the_first_eot(text_sd):
    """A row with two EOT tokens pools at the first: the causal tower's
    output there does not see the tokens after it."""
    model = ckpt.load_clip_text_state_dict(clip.TextTransformer(TXT, EMBED, device="cpu"),
                                           text_sd)
    tok = torch.from_numpy(tokens(2))
    changed = tok.clone()
    changed[-1, 4:7] = 5  # between the two EOTs
    with torch.no_grad():
        a, b = clip.text_forward(model, tok), clip.text_forward(model, changed)
    assert torch.equal(a[-1], b[-1]) and not torch.equal(a[0], a[1])


# ---------------------------------------------------------------------------
# the ViT's image embedding, the visual config
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vit_sd():
    return random_state_dict(VisualTransformer(VIT, "cpu", torch.float32, output_dim=EMBED), 4)


@pytest.mark.parametrize("with_proj", [True, False])
def test_vit_image_embedding_matches_gitax(vit_sd, with_proj):
    """vit_forward(output_grid=False): ln_post on the class token, then
    `proj` where the state dict carries it (gitax vit.py:163-169; gitax's
    converter leaves `proj` out, so gitax's side adds it to its tree)."""
    sd = {"visual." + k: v for k, v in vit_sd.items() if with_proj or k != "proj"}
    kind, cfg, vit = ckpt.load_clip_visual(sd, device="cpu")
    assert kind == "vit" and cfg == VIT and (vit.proj is not None) == with_proj
    tree = gx_convert.convert_vit_state_dict(sd, GxViT(**dataclasses.asdict(VIT)), "visual.")
    if with_proj:
        tree["proj"] = _np(sd["visual.proj"])
    x = images(5, size=96)
    want = np.asarray(gx_vit_forward(tree, jnp.asarray(x), GxViT(**dataclasses.asdict(VIT)),
                                     output_grid=False))
    with torch.no_grad():
        got = vit_forward(vit, torch.from_numpy(x), output_grid=False).numpy()
        grid = vit_forward(vit, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, EMBED if with_proj else VIT.width)
    np.testing.assert_allclose(got, want, **TOL)
    assert grid.shape == (2, VIT.num_tokens, VIT.width)  # GIT's grid mode as before


@pytest.mark.parametrize("tower", ["vit", "resnet"])
def test_infer_visual_config_matches_gitax(tower, vit_sd, rn_sd):
    sd = {"visual." + k: v for k, v in (vit_sd if tower == "vit" else rn_sd).items()}
    kind, cfg = ckpt.infer_visual_config(sd)
    gx_kind, gx_cfg = gx_convert.infer_visual_config(sd)
    assert kind == gx_kind == tower
    assert dataclasses.asdict(cfg) == dataclasses.asdict(gx_cfg)
    if tower == "resnet":
        assert cfg == RN


# ---------------------------------------------------------------------------
# CLIP archives
# ---------------------------------------------------------------------------


def clip_state_dict(tower, vit_sd, rn_sd, text_sd):
    visual = vit_sd if tower == "vit" else dict(rn_sd, **{
        "bn1.num_batches_tracked": torch.tensor(0)})  # as a reference archive carries it
    sd = {"visual." + k: v for k, v in visual.items()}
    sd.update(text_sd)
    return sd


@pytest.fixture(scope="module")
def archives(tmp_path_factory, vit_sd, rn_sd):
    """A ViT and a ResNet archive, named as the published downloads
    (ViT-B/16 and RN50) so that the pins apply, and an unpinned copy."""
    root = tmp_path_factory.mktemp("clip")
    text_sd = random_state_dict(clip.TextTransformer(TXT_ARCHIVE, EMBED, device="cpu"), 6)
    text_sd["logit_scale"] = torch.tensor(2.5)
    out = {}
    for tower, name, res in (("vit", "ViT-B-16.pt", VIT.input_resolution),
                             ("resnet", "RN50.pt", RN.input_resolution)):
        out[tower] = clip_archive.save_clip_archive(
            str(root / name), clip_state_dict(tower, vit_sd, rn_sd, text_sd), res,
            TXT.context_length, TXT.vocab_size)
    out["unpinned"] = clip_archive.save_clip_archive(
        str(root / "mine.pt"), clip_state_dict("vit", vit_sd, rn_sd, text_sd),
        VIT.input_resolution, TXT.context_length, TXT.vocab_size)
    return out


def test_archive_pins_and_roots_equal_gitax():
    assert clip_archive.CLIP_ARCHIVE_SHA256 == gx_archive.CLIP_ARCHIVE_SHA256
    assert clip_archive.DEFAULT_ROOTS == gx_archive.DEFAULT_ROOTS


def test_resolve_archive_searches_the_roots(archives, tmp_path):
    root = op.dirname(archives["vit"])
    for resolve in (clip_archive.resolve_archive, gx_archive.resolve_archive):
        path, pin = resolve("ViT-B/16", roots=(str(tmp_path), root))
        assert path == archives["vit"] and pin == clip_archive.CLIP_ARCHIVE_SHA256["ViT-B/16"]
        assert resolve(archives["unpinned"]) == (archives["unpinned"], None)
        with pytest.raises(FileNotFoundError):
            resolve("ViT-L/14", roots=(str(tmp_path),))
        with pytest.raises(FileNotFoundError):
            resolve("NOT-A-MODEL", roots=(str(tmp_path),))


@pytest.mark.parametrize("which,match", [("vit", "sha256 mismatch"),
                                         ("unpinned", "no published sha256 pin")])
def test_strict_refuses_before_loading(archives, monkeypatch, which, match):
    """'strict' raises on mismatched or unpinned bytes, and torch.jit.load
    is never reached; 'warn' loads them."""
    def no_load(*a, **kw):
        raise AssertionError("torch.jit.load reached unverified bytes")

    with monkeypatch.context() as mp:
        mp.setattr(torch.jit, "load", no_load)
        with pytest.raises(ValueError, match=match):
            clip_archive.load_clip_archive(archives[which], device="cpu")
    loaded = clip_archive.load_clip_archive(archives[which], verify="warn", device="cpu")
    assert loaded["sha256_verified"] is False
    assert clip_archive.load_clip_archive(archives[which], verify=False,
                                          device="cpu")["sha256_verified"] is False


@pytest.mark.parametrize("tower", ["vit", "resnet"])
def test_archive_loads_as_gitax_loads_it(archives, tower):
    """Configs equal gitax's; the port's modules, put through gitax's own
    converters, give gitax's trees leaf for leaf; the towers' outputs
    agree within 1e-4."""
    ours = clip_archive.load_clip_archive(archives[tower], verify="warn", device="cpu")
    theirs = gx_archive.load_clip_archive(archives[tower], verify="warn")
    for key in ("visual_kind", "input_resolution", "sha256_verified"):
        assert ours[key] == theirs[key], key
    for key in ("visual_config", "text_config"):
        assert dataclasses.asdict(ours[key]) == dataclasses.asdict(theirs[key]), key
    vsd = ours["visual"].state_dict()
    if tower == "vit":
        mine = gx_convert.convert_vit_state_dict(vsd, theirs["visual_config"], "")
        assert torch.equal(ours["visual"].proj, archives_proj(archives, tower))
    else:
        mine = gx_resnet.convert_resnet_state_dict(vsd, theirs["visual_config"])
    assert_trees_equal(mine, theirs["visual"])
    assert_trees_equal(gx_clip.convert_clip_text_state_dict(ours["text"].state_dict(),
                                                            theirs["text_config"]),
                       theirs["text"])
    tok = tokens(7)
    with torch.no_grad():
        got = clip.text_forward(ours["text"], torch.from_numpy(tok)).numpy()
    want = gx_clip.text_forward(theirs["text"], jnp.asarray(tok, jnp.int32),
                                theirs["text_config"])
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def archives_proj(archives, tower):
    return torch.jit.load(archives[tower]).state_dict()["visual.proj"]


def assert_trees_equal(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in b:
            assert_trees_equal(a[k], b[k], path + "/" + k)
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, "{}/{}".format(path, i))
    else:
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=path)


@pytest.mark.parametrize("resolution", [128, 160])
def test_image_encoder_resize_matches_gitax(archives, resolution):
    """load_image_encoder_from_archive at a new resolution: the positional
    table within 1e-6 of gitax's `resize_pos_embed_grid`, and GIT's grid
    encode within 1e-4 of gitax's on the same images."""
    cfg, vit = clip_archive.load_image_encoder_from_archive(archives["vit"], resolution,
                                                            verify="warn", device="cpu")
    gx_cfg, gx_params = gx_archive.load_image_encoder_from_archive(archives["vit"], resolution,
                                                                   verify="warn")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(gx_cfg)
    assert cfg.grid == resolution // VIT.patch_size and vit.proj is not None
    pos = vit.positional_embedding.numpy()
    np.testing.assert_allclose(pos, gx_params["positional_embedding"], rtol=0, atol=1e-6)
    base = torch.jit.load(archives["vit"]).state_dict()["visual.positional_embedding"].numpy()
    np.testing.assert_allclose(pos, resize_pos_embed_grid(base, VIT.grid, (cfg.grid, cfg.grid)),
                               rtol=0, atol=1e-6)
    x = images(8, size=resolution)
    with torch.no_grad():
        got = vit_forward(vit, torch.from_numpy(x)).numpy()
    want = np.asarray(gx_vit_forward(gx_params, jnp.asarray(x), gx_cfg))
    np.testing.assert_allclose(got, want, **TOL)


def test_resnet_archive_refuses_the_resize(archives):
    with pytest.raises(ValueError, match="ViT encoders"):
        clip_archive.load_image_encoder_from_archive(archives["resnet"], 64, verify="warn",
                                                     device="cpu")


def test_towers_default_to_the_card(monkeypatch, archives):
    """With no device the new entry points ask for the CUDA card and raise
    without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: resnet.ModifiedResNet(RN), lambda: clip.TextTransformer(TXT, EMBED),
                  lambda: clip_archive.load_clip_archive(archives["vit"], verify="warn")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
