"""gitax_torch against gitax, module by module (CPU): nn primitives, the
int8 quantization, the zoo configs, the weight bridge, and the port's
import and build boundaries.  The same numpy inputs go through both."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gitax.ckpt.torch_convert import export_git_state_dict
from gitax.models import GitConfig, GitModel, ViTConfig
from gitax.models import config as gx_config
from gitax.models import nn as gnn
from gitax.ops import quant as gquant
from gitax.ops.decode_attention import quantize_memory as gx_quantize_memory
from gitax_torch import ckpt
from gitax_torch.models import config as pt_config
from gitax_torch.models import nn as pnn
from gitax_torch.ops import cuda_build
from gitax_torch.ops import quant as pquant
from gitax_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_cuda,
    quantize_memory,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-4, rtol=1e-4)

SMALL = GitConfig(
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
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def _gitax_tree(seed=0):
    return _np_tree(GitModel(SMALL).init_params(jax.random.PRNGKey(seed)))


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(gx_config.MODEL_ZOO))
def test_zoo_config_equals_gitax(name):
    assert pt_config.get_model_param(name) == gx_config.get_model_param(name)
    ours = pt_config.config_from_param(pt_config.get_model_param(name))
    ref = gx_config.config_from_param(gx_config.get_model_param(name))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.head_dim == ref.head_dim
    assert ours.encoder.num_tokens == ref.encoder.num_tokens


def test_zoo_names_and_encoders_equal_gitax():
    assert pt_config.MODEL_ZOO == gx_config.MODEL_ZOO
    assert {k: dataclasses.asdict(v) for k, v in pt_config.ENCODERS.items()} == {
        k: dataclasses.asdict(v) for k, v in gx_config.ENCODERS.items()
    }


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

TOKENIZER_WORDS = ["a", "man", "riding", "wave", "on", "top", "of", "surfboard",
                   "##s", "##ing", "cafe", "the"]
TOKENIZER_TEXTS = [
    "A man riding a wave on top of a surfboard.",
    "  Cafés, the SURFBOARDS!  ",
    "riding [SEP] the [MASK] wave?",
    "xyzzy's 42 wave-riding, don't",
    "中文 a\tman\nrides \u0000here",
    "",
]


@pytest.mark.parametrize("text", TOKENIZER_TEXTS)
def test_tokenizer_encodes_and_decodes_as_gitax(text):
    from gitax import tokenization as gx_tok
    from gitax_torch import tokenization as pt_tok

    vocab = pt_tok.build_tiny_vocab(TOKENIZER_WORDS)
    assert vocab == gx_tok.build_tiny_vocab(TOKENIZER_WORDS)
    ours, ref = pt_tok.BertTokenizer(vocab), gx_tok.BertTokenizer(vocab)
    assert ours.tokenize(text) == ref.tokenize(text)
    for kw in (dict(), dict(add_special_tokens=True), dict(truncation=True, max_length=4),
               dict(add_special_tokens=True, truncation=True, max_length=5)):
        assert ours.encode(text, **kw) == ref.encode(text, **kw), kw
    assert ours([text, text], truncation=True, max_length=6) == \
        ref([text, text], truncation=True, max_length=6)
    ids = ours.encode(text, add_special_tokens=True) + [0, 100, 103]
    for skip in (False, True):
        assert ours.decode(ids, skip_special_tokens=skip) == ref.decode(ids, skip_special_tokens=skip)
    assert ours.all_special_ids == ref.all_special_ids
    assert (ours.cls_token_id, ours.sep_token_id) == (pt_tok.CLS_ID, pt_tok.SEP_ID)


def test_tokenizer_from_vocab_file_as_gitax(tmp_path):
    from gitax import tokenization as gx_tok
    from gitax_torch import tokenization as pt_tok

    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(pt_tok.build_tiny_vocab(TOKENIZER_WORDS, size=300)) + "\n\n")
    ours = pt_tok.BertTokenizer.from_vocab_file(str(path))
    ref = gx_tok.BertTokenizer.from_vocab_file(str(path))
    assert ours.vocab == ref.vocab and ours.vocab_size == 300
    assert ours.encode(TOKENIZER_TEXTS[0]) == ref.encode(TOKENIZER_TEXTS[0])


# ---------------------------------------------------------------------------
# nn primitives
# ---------------------------------------------------------------------------


def test_layer_norm_matches_gitax():
    x, s, b = _rand((3, 5, 16), 0), _rand((16,), 1), _rand((16,), 2)
    ref = gnn.layer_norm(jnp.asarray(x), {"scale": jnp.asarray(s), "bias": jnp.asarray(b)}, 1e-5)
    ours = pnn.layer_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_linear_matches_gitax(int8):
    x, w, b = _rand((4, 7, 24), 0), _rand((24, 40), 1, 0.1), _rand((40,), 2)
    p = {"kernel": w, "bias": b}
    lin = pnn.Linear(24, 40)
    lin.weight.copy_(torch.from_numpy(w.T))
    lin.bias.copy_(torch.from_numpy(b))
    if int8:
        p = gquant.quantize_linear(p)
        pquant._quantize_module_(lin)
    ref = gnn.linear(jnp.asarray(x), p)
    ours = pnn.linear(torch.from_numpy(x), lin)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", ["quick_gelu", "gelu_erf"])
def test_activations_match_gitax(name):
    x = _rand((64,), 0, 3.0)
    ref = getattr(gnn, name)(jnp.asarray(x))
    ours = getattr(pnn, name)(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_split_merge_heads_match_gitax():
    x = _rand((2, 5, 12), 0)
    ref = gnn.split_heads(jnp.asarray(x), 3)
    ours = pnn.split_heads(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(pnn.merge_heads(ours).numpy(), x)


@pytest.mark.parametrize("fast,masked", [(False, False), (False, True), (True, False)])
def test_attention_weights_match_gitax(fast, masked):
    q, k = _rand((2, 3, 5, 8), 0), _rand((2, 3, 6, 8), 1)
    mask = np.where(_rand((2, 1, 5, 6), 2) > 0.5, -1e18, 0.0).astype(np.float32) if masked else None
    ref = gnn.attention_weights(jnp.asarray(q), jnp.asarray(k),
                                None if mask is None else jnp.asarray(mask), fast=fast)
    ours = pnn.attention_weights(torch.from_numpy(q), torch.from_numpy(k),
                                 None if mask is None else torch.from_numpy(mask), fast=fast)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_self_attention_matches_gitax():
    from gitax_torch.models.vit import MultiheadSelfAttention

    d = 16
    x = _rand((2, 5, d), 0)
    qkv_w, qkv_b = _rand((d, 3 * d), 1, 0.2), _rand((3 * d,), 2, 0.1)
    out_w, out_b = _rand((d, d), 3, 0.2), _rand((d,), 4, 0.1)
    params = {"qkv": {"kernel": qkv_w, "bias": qkv_b}, "out": {"kernel": out_w, "bias": out_b}}
    attn = MultiheadSelfAttention(d)
    attn.in_proj_weight.copy_(torch.from_numpy(qkv_w.T))
    attn.in_proj_bias.copy_(torch.from_numpy(qkv_b))
    attn.out_proj.weight.copy_(torch.from_numpy(out_w.T))
    attn.out_proj.bias.copy_(torch.from_numpy(out_b))
    ref = gnn.self_attention(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, params), 4)
    ours = pnn.self_attention(torch.from_numpy(x), attn, 4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


def _assert_trees_identical(ours, ref, path=""):
    if isinstance(ref, dict):
        assert set(ours) == set(ref), path
        for key in ref:
            _assert_trees_identical(ours[key], ref[key], path + "/" + key)
        return
    a, b = np.asarray(ours), np.asarray(ref)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=path)


def _np_tree_keep(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_quantize_git_params_identical_to_gitax():
    tree = _gitax_tree()
    ref = gquant.quantize_git_params(jax.tree_util.tree_map(jnp.asarray, tree))
    ours = pquant.quantize_git_params(tree)
    _assert_trees_identical(ours["textual"], _np_tree_keep(ref["textual"]))


def test_quantize_model_matches_quantized_tree():
    """Quantizing the port's modules in place gives the int8 values and
    scales of gitax's quantized tree, Linear by Linear."""
    tree = _gitax_tree(1)
    model = pquant.quantize_git_model_(ckpt.params_from_gitax(tree, SMALL, device="cpu"))
    loaded = ckpt.params_from_gitax(
        _np_tree_keep(gquant.quantize_git_params(jax.tree_util.tree_map(jnp.asarray, tree))),
        SMALL, device="cpu",
    )
    sd_a, sd_b = model.state_dict(), loaded.state_dict()
    assert set(sd_a) == set(sd_b)
    assert any(k.endswith("weight_q8_t") for k in sd_a)
    for key in sd_a:
        assert sd_a[key].dtype == sd_b[key].dtype, key
        assert torch.equal(sd_a[key], sd_b[key]), key


@pytest.mark.parametrize("loader", ["quantize_model_in_place", "params_from_quantized_tree"])
def test_int8_weights_are_out_major_from_either_loader(loader):
    """Every int8 Linear, the tied head included, stores its [in, out]
    values out-major (a row-major [out, in] seen transposed), the one
    layout the vocab-head kernel reads, whichever loader filled it."""
    tree = _gitax_tree(2)
    if loader == "quantize_model_in_place":
        model = pquant.quantize_git_model_(ckpt.params_from_gitax(tree, SMALL, device="cpu"))
    else:
        model = ckpt.params_from_gitax(pquant.quantize_git_params(tree), SMALL, device="cpu")
    q8 = {k: t for k, t in model.state_dict().items() if k.endswith("weight_q8_t")}
    assert "textual.output.weight_q8_t" in q8 and len(q8) > 1
    for key, t in q8.items():
        assert t.dtype == torch.int8 and t.t().is_contiguous(), (key, t.stride())
    head = model.textual.output.weight_q8_t
    assert head.shape == (SMALL.hidden_size, SMALL.vocab_size)


def test_quantize_memory_identical_to_gitax():
    mem = _rand((2, 3, 7, 16), 0)
    q_ref, s_ref = gx_quantize_memory(jnp.asarray(mem))
    q, s = quantize_memory(torch.from_numpy(mem))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


# ---------------------------------------------------------------------------
# weight bridge
# ---------------------------------------------------------------------------


def test_params_from_gitax_matches_export_state_dict():
    tree = _gitax_tree(2)
    ref = export_git_state_dict(tree, SMALL)
    sd = ckpt.params_from_gitax(tree, SMALL, device="cpu").state_dict()
    assert set(sd) == set(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(sd[key].numpy(), val, err_msg=key)


def test_state_dict_round_trips_through_load_state_dict():
    """The reference-named state dict loads into a fresh model as is."""
    from gitax_torch.models.git import GitModel as PortModel

    tree = _gitax_tree(3)
    ref = {k: torch.tensor(v) for k, v in export_git_state_dict(tree, SMALL).items()}
    model = PortModel(SMALL, device="cpu")
    model.load_state_dict(ref)
    assert model.textual.output.weight is model.textual.embedding.words.weight
    for key, val in model.state_dict().items():
        assert torch.equal(val, ref[key]), key


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device, GitModel and params_from_gitax ask for the CUDA
    card: without one they raise rather than build on the CPU, and where
    torch reports a card the parameters are asked for on `cuda` (which a
    CPU-only torch refuses)."""
    from gitax_torch.models.git import GitModel as PortModel
    from gitax_torch.models.git import resolve_device

    tree = _gitax_tree(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: PortModel(SMALL), lambda: ckpt.params_from_gitax(tree, SMALL)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    with pytest.raises(AssertionError, match="CUDA"):
        PortModel(SMALL)


# ---------------------------------------------------------------------------
# boundaries: no jax, no fallback
# ---------------------------------------------------------------------------


def test_port_imports_no_jax():
    """Importing every gitax_torch module leaves jax and every module of
    the gitax package out of sys.modules."""
    mods = []
    for root, _, files in os.walk(os.path.join(REPO, "gitax_torch")):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").replace(".__init__", ""))
    code = (
        "import importlib, sys\n"
        "for m in {!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m == 'gitax' or m.startswith('gitax.'))\n"
        "print(len({!r}), bad)\n"
        "assert not bad, bad\n"
    ).format(sorted(mods), mods)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(mods) >= 16
    # every kernel module, the vocab head's included
    assert {"gitax_torch.ops.decode_attention", "gitax_torch.ops.flash_attention",
            "gitax_torch.ops.vocab_topk", "gitax_torch.models.git",
            "gitax_torch.runtime.serving", "gitax_torch.serve",
            "gitax_torch.models.resnet", "gitax_torch.models.clip",
            "gitax_torch.ckpt.clip_archive", "gitax_torch.native",
            "gitax_torch.decode.device_loop"} <= set(mods)


def test_port_sources_never_import_jax():
    sources = [os.path.join(root, f)
               for root, _, files in os.walk(os.path.join(REPO, "gitax_torch"))
               for f in files if f.endswith(".py")]
    assert {os.path.join(REPO, "gitax_torch", "ops", name + ".py")
            for name in ("decode_attention", "flash_attention", "vocab_topk")} <= set(sources)
    assert os.path.join(REPO, "gitax_torch", "decode", "device_loop.py") in sources
    assert {os.path.join(REPO, "gitax_torch", "runtime", "serving.py"),
            os.path.join(REPO, "gitax_torch", "serve.py")} <= set(sources)
    for path in sources + [os.path.join(REPO, "chip_smoke.py")]:
        text = open(path).read()
        for banned in ("import jax", "from jax", "import gitax\n", "import gitax.",
                       "from gitax ", "from gitax."):
            assert banned not in text, (path, banned)


def _cpu_inputs():
    b, k, h, dh, m, t = 2, 2, 2, 8, 5, 4
    return dict(
        q=torch.zeros(b * k, h * dh), kv_new=torch.zeros(b * k, h * 2 * dh),
        txt_kv=torch.zeros(t, b * k, h * 2 * dh), anc=torch.zeros(b * k, t, dtype=torch.int32),
        pos=1, mem_kv=torch.zeros(b, h, m, 2 * dh),
    ), dict(beams=k, num_heads=h, head_dim=dh)


def test_cuda_entry_raises_on_cpu_tensors():
    args, kw = _cpu_inputs()
    with pytest.raises(ValueError, match="CUDA device"):
        decode_attention_cuda(**args, **kw)


def test_public_entry_runs_plain_version_on_cpu_without_launching():
    args, kw = _cpu_inputs()
    before = decode_attention.launches
    ctx = decode_attention(**args, **kw)
    assert ctx.shape == (4, 16) and decode_attention.launches == before


def test_missing_nvcc_raises_clear_error(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("decode_attention")
    assert not (tmp_path / "build").exists()
