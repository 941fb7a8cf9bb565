"""The w8a8 encoder (gitax's `quantize_git_params(params, encoder=True)`)
in the port against gitax on the same numpy inputs (CPU, f32).

* `ops/quant.py`: the quantized tree equals gitax's leaf for leaf; a
  `GitModel` quantized in place holds the same codes and scales as
  `params_from_gitax` of gitax's w8a8 tree;
* `ops/int8_dynamic.py`: the per-row codes and scales equal gitax's bit for
  bit (ties at half a step included), a w8a8 `linear` is within 1e-6
  relative of gitax's `linear` with `kernel_q8_dyn`, and the epilogue's
  order of rounding is gitax's;
* the encoder within 1e-4, and `generate`'s tokens equal to gitax's in f32,
  on gitax's test_quant.py weights and on image-dependent ones;
* the split rule of the w8a8 leaves equals gitax's exact-leaf partition
  specs; training refuses a w8a8 model, and the product refuses autograd.

The CUDA kernels run only on the card (`chip_smoke.py` holds them to
these plain versions); here a CPU tensor takes the plain version and no
launch is counted.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gitax.decode import BeamSearchConfig as GxBeam
from gitax.models import GitConfig, GitModel, ViTConfig
from gitax.models.nn import _int8_dynamic_matmul as gx_int8_dynamic_matmul
from gitax.models.nn import linear as gx_linear
from gitax.models.vit import vit_forward as gx_vit_forward
from gitax.ops.quant import quantize_git_params as gx_quantize_git_params
from gitax.ops.quant import quantize_linear_dyn as gx_quantize_linear_dyn
from gitax.parallel import param_partition_specs
from gitax_torch import ckpt
from gitax_torch.decode.beam import BeamSearchConfig
from gitax_torch.models.nn import Linear, linear
from gitax_torch.models.vit import vit_forward
from gitax_torch.ops import int8_dynamic as i8
from gitax_torch.ops import quant
from gitax_torch.parallel import mesh as pmesh
from test_torch_port_slice import _weights as slice_weights
from test_torch_port_slice import CFG as SLICE_CFG

# gitax tests/test_quant.py's CFG
CFG = GitConfig(encoder=ViTConfig(16, 64, 2, 2, 32), visual_feature_size=64, vocab_size=64,
                hidden_size=48, num_layers=2, num_heads=4, feedforward_size=96,
                max_caption_length=64)


def np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def sharpened():
    """gitax test_quant.py:128-143's weights: word table x30."""
    params = GitModel(CFG).init_params(jax.random.PRNGKey(10))
    params["textual"]["embedding"]["words"] = params["textual"]["embedding"]["words"] * 30.0
    return np_tree(params)


def layer(seed=0, k=64, n=96):
    rng = np.random.RandomState(seed)
    return {"kernel": rng.randn(k, n).astype(np.float32) * 0.1,
            "bias": rng.randn(n).astype(np.float32) * 0.1}


def port_linear(p, dynamic=True):
    lin = Linear(*p["kernel"].shape, device="cpu")
    q = quant.quantize_linear_dyn(p)
    lin.set_int8(torch.from_numpy(q["kernel_q8_dyn"]), torch.from_numpy(q["kernel_scale"]),
                 dynamic=dynamic)
    lin.bias.copy_(torch.from_numpy(p["bias"]))
    return lin


def test_quantized_trees_equal_gitax_leaf_for_leaf():
    params = sharpened()
    ours = quant.quantize_git_params(params, encoder=True)
    theirs = np_tree(gx_quantize_git_params(params, encoder=True))
    flat_ours = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_theirs = dict(jax.tree_util.tree_flatten_with_path(theirs)[0])
    assert len(flat_ours) == len(flat_theirs)
    for path, leaf in flat_ours:
        want = flat_theirs[path]
        assert np.asarray(leaf).dtype == want.dtype, path
        np.testing.assert_array_equal(np.asarray(leaf), want, err_msg=str(path))
    assert "kernel_q8_dyn" in ours["image_encoder"]["blocks"]["mlp"]["c_fc"]
    # weight-only stays the default, as in gitax
    assert "kernel" in quant.quantize_git_params(params)["image_encoder"]["blocks"]["mlp"]["c_fc"]


def test_model_quantized_in_place_equals_gitax_w8a8_tree():
    """`quantize_git_model_(encoder=True)` of the fp model and
    `params_from_gitax` of gitax's w8a8 tree: the same buffers, bit for
    bit, the same dynamic tags."""
    params = sharpened()
    ours = quant.quantize_git_model_(ckpt.params_from_gitax(params, CFG, device="cpu"),
                                     encoder=True)
    carried = ckpt.params_from_gitax(np_tree(gx_quantize_git_params(params, encoder=True)), CFG,
                                     device="cpu")
    a, b = ours.state_dict(), carried.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    blk = ours.image_encoder.transformer.resblocks[0]
    assert "attn.in_proj_weight" not in dict(blk.named_parameters())
    assert blk.attn.in_proj_q8_t.dtype == torch.int8 and blk.attn.in_proj_q8_t.t().is_contiguous()
    for m in (ours, carried):
        for blk in m.image_encoder.transformer.resblocks:
            assert blk.attn.quantized
            assert all(lin.dynamic for lin in (blk.attn.out_proj, blk.mlp.c_fc, blk.mlp.c_proj))
        assert not any(lin.dynamic for layer_ in m.textual.layers() for lin in layer_.linears())


def test_row_codes_equal_gitax_with_ties():
    """Per-row codes and scales, rows of every magnitude, with values at
    exactly half a step (round half to even) and an all-zero row."""
    rng = np.random.RandomState(1)
    x = (rng.randn(6, 64) * np.array([1e-3, 0.1, 1, 10, 100, 0])[:, None]).astype(np.float32)
    # amax 127: a_scale is exactly 1, and the row holds exact half steps
    x[2] = np.clip(x[2], -100, 100)
    x[2, :8] = np.array([127, -127, 63.5, -63.5, 0.5, -0.5, 1.5, 2.5], np.float32)
    q, a_scale = i8.quantize_rows_reference(torch.from_numpy(x))
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    want_scale = np.maximum(amax, np.float32(1e-12)) / np.float32(127.0)
    want = np.clip(np.round(x / want_scale), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(a_scale.numpy(), want_scale[:, 0])
    np.testing.assert_array_equal(q.numpy(), want)
    # gitax's own codes through its jitted matmul against an identity kernel
    eye = jnp.eye(64, dtype=jnp.int8)
    y = gx_int8_dynamic_matmul(jnp.asarray(x), eye, jnp.ones(64, jnp.float32))
    np.testing.assert_array_equal(np.asarray(y), (q.float() * a_scale[:, None]).numpy())
    assert a_scale[2] == 1.0 and q.numpy()[2, :8].tolist() == [127, -127, 64, -64, 0, 0, 2, 2]


@pytest.mark.parametrize("shape", [(3, 5, 64), (40, 64)])
def test_linear_matches_gitax(shape):
    p = layer(2)
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    want = np.asarray(gx_linear(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                                 gx_quantize_linear_dyn(p).items()}))
    launches = (i8.quantize_rows.launches, i8.scale_rows.launches)
    got = linear(torch.from_numpy(x), port_linear(p)).numpy()
    assert (i8.quantize_rows.launches, i8.scale_rows.launches) == launches  # the plain path
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # the weight-only form of the same codes is another function
    assert not np.allclose(linear(torch.from_numpy(x), port_linear(p, dynamic=False)).numpy(),
                           want, rtol=1e-6, atol=0)


def test_epilogue_rounds_as_gitax_in_bf16():
    """bf16: the product's scales in f32, one rounding to bf16, then the
    bias added in bf16 (gitax nn.py:69-70, :48-49): the same bf16 values."""
    p = layer(4)
    x = np.random.RandomState(5).randn(16, 64).astype(np.float32)
    q = gx_quantize_linear_dyn(p)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(gx_linear(xb, {k: jnp.asarray(v) for k, v in q.items()}).astype(jnp.float32))
    got = linear(torch.from_numpy(x).bfloat16(), port_linear(p)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_encoder_matches_gitax():
    params = sharpened()
    img = np.random.RandomState(9).randn(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(gx_vit_forward(gx_quantize_git_params(params, encoder=True)["image_encoder"],
                                     jnp.asarray(img), CFG.encoder))
    model = quant.quantize_git_model_(ckpt.params_from_gitax(params, CFG, device="cpu"),
                                      encoder=True)
    got = vit_forward(model.image_encoder, torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # both sides moved off the fp encoder by the same quantization
    fp = np.asarray(gx_vit_forward(params["image_encoder"], jnp.asarray(img), CFG.encoder))
    assert np.abs(fp - want).max() > 1e-3


@pytest.mark.parametrize("weights", ["test_quant", "image_dependent"])
def test_generate_tokens_equal_gitax(weights):
    """beam search through the w8a8 encoder and the weight-only decoder:
    gitax's tokens, in f32, on gitax test_quant.py's weights and on the
    slice test's image-dependent ones."""
    if weights == "test_quant":
        cfg, params, sos, eos = CFG, sharpened(), 1, 2
    else:
        cfg, params, sos, eos = SLICE_CFG, np_tree(slice_weights()[0]), 1, 2
    img = np.random.RandomState(11).randn(4, 32, 32, 3).astype(np.float32)
    qparams = gx_quantize_git_params(params, encoder=True)
    want, _ = GitModel(cfg).generate(jax.tree_util.tree_map(jnp.asarray, qparams),
                                     jnp.asarray(img), beam=GxBeam(num_beams=4, max_steps=10,
                                                                   eos_id=eos), sos_id=sos)
    model = quant.quantize_git_model_(ckpt.params_from_gitax(params, cfg, device="cpu"),
                                      encoder=True)
    got, _ = model.generate(torch.from_numpy(img), beam=BeamSearchConfig(num_beams=4, max_steps=10,
                                                                        eos_id=eos), sos_id=sos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if weights == "image_dependent":
        assert len({tuple(r) for r in got.tolist()}) > 1


def test_w8a8_split_rule_matches_gitax_exact_leaf_specs():
    """Every w8a8 leaf of gitax's encoder gets its partition spec's kind in
    the port's rule: the codes as the fp weight (the fused qkv by heads),
    the scales with a column-parallel layer and replicated for a
    row-parallel one."""
    specs = param_partition_specs(np_tree(gx_quantize_git_params(sharpened(), encoder=True)))
    blocks = specs["image_encoder"]["blocks"]

    def kind(spec):
        parts = tuple(spec)
        return None if "model" not in parts else ("column" if parts[-1] == "model" else "row")

    want = {"attn.in_proj_q8_t": kind(blocks["attn"]["qkv"]["kernel_q8_dyn"]),
            "attn.in_proj_scale": kind(blocks["attn"]["qkv"]["kernel_scale"]),
            "attn.out_proj.weight_q8_t": kind(blocks["attn"]["out"]["kernel_q8_dyn"]),
            "attn.out_proj.weight_scale": kind(blocks["attn"]["out"]["kernel_scale"]),
            "mlp.c_fc.weight_q8_t": kind(blocks["mlp"]["c_fc"]["kernel_q8_dyn"]),
            "mlp.c_fc.weight_scale": kind(blocks["mlp"]["c_fc"]["kernel_scale"]),
            "mlp.c_proj.weight_q8_t": kind(blocks["mlp"]["c_proj"]["kernel_q8_dyn"]),
            "mlp.c_proj.weight_scale": kind(blocks["mlp"]["c_proj"]["kernel_scale"])}
    port = {pmesh.COLUMN: "column", pmesh.QKV: "column", pmesh.ROW: "row", None: None}
    model = quant.quantize_git_model_(ckpt.params_from_gitax(sharpened(), CFG, device="cpu"),
                                      encoder=True)
    names = [n for n, _ in model.named_buffers() if n.startswith("image_encoder.transformer.")]
    assert len(names) == 8 * CFG.encoder.layers
    for name in names:
        local = name.split(".", 4)[-1]
        assert port[pmesh.split_rule(name)] == want[local], name
    assert pmesh.split_rule("image_encoder.transformer.resblocks.0.attn.in_proj_q8_t") == pmesh.QKV


def test_w8a8_shards_reassemble_the_one_card_layers():
    """`shard_for_inference` on [1, 2]: the fused qkv's codes and scales
    split by heads (each third's rows), c_fc by columns, c_proj's codes by
    rows with its scales whole; every shard stays out-major."""
    def quantized():
        return quant.quantize_git_model_(ckpt.params_from_gitax(sharpened(), CFG, device="cpu"),
                                         encoder=True)

    full = quantized().image_encoder.transformer.resblocks[0]
    shards = []
    for rank in range(2):
        model = pmesh.shard_for_inference(quantized(), pmesh.Mesh(data=1, model=2, rank=rank,
                                                                   device="cpu"))
        shards.append(model.image_encoder.transformer.resblocks[0])
        for q in (shards[-1].attn.in_proj_q8_t, shards[-1].mlp.c_proj.weight_q8_t):
            assert q.dtype == torch.int8 and q.t().is_contiguous()
    d = full.attn.in_proj_q8_t.shape[0]
    thirds = [torch.cat([s.attn.in_proj_q8_t[:, j * d // 2:(j + 1) * d // 2] for s in shards], 1)
              for j in range(3)]
    assert torch.equal(torch.cat(thirds, 1), full.attn.in_proj_q8_t)
    assert torch.equal(torch.cat([s.mlp.c_fc.weight_scale for s in shards]),
                       full.mlp.c_fc.weight_scale)
    assert torch.equal(torch.cat([s.mlp.c_proj.weight_q8_t for s in shards], 0),
                       full.mlp.c_proj.weight_q8_t)
    assert all(torch.equal(s.mlp.c_proj.weight_scale, full.mlp.c_proj.weight_scale)
               for s in shards)


def test_w8a8_is_an_inference_format():
    model = quant.quantize_git_model_(ckpt.params_from_gitax(sharpened(), CFG, device="cpu"),
                                      encoder=True)
    with pytest.raises(ValueError, match="image_encoder.transformer.resblocks.0.attn"):
        model.trainable_(True)
    x = torch.zeros(4, 64, requires_grad=True)
    lin = port_linear(layer(0))
    with pytest.raises(RuntimeError, match="no backward"):
        linear(x, lin)
    with torch.no_grad():
        assert linear(x, lin).shape == (4, 96)
