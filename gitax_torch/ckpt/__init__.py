"""Carry gitax weights into the port.

`params_from_gitax(tree, cfg)` takes a gitax params tree as numpy arrays
(fp, or int8-quantized by `gitax.ops.quant.quantize_git_params` or
`gitax_torch.ops.quant.quantize_git_params`) and returns a filled
`GitModel`.  The port's parameters are named after the reference torch
state dict, so for an fp tree `model.state_dict()` equals
`gitax.ckpt.export_git_state_dict(tree, cfg)` key for key, and published
`model.pt` state dicts load with `load_state_dict` and no converter.
A video tree's `img_temporal_embedding` [F, Dv] fills the F parameters
`img_temperal_embedding.{i}` [1, 1, Dv] (the reference's spelling).

A reference checkpoint (`output/{model}/snapshot/model.pt`) loads with
`load_torch_checkpoint`, `infer_visual_config` (the encoder its shapes
define: a ViT or CLIP's ModifiedResNet) and `load_git_state_dict` (names
matched by `align_by_suffix`), the counterparts of gitax's
`ckpt/torch_convert.py:42, 64, 328`.

The CLIP towers: `load_clip_visual` (a CLIP state dict's visual tower, ViT
or ResNet, as a port module), `load_resnet_state_dict` and
`load_clip_text_state_dict` (reference names, no converter), and from
gitax's numpy trees `resnet_params_from_gitax` and
`clip_text_params_from_gitax`; whole CLIP archives load with
`ckpt.clip_archive.load_clip_archive`.

The other way: `save_reference_checkpoint(path, model)` writes a port
model (fine-tuned with the port, on one card or gathered from a mesh) as
a reference `{'model': state_dict}` (`torch_convert.export_git_state_dict`),
the file the CLIs load from `output/{model}/snapshot/model.pt`.
A gitax w8a8 tree (`quantize_git_params(encoder=True)`: the encoder's
`kernel_q8_dyn`) fills the ViT's w8a8 layers (`Linear.set_int8(...,
dynamic=True)`, `MultiheadSelfAttention.set_int8`).
"""

from __future__ import annotations

import io
import logging
import os
import os.path as op
import re
from typing import Dict

import numpy as np
import torch

from ..models.clip import CLIPTextConfig, TextTransformer
from ..models.config import GitConfig, ViTConfig
from ..models.git import GitModel, resolve_device
from ..models.resnet import ModifiedResNet, ResNetConfig
from ..models.vit import VisualTransformer
from .torch_convert import export_git_state_dict


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _int8_leaves(p, pick, sl):
    """(int8 kernel [in, out] of the column slice `sl`, its f32 scales,
    w8a8) of a quantized gitax entry, or None for an fp one."""
    for name, dynamic in (("kernel_q8", False), ("kernel_q8_dyn", True)):
        if name in p:
            return (torch.from_numpy(np.array(pick(p[name])[:, sl], np.int8)),
                    _t(pick(p["kernel_scale"])[sl]), dynamic)
    return None


def _fill_linear(lin, p, i=None, cols=None):
    """Fill a port Linear from a gitax {'kernel' [in, out] | 'kernel_q8' |
    'kernel_q8_dyn', 'kernel_scale', 'bias'} entry; `i` picks a layer of a
    stacked entry, `cols` a column slice of a fused one."""
    pick = (lambda a: np.asarray(a)[i]) if i is not None else np.asarray
    sl = cols if cols is not None else slice(None)
    int8 = _int8_leaves(p, pick, sl)
    if int8 is not None:
        lin.set_int8(*int8[:2], dynamic=int8[2])
    else:
        lin.weight.copy_(_t(pick(p["kernel"])[:, sl].T))
    lin.bias.copy_(_t(pick(p["bias"])[sl]))


def _fill_qkv(attn, p, i):
    """Fill the ViT's fused qkv from a gitax stacked entry: fp, or w8a8
    (`kernel_q8_dyn`: all 3D columns, as the fp weight takes them)."""
    int8 = _int8_leaves(p, lambda a: np.asarray(a)[i], slice(None))
    if int8 is not None:
        attn.set_int8(*int8[:2])
    else:
        attn.in_proj_weight.copy_(_t(np.asarray(p["kernel"])[i].T))
    attn.in_proj_bias.copy_(_t(np.asarray(p["bias"])[i]))


def _fill_ln(ln, p, i=None):
    pick = (lambda a: np.asarray(a)[i]) if i is not None else np.asarray
    ln.weight.copy_(_t(pick(p["scale"])))
    ln.bias.copy_(_t(pick(p["bias"])))


@torch.no_grad()
def params_from_gitax(tree: dict, cfg: GitConfig, device=None,
                      dtype=torch.float32) -> GitModel:
    """gitax params tree (numpy) -> GitModel on `device` (default: the
    CUDA card; raises without one) in `dtype` (int8 values and f32 scales
    keep their types; a w8a8 encoder stays w8a8)."""
    model = GitModel(cfg, device=device, dtype=dtype)

    ie, vit = tree["image_encoder"], model.image_encoder
    p, w = cfg.encoder.patch_size, cfg.encoder.width
    vit.conv1.weight.copy_(
        _t(np.asarray(ie["patch_kernel"], np.float32).reshape(p, p, 3, w)
           .transpose(3, 2, 0, 1))
    )
    vit.class_embedding.copy_(_t(ie["class_embedding"]))
    # the stored table is the configured square grid's (901 rows for
    # ViT-L/14 at 420 px); other grids interpolate it at run time
    pos = np.asarray(ie["positional_embedding"])
    if pos.shape != tuple(vit.positional_embedding.shape):
        raise ValueError("positional table {} does not fit the {} px config, which needs {}".format(
            pos.shape, cfg.encoder.input_resolution, tuple(vit.positional_embedding.shape)))
    vit.positional_embedding.copy_(_t(pos))
    _fill_ln(vit.ln_pre, ie["ln_pre"])
    _fill_ln(vit.ln_post, ie["ln_post"])
    blocks = ie["blocks"]
    for i, blk in enumerate(vit.transformer.resblocks):
        _fill_ln(blk.ln_1, blocks["ln_1"], i)
        _fill_ln(blk.ln_2, blocks["ln_2"], i)
        _fill_qkv(blk.attn, blocks["attn"]["qkv"], i)
        _fill_linear(blk.attn.out_proj, blocks["attn"]["out"], i)
        _fill_linear(blk.mlp.c_fc, blocks["mlp"]["c_fc"], i)
        _fill_linear(blk.mlp.c_proj, blocks["mlp"]["c_proj"], i)

    tx, head = tree["textual"], model.textual
    _fill_linear(head.visual_projection[0], tx["visual_projection"]["linear"])
    _fill_ln(head.visual_projection[1], tx["visual_projection"]["ln"])
    head.embedding.words.weight.copy_(_t(tx["embedding"]["words"]))
    head.embedding.positions.weight.copy_(_t(tx["embedding"]["positions"]))
    _fill_ln(head.embedding.layer_norm, tx["embedding"]["ln"])
    tb = tx["blocks"]
    d = cfg.hidden_size
    for i, layer in enumerate(head.layers()):
        sa = layer.attention.qkv
        for j, lin in enumerate((sa.query, sa.key, sa.value)):
            _fill_linear(lin, tb["attn"]["qkv"], i, slice(j * d, (j + 1) * d))
        _fill_linear(layer.attention.output.dense, tb["attn"]["out"], i)
        _fill_ln(layer.attention.output.LayerNorm, tb["attn_ln"], i)
        _fill_linear(layer.intermediate.dense, tb["mlp"]["intermediate"], i)
        _fill_linear(layer.output.dense, tb["mlp"]["output"], i)
        _fill_ln(layer.output.LayerNorm, tb["mlp_ln"], i)
    head.output.bias.copy_(_t(tx["output_bias"]))
    if "output_words_q8_t" in tx:
        head.output.set_int8(torch.from_numpy(np.array(tx["output_words_q8_t"], np.int8)),
                             _t(tx["output_words_scale"]))

    # video: gitax's [F, Dv] table -> the reference's F parameters [1, 1, Dv]
    n_emb, dv = cfg.num_image_with_embedding, cfg.visual_feature_size
    emb = tree.get("img_temporal_embedding")
    if emb is None and not n_emb:
        return model
    shape = None if emb is None else np.shape(emb)
    if shape != (n_emb, dv):
        raise ValueError("temporal embedding {} does not fit the config, which needs {}".format(
            shape, (n_emb, dv) if n_emb else None))
    for i, p in enumerate(model.img_temperal_embedding):
        p.copy_(_t(np.asarray(emb)[i]).reshape(1, 1, dv))
    return model


def load_torch_checkpoint(path):
    """Load a model.pt on the CPU; returns the state dict (the inner one
    of a reference {'model': state_dict}) with 'module.' prefixes
    stripped (reference torch_common.py:41-56)."""
    from ..io import fileio

    with fileio.open_file(path, "rb") as fp:
        src = fp if getattr(fp, "seekable", lambda: False)() else io.BytesIO(fp.read())
        blob = torch.load(src, map_location="cpu", weights_only=True)
    state = blob.get("model", blob) if isinstance(blob, dict) else blob
    out = {}
    for k, v in state.items():
        while k.startswith("module."):
            k = k[len("module."):]
        out[k] = v
    return out


def align_by_suffix(expected_keys, loaded: Dict[str, object]):
    """For each expected key, pick the loaded key sharing the longest
    suffix (reference align_and_update_state_dicts,
    torch_common.py:100-145).  Returns {expected: loaded_value}."""
    loaded_keys = sorted(loaded)
    result = {}
    for ek in expected_keys:
        best, best_len = None, 0
        for lk in loaded_keys:
            if ek.endswith(lk) or lk.endswith(ek):
                n = min(len(ek), len(lk))
                if n > best_len:
                    best, best_len = lk, n
        if best is not None:
            result[ek] = loaded[best]
        else:
            logging.info("no checkpoint match for %s", ek)
    return result


def infer_visual_config(sd, prefix="visual."):
    """The visual tower that a state dict's shapes define, as the
    reference's build_model does (CLIP/model.py:402-425): ('vit',
    ViTConfig) or ('resnet', ResNetConfig) (gitax
    torch_convert.py:328-377)."""
    if prefix + "conv1.weight" in sd and any(k.startswith(prefix + "transformer.") for k in sd):
        conv = sd[prefix + "conv1.weight"]
        width, patch = conv.shape[0], conv.shape[-1]
        grid = int(round((sd[prefix + "positional_embedding"].shape[0] - 1) ** 0.5))
        block_re = re.compile(re.escape(prefix) + r"transformer\.resblocks\.(\d+)\.")
        layers = len({m.group(1) for k in sd if (m := block_re.match(k))})
        return "vit", ViTConfig(patch_size=int(patch), width=int(width), layers=layers,
                                heads=int(width) // 64, input_resolution=int(patch * grid))
    counts = tuple(
        len({m.group(1) for k in sd
             if (m := re.match(re.escape(prefix) + r"layer{}\.(\d+)\.".format(i), k))})
        for i in (1, 2, 3, 4))
    width = sd[prefix + "layer1.0.conv1.weight"].shape[0]
    out_grid = int(round((sd[prefix + "attnpool.positional_embedding"].shape[0] - 1) ** 0.5))
    out_dim = sd[prefix + "attnpool.c_proj.weight"].shape[0]
    return "resnet", ResNetConfig(layers=counts, width=int(width), output_dim=int(out_dim),
                                  heads=int(width) * 32 // 64, input_resolution=out_grid * 32)


def _strip(sd, prefix):
    """The entries of `sd` under `prefix`, the prefix dropped; BatchNorm's
    `num_batches_tracked` left out."""
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix) and not k.endswith("num_batches_tracked")}


@torch.no_grad()
def load_resnet_state_dict(model: ModifiedResNet, sd, prefix=""):
    """Fill a port ModifiedResNet from a reference state dict (the keys
    under `prefix`, e.g. 'visual.'), casting to the model's dtype and
    device; raises on a missing, extra or misshapen entry."""
    model.load_state_dict(_strip(sd, prefix), strict=True)
    return model


@torch.no_grad()
def load_clip_text_state_dict(model: TextTransformer, sd):
    """Fill a port TextTransformer from a reference CLIP state dict (its
    top-level text keys; the `visual.*` entries are ignored)."""
    keys = set(model.state_dict())
    model.load_state_dict({k: v for k, v in sd.items() if k in keys}, strict=True)
    return model


def text_config_from_state_dict(sd):
    """(CLIPTextConfig, embed_dim) of a CLIP state dict's text tower, as
    the reference infers them (CLIP/model.py:420-426)."""
    width = int(sd["ln_final.weight"].shape[0])
    layers = len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")})
    cfg = CLIPTextConfig(width=width, heads=width // 64, layers=layers,
                         context_length=int(sd["positional_embedding"].shape[0]),
                         vocab_size=int(sd["token_embedding.weight"].shape[0]))
    return cfg, int(sd["text_projection"].shape[1])


def load_clip_visual(sd, prefix="visual.", device=None, dtype=torch.float32):
    """A CLIP checkpoint's visual tower -> (kind, config, module) on
    `device` (default: the CUDA card): a ViT (`VisualTransformer`, with
    `proj` where the state dict carries it) or a `ModifiedResNet`
    (gitax torch_convert.py:380-388, which converts to numpy trees and
    leaves `proj` out)."""
    kind, cfg = infer_visual_config(sd, prefix)
    device = resolve_device(device)
    if kind == "resnet":
        return kind, cfg, load_resnet_state_dict(ModifiedResNet(cfg, device, dtype), sd, prefix)
    proj = sd.get(prefix + "proj")
    vit = VisualTransformer(cfg, device, dtype,
                            output_dim=None if proj is None else int(proj.shape[1]))
    with torch.no_grad():
        vit.load_state_dict(_strip(sd, prefix), strict=True)
    return kind, cfg, vit


@torch.no_grad()
def resnet_params_from_gitax(tree: dict, cfg: ResNetConfig, device=None,
                             dtype=torch.float32) -> ModifiedResNet:
    """A gitax ModifiedResNet tree (numpy, `convert_resnet_state_dict`'s:
    HWIO convs, BatchNorm {scale, bias, mean, var}, the attention pool's
    [in, out] kernels) -> ModifiedResNet on `device` (default: the CUDA
    card) in `dtype`."""
    model = ModifiedResNet(cfg, device=device, dtype=dtype)

    def conv(m, k):
        m.weight.copy_(_t(np.asarray(k, np.float32).transpose(3, 2, 0, 1)))

    def bn(m, p):
        m.weight.copy_(_t(p["scale"]))
        m.bias.copy_(_t(p["bias"]))
        m.running_mean.copy_(_t(p["mean"]))
        m.running_var.copy_(_t(p["var"]))

    stem = tree["stem"]
    for i in (1, 2, 3):
        conv(getattr(model, "conv{}".format(i)), stem["conv{}".format(i)])
        bn(getattr(model, "bn{}".format(i)), stem["bn{}".format(i)])
    for gi, group in enumerate(tree["layers"]):
        for blk, p in zip(getattr(model, "layer{}".format(gi + 1)), group):
            for i in (1, 2, 3):
                conv(getattr(blk, "conv{}".format(i)), p["conv{}".format(i)])
                bn(getattr(blk, "bn{}".format(i)), p["bn{}".format(i)])
            if ("downsample" in p) != (blk.downsample is not None):
                raise ValueError("layer{}: the tree's downsample branch does not fit the "
                                 "config".format(gi + 1))
            if blk.downsample is not None:
                conv(blk.downsample["0"], p["downsample"]["conv"])
                bn(blk.downsample["1"], p["downsample"]["bn"])
    pool = tree.get("attnpool")
    if pool is not None:
        model.attnpool.positional_embedding.copy_(_t(pool["positional_embedding"]))
        for name in ("q", "k", "v", "c"):
            lin = getattr(model.attnpool, name + "_proj")
            lin.weight.copy_(_t(np.asarray(pool[name]["kernel"]).T))
            lin.bias.copy_(_t(pool[name]["bias"]))
    return model


@torch.no_grad()
def clip_text_params_from_gitax(tree: dict, cfg: CLIPTextConfig, device=None,
                                dtype=torch.float32) -> TextTransformer:
    """A gitax text-tower tree (numpy, `convert_clip_text_state_dict`'s:
    stacked blocks, [in, out] kernels) -> TextTransformer on `device`
    (default: the CUDA card) in `dtype`."""
    proj = np.asarray(tree["text_projection"])
    model = TextTransformer(cfg, proj.shape[1], device=device, dtype=dtype)
    model.token_embedding.weight.copy_(_t(tree["token_embedding"]))
    model.positional_embedding.copy_(_t(tree["positional_embedding"]))
    blocks = tree["blocks"]
    for i, blk in enumerate(model.transformer.resblocks):
        _fill_ln(blk.ln_1, blocks["ln_1"], i)
        _fill_ln(blk.ln_2, blocks["ln_2"], i)
        _fill_qkv(blk.attn, blocks["attn"]["qkv"], i)
        _fill_linear(blk.attn.out_proj, blocks["attn"]["out"], i)
        _fill_linear(blk.mlp.c_fc, blocks["mlp"]["c_fc"], i)
        _fill_linear(blk.mlp.c_proj, blocks["mlp"]["c_proj"], i)
    _fill_ln(model.ln_final, tree["ln_final"])
    model.text_projection.copy_(_t(proj))
    model.logit_scale.copy_(_t(tree["logit_scale"]))
    return model


@torch.no_grad()
def load_git_state_dict(model: GitModel, sd):
    """Fill a port GitModel from a reference state dict (names matched by
    suffix, values cast to the model's dtype and copied to its device);
    raises on a missing or misshapen entry."""
    model.load_state_dict(align_by_suffix(list(model.state_dict()), sd), strict=True)
    return model


def save_reference_checkpoint(path, model):
    """Write a port model as a reference-layout torch checkpoint
    ({'model': state_dict} of f32 CPU tensors; gitax
    `ckpt/__init__.py:26-40`), so that the port's CLIs and server
    (`output/{model}/snapshot/model.pt`) and the PyTorch reference run a
    model fine-tuned with the port.  The file is written beside `path` and
    renamed into place, so a run cut mid-write leaves no half-written
    checkpoint.  A model on a mesh is gathered first: every rank of its
    model group calls this, and its mesh's rank 0 writes.  Returns path."""
    sd = {k: torch.from_numpy(v) for k, v in export_git_state_dict(model).items()}
    if model.mesh is not None and model.mesh.rank != 0:
        return path
    parent = op.dirname(op.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = op.join(parent, ".{}.tmp-{}".format(op.basename(path), os.getpid()))
    torch.save({"model": sd}, tmp)
    os.replace(tmp, path)
    return path
