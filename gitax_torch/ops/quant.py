"""Weight-only int8 quantization for the decode loop, and w8a8 for the
image encoder.

The counterpart of `gitax.ops.quant`, with the same rule, so the int8
values and scales are identical to gitax's:

    q = round(w / s) in [-127, 127],   s = max(max|w over in-axis| / 127, 1e-12)
    y = (x @ q) * s + b

The decode step is bandwidth-bound: each step re-reads the decoder block
weights and the tied vocab matrix for few FLOPs, so storing them as int8
halves the bytes.  Activations stay in their dtype, the embedding lookup
table keeps full precision; only matmul weights are quantized.

encoder=True also puts the ViT's GEMMs (the fused qkv, `out_proj`,
`c_fc`, `c_proj`) on the w8a8 path: the same weight codes and scales
(`quantize_linear_dyn`, tagged `kernel_q8_dyn`), and at run time each
activation row is quantized too, so that the product runs int8 x int8
(`ops/int8_dynamic.py`).  The patch embedding, the position embeddings,
the LayerNorms and the attention products stay in the activation dtype
(gitax quant.py:91-98).  gitax keeps w8a8 opt-in: its engine never turns
it on.

Two entries: `quantize_git_params` transforms a gitax-layout params tree
of numpy arrays (the form `ckpt.params_from_gitax` reads), and
`quantize_git_model_` quantizes a port `GitModel` in place.  Both call
`quantize_linear`.
"""

from __future__ import annotations

import numpy as np
import torch


def quantize_linear(p: dict) -> dict:
    """{'kernel' [.., in, out], 'bias'?} -> {'kernel_q8', 'kernel_scale',
    'bias'?} as numpy; stacked kernels ([L, in, out]) quantize per
    (layer, out)."""
    w = np.asarray(p["kernel"], np.float32)
    s = np.max(np.abs(w), axis=-2, keepdims=True) / 127.0
    s = np.maximum(s, 1e-12)
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    out = {"kernel_q8": q, "kernel_scale": np.squeeze(s, axis=-2)}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"])
    return out


def quantize_textual_for_decode(textual: dict) -> dict:
    """Quantize the decoder block matmuls and the tied output head of a
    gitax-layout textual params tree."""
    blocks = textual["blocks"]
    new = dict(textual)
    new["blocks"] = {
        "attn": {
            "qkv": quantize_linear(blocks["attn"]["qkv"]),
            "out": quantize_linear(blocks["attn"]["out"]),
        },
        "attn_ln": blocks["attn_ln"],
        "mlp": {
            "intermediate": quantize_linear(blocks["mlp"]["intermediate"]),
            "output": quantize_linear(blocks["mlp"]["output"]),
        },
        "mlp_ln": blocks["mlp_ln"],
    }
    # the head is the word table transposed: per-vocab-row scales, int8
    # stored pre-transposed [D, V]; lookups keep the fp table
    head = quantize_linear({"kernel": np.asarray(textual["embedding"]["words"]).T})
    new["output_words_q8_t"] = head["kernel_q8"]
    new["output_words_scale"] = head["kernel_scale"]
    return new


def quantize_linear_dyn(p: dict) -> dict:
    """`quantize_linear` tagged for the w8a8 path ('kernel_q8_dyn'): the
    weight codes and scales are the weight-only ones, and at run time the
    activations are quantized per row too."""
    q = quantize_linear(p)
    q["kernel_q8_dyn"] = q.pop("kernel_q8")
    return q


def quantize_vit_for_inference(vit: dict) -> dict:
    """Quantize a gitax-layout ViT tree's block GEMMs (qkv, out, c_fc,
    c_proj, stacked [L, in, out]) for w8a8; the patch kernel, the
    embeddings and the LayerNorms are kept as they are."""
    blocks = vit["blocks"]
    new = dict(vit)
    new["blocks"] = {
        "ln_1": blocks["ln_1"],
        "attn": {
            "qkv": quantize_linear_dyn(blocks["attn"]["qkv"]),
            "out": quantize_linear_dyn(blocks["attn"]["out"]),
        },
        "ln_2": blocks["ln_2"],
        "mlp": {
            "c_fc": quantize_linear_dyn(blocks["mlp"]["c_fc"]),
            "c_proj": quantize_linear_dyn(blocks["mlp"]["c_proj"]),
        },
    }
    return new


def quantize_git_params(params: dict, encoder: bool = False) -> dict:
    """Whole-model tree: quantize the textual tower for decoding
    (weight-only); encoder=True also puts the image encoder's GEMMs on the
    w8a8 path."""
    new = dict(params)
    new["textual"] = quantize_textual_for_decode(params["textual"])
    if encoder and "image_encoder" in new:
        new["image_encoder"] = quantize_vit_for_inference(new["image_encoder"])
    return new


def _codes(weight):
    """quantize_linear of an fp weight [out, in]: (int8 [in, out], f32
    scales [out]) as tensors."""
    q = quantize_linear({"kernel": weight.detach().float().cpu().numpy().T})
    return torch.from_numpy(q["kernel_q8"]), torch.from_numpy(q["kernel_scale"])


def _quantize_module_(lin, dynamic=False):
    lin.set_int8(*_codes(lin.weight), dynamic=dynamic)


@torch.no_grad()
def quantize_git_model_(model, encoder: bool = False):
    """Quantize a port GitModel in place: every decoder-block Linear and
    the tied output head (whose fp weight stays on the embedding),
    weight-only; encoder=True also every encoder block's fused qkv
    (`in_proj`), `out_proj`, `c_fc` and `c_proj`, w8a8 (gitax's
    `quantize_git_params(params, encoder=True)`)."""
    textual = model.textual
    for layer in textual.layers():
        for lin in layer.linears():
            _quantize_module_(lin)
    _quantize_module_(textual.output)
    if encoder:
        for blk in model.image_encoder.transformer.resblocks:
            blk.attn.set_int8(*_codes(blk.attn.in_proj_weight))
            for lin in (blk.attn.out_proj, blk.mlp.c_fc, blk.mlp.c_proj):
                _quantize_module_(lin, dynamic=True)
    return model
