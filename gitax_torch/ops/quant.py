"""Weight-only int8 quantization for the decode loop.

The counterpart of `gitax.ops.quant`, with the same rule, so the int8
values and scales are identical to gitax's:

    q = round(w / s) in [-127, 127],   s = max(max|w over in-axis| / 127, 1e-12)
    y = (x @ q) * s + b

The decode step is bandwidth-bound: each step re-reads the decoder block
weights and the tied vocab matrix for few FLOPs, so storing them as int8
halves the bytes.  Activations stay in their dtype, the embedding lookup
table keeps full precision; only matmul weights are quantized.

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


def quantize_git_params(params: dict) -> dict:
    """Whole-model tree: quantize the textual tower for decoding.  (The
    encoder's w8a8 mode, gitax's `encoder=True`, is not ported.)"""
    new = dict(params)
    new["textual"] = quantize_textual_for_decode(params["textual"])
    return new


def _quantize_module_(lin):
    w = lin.weight.detach().float().cpu().numpy().T  # [in, out]
    q = quantize_linear({"kernel": w})
    lin.set_int8(torch.from_numpy(q["kernel_q8"]), torch.from_numpy(q["kernel_scale"]))


@torch.no_grad()
def quantize_git_model_(model):
    """Quantize a port GitModel in place: every decoder-block Linear and
    the tied output head (whose fp weight stays on the embedding)."""
    textual = model.textual
    for layer in textual.layers():
        for lin in layer.linears():
            _quantize_module_(lin)
    _quantize_module_(textual.output)
    return model
