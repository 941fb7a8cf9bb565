"""Shared NN primitives: parameter-holding modules and plain tensor
functions, the counterpart of `gitax.models.nn`.

Layout convention: `Linear.weight` is `[out, in]`, as in torch and the
reference state dict.  A weight-only int8 `Linear` (ops/quant.py) holds
`weight_q8_t [in, out]` int8 and a per-output-channel `weight_scale`,
the same values gitax stores as `kernel_q8` / `kernel_scale`; a `Linear`
tagged `dynamic` (gitax's `kernel_q8_dyn`, the w8a8 encoder) holds the
same buffers and quantizes its input per row at run time
(`ops/int8_dynamic.py`).  Its
storage is always out-major (a row-major [out, in] seen transposed,
each output channel's weights contiguous), whichever loader filled it:
the layout the fused vocab-head kernel reads.  LayerNorm
and the decoder's softmax accumulate in float32 (`acc_dtype`), so the
bf16 activation mode keeps the parity-critical numerics; float64
activations accumulate in float64, a reference for f32's rounding.

Parameters are created with `requires_grad=False`, the inference
default; `GitModel.trainable_(True)` makes every floating parameter
trainable (the training path, `GitModel.forward_logits`), and refuses a
model whose `Linear`s or head are int8: weight-only int8 is an inference
format, as in gitax.  The casts to the activation dtype below carry
gradients back to the f32 masters.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_qkv_attention
from ..ops.int8_dynamic import int8_dynamic_matmul
from ..parallel.comm import reduce_from_model


def empty_param(shape, device=None, dtype=None):
    """An uninitialized Parameter, frozen (`GitModel.trainable_` thaws it)."""
    return nn.Parameter(
        torch.empty(shape, device=device, dtype=dtype), requires_grad=False
    )


class LayerNorm(nn.Module):
    """Parameters of a LayerNorm (`weight`, `bias`); see `layer_norm`."""

    def __init__(self, width, eps, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = empty_param((width,), device, dtype)
        self.bias = empty_param((width,), device, dtype)

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class Linear(nn.Module):
    """Parameters of an affine map; `forward` is `linear(x, self)`.

    `weight` may be a Parameter shared with another module (the tied
    output head).  After `set_int8` the fp weight is dropped and the
    module holds the int8 values and scales instead; `dynamic` tags the
    w8a8 form, whose activations are quantized too."""

    def __init__(self, in_features, out_features, bias=True, device=None,
                 dtype=None):
        super().__init__()
        self.weight = empty_param((out_features, in_features), device, dtype)
        self.bias = empty_param((out_features,), device, dtype) if bias else None
        self.register_buffer("weight_q8_t", None)
        self.register_buffer("weight_scale", None)
        self.dynamic = False

    @property
    def quantized(self):
        return self.weight_q8_t is not None

    def set_int8(self, q8_t, scale, dynamic=False):
        """Replace the fp weight with int8 `q8_t [in, out]` and f32
        `scale [out]` (see ops/quant.py), stored out-major; dynamic=True:
        the w8a8 form (`int8_dynamic_matmul`), else weight-only."""
        device = self.weight.device
        del self._parameters["weight"]
        self.weight_q8_t, self.weight_scale = int8_buffers(q8_t, scale, device)
        self.dynamic = dynamic

    def forward(self, x):
        return linear(x, self)


def int8_buffers(q8_t, scale, device):
    """(int8 `q8_t [in, out]` stored out-major, f32 `scale [out]`) on
    `device`: the storage of every int8 weight."""
    q8_t = q8_t.to(device=device, dtype=torch.int8)
    return q8_t.t().contiguous().t(), scale.to(device=device, dtype=torch.float32)


def acc_dtype(dtype):
    """The accumulation type of activations of `dtype`: float32, or
    float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def layer_norm(x, weight, bias, eps):
    """LayerNorm with float32 statistics (`acc_dtype`), cast back to x's
    dtype."""
    dtype = x.dtype
    acc = acc_dtype(dtype)
    x32 = x.to(acc)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * weight.to(acc) + bias.to(acc)
    return y.to(dtype)


def linear(x, lin: Linear):
    """fp: x @ W^T + b in x's dtype.  Weight-only int8: the int8 weight
    is converted to x's dtype, multiplied, and the per-output-channel
    scale applied after the matmul (gitax nn.py:36-43).  w8a8 (`dynamic`):
    `int8_dynamic_matmul`, the bias added in it (gitax nn.py:26-35)."""
    if lin.dynamic:
        return int8_dynamic_matmul(x, lin.weight_q8_t, lin.weight_scale, lin.bias)
    if lin.quantized:
        y = torch.matmul(x, lin.weight_q8_t.to(x.dtype))
        y = y * lin.weight_scale.to(x.dtype)
    else:
        y = F.linear(x, lin.weight.to(x.dtype))
    if lin.bias is not None:
        y = y + lin.bias.to(x.dtype)
    return y


def row_linear(x, lin: Linear, tp_group=None):
    """A row-parallel `linear` under tensor parallelism: this rank's
    partial product x @ W_shard^T summed over the model group, then the
    (replicated) bias, added once.  An int8 layer sums x @ q8_shard and
    then applies its (replicated) per-output scale: (sum_r x_r q_r) s.
    A w8a8 layer takes the row's amax over the group and sums int32
    (`int8_dynamic_matmul`).  `linear` itself when tp_group is None."""
    if tp_group is None:
        return linear(x, lin)
    if lin.dynamic:
        return int8_dynamic_matmul(x, lin.weight_q8_t, lin.weight_scale, lin.bias, tp_group)
    if lin.quantized:
        y = reduce_from_model(torch.matmul(x, lin.weight_q8_t.to(x.dtype)), tp_group)
        y = y * lin.weight_scale.to(x.dtype)
    else:
        y = reduce_from_model(F.linear(x, lin.weight.to(x.dtype)), tp_group)
    return y + lin.bias.to(x.dtype) if lin.bias is not None else y


def quick_gelu(x):
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu_erf(x):
    """Exact-erf gelu, the decoder's activation."""
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def split_heads(x, num_heads):
    """[B, T, D] -> [B, H, T, Dh]."""
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).permute(0, 2, 1, 3)


def merge_heads(x):
    """[B, H, T, Dh] -> [B, T, H*Dh]."""
    b, h, t, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * dh)


def attention_weights(q, k, mask=None, fast=False):
    """softmax(q k^T / sqrt(d) + mask); float32 score math by default,
    the activation dtype when fast=True.

    q: [B,H,Tq,Dh], k: [B,H,Tk,Dh], mask: additive, broadcastable to
    [B,H,Tq,Tk] (0 = attend, large negative = blocked).
    """
    dh = q.shape[-1]
    acc = q.dtype if fast else acc_dtype(q.dtype)
    scale = torch.tensor(1.0 / (dh ** 0.5), dtype=acc)  # 0-dim CPU: a scalar
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + mask.to(acc)
    return torch.softmax(scores, dim=-1)


def qkv_project(x, attn, num_heads):
    """Per-head q, k, v ([B,H,T,Dh] each) from an attention module's
    `project(x) -> (q, k, v)`."""
    return tuple(split_heads(t, num_heads) for t in attn.project(x))


def self_attention(x, attn, num_heads, mask=None, fast=False, flash=False, tp_group=None):
    """Multi-head self-attention: projections from `attn.project`, the
    output map `attn.out_proj`.  flash=True (unmasked only) runs the fused
    attention (ops/flash_attention.py) straight off `attn.fused_qkv(x)`,
    the [B, T, 3D] projection; `fast` does not apply there (the kernel's
    softmax is f32), as in gitax (nn.py:127-133).  Under tensor
    parallelism (tp_group) `attn` holds this rank's `num_heads` heads and
    the output map is row-parallel (`row_linear`)."""
    if flash and mask is None:
        ctx = flash_qkv_attention(attn.fused_qkv(x), num_heads)
    else:
        q, k, v = qkv_project(x, attn, num_heads)
        probs = attention_weights(q, k, mask, fast=fast).to(v.dtype)
        ctx = merge_heads(torch.matmul(probs, v))
    return row_linear(ctx, attn.out_proj, tp_group)
