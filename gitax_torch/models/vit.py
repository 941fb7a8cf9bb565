"""CLIP-style ViT image encoder, the counterpart of `gitax.models.vit`.

Parameter names follow the reference VisualTransformer
(CLIP/model.py:215-274): `conv1.weight`, `class_embedding`,
`positional_embedding`, `ln_pre`, `transformer.resblocks.{i}` with
`ln_1`, `attn.in_proj_weight`, `attn.out_proj`, `ln_2`, `mlp.c_fc`,
`mlp.c_proj`, and `ln_post`.

`vit_forward` patchifies by space-to-depth and one matmul, not a conv, so
cuDNN's TF32 default never applies; pre-norm blocks with QuickGELU;
`ln_post` over ALL tokens (GIT's output_grid mode), or, with
output_grid=False, CLIP's image embedding: `ln_post` on the class token,
then the projection `proj` [width, output_dim], which a
`VisualTransformer(..., output_dim=...)` holds (a CLIP state dict
carries it; GIT's does not).  Any grid of whole
patches runs: the stored positional table serves the configured square
grid, and other grids (the MinMax high-res inputs) interpolate it
bicubically (`_pos_embed_for`, CLIP/model.py:245-251).  Attention takes
the fused-attention kernel (ops/flash_attention.py) by gitax's auto rule.

Under tensor parallelism (`parallel.mesh.shard_params` sets `tp_group`)
each block holds its rank's heads and FFN columns: the fused qkv and
`c_fc` are column-parallel behind Megatron's f, `out_proj` and `c_proj`
row-parallel with g; the head count is read from the block's width.

`ops.quant.quantize_git_model_(model, encoder=True)` puts the four GEMMs
of every block (the fused qkv, `out_proj`, `c_fc`, `c_proj`) on gitax's
w8a8 path (`ops/int8_dynamic.py`); the patch embedding, the embeddings,
the LayerNorms and the attention products stay in the activation dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import auto_flash
from .config import ViTConfig
from ..parallel.comm import copy_to_model
from ..ops.int8_dynamic import int8_dynamic_matmul
from .nn import (LayerNorm, Linear, empty_param, int8_buffers, linear, quick_gelu, row_linear,
                 self_attention)


class MultiheadSelfAttention(nn.Module):
    """Fused-qkv self-attention parameters, named as torch's
    nn.MultiheadAttention (`in_proj_weight [3D, D]`, `in_proj_bias`,
    `out_proj`).  After `set_int8` (the w8a8 encoder, ops/quant.py) the
    fused projection holds `in_proj_q8_t [D, 3D]` int8, stored out-major,
    and `in_proj_scale [3D]` in place of `in_proj_weight`."""

    def __init__(self, width, device=None, dtype=None):
        super().__init__()
        self.in_proj_weight = empty_param((3 * width, width), device, dtype)
        self.in_proj_bias = empty_param((3 * width,), device, dtype)
        self.register_buffer("in_proj_q8_t", None)
        self.register_buffer("in_proj_scale", None)
        self.out_proj = Linear(width, width, device=device, dtype=dtype)

    @property
    def quantized(self):
        return self.in_proj_q8_t is not None

    def set_int8(self, q8_t, scale):
        """Replace the fp `in_proj_weight` with gitax's `kernel_q8_dyn`
        [D, 3D] and `kernel_scale` [3D]: the w8a8 fused projection."""
        device = self.in_proj_weight.device
        del self._parameters["in_proj_weight"]
        self.in_proj_q8_t, self.in_proj_scale = int8_buffers(q8_t, scale, device)

    def fused_qkv(self, x):
        """The fused projection [B, T, 3D] (q | k | v), on the flash path
        and the plain one alike; w8a8 once quantized."""
        if self.quantized:
            return int8_dynamic_matmul(x, self.in_proj_q8_t, self.in_proj_scale,
                                       self.in_proj_bias)
        return F.linear(x, self.in_proj_weight.to(x.dtype)) + self.in_proj_bias.to(x.dtype)

    def project(self, x):
        return self.fused_qkv(x).chunk(3, dim=-1)


class Mlp(nn.Module):
    def __init__(self, width, device=None, dtype=None):
        super().__init__()
        self.c_fc = Linear(width, 4 * width, device=device, dtype=dtype)
        self.c_proj = Linear(4 * width, width, device=device, dtype=dtype)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        w = cfg.width
        self.ln_1 = LayerNorm(w, cfg.ln_eps, device, dtype)
        self.attn = MultiheadSelfAttention(w, device, dtype)
        self.ln_2 = LayerNorm(w, cfg.ln_eps, device, dtype)
        self.mlp = Mlp(w, device, dtype)


class Transformer(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(cfg, device, dtype) for _ in range(cfg.layers)
        )


class VisualTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None, dtype=None, output_dim=None):
        super().__init__()
        self.cfg = cfg
        w, p = cfg.width, cfg.patch_size
        self.conv1 = nn.Module()
        self.conv1.weight = empty_param((w, 3, p, p), device, dtype)
        self.class_embedding = empty_param((w,), device, dtype)
        self.positional_embedding = empty_param((cfg.num_tokens, w), device, dtype)
        self.ln_pre = LayerNorm(w, cfg.ln_eps, device, dtype)
        self.transformer = Transformer(cfg, device, dtype)
        self.ln_post = LayerNorm(w, cfg.ln_eps, device, dtype)
        # CLIP's image-embedding projection (x @ proj); None in GIT's encoder
        self.proj = empty_param((w, output_dim), device, dtype) if output_dim else None
        # the model group under tensor parallelism (parallel/mesh.py)
        self.tp_group = None

    @torch.no_grad()
    def init_params(self, generator):
        """Random init with gitax's scheme (normal std 0.02 for matmul
        weights, width**-0.5 for the embeddings, LayerNorm ones/zeros,
        zero biases), drawn from `generator` on the CPU."""
        scale = self.cfg.width ** -0.5
        for name, p in self.named_parameters():
            if name in ("class_embedding", "positional_embedding", "proj"):
                std = scale
            elif name.endswith("bias") or ".ln_" in name or name.startswith("ln_"):
                p.fill_(0.0 if name.endswith("bias") else 1.0)
                continue
            else:
                std = 0.02
            p.copy_(torch.randn(p.shape, generator=generator) * std)


def _block(x, blk: ResidualAttentionBlock, num_heads, fast, flash, tp_group=None):
    h1 = copy_to_model(blk.ln_1(x), tp_group)
    x = x + self_attention(h1, blk.attn, num_heads, fast=fast, flash=flash, tp_group=tp_group)
    h = copy_to_model(blk.ln_2(x), tp_group)
    h = row_linear(quick_gelu(linear(h, blk.mlp.c_fc)), blk.mlp.c_proj, tp_group)
    return x + h


def _pos_embed_for(vit: VisualTransformer, gh, gw, dtype):
    """Positional table for a (gh, gw) patch grid: the stored table for
    the configured square grid, else its spatial rows [g, g, W]
    interpolated as [1, W, g, g] with torch's bicubic (a = -0.75, edges
    clamped: the kernel gitax's `ops/interp.py` matches), in the activation
    dtype as gitax does (vit.py:91-100); the class row is kept."""
    pos = vit.positional_embedding.to(dtype)
    g = vit.cfg.grid
    if (gh, gw) == (g, g):
        return pos
    return resize_pos_embed(pos, g, gh, gw)


def resize_pos_embed(pos, g, gh, gw):
    """A positional table [1 + g*g, W] for a (gh, gw) grid: the class row
    kept, the spatial rows [g, g, W] interpolated as [1, W, g, g] with
    torch's bicubic (a = -0.75, align_corners=False, edges clamped), in
    pos's dtype (reference torch_common.py:19-39, CLIP/model.py:245-251)."""
    w = pos.shape[-1]
    spatial = pos[1:].reshape(g, g, w).permute(2, 0, 1)[None]
    resized = F.interpolate(spatial, size=(gh, gw), mode="bicubic", align_corners=False)
    return torch.cat([pos[:1], resized[0].permute(1, 2, 0).reshape(gh * gw, w)], 0)


def vit_forward(vit: VisualTransformer, images, dtype=torch.float32, fast=None, flash=None,
                remat=False, output_grid=True):
    """images [B, H, W, 3] (NHWC, normalized; H and W whole patches) ->
    tokens [B, 1 + gh*gw, width]; with output_grid=False CLIP's image
    embedding [B, output_dim] (`ln_post` on the class token, then `proj`
    where the encoder holds one, else [B, width]; gitax vit.py:163-169).
    flash=None applies gitax's auto rule
    (`ops.flash_attention.auto_flash`: S >= 640, not f32, on a CUDA
    device); True or False forces the fused-attention kernel on or off
    (the kernel has no backward: training passes False).

    remat=True runs each residual block under
    `torch.utils.checkpoint.checkpoint` (use_reentrant=False), so the
    backward recomputes one block at a time and keeps only the blocks'
    inputs: gitax's per-block `jax.checkpoint` inside its scan
    (vit.py:153-161), not a checkpoint of the whole forward, which
    holds every recomputed block's intermediates at once (gitax
    trainer.py:88-92).  Under tensor parallelism the recomputation issues
    the block's collectives again, in the same order on every rank."""
    cfg = vit.cfg
    if fast is None:
        fast = cfg.fast_softmax
    b, h, w, c = images.shape
    p = cfg.patch_size
    if h % p or w % p:
        raise ValueError("image {}x{} is not whole {}-pixel patches".format(h, w, p))
    gh, gw = h // p, w // p
    if flash is None:
        flash = auto_flash(gh * gw + 1, dtype, images.device)
    x = images.to(dtype)
    # space-to-depth patchify: [B, gh, gw, P*P*3] then one matmul with the
    # conv weight laid out as [P*P*3, width] (the (kh, kw, c) order)
    x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, gh * gw, p * p * c)
    kernel = vit.conv1.weight.permute(2, 3, 1, 0).reshape(p * p * c, cfg.width)
    x = torch.matmul(x, kernel.to(dtype))
    cls = vit.class_embedding.to(dtype).expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    x = x + _pos_embed_for(vit, gh, gw, dtype)
    x = vit.ln_pre(x)
    head_dim = cfg.width // cfg.heads
    tp = vit.tp_group
    for blk in vit.transformer.resblocks:
        heads = blk.attn.in_proj_bias.shape[0] // (3 * head_dim)  # this rank's
        if remat:
            x = checkpoint(_block, x, blk, heads, fast, flash, tp, use_reentrant=False)
        else:
            x = _block(x, blk, heads, fast, flash, tp)
    if not output_grid:
        x = vit.ln_post(x[:, 0])
        return x if vit.proj is None else torch.matmul(x, vit.proj.to(x.dtype))
    return vit.ln_post(x)
