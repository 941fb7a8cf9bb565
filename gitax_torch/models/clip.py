"""CLIP's text tower and contrastive head, the counterpart of
`gitax.models.clip` (reference CLIP/model.py:277-375).

GIT uses only CLIP's visual tower at run time; the text tower is there so
that a CLIP archive loads whole (`ckpt.clip_archive`) and image-text
similarity works.  The tower is a causal pre-norm transformer over BPE
tokens, built from the ViT's blocks (`vit.ResidualAttentionBlock`) with
an additive causal -inf mask, pooled at the EOT token (the highest token
id, the first such position as `jnp.argmax` picks) and projected.

Parameter names follow the reference's top-level CLIP keys
(`token_embedding.weight`, `positional_embedding`,
`transformer.resblocks.{i}.*`, `ln_final`, `text_projection`,
`logit_scale`), so a reference state dict loads with
`ckpt.load_clip_text_state_dict`.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from .nn import LayerNorm, empty_param, linear, quick_gelu, self_attention
from .vit import Transformer


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    ln_eps: float = 1e-5


class TextTransformer(nn.Module):
    """The text tower on `device` (default: the CUDA card, see
    `models.git.resolve_device`) in `dtype`, projecting to `embed_dim`
    (the visual tower's output width); values random until `init_params`
    or a loader fills them."""

    def __init__(self, cfg: CLIPTextConfig, embed_dim: int, device=None, dtype=torch.float32):
        super().__init__()
        from .git import resolve_device

        device = resolve_device(device)
        self.cfg = cfg
        w = cfg.width
        self.token_embedding = nn.Module()
        self.token_embedding.weight = empty_param((cfg.vocab_size, w), device, dtype)
        self.positional_embedding = empty_param((cfg.context_length, w), device, dtype)
        self.transformer = Transformer(cfg, device, dtype)  # reads width, layers, ln_eps
        self.ln_final = LayerNorm(w, cfg.ln_eps, device, dtype)
        self.text_projection = empty_param((w, embed_dim), device, dtype)
        self.logit_scale = empty_param((), device, dtype)

    @torch.no_grad()
    def init_params(self, generator):
        """The reference's `initialize_parameters` (CLIP/model.py:311-337)
        drawn from `generator` on the CPU: embeddings std 0.02 and 0.01,
        attention in width**-0.5, out and c_proj width**-0.5 (2 layers)**-0.5,
        c_fc (2 width)**-0.5, the projection width**-0.5, zero biases,
        LayerNorm ones, logit_scale log(1 / 0.07)."""
        w, n = self.cfg.width, self.cfg.layers
        attn_std, proj_std, fc_std = w ** -0.5, w ** -0.5 * (2 * n) ** -0.5, (2 * w) ** -0.5

        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator) * std)

        normal(self.token_embedding.weight, 0.02)
        normal(self.positional_embedding, 0.01)
        for blk in self.transformer.resblocks:
            normal(blk.attn.in_proj_weight, attn_std)
            normal(blk.attn.out_proj.weight, proj_std)
            normal(blk.mlp.c_fc.weight, fc_std)
            normal(blk.mlp.c_proj.weight, proj_std)
            for p in (blk.attn.in_proj_bias, blk.attn.out_proj.bias, blk.mlp.c_fc.bias,
                      blk.mlp.c_proj.bias, blk.ln_1.bias, blk.ln_2.bias):
                p.zero_()
            blk.ln_1.weight.fill_(1.0)
            blk.ln_2.weight.fill_(1.0)
        self.ln_final.weight.fill_(1.0)
        self.ln_final.bias.zero_()
        normal(self.text_projection, w ** -0.5)
        self.logit_scale.fill_(math.log(1 / 0.07))
        return self


def text_forward(text: TextTransformer, tokens, dtype=torch.float32):
    """tokens [B, T <= context_length] integer ids -> embeddings
    [B, embed_dim] (reference encode_text, CLIP/model.py:346-359)."""
    cfg = text.cfg
    t = tokens.shape[1]
    x = text.token_embedding.weight[tokens].to(dtype)
    x = x + text.positional_embedding[:t].to(dtype)
    mask = torch.full((t, t), float("-inf"), device=x.device).triu(1)[None, None]  # causal
    for blk in text.transformer.resblocks:
        x = x + self_attention(blk.ln_1(x), blk.attn, cfg.heads, mask=mask)
        h = blk.ln_2(x)
        x = x + linear(quick_gelu(linear(h, blk.mlp.c_fc)), blk.mlp.c_proj)
    x = text.ln_final(x)
    # pool at the EOT token, the highest id: torch's argmax, as jnp's,
    # returns the first maximal position
    eot = tokens.argmax(dim=1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    return torch.matmul(pooled, text.text_projection.to(pooled.dtype))


def clip_similarity(image_features, text_features, logit_scale):
    """Cosine-similarity logits (reference CLIP/model.py:361-375):
    (logits_per_image [Bi, Bt], logits_per_text [Bt, Bi]), scaled by
    exp(logit_scale)."""
    im = image_features / image_features.norm(dim=-1, keepdim=True)
    tx = text_features / text_features.norm(dim=-1, keepdim=True)
    scale = torch.as_tensor(logit_scale, dtype=im.dtype, device=im.device).exp()
    logits_per_image = scale * im @ tx.T
    return logits_per_image, logits_per_image.T
