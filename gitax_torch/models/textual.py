"""GIT's unified [image; text] transformer decoder, the counterpart of
`gitax.models.textual`.

Parameter names follow the reference state dict (`textual.` prefix in a
GIT checkpoint): `visual_projection.{0,1}` ('linearLn'),
`embedding.{words,positions,layer_norm}`,
`transformer.encoder.layer.{i}` as BERT layers
(`attention.self.{query,key,value}`, `attention.output.{dense,LayerNorm}`,
`intermediate.dense`, `output.{dense,LayerNorm}`), and the tied head
`output` whose weight IS `embedding.words.weight`.

Decoding uses a static KV cache (`KVCache`): memory K/V are computed once
at prefill, stored once per batch element and broadcast over beams; the
text K/V live in per-layer time-major `[T_max, B*K, H*2Dh]` buffers with
k|v interleaved per head.  Unlike gitax (functional JAX), the port
updates the text cache IN PLACE: each step writes one row per layer, and
a `KVCache` returned by `decode_step` shares its buffers with the one
passed in.

Under tensor parallelism (`parallel.mesh.shard_params` sets `tp_group`)
`textual_forward` runs each layer on its rank's heads and FFN columns:
query, key, value and `intermediate.dense` column-parallel behind
Megatron's f, `attention.output.dense` and `output.dense` row-parallel
with g; the visual projection, the embeddings, the LayerNorms and the
tied head are replicated, so the logits are full-width on every rank.
The prefill and the decode steps run the same way for generation on a
mesh: each rank holds its heads' K/V (the text cache is
[T_max, B*beams, h*2Dh] and the memory [B, h, M, 2Dh] for this rank's h
heads) and both kernels run on those heads; after each layer's last
all-reduce every rank holds the same activations and computes the full
logits.  Over NCCL a decode step's all-reduces (two a layer, both
`row_linear`'s) are captured with the rest of the step and replayed by
`decode.device_loop`; such a step (`decode_step(graph=True)`) sums over
`graph_group`, the model group's twin that only captured steps use.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from ..ops.decode_attention import decode_attention, quantize_memory
from ..ops.flash_attention import auto_flash, fused_attention
from ..ops.vocab_topk import vocab_logits_topk
from ..parallel.comm import copy_to_model
from .config import GitConfig
from .nn import (
    LayerNorm,
    Linear,
    acc_dtype,
    empty_param,
    attention_weights,
    gelu_erf,
    layer_norm,
    linear,
    merge_heads,
    qkv_project,
    row_linear,
)

NEG_INF = -1e18  # additive-mask "blocked"; avoids inf-inf NaN edge cases


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class BertSelfAttention(nn.Module):
    def __init__(self, d, device=None, dtype=None):
        super().__init__()
        self.query = Linear(d, d, device=device, dtype=dtype)
        self.key = Linear(d, d, device=device, dtype=dtype)
        self.value = Linear(d, d, device=device, dtype=dtype)

    def project(self, x):
        return linear(x, self.query), linear(x, self.key), linear(x, self.value)


class _DenseLN(nn.Module):
    def __init__(self, d_in, d_out, eps, device=None, dtype=None):
        super().__init__()
        self.dense = Linear(d_in, d_out, device=device, dtype=dtype)
        self.LayerNorm = LayerNorm(d_out, eps, device, dtype)


class BertAttention(nn.Module):
    def __init__(self, cfg: GitConfig, device=None, dtype=None):
        super().__init__()
        d = cfg.hidden_size
        # the reference's submodule is named `self`
        self.add_module("self", BertSelfAttention(d, device, dtype))
        self.output = _DenseLN(d, d, cfg.bert_ln_eps, device, dtype)

    @property
    def qkv(self) -> BertSelfAttention:
        return self._modules["self"]


class BertLayer(nn.Module):
    """Post-norm BERT layer (modeling_bert.py:269-297)."""

    def __init__(self, cfg: GitConfig, device=None, dtype=None):
        super().__init__()
        d, f = cfg.hidden_size, cfg.feedforward_size
        self.attention = BertAttention(cfg, device, dtype)
        self.intermediate = nn.Module()
        self.intermediate.dense = Linear(d, f, device=device, dtype=dtype)
        self.output = _DenseLN(f, d, cfg.bert_ln_eps, device, dtype)

    def linears(self):
        sa = self.attention.qkv
        return (sa.query, sa.key, sa.value, self.attention.output.dense,
                self.intermediate.dense, self.output.dense)


class TextualHead(nn.Module):
    def __init__(self, cfg: GitConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d, v = cfg.hidden_size, cfg.vocab_size
        self.visual_projection = nn.ModuleList([
            Linear(cfg.visual_feature_size, d, device=device, dtype=dtype),
            LayerNorm(d, cfg.projection_ln_eps, device, dtype),
        ])
        self.embedding = nn.Module()
        self.embedding.words = nn.Module()
        self.embedding.words.weight = empty_param((v, d), device, dtype)
        self.embedding.positions = nn.Module()
        self.embedding.positions.weight = empty_param((cfg.max_caption_length, d), device, dtype)
        self.embedding.layer_norm = LayerNorm(d, cfg.embedding_ln_eps, device, dtype)
        self.transformer = nn.Module()
        self.transformer.encoder = nn.Module()
        self.transformer.encoder.layer = nn.ModuleList(
            BertLayer(cfg, device, dtype) for _ in range(cfg.num_layers)
        )
        # tied head: logits = h @ words^T + bias (decoder.py:500-505)
        self.output = Linear(d, v, device=device, dtype=dtype)
        self.output.weight = self.embedding.words.weight
        # the model group under tensor parallelism (parallel/mesh.py), and
        # its twin for captured decode steps (NCCL only)
        self.tp_group = None
        self.graph_group = None

    def layers(self) -> List[BertLayer]:
        return list(self.transformer.encoder.layer)

    @torch.no_grad()
    def init_params(self, generator):
        """Random init with gitax's scheme: normal std 0.02 for matmul
        weights and both embedding tables, LayerNorm ones/zeros, zero
        biases; drawn from `generator` on the CPU."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif "LayerNorm" in name or "layer_norm" in name or name == "visual_projection.1.weight":
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)


# ---------------------------------------------------------------------------
# sub-modules
# ---------------------------------------------------------------------------


def project_visual(tx: TextualHead, feats, cfg: GitConfig):
    """'linearLn' projection of encoder tokens into decoder space."""
    lin, ln = tx.visual_projection
    return layer_norm(linear(feats, lin), ln.weight, ln.bias, cfg.projection_ln_eps)


def embed_captions(tx: TextualHead, tokens, cfg: GitConfig, position_offset=0):
    """Word + positional embedding with LN(eps 1e-8); tokens [B, T].
    position_offset: an int or a 0-dim integer tensor on the tokens'
    device (a decode step's cache position, never read on the host)."""
    e = tx.embedding
    t = tokens.shape[-1]
    word = e.words.weight[tokens]
    pos_idx = position_offset + torch.arange(t, device=tokens.device)
    pos = e.positions.weight[pos_idx]
    ln = e.layer_norm
    return layer_norm(word + pos, ln.weight, ln.bias, cfg.embedding_ln_eps)


def output_logits(tx: TextualHead, hidden, acc_dtype=None):
    """Weight-tied output projection.  acc_dtype=float32 (the decode
    path) keeps the products of the activation-dtype operands in f32:
    both operands are cast up exactly, so the beam's logits are never
    rounded to bf16.  The int8 head applies its per-vocab scale to the
    logits."""
    out = tx.output
    out_dtype = acc_dtype or hidden.dtype
    h = hidden.to(out_dtype)
    if out.quantized:
        logits = torch.matmul(h, out.weight_q8_t.to(out_dtype))
        logits = logits * out.weight_scale.to(out_dtype)
    else:
        w = out.weight.to(hidden.dtype).to(out_dtype)
        logits = torch.matmul(h, w.t())
    return logits + out.bias.to(out_dtype)


def build_unified_mask(num_memory: int, num_text: int, memory_valid=None,
                       bi_valid_mask=None, batch: int = 1, device=None):
    """Additive attention mask [B, 1, M+T, M+T] (decoder.py:114-146):
    mem->mem 0, mem->text blocked, text->mem 0, text->text causal;
    padded memory columns blocked everywhere; `bi_valid_mask` columns
    forced open for all rows."""
    m, t = num_memory, num_text
    s = m + t
    row = torch.arange(s, device=device)[:, None]
    col = torch.arange(s, device=device)[None, :]
    is_text_col = col >= m
    is_text_row = row >= m
    causal_block = (col > row) & is_text_col & is_text_row
    mem_to_text = (~is_text_row) & is_text_col
    zero = torch.zeros((), dtype=torch.float32, device=device)
    blocked = torch.full((), NEG_INF, dtype=torch.float32, device=device)
    mask = torch.where(causal_block | mem_to_text, blocked, zero)
    mask = mask.expand(batch, s, s)
    if memory_valid is not None:
        col_block = torch.cat(
            [~memory_valid, torch.zeros((batch, t), dtype=torch.bool, device=device)], 1
        )
        mask = mask + torch.where(col_block[:, None, :], blocked, zero)
    if bi_valid_mask is not None:
        tv = bi_valid_mask.shape[1]
        open_cols = torch.cat([
            torch.zeros((batch, m), dtype=torch.bool, device=device),
            bi_valid_mask,
            torch.zeros((batch, t - tv), dtype=torch.bool, device=device),
        ], 1)
        mask = torch.where(open_cols[:, None, :], zero, mask)
    return mask[:, None, :, :]


def _attn_tail(xcur, ctx_merged, layer: BertLayer, cfg: GitConfig, tp_group=None):
    """Out-projection + residual post-norm + MLP + residual post-norm;
    the one home of this sequence for the full forward, the prefill and
    both decode-step paths.  tp_group: the model group of a sharded layer
    (the output maps row-parallel)."""
    ln1 = layer.attention.output.LayerNorm
    attn_out = row_linear(ctx_merged, layer.attention.output.dense, tp_group)
    x = layer_norm(attn_out + xcur, ln1.weight, ln1.bias, cfg.bert_ln_eps)
    inter = gelu_erf(linear(copy_to_model(x, tp_group), layer.intermediate.dense))
    ln2 = layer.output.LayerNorm
    return layer_norm(row_linear(inter, layer.output.dense, tp_group) + x, ln2.weight, ln2.bias,
                      cfg.bert_ln_eps)


def local_heads(layer: BertLayer, cfg: GitConfig) -> int:
    """The layer's head count: its rank's under tensor parallelism, read
    from the query's width."""
    return layer.attention.qkv.query.bias.shape[0] // cfg.head_dim


def _bert_layer(x, layer: BertLayer, cfg: GitConfig, mask, fast=False, flash_memory=None,
                tp_group=None):
    """One decoder layer; returns (output, (q, k, v)).  flash_memory=M
    runs the attention through `ops.flash_attention.fused_attention` with
    GIT's block mask over M leading memory tokens (built in the kernel
    from indices; `mask` and `fast` are not read), else the plain path
    with the additive `mask`.  The head count is the layer's own (its
    rank's under tensor parallelism, tp_group)."""
    q, k, v = qkv_project(copy_to_model(x, tp_group), layer.attention.qkv,
                          local_heads(layer, cfg))
    if flash_memory is not None:
        ctx = fused_attention(q, k, v, num_memory=flash_memory, masked=True)
    else:
        ctx = torch.matmul(attention_weights(q, k, mask, fast=fast).to(v.dtype), v)
    return _attn_tail(x, merge_heads(ctx), layer, cfg, tp_group), (q, k, v)


# ---------------------------------------------------------------------------
# full (parity) forward
# ---------------------------------------------------------------------------


def textual_forward(tx: TextualHead, visual_features, caption_tokens, cfg: GitConfig,
                    memory_valid=None, bi_valid_mask=None, dtype=torch.float32,
                    fast=False):
    """Full unified forward -> logits [B, T, vocab]."""
    b, t = caption_tokens.shape
    text = embed_captions(tx, caption_tokens, cfg).to(dtype)
    if visual_features is not None:
        mem = project_visual(tx, visual_features.to(dtype), cfg)
        m = mem.shape[1]
        x = torch.cat([mem, text], 1)
    else:
        m = 0
        x = text
    mask = build_unified_mask(m, t, memory_valid, bi_valid_mask, batch=b,
                              device=x.device)
    for layer in tx.layers():
        x, _ = _bert_layer(x, layer, cfg, mask, fast=fast, tp_group=tx.tp_group)
    return output_logits(tx, x[:, m:])


# ---------------------------------------------------------------------------
# incremental decode: prefill + step with a static KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """Decode state.

    mem_kv: per-layer [B, H, M, 2Dh] memory k|v interleaved per head,
      stored once per batch element (beams share it); the activation
      dtype, or int8 with per-layer `mem_scale` [B, H, 2] f32 k|v scales.
      Both decode paths read this one layout.
    txt_kv: per-layer [T_max, B*beams, H*2Dh] text k|v, time-major,
      updated in place one row per step.
    length: number of text positions already cached (the next position),
      a 0-dim int32 tensor on the cache's device: the decode step and
      kernel 1 read it there, so no step reads the host and a captured
      step replays at any position (`decode.device_loop`).
    mem_bias: [B, M] f32 additive memory bias (0 valid / NEG_INF padded),
      built once at prefill from memory_valid; None when all are valid.
    anc: [B*beams, T_max] int32 beam ancestry, or None: slot t of beam k
      lives in cache row b*K + anc[b*K+k, t].  With it, beam search never
      reorders the cache.
    """

    mem_kv: list
    txt_kv: list
    length: torch.Tensor
    mem_bias: Optional[torch.Tensor] = None
    mem_scale: Optional[list] = None
    anc: Optional[torch.Tensor] = None

    @property
    def max_text_len(self):
        return self.txt_kv[0].shape[0]

    @property
    def num_layers(self):
        return len(self.txt_kv)

    @property
    def batch(self):
        return self.mem_kv[0].shape[0]


def prefill(tx: TextualHead, visual_features, prefix_tokens, cfg: GitConfig,
            max_text_len: int, memory_valid=None, dtype=torch.float32, fast=False,
            kernel_memory=False, flash=None):
    """Run [memory; prefix] once; return last-position f32 logits and a
    cache ready for single-token steps.  fast=True keeps the attention
    score math in the activation dtype.  kernel_memory='int8' stores the
    memory k|v as int8 with per-(batch, head) scales, read only by the
    decode-attention kernel path; any other value keeps the activation
    dtype.

    flash routes the attention through the fused-attention kernel with
    the block mask built in the kernel (gitax textual.py:369-386): None
    applies gitax's auto rule to M + Tp; either way only for a fully valid
    memory (the kernel has no validity input).  The cache is built from
    the same k and v on both paths."""
    b, tp = prefix_tokens.shape
    mem = project_visual(tx, visual_features.to(dtype), cfg)
    m = mem.shape[1]
    text = embed_captions(tx, prefix_tokens, cfg).to(dtype)
    x = torch.cat([mem, text], 1)
    if flash is None:
        flash = auto_flash(m + tp, dtype, x.device)
    flash = flash and memory_valid is None
    # the additive mask is [B, 1, S, S] f32 (197 MB at B=32, S=1240): only
    # the plain path builds it
    mask = None if flash else build_unified_mask(m, tp, memory_valid, batch=b, device=x.device)
    dh = cfg.head_dim
    if max_text_len < tp:
        raise ValueError("prefix of {} tokens exceeds max_text_len {}".format(tp, max_text_len))
    mem_kv, mem_scale, txt_kv = [], [], []
    for layer in tx.layers():
        h = local_heads(layer, cfg)
        x, (_, k, v) = _bert_layer(x, layer, cfg, mask, fast=fast,
                                   flash_memory=m if flash else None, tp_group=tx.tp_group)
        tkv = torch.cat([k[:, :, m:], v[:, :, m:]], -1).permute(2, 0, 1, 3)
        buf = torch.zeros((max_text_len, b, h * 2 * dh), dtype=dtype, device=x.device)
        buf[:tp] = tkv.reshape(tp, b, h * 2 * dh)
        txt_kv.append(buf)
        kv_mem = torch.cat([k[:, :, :m], v[:, :, :m]], -1)
        if kernel_memory == "int8":
            q8, scale = quantize_memory(kv_mem)
            mem_kv.append(q8)
            mem_scale.append(scale)
        else:
            mem_kv.append(kv_mem)
    logits = output_logits(tx, x[:, m + tp - 1], acc_dtype=acc_dtype(dtype))
    mem_bias = None
    if memory_valid is not None:
        mem_bias = torch.where(memory_valid, 0.0, NEG_INF).float()
    cache = KVCache(
        mem_kv=mem_kv, txt_kv=txt_kv, length=torch.full((), tp, dtype=torch.int32, device=x.device),
        mem_bias=mem_bias, mem_scale=mem_scale if kernel_memory == "int8" else None,
    )
    return logits, cache


def decode_step(tx: TextualHead, tokens, cache: KVCache, cfg: GitConfig,
                dtype=torch.float32, kernel=False, vocab_kernel=False, graph=False):
    """One incremental step: tokens [B*beams] at text position
    cache.length.  Returns (f32 logits [B*beams, vocab], the cache with
    length+1, a new 0-dim tensor); the text cache is updated in place.
    The position stays on the device: nothing here reads the host, so the
    step can be captured in a CUDA graph (an int length, as a hand-built
    cache may hold, is made a tensor first).

    vocab_kernel=True routes the int8 tied head through
    `ops.vocab_topk.vocab_logits_topk` (the CUDA kernel for CUDA tensors,
    its plain version for CPU tensors) and changes the return to
    (logits [B*beams, NB*512] -inf-padded, cache, (bmax, bsum)), what
    `beam_search(vocab_stats=True)` reads (gitax textual.py:546-560).  It
    needs the int8 head and raises without it.

    kernel=True routes each layer's attention through
    `ops.decode_attention.decode_attention`: the CUDA kernel for CUDA
    tensors, its plain version for CPU tensors.  A cache without an
    ancestry table (a prefill not tiled for beam search) gets the
    identity ancestry, each row reading its own slots, which is what the
    plain path reads then.  kernel=False takes the plain path below
    (gitax textual.py:618-675), which scores against all beam rows and
    selects through the ancestry one-hot.  Score math is f32 in both; in
    f32 they agree to rounding, in bf16 the kernel sums both contexts in
    f32 before one cast.

    graph=True: the step runs under `decode.device_loop` (warm-up and
    capture), and its all-reduces go over `tx.graph_group` where the mesh
    made one (NCCL), else over the model group."""
    group = tx.graph_group if graph and tx.graph_group is not None else tx.tp_group
    bk = tokens.shape[0]
    b = cache.batch
    beams = bk // b
    if beams * b != bk:
        raise ValueError("{} tokens for a batch of {}".format(bk, b))
    pos = torch.as_tensor(cache.length, dtype=torch.int32, device=tokens.device)
    x = embed_captions(tx, tokens[:, None], cfg, position_offset=pos).to(dtype)
    dh = cfg.head_dim
    t_max = cache.max_text_len
    # a 0-dim CPU tensor acts as a scalar in device ops: no upload per step
    scale = (1.0 / torch.sqrt(torch.tensor(float(dh)))).to(dtype)
    if cache.mem_scale is not None and not kernel:
        raise ValueError("int8 memory is read only by the decode-attention kernel path")
    if vocab_kernel and not tx.output.quantized:
        raise ValueError("vocab_kernel needs the int8 output head (ops/quant.py)")

    if kernel:
        anc = cache.anc
        if anc is None:
            anc = (torch.arange(bk, dtype=torch.int32, device=x.device) % beams)[:, None]
            anc = anc.expand(bk, t_max).contiguous()

        def attend(xcur, layer, mem_kv, mem_scale, txt_kv):
            h = local_heads(layer, cfg)
            q, k_new, v_new = qkv_project(xcur, layer.attention.qkv, h)
            qs = (q[:, :, 0] * scale).reshape(bk, h * dh)
            kvn = torch.cat([k_new[:, :, 0], v_new[:, :, 0]], -1).reshape(bk, h * 2 * dh)
            ctx = decode_attention(
                qs, kvn, txt_kv, anc, pos, mem_kv, cache.mem_bias, mem_scale,
                beams=beams, num_heads=h, head_dim=dh,
            )
            return ctx.reshape(bk, 1, h * dh)
    else:
        acc = acc_dtype(dtype)  # score math: f32 (f64 for f64 activations)
        txt_bias = torch.where(
            torch.arange(t_max, device=x.device) <= pos, 0.0, NEG_INF
        ).float()
        pos_row = pos.long().reshape(1)  # the cache row this step writes
        anc_onehot = None
        if cache.anc is not None:
            anc_onehot = nn.functional.one_hot(
                cache.anc.long().reshape(b, beams, t_max), beams
            ).to(acc)

        def attend(xcur, layer, mem_kv, mem_scale, txt_kv):
            h = local_heads(layer, cfg)
            q, k_new, v_new = qkv_project(xcur, layer.attention.qkv, h)
            new_row = torch.cat([k_new, v_new], -1).permute(2, 0, 1, 3)
            txt_kv.index_copy_(0, pos_row, new_row.reshape(1, bk, h * 2 * dh))
            qb = (q[:, :, 0] * scale).reshape(b, beams, h, dh).to(acc)
            m = mem_kv.shape[2]
            mem_scores = torch.einsum("bkhd,bhmd->bkhm", qb, mem_kv[..., :dh].to(acc))
            if cache.mem_bias is not None:
                mem_scores = mem_scores + cache.mem_bias[:, None, None, :]
            kvb = txt_kv.reshape(t_max, b, beams, h, 2 * dh)
            txt_kb, txt_vb = kvb[..., :dh], kvb[..., dh:]
            if anc_onehot is None:
                txt_scores = torch.einsum("bkhd,tbkhd->bkht", qb, txt_kb.to(acc))
            else:
                scores_all = torch.einsum("bkhd,tbjhd->bkjht", qb, txt_kb.to(acc))
                txt_scores = torch.einsum("bkjht,bktj->bkht", scores_all, anc_onehot)
            txt_scores = txt_scores + txt_bias
            scores = torch.cat([mem_scores, txt_scores], -1)
            probs = torch.softmax(scores, -1).to(xcur.dtype)
            ctx_mem = torch.einsum("bkhm,bhmd->bkhd", probs[..., :m], mem_kv[..., dh:])
            if anc_onehot is None:
                ctx_txt = torch.einsum("bkht,tbkhd->bkhd", probs[..., m:], txt_vb)
            else:
                pe = torch.einsum("bkht,bktj->bkjht", probs[..., m:],
                                  anc_onehot.to(xcur.dtype))
                ctx_txt = torch.einsum("bkjht,tbjhd->bkhd", pe, txt_vb)
            return (ctx_mem + ctx_txt).reshape(bk, 1, h * dh)

    mem_scale = cache.mem_scale or [None] * cache.num_layers
    for li, layer in enumerate(tx.layers()):
        ctx = attend(x, layer, cache.mem_kv[li], mem_scale[li], cache.txt_kv[li])
        x = _attn_tail(x, ctx, layer, cfg, group)
    cache = dataclasses.replace(cache, length=pos + 1)
    if vocab_kernel:
        out = tx.output
        logits, bmax, bsum = vocab_logits_topk(x[:, 0].contiguous(), out.weight_q8_t,
                                               out.weight_scale, out.bias.float())
        return logits, cache, (bmax, bsum)
    return output_logits(tx, x[:, 0], acc_dtype=acc_dtype(dtype)), cache
