"""Beam search, the counterpart of `gitax.decode.beam` (plain beam search).

The semantics are gitax's, and through it the reference's
GeneratorWithBeamSearch (decoder.py:1056-1290): per-beam top-C over raw
logits normalized by logsumexp and merged, the rank-arithmetic candidate
triage (EOS -> n-best hypotheses, non-EOS -> the next beams until full),
the n-best merge that keeps existing entries on ties, the forced add at
the last step, OpenNMT length norm and `is_done` early stopping.

gitax runs the search as one `lax.while_loop`; here the loop is a Python
loop on the host over device tensors, with one host read per step (the
all-done test).  The cache is never reordered: each beam inherits its
parent's ancestry row (KVCache.anc).

Every top-k breaks ties toward the lowest index, as gitax does
(beam.py:103-107): `torch.topk` documents no tie order, so the top-k is a
stable descending sort and a slice.  The per-beam top-C over the vocab
goes through gitax's blocked top-k (`_top_k_blocked`), which sorts the
block maxima and then C blocks rather than the whole row: on the plain
path it takes the maxima itself, on the `vocab_stats` path it reads the
block maxima and sums of exponentials that the fused vocab-head kernel
(ops/vocab_topk.py) emits.

Sampling and the repetition penalty are not ported yet: the config has no
fields for them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.vocab_topk import TILE, block_stats, combine_lse

NEG_INF = -1e9
EMPTY_HYP_LOGPROB = -1e5  # reference decoder.py:1265-1266


@dataclasses.dataclass(frozen=True)
class BeamSearchConfig:
    """Static search hyper-parameters (reference model.py:34-40 defaults)."""

    num_beams: int = 4
    per_node_beam_size: int = 2
    length_penalty: float = 0.6
    max_steps: int = 1024  # sequence buffer length, prefix included
    num_keep_best: int = 1
    eos_id: int = 102
    # length-norm max_length for is_done; None couples it to max_steps
    norm_max_length: Optional[int] = None


def _length_norm(length, alpha):
    """((5+len)/6)^alpha, OpenNMT norm (decoder.py:1310-1313), in f32."""
    length = torch.as_tensor(length, dtype=torch.float32)
    return ((5.0 + length) ** alpha) / torch.tensor(6.0 ** alpha, dtype=torch.float32)


def top_k_stable(x, k):
    """Top-k along the last axis; ties go to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _top_k_blocked(x, k, block=TILE, bmax=None):
    """Exact top-k of x [B, N] through a block-max prefilter (gitax
    beam.py:142-177): the k blocks of highest max (ties to the lower
    block) cover the true top-k, since each block holding one of them has
    a max ranked at or before it; the top-k of those k blocks, gathered
    in index order, keeps the lowest-index tie rule.  bmax: the [B, NB]
    maxima of x under the -inf padding, precomputed (the vocab-head
    kernel's); else taken here, and with fewer than max(k, 4) blocks the
    plain top-k runs instead, as in gitax."""
    b, n = x.shape
    nb = (n + block - 1) // block
    if bmax is None and nb < max(k, 4):
        return top_k_stable(x, k)
    pad = nb * block - n
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=float("-inf"))
    xb = x.reshape(b, nb, block)
    if bmax is None:
        bmax = xb.amax(dim=-1)
    if tuple(bmax.shape) != (b, nb):
        raise ValueError("bmax {} for {} rows of {} blocks".format(tuple(bmax.shape), b, nb))
    if k > nb:
        raise ValueError("top-{} over {} blocks: the blocks cannot cover it".format(k, nb))
    _, bidx = top_k_stable(bmax, k)
    bidx = torch.sort(bidx, dim=-1).values
    cand = xb.gather(1, bidx[:, :, None].expand(b, k, block))
    vals, within = top_k_stable(cand.reshape(b, k * block), k)
    idx = bidx.gather(1, within // block) * block + within % block
    return vals, idx


def _tile_beams(cache, num_beams: int):
    """Expand the TEXT cache to B*num_beams rows (b0 b0 .. b1 b1 ..).
    Memory K/V stay at batch B: beams of one element share them."""
    return dataclasses.replace(
        cache,
        txt_kv=[kv.repeat_interleave(num_beams, dim=1) for kv in cache.txt_kv],
    )


def beam_search(decode_step_fn, prefill_logits, cache, prefix_tokens,
                cfg: BeamSearchConfig, vocab_stats=False):
    """Run the search.  Returns (decoded [B, N, max_steps] int64,
    logprobs [B, N] f32); sequences include the prefix and are
    EOS-padded.  decode_step_fn(tokens [BK], cache) -> (logits [BK, V],
    cache).

    vocab_stats=True: decode_step_fn returns (logits [BK, NB*512]
    -inf-padded, cache, (bmax, bsum) [BK, NB]), the vocab-head kernel's
    outputs (ops/vocab_topk.py), and each step's top-k and logsumexp read
    the block statistics instead of passing over the full logits.  The
    first step's statistics come from the prefill's plain-head logits
    (`block_stats`).  The vocab size stays the unpadded prefill logits'."""
    b, tp = prefix_tokens.shape
    k = cfg.num_beams
    n = cfg.num_keep_best
    c = cfg.per_node_beam_size * k  # candidates per batch element
    v = prefill_logits.shape[-1]
    max_len = cfg.max_steps
    alpha = cfg.length_penalty
    eos = cfg.eos_id
    dev = prefill_logits.device
    if tp >= max_len:
        raise ValueError("prefix of {} tokens fills max_steps {}".format(tp, max_len))

    cache = _tile_beams(cache, k)
    t_buf = cache.max_text_len
    own_row = torch.arange(k, dtype=torch.int32, device=dev).repeat(b)  # [BK]
    cache = dataclasses.replace(
        cache, anc=own_row[:, None].expand(b * k, t_buf).contiguous()
    )

    seqs = torch.full((b, k, max_len), eos, dtype=torch.long, device=dev)
    seqs[:, :, :tp] = prefix_tokens[:, None, :]
    beam_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    beam_scores[:, 0] = 0.0
    hyp_seqs = torch.full((b, n, max_len), eos, dtype=torch.long, device=dev)
    hyp_scores = torch.full((b, n), float("-inf"), dtype=torch.float32, device=dev)
    hyp_count = torch.zeros((b,), dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    logits = prefill_logits.repeat_interleave(k, dim=0)
    if vocab_stats:
        logits, bmax, bsum = block_stats(logits.float())

    # length norms are 0-dim CPU tensors: scalars to device ops, no upload
    done_norm = _length_norm((cfg.norm_max_length or max_len) - 1, alpha)
    beam_of = torch.arange(k, device=dev).repeat_interleave(c)  # [K*C]
    slots = torch.arange(k, device=dev)
    positions = torch.arange(max_len, device=dev)
    batch_base = torch.arange(b, device=dev)[:, None] * k

    cur_len = tp
    while cur_len < max_len and not bool(done.all()):
        # top-C per beam over raw logits, normalized by logsumexp only for
        # the candidates, then merged over the group's K*C candidates
        if vocab_stats:
            pb_vals, pb_idx = _top_k_blocked(logits, c, block=TILE, bmax=bmax)
            lse = combine_lse(bmax, bsum)
        else:
            pb_vals, pb_idx = _top_k_blocked(logits, c)  # [BK, C]
            lse = torch.logsumexp(logits.float(), dim=-1)
        cand = pb_vals.float() - lse[:, None] + beam_scores.reshape(-1)[:, None]
        merged_scores = cand.reshape(b, k * c)
        merged_idx = pb_idx.reshape(b, k * c) + (beam_of * v)[None, :]
        next_scores, sel = top_k_stable(merged_scores, c)
        next_idx = merged_idx.gather(1, sel)
        beam_id = next_idx // v
        word_id = next_idx % v

        # done check: hypotheses from BEFORE this step vs the best candidate
        newly_done = (hyp_count >= n) & (
            hyp_scores.amin(dim=1) >= next_scores[:, 0] / done_norm
        )
        done_now = done | newly_done

        force_add = (cur_len + 1) == max_len  # decoder.py:1202
        is_add = (word_id == eos) | force_add
        not_add = (~is_add).long()
        non_eos_before = torch.cumsum(not_add, dim=1) - not_add
        # beam fillers: the first k non-EOS candidates
        fill = (~is_add) & (non_eos_before < k)
        sof = ((non_eos_before[:, :, None] == slots) & fill[:, :, None]).float()
        new_scores = torch.einsum("bck,bc->bk", sof, next_scores)
        new_words = torch.einsum("bck,bc->bk", sof, word_id.float()).long()
        new_parents = torch.einsum("bck,bc->bk", sof, beam_id.float()).long()

        # hypothesis adds: EOS (or forced) candidates seen before the beam
        # filled (decoder.py:1209-1211)
        eligible = is_add & (non_eos_before < k) & ~done_now[:, None]
        cand_norm = next_scores / _length_norm(cur_len, alpha)
        cand_norm = torch.where(eligible, cand_norm, float("-inf"))
        parent_seqs = seqs.gather(1, beam_id[:, :, None].expand(b, c, max_len))
        cand_seqs = torch.where(positions < cur_len, parent_seqs, eos)
        # top-N merge; existing entries come first and win ties
        all_scores = torch.cat([hyp_scores, cand_norm], dim=1)
        all_seqs = torch.cat([hyp_seqs, cand_seqs], dim=1)
        hyp_scores, top_idx = top_k_stable(all_scores, n)
        hyp_seqs = all_seqs.gather(1, top_idx[:, :, None].expand(b, n, max_len))
        hyp_count = hyp_count + eligible.sum(dim=1)

        # beam update; frozen for done batches and at the forced last step
        upd = (~done_now)[:, None] & (not force_add)
        parents = torch.where(upd, new_parents, slots[None, :])
        beam_scores = torch.where(
            upd, new_scores,
            torch.where(done_now[:, None], torch.zeros_like(new_scores), beam_scores),
        )
        words = torch.where(upd, new_words, eos)
        seqs = seqs.gather(1, parents[:, :, None].expand(b, k, max_len))
        seqs[:, :, cur_len] = words
        done = done_now

        # no cache reorder: inherit the parent's ancestry row and claim
        # position cur_len for this row
        anc = cache.anc[(parents + batch_base).reshape(-1)]
        anc[:, cur_len] = own_row
        cache = dataclasses.replace(cache, anc=anc)
        if vocab_stats:
            logits, cache, (bmax, bsum) = decode_step_fn(words.reshape(-1), cache)
        else:
            logits, cache = decode_step_fn(words.reshape(-1), cache)
        cur_len += 1

    filled = torch.isfinite(hyp_scores)
    logprobs = torch.where(filled, hyp_scores, EMPTY_HYP_LOGPROB)
    decoded = torch.where(filled[:, :, None], hyp_seqs, eos)
    return decoded, logprobs
