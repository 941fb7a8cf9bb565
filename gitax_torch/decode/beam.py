"""Beam search, the counterpart of `gitax.decode.beam` (plain beam search).

The semantics are gitax's, and through it the reference's
GeneratorWithBeamSearch (decoder.py:1056-1290): per-beam top-C over raw
logits normalized by logsumexp and merged, the rank-arithmetic candidate
triage (EOS -> n-best hypotheses, non-EOS -> the next beams until full),
the n-best merge that keeps existing entries on ties, the forced add at
the last step, OpenNMT length norm and `is_done` early stopping.

gitax runs the search as one `lax.while_loop` (beam.py:1-11, `cond`
:283-284).  Here the search is three parts: `beam_init` (the state),
`beam_step` (the body, a function of device state that updates it in
place) and a loop.  On a CUDA card `decode.device_loop` captures one
step in a CUDA graph under a conditional node whose predicate,
`beam_running`, the last step computed on the card, and replays it
without reading the host; `beam_search` is the eager loop (the CPU, a
model group of m > 1 ranks, and the reference the graph is held
against; and gloo model groups), with one host read per step.  On a
model group the predicate is computed on every rank from values that
are equal on all of them, so the ranks run the same steps.  The cache
is never reordered:
each beam inherits its parent's ancestry row (KVCache.anc).

Every top-k breaks ties toward the lowest index, as gitax does
(beam.py:103-107): `torch.topk` documents no tie order, so the top-k is a
stable descending sort and a slice.  The per-beam top-C over the vocab
goes through gitax's blocked top-k (`_top_k_blocked`), which sorts the
block maxima and then C blocks rather than the whole row: on the plain
path it takes the maxima itself, on the `vocab_stats` path it reads the
block maxima and sums of exponentials that the fused vocab-head kernel
(ops/vocab_topk.py) emits.

The CTRL repetition penalty reads a `seen` [BK, V] mask: it starts from
the prefix, is gathered by parent beam each step and takes the chosen
words.  Sampling (gitax beam.py:288-338) filters the tempered logits with
gitax's positional top-k/top-p, draws P words per beam without
replacement by Gumbel top-k, and scores them by the log-softmax of the
filtered logits; parents are labelled as gitax labels them.  The noise
comes from `gumbel_noise` with the caller's `torch.Generator`: RNG
streams cannot match jax.random, so the parity tests replace
`gumbel_noise` with gitax's own draws.
"""

from __future__ import annotations

import dataclasses
import functools
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
    repetition_penalty: float = 1.0
    # length-norm max_length for is_done; None couples it to max_steps
    norm_max_length: Optional[int] = None
    # sampling (decoder.py:1146-1166): per-beam draws without replacement
    # (Gumbel top-k) after temperature and top-k/top-p filtering
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: Optional[float] = None


def _length_norm(length, alpha):
    """((5+len)/6)^alpha, OpenNMT norm (decoder.py:1310-1313), in f32."""
    length = torch.as_tensor(length, dtype=torch.float32)
    return ((5.0 + length) ** alpha) / torch.tensor(6.0 ** alpha, dtype=torch.float32)


@functools.lru_cache(maxsize=64)
def length_norm_table(max_len: int, alpha: float, device) -> torch.Tensor:
    """[max_len] f32 on `device`: `_length_norm(t, alpha)` for t in
    [0, max_len), each entry from the host's scalar formula (a vectorised
    pow may differ in the last place), uploaded once and cached, so that
    a search's setup uploads nothing."""
    table = torch.stack([_length_norm(t, alpha) for t in range(max_len)])
    return table.to(device)


def top_k_stable(x, k):
    """Top-k along the last axis; ties go to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_top_p_filter(logits, top_k=0, top_p=None, min_tokens_to_keep=1,
                       filter_value=float("-inf")):
    """Top-k / nucleus filtering (reference decoder.py:1343-1375), gitax's
    (beam.py:67-100): top-p removal is positional, by rank in a stable
    descending sort scattered back, so a token tied with the last kept
    logit is still removed."""
    v = logits.shape[-1]
    if top_k and top_k > 0:
        k = min(max(top_k, min_tokens_to_keep), v)
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, filter_value, logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits, order = torch.sort(logits, dim=-1, descending=True, stable=True)
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep tokens until the cumulative probability passes top_p (the
        # first token past it is kept), and at least min_tokens_to_keep
        remove_sorted = torch.zeros_like(cum, dtype=torch.bool)
        remove_sorted[..., 1:] = cum[..., :-1] > top_p
        if min_tokens_to_keep > 1:
            remove_sorted[..., :min_tokens_to_keep] = False
        removed = torch.empty_like(remove_sorted).scatter_(-1, order, remove_sorted)
        logits = torch.where(removed, filter_value, logits)
    return logits


def gumbel_noise(shape, generator):
    """Standard Gumbel noise [shape] f32 on the generator's device:
    -log(E), E ~ Exponential(1).  The sampling search's one source of
    randomness (gitax draws `jax.random.gumbel`, beam.py:325-326)."""
    e = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return -e.exponential_(generator=generator).log()


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


@dataclasses.dataclass
class BeamState:
    """The search's state, every tensor on the logits' device.  `beam_step`
    updates each one IN PLACE (copy_, add_, index_copy_), so a CUDA graph
    that captured one step reads at each replay what the last replay
    wrote.  cur_len [] int32 is the next position to fill and is also the
    cache's length (one tensor); norms [max_len] f32 holds
    `_length_norm(t)` for every t, computed once on the host and indexed
    on the card, so each step divides by the values the host formula
    gives.  seen is the penalty's mask, bmax and bsum the vocab head's
    block statistics, None where unused; the rest are index constants."""

    cache: object
    logits: torch.Tensor
    bmax: Optional[torch.Tensor]
    bsum: Optional[torch.Tensor]
    seen: Optional[torch.Tensor]
    seqs: torch.Tensor
    beam_scores: torch.Tensor
    hyp_seqs: torch.Tensor
    hyp_scores: torch.Tensor
    hyp_count: torch.Tensor
    done: torch.Tensor
    cur_len: torch.Tensor
    norms: torch.Tensor
    own_row: torch.Tensor
    beam_of: torch.Tensor
    sample_beam_of: torch.Tensor
    slots: torch.Tensor
    positions: torch.Tensor
    batch_base: torch.Tensor
    vocab: int


def beam_init(prefill_logits, cache, prefix_tokens, cfg: BeamSearchConfig, rng=None,
              vocab_stats=False) -> BeamState:
    """The state before the first step (see `beam_search` for the
    arguments); raises on settings the search does not take."""
    b, tp = prefix_tokens.shape
    k = cfg.num_beams
    n = cfg.num_keep_best
    p = cfg.per_node_beam_size
    c = p * k  # candidates per batch element
    penalty = cfg.repetition_penalty != 1.0
    if cfg.do_sample and rng is None:
        raise ValueError("do_sample needs a torch.Generator (rng)")
    if vocab_stats and (cfg.do_sample or penalty):
        raise ValueError("vocab_stats serves the plain beam only: no sampling, no "
                         "repetition penalty")
    v = prefill_logits.shape[-1]
    max_len = cfg.max_steps
    eos = cfg.eos_id
    dev = prefill_logits.device
    if tp >= max_len:
        raise ValueError("prefix of {} tokens fills max_steps {}".format(tp, max_len))

    cur_len = torch.full((), tp, dtype=torch.int32, device=dev)
    cache = _tile_beams(cache, k)
    t_buf = cache.max_text_len
    own_row = torch.arange(k, dtype=torch.int32, device=dev).repeat(b)  # [BK]
    cache = dataclasses.replace(
        cache, anc=own_row[:, None].expand(b * k, t_buf).contiguous(), length=cur_len,
    )

    seqs = torch.full((b, k, max_len), eos, dtype=torch.long, device=dev)
    seqs[:, :, :tp] = prefix_tokens[:, None, :]
    beam_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    beam_scores[:, 0] = 0.0
    logits = prefill_logits.repeat_interleave(k, dim=0)
    bmax = bsum = seen = None
    if vocab_stats:
        logits, bmax, bsum = block_stats(logits.float())
    if penalty:
        seen = torch.zeros((b, v), dtype=torch.bool, device=dev)
        seen.scatter_(1, prefix_tokens.long(), True)
        seen = seen.repeat_interleave(k, dim=0)  # [BK, V]
    norms = length_norm_table(max_len, cfg.length_penalty, dev)
    return BeamState(
        cache=cache, logits=logits, bmax=bmax, bsum=bsum, seen=seen, seqs=seqs,
        beam_scores=beam_scores,
        hyp_seqs=torch.full((b, n, max_len), eos, dtype=torch.long, device=dev),
        hyp_scores=torch.full((b, n), float("-inf"), dtype=torch.float32, device=dev),
        hyp_count=torch.zeros((b,), dtype=torch.long, device=dev),
        done=torch.zeros((b,), dtype=torch.bool, device=dev),
        cur_len=cur_len, norms=norms, own_row=own_row,
        beam_of=torch.arange(k, device=dev).repeat_interleave(c),  # [K*C]
        sample_beam_of=torch.arange(k, device=dev).repeat_interleave(p),  # [C]
        slots=torch.arange(k, device=dev),
        positions=torch.arange(max_len, device=dev),
        batch_base=torch.arange(b, device=dev)[:, None] * k,
        vocab=v,
    )


def beam_running(state: BeamState, cfg: BeamSearchConfig):
    """gitax's `cond` (beam.py:283-284) on the card: a 0-dim bool, true
    while a position is left and some batch element is not done.  On a
    model group every rank's `done` and `cur_len` are equal bit for bit
    (they follow from the replicated head's logits over all-reduced
    activations), so every rank computes the same predicate."""
    return (state.cur_len < cfg.max_steps) & ~state.done.all()


def beam_step(state: BeamState, decode_step_fn, cfg: BeamSearchConfig, noise=None,
              vocab_stats=False) -> None:
    """One step of the search (gitax beam.py's loop body), in place on
    `state`; reads nothing on the host, so it can be captured.  noise: a
    sampled search's Gumbel noise [BK, V] for this step (`beam_draw`)."""
    s = state
    b, k, max_len = s.seqs.shape
    n = cfg.num_keep_best
    p = cfg.per_node_beam_size
    c = p * k
    v = s.vocab
    alpha = cfg.length_penalty
    eos = cfg.eos_id
    cur = s.cur_len.long()
    logits = s.logits
    # a 0-dim CPU tensor: a scalar to device ops, no upload
    done_norm = _length_norm((cfg.norm_max_length or max_len) - 1, alpha)
    if s.seen is not None:
        # CTRL (decoder.py:1137-1144): a seen token's positive logit is
        # divided by the penalty, a negative one multiplied
        pen = cfg.repetition_penalty
        logits = torch.where(s.seen, torch.where(logits < 0, logits * pen, logits / pen), logits)
    if cfg.do_sample:
        # temperature, top-k/top-p, then P draws per beam without
        # replacement; the reference keeps at least 2 tokens, gitax at
        # least P as well (beam.py:309-318)
        lt = logits.float()
        if cfg.temperature != 1.0:
            lt = lt / cfg.temperature
        lt = top_k_top_p_filter(lt, cfg.top_k, cfg.top_p, min_tokens_to_keep=max(2, p))
        noisy = torch.where(torch.isfinite(lt), lt + noise, float("-inf"))
        _, words_s = top_k_stable(noisy, p)  # [BK, P]
        samp_lp = torch.log_softmax(lt, dim=-1).gather(1, words_s)
        # candidates stay beam-major: parent j's P draws at j*P.. (the
        # reference mislabels the parents here; gitax does not)
        next_scores = (samp_lp.reshape(b, k, p) + s.beam_scores[:, :, None]).reshape(b, c)
        next_idx = words_s.reshape(b, c) + (s.sample_beam_of * v)[None, :]
    else:
        # top-C per beam over raw logits, normalized by logsumexp only
        # for the candidates, then merged over the group's K*C
        if vocab_stats:
            pb_vals, pb_idx = _top_k_blocked(logits, c, block=TILE, bmax=s.bmax)
            lse = combine_lse(s.bmax, s.bsum)
        else:
            pb_vals, pb_idx = _top_k_blocked(logits, c)  # [BK, C]
            lse = torch.logsumexp(logits.float(), dim=-1)
        cand = pb_vals.float() - lse[:, None] + s.beam_scores.reshape(-1)[:, None]
        merged_scores = cand.reshape(b, k * c)
        merged_idx = pb_idx.reshape(b, k * c) + (s.beam_of * v)[None, :]
        next_scores, sel = top_k_stable(merged_scores, c)
        next_idx = merged_idx.gather(1, sel)
    beam_id = next_idx // v
    word_id = next_idx % v

    # done check: hypotheses from BEFORE this step vs the best candidate
    # (sampled candidates are unsorted)
    best = next_scores.amax(dim=1) if cfg.do_sample else next_scores[:, 0]
    newly_done = (s.hyp_count >= n) & (s.hyp_scores.amin(dim=1) >= best / done_norm)
    done_now = s.done | newly_done

    force_add = (cur + 1) == max_len  # decoder.py:1202
    is_add = (word_id == eos) | force_add
    not_add = (~is_add).long()
    non_eos_before = torch.cumsum(not_add, dim=1) - not_add
    # beam fillers: the first k non-EOS candidates
    fill = (~is_add) & (non_eos_before < k)
    sof = ((non_eos_before[:, :, None] == s.slots) & fill[:, :, None]).float()
    new_scores = torch.einsum("bck,bc->bk", sof, next_scores)
    new_words = torch.einsum("bck,bc->bk", sof, word_id.float()).long()
    new_parents = torch.einsum("bck,bc->bk", sof, beam_id.float()).long()

    # hypothesis adds: EOS (or forced) candidates seen before the beam
    # filled (decoder.py:1209-1211)
    eligible = is_add & (non_eos_before < k) & ~done_now[:, None]
    cand_norm = next_scores / s.norms.index_select(0, cur.reshape(1))
    cand_norm = torch.where(eligible, cand_norm, float("-inf"))
    parent_seqs = s.seqs.gather(1, beam_id[:, :, None].expand(b, c, max_len))
    cand_seqs = torch.where(s.positions < cur, parent_seqs, eos)
    # top-N merge; existing entries come first and win ties
    all_scores = torch.cat([s.hyp_scores, cand_norm], dim=1)
    all_seqs = torch.cat([s.hyp_seqs, cand_seqs], dim=1)
    hyp_scores, top_idx = top_k_stable(all_scores, n)
    s.hyp_seqs.copy_(all_seqs.gather(1, top_idx[:, :, None].expand(b, n, max_len)))
    s.hyp_scores.copy_(hyp_scores)
    s.hyp_count.add_(eligible.sum(dim=1))

    # beam update; frozen for done batches and at the forced last step
    upd = (~done_now)[:, None] & ~force_add
    parents = torch.where(upd, new_parents, s.slots[None, :])
    s.beam_scores.copy_(torch.where(
        upd, new_scores,
        torch.where(done_now[:, None], torch.zeros_like(new_scores), s.beam_scores),
    ))
    words = torch.where(upd, new_words, eos)
    seqs = s.seqs.gather(1, parents[:, :, None].expand(b, k, max_len))
    seqs.index_copy_(2, cur.reshape(1), words[:, :, None])  # seqs[:, :, cur] = words
    s.seqs.copy_(seqs)
    s.done.copy_(done_now)

    # no cache reorder: inherit the parent's ancestry row and claim
    # position cur for this row
    flat_parents = (parents + s.batch_base).reshape(-1)
    anc = s.cache.anc.index_select(0, flat_parents)
    anc.index_copy_(1, cur.reshape(1), s.own_row[:, None])
    s.cache.anc.copy_(anc)
    if s.seen is not None:
        seen = s.seen.index_select(0, flat_parents)
        seen.scatter_(1, words.reshape(-1, 1), True)
        s.seen.copy_(seen)
    out = decode_step_fn(words.reshape(-1), s.cache)
    s.logits.copy_(out[0])
    if vocab_stats:
        s.bmax.copy_(out[2][0])
        s.bsum.copy_(out[2][1])
    s.cur_len.add_(1)


def beam_result(state: BeamState, cfg: BeamSearchConfig):
    """(decoded [B, N, max_steps] int64, logprobs [B, N] f32), new tensors
    (not views of the state)."""
    filled = torch.isfinite(state.hyp_scores)
    logprobs = torch.where(filled, state.hyp_scores, EMPTY_HYP_LOGPROB)
    decoded = torch.where(filled[:, :, None], state.hyp_seqs, cfg.eos_id)
    return decoded, logprobs


def beam_search(decode_step_fn, prefill_logits, cache, prefix_tokens,
                cfg: BeamSearchConfig, rng=None, vocab_stats=False, run=None):
    """Run the search.  Returns (decoded [B, N, max_steps] int64,
    logprobs [B, N] f32); sequences include the prefix and are
    EOS-padded.  decode_step_fn(tokens [BK], cache) -> (logits [BK, V],
    cache).  rng: a torch.Generator on the logits' device, required with
    cfg.do_sample.

    vocab_stats=True: decode_step_fn returns (logits [BK, NB*512]
    -inf-padded, cache, (bmax, bsum) [BK, NB]), the vocab-head kernel's
    outputs (ops/vocab_topk.py), and each step's top-k and logsumexp read
    the block statistics instead of passing over the full logits.  The
    first step's statistics come from the prefill's plain-head logits
    (`block_stats`).  The vocab size stays the unpadded prefill logits'.
    It serves the plain beam only: with sampling or a repetition penalty
    it raises, as gitax asserts.

    run: None runs the eager loop (`device_loop.run_eager`: one host read
    a step); else a callable taking (state, step, running, result,
    replays, draw, rng), as `device_loop.run` bound to its key does, which
    runs the steps on the card.  A sampled step's noise is drawn before
    the step, one `gumbel_noise` call a step, as before."""
    from .device_loop import run_eager

    state = beam_init(prefill_logits, cache, prefix_tokens, cfg, rng, vocab_stats)

    def step(st, noise):
        beam_step(st, decode_step_fn, cfg, noise, vocab_stats)

    draw = None
    if cfg.do_sample:
        shape = state.logits.shape

        def draw(g):
            return gumbel_noise(shape, g)

    args = (state, step, lambda st: beam_running(st, cfg), lambda st: beam_result(st, cfg))
    if run is None:
        return run_eager(*args, draw=draw, rng=rng)
    return run(*args, replays=cfg.max_steps - prefix_tokens.shape[1], draw=draw, rng=rng)
