"""Greedy decoding, the counterpart of `gitax.decode.greedy`: argmax steps
over the KV cache, finished rows keep emitting EOS (reference
decoder.py:347-351).

gitax runs the loop as one `lax.while_loop` (greedy.py:66).  Here the
search is `greedy_init` (the prefill's pick), `greedy_step` (a decode
step and the next pick, in place on device state) and a loop: on a CUDA
card `decode.device_loop` replays a captured step under the predicate
`greedy_running`, computed on the card; `greedy_search`'s eager loop
reads the host once a step.  No decode step runs whose logits nobody
would read.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class GreedyState:
    """The search's state, updated IN PLACE by `greedy_step`.  cur [] int32
    is the position last filled and also the cache's length (one tensor):
    the next decode step writes the cache there.  tok [B]: the tokens
    picked at cur."""

    cache: object
    seqs: torch.Tensor
    tok: torch.Tensor
    finished: torch.Tensor
    sum_logprobs: torch.Tensor
    cur: torch.Tensor


def _pick(s: GreedyState, logits, eos_id):
    """Argmax at position cur, in place; finished rows emit EOS."""
    logprobs = torch.log_softmax(logits, dim=-1)
    words = torch.where(s.finished, eos_id, torch.argmax(logprobs, dim=-1))
    tok_lp = logprobs.gather(1, words[:, None])[:, 0]
    s.sum_logprobs.add_(torch.where(s.finished, 0.0, tok_lp))
    s.seqs.index_copy_(1, s.cur.long().reshape(1), words[:, None])  # seqs[:, cur] = words
    s.tok.copy_(words)
    s.finished.logical_or_(words == eos_id)


def greedy_init(prefill_logits, cache, prefix_tokens, max_steps: int, eos_id: int = 102):
    """The state after the pick from the prefill's logits."""
    b, tp = prefix_tokens.shape
    if tp >= max_steps:
        raise ValueError("a prefix of {} tokens leaves no step of {}".format(tp, max_steps))
    dev = prefill_logits.device
    seqs = torch.full((b, max_steps), eos_id, dtype=torch.long, device=dev)
    seqs[:, :tp] = prefix_tokens
    cur = torch.full((), tp, dtype=torch.int32, device=dev)
    s = GreedyState(cache=dataclasses.replace(cache, length=cur), seqs=seqs,
                    tok=torch.zeros(b, dtype=torch.long, device=dev),
                    finished=torch.zeros(b, dtype=torch.bool, device=dev),
                    sum_logprobs=torch.zeros(b, dtype=torch.float32, device=dev), cur=cur)
    _pick(s, prefill_logits.float(), eos_id)
    return s


def greedy_running(s: GreedyState, max_steps: int):
    """A 0-dim bool: a position is left after cur and a row is running."""
    return (s.cur + 1 < max_steps) & ~s.finished.all()


def greedy_step(s: GreedyState, decode_step_fn, eos_id: int = 102) -> None:
    """Feed the last pick, advance cur, pick again; in place."""
    logits, _ = decode_step_fn(s.tok, s.cache)
    s.cur.add_(1)
    _pick(s, logits.float(), eos_id)


def greedy_result(s: GreedyState):
    return s.seqs.clone(), s.sum_logprobs.clone()


def greedy_search(decode_step_fn, prefill_logits, cache, prefix_tokens, max_steps: int,
                  eos_id: int = 102, run=None):
    """prefill_logits [B, V], prefix_tokens [B, Tp].  Returns (sequences
    [B, max_steps] incl. the prefix, EOS-padded; sum_logprobs [B] f32 over
    the generated tokens up to and including EOS).  run: None for the
    eager loop, else a device loop (see `beam.beam_search`)."""
    from .device_loop import run_eager

    state = greedy_init(prefill_logits, cache, prefix_tokens, max_steps, eos_id)
    args = (state, lambda st, _: greedy_step(st, decode_step_fn, eos_id),
            lambda st: greedy_running(st, max_steps), greedy_result)
    if run is None:
        return run_eager(*args)
    return run(*args, replays=max_steps - prefix_tokens.shape[1] - 1)
