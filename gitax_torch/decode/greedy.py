"""Greedy decoding, the counterpart of `gitax.decode.greedy`: argmax steps
over the KV cache, finished rows keep emitting EOS (reference
decoder.py:347-351).

gitax runs the loop as one `lax.while_loop`; here it is a host loop over
`decode_step`, with one host read per step (the all-finished test).  The
loop stops before a decode step whose logits nobody would read.
"""

from __future__ import annotations

import torch


def greedy_search(decode_step_fn, prefill_logits, cache, prefix_tokens, max_steps: int,
                  eos_id: int = 102):
    """prefill_logits [B, V], prefix_tokens [B, Tp].  Returns (sequences
    [B, max_steps] incl. the prefix, EOS-padded; sum_logprobs [B] f32 over
    the generated tokens up to and including EOS)."""
    b, tp = prefix_tokens.shape
    if tp >= max_steps:
        raise ValueError("a prefix of {} tokens leaves no step of {}".format(tp, max_steps))
    dev = prefill_logits.device
    seqs = torch.full((b, max_steps), eos_id, dtype=torch.long, device=dev)
    seqs[:, :tp] = prefix_tokens
    logits = prefill_logits.float()
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    sum_logprobs = torch.zeros(b, dtype=torch.float32, device=dev)
    for cur in range(tp, max_steps):
        logprobs = torch.log_softmax(logits, dim=-1)
        words = torch.where(finished, eos_id, torch.argmax(logprobs, dim=-1))
        tok_lp = logprobs.gather(1, words[:, None])[:, 0]
        sum_logprobs = sum_logprobs + torch.where(finished, 0.0, tok_lp)
        seqs[:, cur] = words
        finished = finished | (words == eos_id)
        if cur + 1 == max_steps or bool(finished.all()):
            break
        logits, cache = decode_step_fn(words, cache)
        logits = logits.float()
    return seqs, sum_logprobs
