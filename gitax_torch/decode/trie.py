"""Trie-constrained greedy decoding (classification as generation), the
counterpart of `gitax.decode.trie` and through it of the reference's
TrieAutoRegressiveBeamSearch + TokenTrie (trie_decoder.py:27-257):
generation restricted to a vocabulary of class names, each ending in
[SEP], by boosting the logprobs of the current trie node's children by
(logits.max() - logits.min() + 1) over the finite logits, then argmax
(trie_decoder.py:62-63, 148-149), with the legacy search's block of the
last token (-10000, trie_decoder.py:141) and EOS forcing.

The trie is the dense pair gitax builds, children_tokens [M, C] and
children_index [M, C] (C = the largest branching, padded with -1), so a
step is a gather, a scatter into a [B, V] mask and an argmax, batched
over B.  As in `decode.greedy`, the search is an init (the first pick),
a step in place on device state (`trie_step`) and a loop: gitax's
`lax.while_loop` (trie.py:188) is, on a CUDA card, a captured step
replayed under the predicate `trie_running` (`decode.device_loop`), and
`trie_greedy_search`'s eager loop reads the host once a step.  No decode
step runs whose logits nobody would read.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

REP_BLOCK = -10000.0  # reference trie_decoder.py:141


class TokenTrie(object):
    """Host-side trie over token sequences, exported as dense arrays."""

    def __init__(self):
        self._children: List[dict] = [{}]

    @classmethod
    def construct(cls, all_tokens: Sequence[Sequence[int]]):
        trie = cls()
        for toks in all_tokens:
            trie.insert(toks)
        return trie

    def insert(self, tokens):
        node = 0
        for t in tokens:
            nxt = self._children[node].get(t)
            if nxt is None:
                nxt = len(self._children)
                self._children.append({})
                self._children[node][t] = nxt
            node = nxt

    @property
    def num_nodes(self):
        return len(self._children)

    def get_valid(self, tokens):
        node = 0
        for t in tokens:
            node = self._children[node].get(t)
            if node is None:
                return []
        return sorted(self._children[node].keys())

    def as_arrays(self):
        """(children_tokens [M, C], children_index [M, C]) int32, pad -1."""
        max_branch = max((len(c) for c in self._children), default=1) or 1
        m = self.num_nodes
        toks = np.full((m, max_branch), -1, np.int32)
        idxs = np.full((m, max_branch), -1, np.int32)
        for i, children in enumerate(self._children):
            for j, (t, n) in enumerate(sorted(children.items())):
                toks[i, j] = t
                idxs[i, j] = n
        return toks, idxs


def build_vocab_trie(tokenizer, class_names: Sequence[str]) -> TokenTrie:
    """Tokenize each class name and terminate it with [SEP] (reference
    trie_decoder.py:17-25)."""
    seqs = []
    for name in class_names:
        ids = tokenizer(name, padding="do_not_pad", add_special_tokens=False)["input_ids"]
        seqs.append(ids + [tokenizer.sep_token_id])
    return TokenTrie.construct(seqs)


def device_arrays(trie: TokenTrie, device):
    """(children_tokens, children_index) int64 on `device`, uploaded once
    per trie and device (again after an insert), so that a search's setup
    uploads nothing."""
    cached = trie.__dict__.setdefault("_device_arrays", {})
    key = (str(device), trie.num_nodes, sum(len(c) for c in trie._children))
    if key not in cached:
        cached.clear()
        cached[key] = tuple(torch.from_numpy(a).long().to(device) for a in trie.as_arrays())
    return cached[key]


@dataclasses.dataclass
class TrieState:
    """The search's state, updated IN PLACE by `trie_step`.  cur [] int32
    is the position last filled and also the cache's length; tok and node
    [B]: the last pick and its trie node."""

    cache: object
    seqs: torch.Tensor
    tok: torch.Tensor
    node: torch.Tensor
    finished: torch.Tensor
    sum_logprobs: torch.Tensor
    cur: torch.Tensor
    children_tokens: torch.Tensor
    children_index: torch.Tensor
    eos_row: torch.Tensor


def constrained_pick(s: TrieState, logits, node):
    """Boost the current node's children in logprob space, argmax; returns
    (tok, new node, the boosted logprob of tok)."""
    b, v = logits.shape
    logprobs = torch.log_softmax(logits, dim=-1)
    finite = torch.isfinite(logits)
    big = torch.where(finite, logits, float("-inf")).amax(dim=-1)
    small = torch.where(finite, logits, float("inf")).amin(dim=-1)
    boost = big - small + 1.0
    ctoks = s.children_tokens[node]  # [B, C]
    # the pad slot V absorbs the -1 entries
    cmask = torch.zeros((b, v + 1), dtype=torch.bool, device=logits.device)
    cmask.scatter_(1, torch.where(ctoks >= 0, ctoks, v), True)
    boosted = logprobs + torch.where(cmask[:, :v], boost[:, None], 0.0)
    tok = torch.argmax(boosted, dim=-1)
    # advance the trie: the position of tok among the children, or stay
    hit = ctoks == tok[:, None]
    pos = torch.argmax(hit.to(torch.uint8), dim=1)
    new_node = torch.where(hit.any(dim=1), s.children_index[node, pos], node)
    # the reference accumulates the boosted logprob (its top-k reads the
    # boosted distribution, trie_decoder.py:62-67, 148-153)
    return tok, new_node, boosted.gather(1, tok[:, None])[:, 0]


def trie_init(prefill_logits, cache, prefix_tokens, trie: TokenTrie, max_steps: int,
              eos_id: int = 102):
    """The state after the first pick, on the prefill's raw logits
    (trie_decoder.py:60-63)."""
    dev = prefill_logits.device
    children_tokens, children_index = device_arrays(trie, dev)
    b, tp = prefix_tokens.shape
    if tp >= max_steps:
        raise ValueError("a prefix of {} tokens leaves no step of {}".format(tp, max_steps))
    v = prefill_logits.shape[-1]
    seqs = torch.full((b, max_steps), eos_id, dtype=torch.long, device=dev)
    seqs[:, :tp] = prefix_tokens
    eos_row = torch.full((v,), float("-inf"), device=dev)
    eos_row[eos_id] = 0.0
    cur = torch.full((), tp, dtype=torch.int32, device=dev)
    s = TrieState(cache=dataclasses.replace(cache, length=cur), seqs=seqs, tok=None, node=None,
                  finished=None, sum_logprobs=None, cur=cur, children_tokens=children_tokens,
                  children_index=children_index, eos_row=eos_row)
    s.tok, s.node, s.sum_logprobs = constrained_pick(
        s, prefill_logits.float(), torch.zeros(b, dtype=torch.long, device=dev))
    s.seqs[:, tp] = s.tok
    s.finished = s.tok == eos_id
    return s


def trie_running(s: TrieState, max_steps: int):
    """A 0-dim bool: a position is left after cur and a row is running.
    On a model group every rank's picks, and so this, are equal (argmax
    of the replicated head's logits over all-reduced activations)."""
    return (s.cur + 1 < max_steps) & ~s.finished.all()


def trie_step(s: TrieState, decode_step_fn, eos_id: int = 102) -> None:
    """Feed the last pick, advance cur, pick again under the trie; in
    place."""
    logits, _ = decode_step_fn(s.tok, s.cache)
    s.cur.add_(1)
    logits = logits.float().clone()
    # block the previous token, then force EOS on finished rows
    # (trie_decoder.py:255-268)
    logits.scatter_(1, s.tok[:, None], REP_BLOCK)
    logits = torch.where(s.finished[:, None], s.eos_row[None, :], logits)
    nxt, node, lp = constrained_pick(s, logits, s.node)
    tok = torch.where(s.finished, eos_id, nxt)
    s.seqs.index_copy_(1, s.cur.long().reshape(1), tok[:, None])  # seqs[:, cur] = tok
    s.sum_logprobs.add_(torch.where(s.finished, 0.0, lp))
    s.finished.logical_or_(tok == eos_id)
    s.node.copy_(node)
    s.tok.copy_(tok)


def trie_result(s: TrieState, tp: int, eos_id: int = 102):
    """(sequences, logprobs) as new tensors.  Length normalization
    (trie_decoder.py:330-340): tokens other than EOS, plus one if any EOS,
    less the prefix, at least 1."""
    seqs = s.seqs
    num_valid = (seqs != eos_id).sum(dim=1) + (seqs == eos_id).any(dim=1).long()
    num_valid = torch.clamp(num_valid - tp, min=1)
    return seqs.clone(), s.sum_logprobs / num_valid.float()


def trie_greedy_search(decode_step_fn, prefill_logits, cache, prefix_tokens, trie: TokenTrie,
                       max_steps: int, eos_id: int = 102, run=None):
    """Returns (sequences [B, max_steps] incl. the prefix, EOS-padded;
    logprobs [B], the boosted logprobs summed and normalized by the
    generated length as the legacy search does, trie_decoder.py:330-340).
    run: None for the eager loop, else a device loop (see
    `beam.beam_search`)."""
    from .device_loop import run_eager

    tp = prefix_tokens.shape[1]
    state = trie_init(prefill_logits, cache, prefix_tokens, trie, max_steps, eos_id)
    args = (state, lambda st, _: trie_step(st, decode_step_fn, eos_id),
            lambda st: trie_running(st, max_steps), lambda st: trie_result(st, tp, eos_id))
    if run is None:
        return run_eager(*args)
    return run(*args, replays=max_steps - tp - 1)
