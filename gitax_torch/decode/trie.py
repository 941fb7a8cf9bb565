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
over B.  The loop is a host loop over `decode_step` (gitax: a
`lax.while_loop`) with one host read per step, and stops before a decode
step whose logits nobody would read.
"""

from __future__ import annotations

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


def trie_greedy_search(decode_step_fn, prefill_logits, cache, prefix_tokens, trie: TokenTrie,
                       max_steps: int, eos_id: int = 102):
    """Returns (sequences [B, max_steps] incl. the prefix, EOS-padded;
    logprobs [B], the boosted logprobs summed and normalized by the
    generated length as the legacy search does, trie_decoder.py:330-340)."""
    dev = prefill_logits.device
    children_tokens, children_index = (torch.from_numpy(a).long().to(dev)
                                       for a in trie.as_arrays())
    b, tp = prefix_tokens.shape
    if tp >= max_steps:
        raise ValueError("a prefix of {} tokens leaves no step of {}".format(tp, max_steps))
    v = prefill_logits.shape[-1]
    rows = torch.arange(b, device=dev)
    seqs = torch.full((b, max_steps), eos_id, dtype=torch.long, device=dev)
    seqs[:, :tp] = prefix_tokens

    def constrained_pick(logits, node):
        """Boost the current node's children in logprob space, argmax."""
        logprobs = torch.log_softmax(logits, dim=-1)
        finite = torch.isfinite(logits)
        big = torch.where(finite, logits, float("-inf")).amax(dim=-1)
        small = torch.where(finite, logits, float("inf")).amin(dim=-1)
        boost = big - small + 1.0
        ctoks = children_tokens[node]  # [B, C]
        # the pad slot V absorbs the -1 entries
        cmask = torch.zeros((b, v + 1), dtype=torch.bool, device=dev)
        cmask[rows[:, None], torch.where(ctoks >= 0, ctoks, v)] = True
        boosted = logprobs + torch.where(cmask[:, :v], boost[:, None], 0.0)
        tok = torch.argmax(boosted, dim=-1)
        # advance the trie: the position of tok among the children, or stay
        hit = ctoks == tok[:, None]
        pos = torch.argmax(hit.to(torch.uint8), dim=1)
        new_node = torch.where(hit.any(dim=1), children_index[node, pos], node)
        # the reference accumulates the boosted logprob (its top-k reads the
        # boosted distribution, trie_decoder.py:62-67, 148-153)
        return tok, new_node, boosted.gather(1, tok[:, None])[:, 0]

    # first pick: raw logits (trie_decoder.py:60-63)
    tok, node, sum_logprobs = constrained_pick(
        prefill_logits.float(), torch.zeros(b, dtype=torch.long, device=dev))
    seqs[:, tp] = tok
    finished = tok == eos_id
    eos_row = torch.full((v,), float("-inf"), device=dev)
    eos_row[eos_id] = 0.0
    for cur in range(tp + 1, max_steps):
        if bool(finished.all()):
            break
        logits, cache = decode_step_fn(tok, cache)
        logits = logits.float().clone()
        # block the previous token, then force EOS on finished rows
        # (trie_decoder.py:255-268)
        logits[rows, tok] = REP_BLOCK
        logits = torch.where(finished[:, None], eos_row[None, :], logits)
        nxt, node, lp = constrained_pick(logits, node)
        tok = torch.where(finished, eos_id, nxt)
        seqs[:, cur] = tok
        sum_logprobs = sum_logprobs + torch.where(finished, 0.0, lp)
        finished = finished | (tok == eos_id)
    # length normalization (trie_decoder.py:330-340): tokens other than EOS,
    # plus one if any EOS, less the prefix, at least 1
    num_valid = (seqs != eos_id).sum(dim=1) + (seqs == eos_id).any(dim=1).long()
    num_valid = torch.clamp(num_valid - tp, min=1)
    return seqs, sum_logprobs / num_valid.float()
