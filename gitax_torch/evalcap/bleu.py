"""A copy of `gitax.evalcap.bleu` (pure Python; `tests/test_torch_port_evalcap.py`
holds it equal to gitax's).

Corpus BLEU-1..4 (Papineni et al. 2002) with clipped n-gram precision
and closest-reference-length brevity penalty, as COCO evaluation uses."""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List


def _ngram_counts(tokens, n):
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(
    candidates: Dict[str, List[str]],
    references: Dict[str, List[List[str]]],
    max_n: int = 4,
):
    """Returns [BLEU-1, ..., BLEU-max_n]."""
    clipped = [0] * max_n
    totals = [0] * max_n
    cand_len = 0
    ref_len = 0
    for iid, cand in candidates.items():
        refs = references[iid]
        cand_len += len(cand)
        # closest reference length (ties -> shorter)
        ref_len += min((abs(len(r) - len(cand)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            ccounts = _ngram_counts(cand, n)
            if not ccounts:
                continue
            maxref = Counter()
            for r in refs:
                for g, cnt in _ngram_counts(r, n).items():
                    if cnt > maxref[g]:
                        maxref[g] = cnt
            totals[n - 1] += sum(ccounts.values())
            clipped[n - 1] += sum(min(c, maxref[g]) for g, c in ccounts.items())

    bp = 1.0 if cand_len > ref_len else math.exp(1.0 - ref_len / max(cand_len, 1))
    tiny, small = 1e-15, 1e-9
    bleus = []
    log_sum = 0.0
    for n in range(max_n):
        p = (clipped[n] + tiny) / (totals[n] + small)
        log_sum += math.log(p)
        bleus.append(bp * math.exp(log_sum / (n + 1)))
    return bleus
