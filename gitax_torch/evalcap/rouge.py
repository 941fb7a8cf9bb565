"""A copy of `gitax.evalcap.rouge` (pure Python; `tests/test_torch_port_evalcap.py`
holds it equal to gitax's).

ROUGE-L (Lin 2004): LCS-based F-measure with beta=1.2, max over
references per image, mean over the corpus — COCO evaluation's variant."""

from __future__ import annotations

from typing import Dict, List


def _lcs_len(a, b):
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(
    candidates: Dict[str, List[str]],
    references: Dict[str, List[List[str]]],
    beta: float = 1.2,
):
    scores = []
    for iid, cand in candidates.items():
        prec_max = rec_max = 0.0
        for ref in references[iid]:
            lcs = _lcs_len(cand, ref)
            if len(cand):
                prec_max = max(prec_max, lcs / len(cand))
            if len(ref):
                rec_max = max(rec_max, lcs / len(ref))
        if prec_max > 0 and rec_max > 0:
            f = ((1 + beta ** 2) * prec_max * rec_max) / (
                rec_max + beta ** 2 * prec_max
            )
        else:
            f = 0.0
        scores.append(f)
    return sum(scores) / max(len(scores), 1), scores
