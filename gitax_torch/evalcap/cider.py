"""A copy of `gitax.evalcap.cider` (pure Python; `tests/test_torch_port_evalcap.py`
holds it equal to gitax's).

CIDEr-D metric (Vedantam et al., arXiv:1411.5726), implemented from
the published formula.

For n-grams n=1..4: g_n(s) is the vector of ngram counts weighted by
corpus idf (computed over the reference sets); the per-n score between
candidate c and reference r is

    e^{-(|c|-|r|)^2 / 2 sigma^2} * <min(g(c), g(r)), g(r)> / (|g(c)| |g(r)|)

(candidate counts clipped to reference counts — the "D" variant's
gaming penalty), averaged over references and n, scaled by 10.

The reference repo delegates this to pycocoevalcap
(inference.py:295-307); gitax ships its own so COCO evaluation runs
offline.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence


def _ngrams(tokens: Sequence[str], max_n: int = 4) -> List[Counter]:
    out = []
    for n in range(1, max_n + 1):
        out.append(Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)))
    return out


class CiderD(object):
    def __init__(self, max_n: int = 4, sigma: float = 6.0):
        self.max_n = max_n
        self.sigma = sigma

    def compute(
        self,
        candidates: Dict[str, List[str]],  # image_id -> [tokens]
        references: Dict[str, List[List[str]]],  # image_id -> [[tokens], ...]
    ):
        assert set(candidates) == set(references)
        ids = sorted(candidates)
        num_images = len(ids)

        # document frequency over reference sets: in how many images does
        # each ngram appear (in any reference)?
        df = [defaultdict(int) for _ in range(self.max_n)]
        ref_grams = {}
        for iid in ids:
            per_ref = [_ngrams(r, self.max_n) for r in references[iid]]
            ref_grams[iid] = per_ref
            for n in range(self.max_n):
                seen = set()
                for grams in per_ref:
                    seen.update(grams[n].keys())
                for g in seen:
                    df[n][g] += 1

        log_n = math.log(max(num_images, 1))

        def tfidf(grams: Counter, n: int):
            vec = {}
            norm_sq = 0.0
            for g, cnt in grams.items():
                idf = log_n - math.log(max(df[n].get(g, 0), 1.0))
                w = cnt * idf
                vec[g] = w
                norm_sq += w * w
            return vec, math.sqrt(norm_sq)

        scores = []
        for iid in ids:
            cand_tokens = candidates[iid]
            cgrams = _ngrams(cand_tokens, self.max_n)
            cvecs = [tfidf(cgrams[n], n) for n in range(self.max_n)]
            clen = len(cand_tokens)
            image_score = 0.0
            for ref_tokens, rgrams in zip(references[iid], ref_grams[iid]):
                rlen = len(ref_tokens)
                delta = float(clen - rlen)
                pen = math.exp(-(delta * delta) / (2.0 * self.sigma ** 2))
                for n in range(self.max_n):
                    cvec, cnorm = cvecs[n]
                    rvec, rnorm = tfidf(rgrams[n], n)
                    if cnorm == 0.0 or rnorm == 0.0:
                        continue
                    # clip candidate weights to reference weights ("D")
                    dot = 0.0
                    for g, w in cvec.items():
                        rw = rvec.get(g)
                        if rw is not None:
                            dot += min(w, rw) * rw
                    image_score += pen * dot / (cnorm * rnorm)
            image_score *= 10.0 / (self.max_n * max(len(references[iid]), 1))
            scores.append(image_score)
        mean = sum(scores) / max(len(scores), 1)
        return mean, scores
