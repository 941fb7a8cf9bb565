"""A copy of `gitax.evalcap.meteor` (pure Python; `tests/test_torch_port_evalcap.py`
holds it equal to gitax's).

Pure-Python METEOR for offline evaluation.

The reference scores METEOR through pycocoevalcap's Java meteor-1.5.jar
(reference inference.py:295-307), which cannot run in this environment.
This module implements the Meteor 1.5 scoring structure natively:

  * matcher stages: exact match, then Porter-stemmed match on the
    remaining words (module weights 1.0 / 0.6);
  * weighted precision/recall with content/function-word discounting
    (delta), alpha-weighted harmonic F-mean, and the fragmentation
    penalty gamma * (chunks / matches) ** beta;
  * per-segment best-reference selection, corpus aggregation over summed
    sufficient statistics (the jar's "aggregate stats then score"
    behavior).

Parameters default to Meteor 1.5's English task tuning (alpha=0.85,
beta=0.2, gamma=0.6, delta=0.75).

Documented deviations from the jar (acceptable degradation per the
design: exact/stem only): no WordNet synonymy or paraphrase-table stages
(both need data files unavailable offline), a classic Porter stemmer
instead of Snowball English, a compact built-in function-word list, and
a leftmost-greedy aligner (ties in the jar's beam aligner may count
chunks slightly differently).  Scores are therefore a faithful METEOR
variant, validated by hand-computed examples in
tests/test_meteor.py, not a bit-exact jar reproduction.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Porter stemmer (classic 1980 algorithm)
# ---------------------------------------------------------------------------

_VOWELS = set("aeiou")


def _is_cons(word, i):
    ch = word[i]
    if ch in _VOWELS:
        return False
    if ch == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem):
    """Number of VC sequences in [C](VC)^m[V]."""
    m, i, n = 0, 0, len(stem)
    while i < n and _is_cons(stem, i):
        i += 1
    while True:
        while i < n and not _is_cons(stem, i):
            i += 1
        if i >= n:
            return m
        m += 1
        while i < n and _is_cons(stem, i):
            i += 1
        if i >= n:
            return m


def _has_vowel(stem):
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _double_cons(word):
    return (
        len(word) >= 2
        and word[-1] == word[-2]
        and _is_cons(word, len(word) - 1)
    )


def _cvc(word):
    if len(word) < 3:
        return False
    if not (
        _is_cons(word, len(word) - 3)
        and not _is_cons(word, len(word) - 2)
        and _is_cons(word, len(word) - 1)
    ):
        return False
    return word[-1] not in "wxy"


def porter_stem(word):
    """Classic Porter stemmer."""
    if len(word) <= 2:
        return word
    w = word

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w, flag = w[:-2], True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w, flag = w[:-3], True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _double_cons(w) and not w.endswith(("l", "s", "z")):
                w = w[:-1]
            elif _measure(w) == 1 and _cvc(w):
                w += "e"

    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # step 2
    for suf, rep in (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
        ("anci", "ance"), ("izer", "ize"), ("abli", "able"), ("alli", "al"),
        ("entli", "ent"), ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
        ("ation", "ate"), ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
        ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
        ("iviti", "ive"), ("biliti", "ble"),
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 3
    for suf, rep in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 4
    for suf in (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1:
                if suf == "ion" and not stem.endswith(("s", "t")):
                    break
                w = stem
            break

    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# ---------------------------------------------------------------------------
# METEOR
# ---------------------------------------------------------------------------

# compact English closed-class list (the jar ships a data file)
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no all both either
neither and or but nor so yet for of in on at by to from with without
about against between into through during before after above below up
down out off over under again further then once here there when where
why how is am are was were be been being have has had having do does did
doing will would shall should can could may might must it its he she his
her him them they their we us our you your i me my not as if than too
very s t don now
""".split())

EXACT_WEIGHT = 1.0
STEM_WEIGHT = 0.6


def _align(cand, ref):
    """Stage-wise leftmost-greedy alignment.  Returns a list of
    (cand_idx, ref_idx, module_weight) sorted by cand_idx."""
    matches = {}
    used_ref = set()
    # stage 1: exact
    for i, w in enumerate(cand):
        for j, r in enumerate(ref):
            if j in used_ref or i in matches:
                continue
            if w == r:
                matches[i] = (j, EXACT_WEIGHT)
                used_ref.add(j)
    # stage 2: stems of the leftovers
    cand_stem = [porter_stem(w) for w in cand]
    ref_stem = [porter_stem(r) for r in ref]
    for i in range(len(cand)):
        if i in matches:
            continue
        for j in range(len(ref)):
            if j in used_ref:
                continue
            if cand_stem[i] == ref_stem[j]:
                matches[i] = (j, STEM_WEIGHT)
                used_ref.add(j)
                break
    return sorted((i, j, w) for i, (j, w) in matches.items())


def _chunks(pairs):
    """Number of maximal runs contiguous in BOTH sentences."""
    if not pairs:
        return 0
    ch = 1
    for (i0, j0, _), (i1, j1, _) in zip(pairs, pairs[1:]):
        if not (i1 == i0 + 1 and j1 == j0 + 1):
            ch += 1
    return ch


def _weighted_counts(tokens, idx_weights, delta):
    """(weighted match mass, weighted length) with content/function
    discounting: content words weigh delta, function words 1-delta."""
    total = 0.0
    for t in tokens:
        total += delta if t not in FUNCTION_WORDS else (1.0 - delta)
    mass = 0.0
    for idx, w in idx_weights:
        t = tokens[idx]
        mass += w * (delta if t not in FUNCTION_WORDS else (1.0 - delta))
    return mass, total


class MeteorStats(object):
    __slots__ = ("m_cand", "len_cand", "m_ref", "len_ref", "chunks", "matches")

    def __init__(self, m_cand=0.0, len_cand=0.0, m_ref=0.0, len_ref=0.0,
                 chunks=0, matches=0):
        self.m_cand, self.len_cand = m_cand, len_cand
        self.m_ref, self.len_ref = m_ref, len_ref
        self.chunks, self.matches = chunks, matches

    def __iadd__(self, o):
        self.m_cand += o.m_cand
        self.len_cand += o.len_cand
        self.m_ref += o.m_ref
        self.len_ref += o.len_ref
        self.chunks += o.chunks
        self.matches += o.matches
        return self


def segment_stats(cand_tokens, ref_tokens, delta=0.75):
    pairs = _align(cand_tokens, ref_tokens)
    m_cand, len_cand = _weighted_counts(
        cand_tokens, [(i, w) for i, _, w in pairs], delta
    )
    m_ref, len_ref = _weighted_counts(
        ref_tokens, [(j, w) for _, j, w in pairs], delta
    )
    return MeteorStats(
        m_cand, len_cand, m_ref, len_ref, _chunks(pairs), len(pairs)
    )


def score_from_stats(st: MeteorStats, alpha=0.85, beta=0.2, gamma=0.6):
    if st.m_cand == 0 or st.m_ref == 0:
        return 0.0
    p = st.m_cand / st.len_cand if st.len_cand else 0.0
    r = st.m_ref / st.len_ref if st.len_ref else 0.0
    if p == 0 or r == 0:
        return 0.0
    fmean = p * r / (alpha * p + (1.0 - alpha) * r)
    # Pen = gamma * (chunks / matches) ** beta (Meteor 1.5 paper, eq. 2)
    frag = (st.chunks / float(st.matches)) if st.matches else 0.0
    penalty = gamma * (frag ** beta) if frag > 0 else 0.0
    return (1.0 - penalty) * fmean


def meteor_segment(cand_tokens, references_tokens, alpha=0.85, beta=0.2,
                   gamma=0.6, delta=0.75):
    """Best score over references; returns (score, best stats)."""
    best, best_stats = 0.0, MeteorStats()
    for ref in references_tokens:
        st = segment_stats(cand_tokens, ref, delta)
        s = score_from_stats(st, alpha, beta, gamma)
        if s >= best:
            best, best_stats = s, st
    return best, best_stats


def meteor(candidates: dict, references: dict, alpha=0.85, beta=0.2,
           gamma=0.6, delta=0.75):
    """candidates: id -> token list; references: id -> [token lists].
    Returns (corpus score from aggregated stats, per-segment scores) —
    the jar's aggregation (sum each segment's best-reference sufficient
    statistics, then score the sums)."""
    total = MeteorStats()
    seg_scores = {}
    for key, cand in candidates.items():
        s, st = meteor_segment(cand, references[key], alpha, beta, gamma, delta)
        seg_scores[key] = s
        total += st
    return score_from_stats(total, alpha, beta, gamma), seg_scores
