"""How `correct` is decided: the served outputs of the window, sampled from the
seed, held to the plain reference.

Every output a user got (a row of the output TSV) is matched to the batch
row the program searched it in: same image (the 4 x 4 pixel fingerprint of
each frame of the program's batch against the reference's own decode,
within 2 levels; the same frames a row and one frame's shape),
same prefix (the reference's own tokenisation of the question), and the
row's tokens detokenised by the reference equal to the served text.  Then:

- `unmatched`: sampled outputs that no batch row produced (the text was
  altered after the search, or the image or prefix that reached the search
  was not the payload's).  Exact: limit 0.
- `missing`: outputs due in the window that never came (a TSV row not
  written, an answer not returned).  Exact: limit 0.
- `score_gap_bf16`: over the sampled outputs' batch rows (one a batch: the
  copies a grid group is padded with are one row), the summed gap
  between the score the search gave each served sequence (its second
  output, the length-normed sum of log-probabilities, de-normed) and the
  plain reference's sum of log-probabilities of the same tokens, the prefix
  and image fed, over the summed gap that rounding the reference's product
  operands to bf16 (the configuration's precision) makes on the same rows:
  the program's error in units of bf16 rounding.  A mesh's scores reach its
  rank 0 for that rank's own rows only (the first of each batch): the rows
  searched on the other cards are held to `search_gap_nats` alone.  Beam search serves the
  sequence of best score, not each step's best token, so its tokens are not
  compared with the reference's first choices; the score is the search's
  own statement about them, and a lower precision or a token altered where
  it is produced moves it.  The unit makes seeds alike: how far rounding
  moves a score depends on the row (a caption ended by the prefill's
  logits, scored in the prefill's bf16 score math, moves ten times as far
  as one of twelve decode steps), and on some seeds most captions are
  short.
- `search_gap_nats` (in the cells whose limits name it): the search's
  choices.  The reference runs its own plain beam search over each sampled
  input (`Reference.beam_search`, the program's semantics); each input's
  shortfall is how far, in length-normed nats, the reference's best
  hypothesis lies above the reference's score of the sequence served (the
  largest over the input's rows; 0 where the served one scores at least as
  well), and the number is their sum over the inputs but the largest
  sixth of them.  Beam search is chaotic under rounding: a near tie pruned
  the other way several steps before the end costs a sound run up to 4.3
  nats on an input, on 0-4 inputs of 32, while a search that scores its
  tokens right but picks the wrong ones (a top-k that loses the best
  candidate, fewer beams, the wrong hypothesis kept) moves most inputs;
  the sum over all of them swung from seed to seed (0 to 7.0) where the
  trimmed one reads 0.  Counted once an input, not once a row: an input
  served in many passes weighs as one.

The control (`control.py`) reads both with the reference computed one step
below the configuration's precision in the program's place: its scores of
the served tokens, and its own search's choice.

The reference is the module the configuration names (`spec.reference`):
its `Reference` objects in `refs` and its `pixels`, passed as `R`.
"""

from __future__ import annotations

import numpy as np

from . import reference as R
from . import vocab as V


class Served(object):
    """One output due in the window: the payload, the question ('' for a
    caption), the text served (None when it never came)."""

    __slots__ = ("payload", "question", "text")

    def __init__(self, payload, question, text):
        self.payload, self.question, self.text = payload, question, text


def pick(served, n, seed):
    """A sample of up to n of the outputs that came, drawn from the seed,
    with the longest text in it."""
    came = [i for i, s in enumerate(served) if s.text is not None]
    if not came:
        return []
    rng = np.random.default_rng([int(seed), 0x5A3])
    chosen = list(rng.choice(came, size=min(n, len(came)), replace=False))
    longest = max(came, key=lambda i: (len(served[i].text.split()), -i))
    if longest not in chosen:
        chosen[-1] = longest
    return sorted(int(i) for i in chosen)


def candidates(batches, arr, prefix):
    """[(batch, row)] whose frames, shape, fingerprint and prefix match;
    arr an image [H, W, 3] or a clip [F, H, W, 3]."""
    from .program import fingerprint

    fp = fingerprint(arr[None])[0].astype(np.int16)
    n_frames = arr.shape[0] if arr.ndim == 4 else 1
    out = []
    for bi, b in enumerate(batches):
        if b.get("frames", 1) != n_frames or b["shape"] != arr.shape[-3:-1] \
                or b["prefix"].shape[1] != len(prefix):
            continue
        near = np.abs(b["fp"].astype(np.int16) - fp).reshape(len(b["fp"]), -1).max(1) <= 2
        same = (b["prefix"] == np.asarray(prefix)[None]).all(1)
        out += [(bi, int(r)) for r in np.nonzero(near & same)[0]]
    return out


def units(gaps, unit):
    """Summed gaps over summed units; None with nothing scored."""
    return float(np.sum(gaps) / max(np.sum(unit), 1e-12)) if gaps else None


def nats(short):
    """The summed shortfalls of the inputs searched but the largest sixth
    (rounded down) of them; None with none."""
    if not short:
        return None
    return float(np.sum(sorted(short, reverse=True)[len(short) // 6:]))


def words_of(row, eos):
    """The tokens of a search row before its first EOS; None without one."""
    hit = np.nonzero(row == eos)[0]
    return None if not len(hit) else [int(t) for t in row[:hit[0]]]


def judge(cfg, served, batches, sample, seed, refs, device, limits, R=R, pick=pick):
    """The numbers compared, each with its limit, for the sampled outputs;
    refs: {'f32': Reference, 'bf16': Reference} (a 'lowp' entry adds the
    control's readings, `control_<number>`) of the reference module R.
    `search_gap_nats` is read where `limits` holds it; pick(served, n,
    seed) draws the sample.  Returns (checks, info)."""
    vocab = V.tokens(cfg["vocab_size"])
    idx = V.index(vocab)
    eos = cfg["eos_id"]
    alpha = cfg["length_penalty"]
    searched = "search_gap_nats" in limits
    chosen = pick(served, sample, seed)
    unmatched, skipped, unscored, tokens, lengths, worst = 0, 0, 0, 0, [], []
    gaps = {name: [] for name in ("f32", "bf16", "lowp", "search", "lowp_search")}
    for i in chosen:
        s = served[i]
        if s.payload is None:
            unmatched += 1
            continue
        arr = R.pixels(s.payload, cfg)
        prefix = V.prefix_ids(s.question, idx, cfg["max_text_len"])
        rows, seen = [], set()
        for bi, r in candidates(batches, arr, prefix):
            words = words_of(batches[bi]["seqs"][r], eos)
            if bi not in seen and words is not None and V.detokenize(words, vocab) == s.text:
                seen.add(bi)  # one row a batch: a group padded with copies weighs as one
                rows.append((bi, r, words))
        if not rows:
            unmatched += 1
            continue
        memory = {name: ref.encode(arr) for name, ref in refs.items()}
        tp = len(prefix)
        short = []  # each row's shortfall below the reference's own best, normed
        for bi, r, words in rows:
            n = len(words)
            if tp + n >= max(cfg["max_steps"], tp + cfg["max_text_len"]) - 1:
                skipped += 1  # a forced end: the score holds a word not served
                continue
            norm = R.length_norm(tp + n, alpha)
            ref_sum = float(refs["f32"].sequence(memory["f32"], prefix, words, eos).sum())
            scores = batches[bi]["scores"]
            if r < len(scores):  # else searched on another card of a mesh
                prog = float(scores[r]) * norm
                unit = abs(float(refs["bf16"].sequence(memory["bf16"], prefix, words, eos)
                                 .sum()) - ref_sum)
                gaps["f32"].append(abs(prog - ref_sum))
                gaps["bf16"].append(unit)
                if "lowp" in refs:  # the control: its own sum in the program's place
                    lp = refs["lowp"].sequence(memory["lowp"], prefix, words, eos)
                    gaps["lowp"].append(abs(float(lp.sum()) - ref_sum))
                worst.append((round(gaps["f32"][-1], 4), round(unit, 4), batches[bi]["rows"],
                              tp, n))
            else:
                unscored += 1
            if searched:
                if not short:  # the reference's own search, once an input
                    best = refs["f32"].beam_search(memory["f32"], prefix, cfg)[0]
                short.append(max(0.0, best - ref_sum / norm))
            tokens += n + 1
            lengths.append(n)
        if short:
            gaps["search"].append(max(short))
            if "lowp" in refs:  # the control's own search in the program's place
                words = refs["lowp"].beam_search(memory["lowp"], prefix, cfg)[1]
                ref_sum = float(refs["f32"].sequence(memory["f32"], prefix, words, eos).sum())
                gaps["lowp_search"].append(
                    max(0.0, best - ref_sum / R.length_norm(tp + len(words), alpha)))
    missing = sum(1 for s in served if s.text is None)
    checks = {"unmatched": {"value": unmatched, "limit": limits["unmatched"]},
              "missing": {"value": missing, "limit": limits["missing"]},
              "score_gap_bf16": {"value": units(gaps["f32"], gaps["bf16"]),
                                 "limit": limits["score_gap_bf16"]}}
    if searched:
        checks["search_gap_nats"] = {"value": nats(gaps["search"]),
                                     "limit": limits["search_gap_nats"]}
    if "lowp" in refs:
        checks["control_score_gap_bf16"] = {"value": units(gaps["lowp"], gaps["bf16"]),
                                            "limit": limits["score_gap_bf16"]}
        if searched:
            checks["control_search_gap_nats"] = {"value": nats(gaps["lowp_search"]),
                                                 "limit": limits["search_gap_nats"]}
    info = dict(sampled=len(chosen), scored_rows=len(gaps["f32"]), unscored_rows=unscored,
                forced_skipped=skipped,
                tokens=tokens, served=len(served),
                mean_words=float(np.mean(lengths)) if lengths else None,
                max_words=max(lengths) if lengths else None,
                worst=sorted(worst, reverse=True)[:4])
    if searched:
        info["searched_inputs"] = len(gaps["search"])
        info["shortfalls"] = sorted((round(g, 4) for g in gaps["search"] if g > 1e-3),
                                    reverse=True)
        info["shortfall_sum"] = float(np.sum(gaps["search"]))
        if "lowp" in refs:
            info["control_shortfalls"] = sorted((round(g, 4) for g in gaps["lowp_search"]
                                                 if g > 1e-3), reverse=True)
    return checks, info


def passed(checks):
    """Each number compared present and within its limit."""
    for name, c in checks.items():
        if name.startswith("control_"):
            continue
        if c["value"] is None or c["value"] > c["limit"]:
            return False
    return True


def control_passed(checks):
    """The verdict `passed` gives the control: its readings in the place of
    the program's, where it has them."""
    return passed({name: checks.get("control_" + name, c) for name, c in checks.items()
                   if not name.startswith("control_")})
