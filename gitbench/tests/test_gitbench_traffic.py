"""The traffic generator: one seed gives the same inputs; seeds differ in
content, never in the amount of work."""

import base64
import collections
import io

import numpy as np
import pytest

from gitbench import spec
from gitbench import traffic as T

SHARES = {"640x480": 45, "480x640": 25, "640x427": 20, "427x640": 10}
BIG = 2 ** 31 + 12345  # seeds beyond 32 signed bits


def _shapes(payloads):
    return collections.Counter((w, h) for w, h, _ in payloads)


def test_payloads_repeat_for_a_seed_and_differ_across_seeds():
    a = T.payloads(BIG, SHARES, 8, 90)
    b = T.payloads(BIG, SHARES, 8, 90)
    c = T.payloads(BIG + 1, SHARES, 8, 90)
    assert a == b
    assert [p for _, _, p in a] != [p for _, _, p in c]
    assert _shapes(a) == _shapes(c)  # the same multiset of sizes


def test_payloads_are_photograph_sized_jpegs():
    from PIL import Image

    for w, h, b64 in T.payloads(7, {"640x480": 1}, 2, 90):
        raw = base64.b64decode(b64)
        img = Image.open(io.BytesIO(raw))
        assert img.format == "JPEG" and img.size == (w, h) == (640, 480)
        assert 60_000 < len(raw) < 250_000


def test_counts_are_fixed_multisets():
    assert T.counts({"a": 45, "b": 20, "c": 20, "d": 10, "e": 5}, 32) == \
        {"a": 15, "b": 6, "c": 6, "d": 3, "e": 2}
    assert sum(T.counts({"3": 3, "4": 6, "5": 9, "6": 14}, 32).values()) == 32


def test_questions_repeat_are_distinct_and_keep_their_lengths():
    t = spec.traffic("vqa_tsv")
    a = T.questions(BIG, t["questions_per_image"], t["question_words"], 32, 40)
    b = T.questions(BIG, t["questions_per_image"], t["question_words"], 32, 40)
    c = T.questions(BIG + 1, t["questions_per_image"], t["question_words"], 32, 40)
    assert a == b and a != c
    flat_a = [q for qs in a for q in qs]
    flat_c = [q for qs in c for q in qs]
    assert len(set(flat_a)) == len(flat_a)
    assert sorted(len(q.split()) for q in flat_a) == sorted(len(q.split()) for q in flat_c)
    assert sorted(map(len, a)) == sorted(map(len, c))
    assert min(len(q.split()) for q in flat_a) >= 3 and max(len(q.split()) for q in flat_a) <= 15


def test_tsv_offsets_read_back_with_the_ports_reader(tmp_path):
    from gitax_torch.io.tsv import TSVFile

    rows = [("k{}".format(i), "v" * (i + 1)) for i in range(5)]
    path = str(tmp_path / "x.tsv")
    T.write_tsv(path, rows)
    f = TSVFile(path)
    assert len(f) == 5 and [tuple(f[i]) for i in range(5)] == rows
