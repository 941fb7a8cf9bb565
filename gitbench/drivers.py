"""The ways traffic reaches the program, one class each, chosen by the
traffic file's `kind`:

- 'caption_tsv': `CaptionEngine.run_caption_tsv` over a base64 JPEG TSV, pass
  after pass (the CLI's `-p` loop);
- 'vqa_tsv': `CaptionEngine.run_vqa_tsv` over image and question TSVs, pass
  after pass.

A kind missing from `KINDS` is a file: `kinds/<kind>.py` (a kind with a
`/` is a module path under gitbench/, as the tests' are) defines `Driver`,
built as `Driver(cfg, spec, seed, work)`.

Each makes its inputs in set-up (`prepare`), builds the program (`build`:
an object with `.model`, `.engine` and `close()`, which stops whatever it
started; `program.Program` by default), warms the shapes its traffic uses
(`warm`), runs the window (`window`), lists the outputs due in it
(`served`) for the judge and draws the sample judged (`pick`).  Rates are
the items completed (the program's `resolve` calls) from the window's
opening to its close, over its seconds.
"""

from __future__ import annotations

import json
import os
import time

from . import judge as J
from . import spec as S
from . import traffic as T
from . import vocab as V
from .judge import Served

HERE = os.path.dirname(os.path.abspath(__file__))


class WindowClosed(Exception):
    """Raised into a pass at its first dispatch after the window's close."""


class _TSVDriver(object):
    # whether a pass still running at the close is cut at its next dispatch
    # (a long TSV) or finishes (a short one, whose written rows are judged)
    cut_at_close = False

    def __init__(self, cfg, spec, seed, work):
        self.cfg, self.spec, self.seed, self.work = cfg, spec, int(seed), work
        self.passes = []  # out TSV paths of the passes started in the window

    def build(self, cfg, sd, device):
        """The system under test from the benchmark's weights `sd`."""
        from .program import Program

        return Program(cfg, sd, device)

    def pick(self, served, n, seed):
        """The indices of the served outputs the judge samples."""
        return J.pick(served, n, seed)

    def rate_window(self, hooks, t_open, deadline):
        """(items, seconds): the items `resolve` completed from the window's
        opening to its close, and the window's seconds."""
        return sum(n for t, n in hooks.resolved if t_open <= t <= deadline), deadline - t_open

    def window(self, program, hooks, seconds, span=None):
        t_open = time.perf_counter()
        deadline = t_open + seconds
        hooks.recording = True
        self._install_poll(hooks, span, t_open, deadline)
        pass_s = []
        while time.perf_counter() < deadline:
            out = os.path.join(self.work, "out.{}.tsv".format(len(self.passes)))
            self.passes.append(out)
            t0 = time.perf_counter()
            try:
                self.one_pass(program.engine, out)
            except WindowClosed:
                break
            pass_s.append(round(time.perf_counter() - t0, 3))
        if span is not None:
            span.close()
        items, secs = self.rate_window(hooks, t_open, deadline)
        hooks.recording = False
        rows = sum(b["rows"] for b in hooks.batches if b["t"] <= deadline)
        return dict(items=items, seconds=secs, rows_dispatched=rows, passes=len(self.passes),
                    pass_s=pass_s, window_open=t_open, deadline=deadline)

    def _install_poll(self, hooks, span, t_open, deadline):
        """At every dispatch, from the thread that drives the passes: poll
        the traced span, and past the close cut a long pass."""
        eng = hooks.p.engine
        inner = eng.dispatch_device_batch

        def dispatch(imgs, pref, **kw):
            now = time.perf_counter()
            if span is not None:
                span.poll(now - t_open)
            if self.cut_at_close and now > deadline:
                raise WindowClosed()
            return inner(imgs, pref, **kw)

        eng.dispatch_device_batch = dispatch
        hooks._undo.append(lambda: setattr(eng, "dispatch_device_batch", inner))


class CaptionTSV(_TSVDriver):
    """Captions over a TSV of `rows` JPEG rows, each of `payloads` distinct
    photographs `rows / payloads` times."""

    def prepare(self):
        s = self.spec
        self.payloads = T.payloads(self.seed, s["shapes"], s["payloads"], s["jpeg_quality"])
        order = T.caption_rows(self.seed, s["payloads"], s["rows"] // s["payloads"])
        self.keys = ["{:05d}_{:03d}".format(i, p) for i, p in enumerate(order)]
        self.tsv = os.path.join(self.work, "images.tsv")
        T.write_image_tsv(self.tsv, [(k, self.payloads[p][2]) for k, p in zip(self.keys, order)])
        self.warm_tsv = os.path.join(self.work, "warm.tsv")
        n = self.cfg["batch_size"]
        T.write_image_tsv(self.warm_tsv, [(k, self.payloads[p][2])
                                          for k, p in zip(self.keys[:n], order[:n])])

    def warm(self, program):
        program.engine.run_caption_tsv(self.warm_tsv, os.path.join(self.work, "warm.out.tsv"))

    def one_pass(self, engine, out):
        engine.run_caption_tsv(self.tsv, out)

    def served(self, hooks, window):
        out = []
        for path in self.passes:
            got = {}
            with open(path) as f:
                for line in f:
                    key, val = line.rstrip("\n").split("\t")
                    got[key] = json.loads(val)[0]["caption"]
            for key in self.keys:
                p = int(key.split("_")[1])
                out.append(Served(self.payloads[p][2], "", got.get(key)))
        return out


class VqaTSV(_TSVDriver):
    """VQA over a long TSV of `images` JPEGs with their questions, as a user
    runs VQAv2's: the window sees the loop's steady state, prefix buckets
    filling and dispatching, and the pass is cut at the close (answers are
    written only when a pass ends, so the items judged are the answers
    `resolve` returned in the window).  Warm-up: a TSV of one image of each
    shape with a question of each length, every (grid, prefix length) once."""

    cut_at_close = True

    def prepare(self):
        s, cfg = self.spec, self.cfg
        self.payloads = T.payloads(self.seed, s["shapes"], s["images"], s["jpeg_quality"])
        self.questions = T.questions(self.seed, s["questions_per_image"], s["question_words"],
                                     s["images"], cfg["max_text_len"])
        self.img_tsv, self.q_tsv = self._write("", self.payloads, self.questions)
        shapes = list(s["shapes"])
        warm_pay = T.payloads(self.seed, {k: 1 for k in shapes}, len(shapes), s["jpeg_quality"],
                              stream=1)
        lens = {k: 1 for k in s["question_words"]}
        warm_q = [T.questions(self.seed + 1 + i, {str(len(lens)): 1}, lens, 1,
                              cfg["max_text_len"])[0] for i in range(len(shapes))]
        self.warm_tsvs = self._write("warm.", warm_pay, warm_q)
        idx = V.index(V.tokens(cfg["vocab_size"]))
        self.by_prefix = {tuple(V.prefix_ids(q, idx, cfg["max_text_len"])): (i, q)
                          for i, qs in enumerate(self.questions) for q in qs}

    def _write(self, stem, payloads, questions):
        img_tsv = os.path.join(self.work, stem + "images.tsv")
        q_tsv = os.path.join(self.work, stem + "questions.tsv")
        keys = ["img{:04d}".format(i) for i in range(len(payloads))]
        T.write_image_tsv(img_tsv, [(k, p[2]) for k, p in zip(keys, payloads)])
        T.write_question_tsv(q_tsv, [
            (k, [{"question": q, "question_id": "{}_{}".format(i, j)} for j, q in enumerate(qs)])
            for i, (k, qs) in enumerate(zip(keys, questions))])
        return img_tsv, q_tsv

    def warm(self, program):
        program.engine.run_vqa_tsv(*self.warm_tsvs, os.path.join(self.work, "warm.out.tsv"))

    def one_pass(self, engine, out):
        engine.run_vqa_tsv(self.img_tsv, self.q_tsv, out)

    def served(self, hooks, window):
        """The answers `resolve` returned in the window, each tied to its
        question by the prefix its batch row carried (every question of
        the TSV is distinct); a prefix no question has is served with no
        payload, which the judge counts as unmatched."""
        batches = {id(b["seqs"]): b for b in hooks.batches}
        out = []
        for sid, r, text, t in hooks.answers:
            if t > window["deadline"]:
                continue
            hit = self.by_prefix.get(tuple(batches[sid]["prefix"][r].tolist()))
            out.append(Served(self.payloads[hit[0]][2], hit[1], text) if hit
                       else Served(None, "", text))
        return out


KINDS = {"caption_tsv": CaptionTSV, "vqa_tsv": VqaTSV}


def driver_class(kind):
    """KINDS[kind], else the `Driver` of the kind's file (`kinds/<kind>.py`,
    or `<kind>.py` under gitbench/ for a kind with a `/`)."""
    if kind in KINDS:
        return KINDS[kind]
    rel = kind if "/" in kind else "kinds/" + kind
    try:
        return S.module(rel).Driver
    except (FileNotFoundError, ValueError, AttributeError) as e:
        raise ValueError("traffic kind {!r}: one of {} or a file gitbench/{}.py defining "
                         "Driver ({})".format(kind, sorted(KINDS), rel, e))


def make(cfg, spec, seed, work):
    return driver_class(spec["kind"])(cfg, spec, seed, work)
