"""A traffic kind that lives in a file of its own, for the tests: captions
of video clips, each `frames` JPEG frames of one shape, through the
engine's `dispatch` and `resolve` pass after pass.  Named in a traffic file
as `"kind": "tests/clips_kind"`.  A clip's payload is the list of its
frames' base64 JPEGs; its reference (`clips_reference.pixels`) decodes
each.  The frames are decoded with the program's transform in the
warm-up, before the window."""

from __future__ import annotations

import time

from gitbench import traffic as T
from gitbench.drivers import _TSVDriver
from gitbench.judge import Served


class Driver(_TSVDriver):

    def prepare(self):
        s = self.spec
        n, f = s["clips"], s["frames"]
        flat = T.payloads(self.seed, s["shapes"], n * f, s["jpeg_quality"])
        self.clips = [[p[2] for p in flat[i * f:(i + 1) * f]] for i in range(n)]
        self.results = []  # each pass's captions, in clip order

    def warm(self, program):
        import numpy as np

        eng = program.engine
        self.arrays = [np.stack([eng._decode_row(b) for b in clip]) for clip in self.clips]
        self.one_pass(eng)

    def one_pass(self, engine):
        b, cls = engine.batch_size, engine.tokenizer.cls_token_id
        texts = []
        for i in range(0, len(self.arrays), b):
            arrs = self.arrays[i:i + b]
            texts += engine.resolve(engine.dispatch(arrs, [[cls]] * len(arrs)))
        return texts

    def window(self, program, hooks, seconds, span=None):
        t_open = time.perf_counter()
        deadline = t_open + seconds
        hooks.recording = True
        while time.perf_counter() < deadline:
            self.results.append(self.one_pass(program.engine))
        items, secs = self.rate_window(hooks, t_open, deadline)
        hooks.recording = False
        rows = sum(b["rows"] for b in hooks.batches if b["t"] <= deadline)
        return dict(items=items, seconds=secs, rows_dispatched=rows, passes=len(self.results),
                    window_open=t_open, deadline=deadline)

    def served(self, hooks, window):
        return [Served(clip, "", text) for texts in self.results
                for clip, text in zip(self.clips, texts)]
