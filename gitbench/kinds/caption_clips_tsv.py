"""The traffic kind 'caption_clips_tsv': video captioning in bulk through
`CaptionEngine.run_caption_tsv`, the CLI's `-p` loop, on a video model.  A
row is one clip: its key, a tab, and a JSON list of the clip's `frames`
base64 JPEG frames in time order.  `clips` distinct clips, all
frames of a clip of one shape (the traffic's shares, counted over clips),
each clip `rows / clips` times in a TSV whose order the seed draws,
replayed pass after pass; warm-up: a TSV of the first device batch's clips.

The warm-up also checks that the program takes clips: every device batch
of the warm-up pass must hold clips of `frames` frames.  A program whose
loop reads a clip's row as one image (or drops it) fails there, before
the window."""

from __future__ import annotations

import json
import os

import numpy as np

from gitbench import traffic as T
from gitbench.drivers import CaptionTSV


def clips(seed, shares, n, frames, quality):
    """n clips [(w, h, [base64 frame, ...])] of `frames` frames each, in the
    proportions of `shares` counted over clips, their order drawn from the
    seed; each shape's frames from a stream of their own."""
    out = []
    for stream, (key, count) in enumerate(T.counts(shares, n).items()):
        flat = T.payloads(seed, {key: 1}, count * frames, quality, stream=1 + stream)
        out += [(flat[i][0], flat[i][1], [p[2] for p in flat[i:i + frames]])
                for i in range(0, len(flat), frames)]
    order = np.random.default_rng([int(seed), 0xC11]).permutation(n)
    return [out[i] for i in order]


class Driver(CaptionTSV):

    def prepare(self):
        s = self.spec
        self.payloads = clips(self.seed, s["shapes"], s["clips"], s["frames"],
                              s["jpeg_quality"])
        order = T.caption_rows(self.seed, s["clips"], s["rows"] // s["clips"])
        self.keys = ["{:05d}_{:03d}".format(i, p) for i, p in enumerate(order)]
        self.tsv = os.path.join(self.work, "clips.tsv")
        T.write_image_tsv(self.tsv, [(k, json.dumps(self.payloads[p][2]))
                                     for k, p in zip(self.keys, order)])
        self.warm_tsv = os.path.join(self.work, "warm.tsv")
        n = self.cfg["batch_size"]
        T.write_image_tsv(self.warm_tsv, [(k, json.dumps(self.payloads[p][2]))
                                          for k, p in zip(self.keys[:n], order[:n])])

    def warm(self, program):
        eng, frames = program.engine, self.spec["frames"]
        inner = eng.dispatch_device_batch
        shapes = []

        def dispatch(imgs, pref, **kw):
            shapes.append(np.shape(imgs))
            return inner(imgs, pref, **kw)

        eng.dispatch_device_batch = dispatch
        try:
            super(Driver, self).warm(program)
        finally:
            eng.dispatch_device_batch = inner
        if not shapes or any(len(s) != 5 or s[1] != frames for s in shapes):
            raise RuntimeError("the program's run_caption_tsv did not caption the warm-up's "
                               "rows as clips of {} frames: its device batches were {}".format(
                                   frames, shapes))
