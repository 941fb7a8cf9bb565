"""Throughput logging, the counterpart of `ThroughputMeter` in
`gitax.runtime.profiling` (reference train.py:290-300 semantics: periodic
window timing after a warm-up).  The TSV caption loop reports through it."""

from __future__ import annotations

import logging
import time


class ThroughputMeter(object):
    """Rolling items/s logger."""

    def __init__(self, name="throughput", unit="items", log_every=10, warmup=2):
        self.name, self.unit = name, unit
        self.log_every, self.warmup = log_every, warmup
        self._count = 0
        self._items = 0
        self._t0 = time.time()
        self.last_rate = None

    def update(self, n_items):
        self._count += 1
        if self._count <= self.warmup:
            self._t0 = time.time()
            return
        self._items += n_items
        if (self._count - self.warmup) % self.log_every == 0:
            dt = time.time() - self._t0
            self.last_rate = self._items / max(dt, 1e-9)
            logging.info("%s: %.1f %s/s", self.name, self.last_rate, self.unit)
            self._items = 0
            self._t0 = time.time()
