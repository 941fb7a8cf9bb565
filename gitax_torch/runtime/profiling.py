"""Profiling and throughput logging, the counterpart of
`gitax.runtime.profiling`: `trace` records a device trace with
`torch.profiler` where gitax records one with `jax.profiler`;
`ThroughputMeter` (the TSV caption loop reports through it) and
`StepLogger` are copies of gitax's (reference train.py:290-300 and
decoder.py:645-665 semantics)."""

from __future__ import annotations

import contextlib
import logging
import os
import time


@contextlib.contextmanager
def trace(logdir="gitax_torch_trace"):
    """Capture a device trace of the enclosed block into `logdir`, as a
    Chrome trace (`trace.json`, viewable in Perfetto or chrome://tracing)
    of the host's calls and, where a card is present, its kernels:

        with profiling.trace('traces/batch'):
            run_batch()

    The context yields the profiler (its `events()` and `key_averages()`
    are there after the block)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
        logging.info("profiler trace written to %s", path)


class ThroughputMeter(object):
    """Rolling items/s logger (reference train.py:290-300 semantics:
    periodic window timing after warmup)."""

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
            logging.info(
                "%s: %.1f %s/s", self.name, self.last_rate, self.unit
            )
            self._items = 0
            self._t0 = time.time()


class StepLogger(object):
    """Periodic training-metrics logging (covers the reference's
    in-module loss stats, decoder.py:645-665, without stateful loss
    modules)."""

    def __init__(self, log_every=100):
        self.log_every = log_every
        self._min = float("inf")
        self._max = float("-inf")

    def update(self, step, metrics):
        loss = float(metrics.get("loss", float("nan")))
        self._min = min(self._min, loss)
        self._max = max(self._max, loss)
        if step % self.log_every == 0:
            extras = {
                k: float(v) for k, v in metrics.items() if k != "loss"
            }
            logging.info(
                "step=%d loss=%.4f window_min=%.4f window_max=%.4f %s",
                step, loss, self._min, self._max, extras,
            )
            self._min, self._max = float("inf"), float("-inf")
