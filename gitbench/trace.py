"""The traced span of a `--trace 1` run: torch.profiler over a steady part of
the window, reduced to the device's busy time, each kernel's device time and
the longest idle gaps.

Copied from chip_smoke.py and repaired: `profile_batch` summed kernel times
over a wall clock the profiler inflates; here the busy time is the union of
the kernels' intervals (phase 34's busy share), clipped to the span between
two marker kernels (`torch.cuda._sleep`, launched on a drained card as the
span opens and closes).  Only device activity is traced, so the host runs
at its own pace.  Each idle gap is named by the benchmark's host span
(`Hooks.spans`: dispatch, resolve, to_host, decode) that held its midpoint,
mapped onto the trace's clock through the opening marker.

The span opens and closes with the card drained (`synchronize` and the
graphs' step counts settled), so every batch dispatched inside it also ran
inside it and its steps are counted.
"""

from __future__ import annotations

import collections
import time

MARK = "spin_kernel"  # the kernel of torch.cuda._sleep
MARK_CYCLES = 1000
# host time between the tracer's start and the opening marker, and between the closing marker
# and the tracer's stop.  With none, a marker (and at times kernels near it) went missing in 12
# of 450 start-stop cycles on an H100 with busy host threads or NCCL in the process; with 2 ms
# in none of 450, with 10 ms in none of 300
PAUSE_S = 0.01
NAME_CHARS = 120  # a kernel's name in the breakdown, cut to this


class Span(object):
    """The profiler over part of the window: `poll(elapsed)`, from the thread
    that drives the work, starts it once `elapsed` (seconds into the
    window) reaches `start` and stops it `length` seconds of host time
    after it started; `close()` stops it early at the window's close.  (One
    session, started in the window: the tracer's start-up falls before the
    span opens; a session started in set-up and carried through a schedule
    lost its kernel records, and one carried through graph captures
    crashed a vqa.tsv run.)"""

    def __init__(self, start, length, settle, launches):
        self.start, self.length, self.settle, self.launches = start, length, settle, launches
        self.prof = None
        self.t_open = self.t_close = None
        self.steps = None  # decode steps run inside the span
        self.events = None
        self.result = None
        self.lost = None  # the marker kernel the trace lost: 'opening', 'closing' or None
        self.launched = None  # each counted kernel's launches inside the span
        self._steps0 = self._launches0 = None

    def poll(self, elapsed):
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self.prof is None and elapsed >= self.start:
            torch.cuda.synchronize()
            self._steps0 = self.settle()
            self._launches0 = self.launches()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            time.sleep(PAUSE_S)
            self.t_open = time.perf_counter()
            self._mark()
            self.ref = torch.cuda.Event(enable_timing=True)
            self.ref.record()
        elif self.t_open is not None and self.t_close is None \
                and time.perf_counter() - self.t_open >= self.length:
            self.close()

    def _mark(self):
        import torch

        torch.cuda._sleep(MARK_CYCLES)

    def close(self):
        import torch

        if self.prof is None or self.t_close is not None:
            return
        torch.cuda.synchronize()
        self.t_close = time.perf_counter()
        self._mark()
        torch.cuda.synchronize()
        self.steps = self.settle() - self._steps0
        self.launched = {k: v - self._launches0[k] for k, v in self.launches().items()}
        time.sleep(PAUSE_S)
        self.prof.stop()
        self.events = self.prof.events()

    def bounds(self, kernels):
        """(lo, hi): the span's ends in trace microseconds, its two marker
        kernels'; None where the trace lost one.  Only where it lost one
        marker and kept a record of every launch the port counted in the
        span (`all_kept`), so that nothing else at that end went with it:
        the other marker and the span's length on the host clock
        (`t_close - t_open`, the clock the idle gaps are mapped through),
        the lost one told by the side of the kept one on which the span's
        other kernels lie (`lost`)."""
        marks = sorted(e.time_range.start for e in kernels if MARK in e.name)
        if len(marks) >= 2:
            return marks[0], marks[-1]
        if len(marks) != 1 or not self.all_kept(kernels):
            return None
        mark, length = marks[0], (self.t_close - self.t_open) * 1e6
        starts = [e.time_range.start for e in kernels if MARK not in e.name]
        if 2 * sum(1 for t in starts if t >= mark) >= len(starts):
            self.lost = "closing"
            return mark, mark + length
        self.lost = "opening"
        return mark - length, mark

    def all_kept(self, kernels):
        """Whether the trace holds a record of each launch of the kernels
        the port counts (`launched`: kernels 1 and 2), some launched."""
        if not self.launched or not sum(self.launched.values()):
            return False
        return all(sum(1 for e in kernels if k in e.name) == n
                   for k, n in self.launched.items())

    def reduce(self, spans, searches=()):
        """{busy_s, window_s, kernels {name: s}, calls {name: records},
        device_ops, idle_gaps}.  searches: the searches' device intervals
        (ms after the opening marker's event): the tracer drops the kernels
        of graphs captured while it runs (vqa.tsv captures throughout), so
        the replayed searches count as busy from their CUDA events too."""
        from torch.autograd import DeviceType

        if not self.events:
            raise RuntimeError("the profiler kept no events for the span")
        kernels = [e for e in self.events if e.device_type == DeviceType.CUDA]
        ends = self.bounds(kernels)
        if ends is None:
            raise RuntimeError(
                "the trace holds {} of its 2 marker kernels and {} of the counted launches {}".format(
                    sum(1 for e in kernels if MARK in e.name),
                    {k: sum(1 for e in kernels if k in e.name) for k in self.launched or {}},
                    self.launched))
        lo, hi = ends
        markers = sum(1 for e in kernels if MARK in e.name)
        ivals, by_name, calls = [], collections.Counter(), collections.Counter()
        for e in kernels:
            if MARK in e.name:
                continue
            a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
            if b <= a:
                continue
            ivals.append((a, b))
            by_name[e.name] += (b - a) / 1e6
            calls[e.name] += 1
        for a, b in searches:  # the opening marker's event follows its kernel
            a, b = lo + a * 1e3, min(lo + b * 1e3, hi)
            if b > a:
                ivals.append((a, b))
        ivals.sort()
        merged = []
        for a, b in ivals:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy = sum(b - a for a, b in merged) / 1e6
        gaps, at = [], lo
        for a, b in merged:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if hi > at:
            gaps.append((at, hi))

        def host(us):  # trace microseconds -> host perf_counter seconds
            return self.t_open + (us - lo) / 1e6

        named = collections.Counter()
        for a, b in gaps:
            mid = host((a + b) / 2)
            holding = [s for s in spans if s[1] <= mid <= s[2]]
            name = max(holding, key=lambda s: s[1])[0] if holding else "other host work"
            named[name] += (b - a) / 1e6
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        idle_gaps = []
        for a, b in longest:
            mid = host((a + b) / 2)
            holding = [s for s in spans if s[1] <= mid <= s[2]]
            idle_gaps.append(["while " + (max(holding, key=lambda s: s[1])[0] if holding
                                          else "other host work"), (b - a) / 1e6])
        self.result = dict(
            busy_s=busy, window_s=(hi - lo) / 1e6, kernels=dict(by_name), calls=dict(calls),
            device_ops=[[n[:NAME_CHARS], s] for n, s in by_name.most_common(10)],
            idle_gaps=idle_gaps, idle_by_host=dict(named), markers=markers, lost=self.lost)
        return self.result
