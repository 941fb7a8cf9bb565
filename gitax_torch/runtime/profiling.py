"""The port's recorder of spans and counters, and its device trace.

Spans.  `with span(name, device=False, **attrs):` records the block's name,
its start and end on the host (`time.perf_counter_ns()`), the thread, the
id of the span that encloses it on that thread (`parent`), the id of the
`engine.device_batch` span around it (`batch`: every span of one device
batch carries its id) and its attributes.  `mark(name, **attrs)` records an
instant.  Finished records live in a ring of RING; `spans()` returns them
as `Record`s, oldest first:

    with profiling.span("engine.upload", bytes=n):
        ...
    for r in profiling.spans():
        print(r.name, (r.t1 - r.t0) / 1e6, "ms", r.device_ms, r.attrs)

Device spans.  `device=True` on a CUDA device also launches a stamp at the
block's start and one at its end on the current stream: a one-thread
kernel (`csrc/span_clock.cu`) that writes the GPU's global timer (ns) and
then the stamp's sequence number into a slot of page-locked host memory,
so that the span's `device` is (start, end) ms on that timer, `device_ms`
its length and `stamps` the two sequence numbers; no CUDA event, no host
wait.  A span's `counter(key, t, since)` has its end stamp also copy the
0-dim int64 device tensor t, and `attrs[key]` becomes that value less
`since`'s (the device-side search counts its steps so).  A device span
opened with chain=True starts at the end stamp of the thread's last device
span (the prefill's start is the encoder's end).  The slots are a
ring of SLOTS, two a device span: when it comes round to a span not read
yet, that span is read where its stamps have landed and else loses its
device times (`counters()['lost']`), never waiting for the card.  `spans()`
reads the rest, waiting for the card where a stamp has not landed yet.
Never inside a stream capture (a conditional graph's body holds only what
its step launches), so a span under capture keeps its host times only.

Counters.  `count(name=n)` adds to a plain integer whether spans are on or
off; `counters()` returns them (rows dispatched and real, their frames,
graph captures and their seconds, evictions, upload waits, device spans
lost, the VQA loop's full and flushed buckets) with the records made and
those the ring dropped.

Spans are on unless GITAX_TORCH_SPANS=0 (read at import; then `span` is
one flag test and returns a shared no-op).

`trace(logdir)` records a Chrome trace (`trace.json`) of the enclosed block
with torch.profiler, then writes the spans recorded inside the block into
it on a `gitax_torch` track: host spans by converting perf_counter to the
realtime clock of Kineto's timestamps (the trace's `baseTimeNanoseconds`,
its events' `ts` in microseconds after it), each device span on a row of
its own from its two stamp kernels' records in the trace, which `paired`
matches to the spans by launch order (the stamps' sequence numbers against
the kernels' correlation ids).  On a card the block opens with a marker
kernel (`torch.cuda._sleep`) on a drained card and the `trace.open` mark.
gitax's counterpart is `gitax.runtime.profiling.trace` (jax.profiler)."""

from __future__ import annotations

import collections
import contextlib
import ctypes
import itertools
import json
import logging
import os
import threading
import time

import torch

RING = 65536  # finished records kept, the oldest dropped first
SLOTS = 65536  # page-locked stamp slots, two a device span, reused in turn
BATCH = "engine.device_batch"  # the span whose id its descendants carry
STAMP = "span_stamp"  # the stamp kernel's name in a profiler's records
TRACK_PID = 2 ** 31 - 2  # the `gitax_torch` process track in trace.json
MARK_CYCLES = 1000  # the opening marker kernel's spin


def enabled_by(environ):
    """Whether spans are on under the environment `environ`."""
    return environ.get("GITAX_TORCH_SPANS", "1").strip() != "0"


ON = enabled_by(os.environ)

# A finished record: host times in perf_counter ns; for a device span whose
# stamps were read, `device` (start, end) ms on the GPU's global timer and
# `device_ms`, and for every device span that stamped, `stamps` (start, end
# sequence numbers); `kind` 'span' or 'mark'.
Record = collections.namedtuple("Record", ("name", "id", "parent", "batch", "thread", "t0", "t1",
                                           "attrs", "device", "device_ms", "kind", "stamps"))

_perf_ns = time.perf_counter_ns
_get_ident = threading.get_ident
# host records as flat tuples (name, id, parent, batch, thread, t0, t1, kind,
# the attributes' keys, their values): the garbage collector stops tracking
# a tuple of plain values in the young generations, where a dict or a
# nested tuple keeps it tracked into the old one, and every tracked record
# that reaches it brings the next full collection nearer (with torch
# loaded some 170k objects, ~90 ms a collection: one every ~2000 device
# batches with a dict in each record).  Device spans stay their Span.
_records = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_tls = threading.local()
_lock = threading.Lock()  # reading device spans
_pending = {}  # device spans not read yet, in the order they ended
# bound at the first device span
_lib = _slots = _owner = _launch = _raw_stream = _device = _capturing = None
_seq = itertools.count(1)  # stamp numbers; stamp s writes slot s % SLOTS
_count_lock = threading.Lock()
_counts = {"rows": 0, "real_rows": 0, "frames": 0, "captures": 0, "capture_s": 0.0,
           "evictions": 0, "upload_waits": 0, "lost": 0, "full_buckets": 0,
           "flushed_buckets": 0, "encode_captures": 0, "encode_replays": 0,
           "encode_evictions": 0, "encode_eager": 0}


def count(**n):
    """Add to the counters named, spans on or off: `count(rows=32,
    real_rows=30)`."""
    with _count_lock:
        for name, k in n.items():
            _counts[name] += k


def counters():
    """The process's counters: {rows, real_rows, frames (the rows'
    frames: F a clip, 1 an image), captures, capture_s, evictions (the
    search's graphs), upload_waits, lost (device spans whose stamps were
    not read), full_buckets and flushed_buckets (the VQA loop's device
    batches dispatched because their bucket filled, and by its pass-end
    flush), encode_captures, encode_replays, encode_evictions and
    encode_eager (the encoder's graphs, `decode.device_loop.encode`:
    misses captured, hits, graphs dropped, and misses run eagerly; the
    hit share is replays / (replays + captures + eager)), records
    (made), dropped (by the ring)}."""
    out = dict(_counts)
    # the ids handed out, read from the counter's repr without taking one
    out["records"] = made = int(repr(_ids)[len("count("):-1]) - 1
    out["dropped"] = max(0, made - RING)
    return out


class Span(object):
    """An open span (see `span`); once finished, a Record in the ring."""

    __slots__ = ("name", "id", "parent", "batch", "thread", "t0", "t1", "attrs", "device",
                 "device_ms", "stamps", "value", "_dev", "_count", "_chain")

    def __init__(self, name, device, chain, attrs):
        self.name, self.attrs, self._dev, self._chain = name, attrs, device, chain
        self.stamps = self.device = self.device_ms = self.value = self._count = None

    def __enter__(self):
        try:
            stack = _tls.stack
        except AttributeError:
            stack = _tls.stack = []
        self.id = i = next(_ids)
        if stack:
            top = stack[-1]
            self.parent, self.batch = top.id, top.batch
        else:
            self.parent = self.batch = None
        if self.name == BATCH:
            self.batch = i
        self.thread = _get_ident()
        stack.append(self)
        self.t0 = _perf_ns()
        if self._dev and (_lib is not None or _bind()) and not _capturing():
            self._dev = dev = _device()
            last = getattr(_tls, "last", None) if self._chain else None
            if last is not None and last._dev == dev:  # its end stamp is this span's start
                _owner[last.stamps[1] % SLOTS] = self
                self.stamps = (last.stamps[1], None)
            else:
                self.stamps = (_stamp(self, _raw_stream(dev), None), None)
        else:
            self._dev = None
        return self

    def __exit__(self, a, b, c):
        if self._dev is not None:
            copied = self._count
            self.stamps = (self.stamps[0], _stamp(self, _raw_stream(self._dev),
                                                  copied and copied[1].data_ptr()))
            self.t1 = _perf_ns()
            _records.append(self)
            _pending[self] = None
            _tls.last = self
        else:
            _records.append((self.name, self.id, self.parent, self.batch, self.thread, self.t0,
                             _perf_ns(), "span", *self.attrs, *self.attrs.values()))
        stack = _tls.stack
        if stack[-1] is self:
            stack.pop()
        elif self in stack:  # a generator's span closed out of turn
            stack.remove(self)
        return False

    def set(self, **attrs):
        """Add attributes (known only inside the block)."""
        self.attrs.update(attrs)

    def counter(self, key, tensor, since=None):
        """Have the end stamp copy the 0-dim int64 device tensor's value (no
        host read); once read, `value` is that value and attrs[key] it less
        `since`'s (a span that copied the same counter before), or the
        value where since is None.  A no-op where the span records no
        stamps."""
        if self._dev is not None:
            self._count = (key, tensor, since)


class _Off(object):
    """The no-op span of a recorder that is off."""

    __slots__ = ()
    value = None


_OFF = _Off()
# all in C, a third cheaper than Python methods: a class's builtin
# callables are called unbound, so __enter__ takes no argument (a repeat's
# __next__ returns the no-op span), and __exit__, set and counter take
# what they are given (`"".format` returns "": false, so an exception
# propagates)
_Off.__enter__ = itertools.repeat(_OFF).__next__
_Off.__exit__ = _Off.set = _Off.counter = "".format


def span(name, device=False, chain=False, **attrs):
    """A span of the enclosed block (see the module docstring).  A device
    span with chain=True starts at the end stamp of the device span this
    thread ended last, on the same device, and launches one stamp fewer:
    what the stream ran between the two counts to this one."""
    if not ON:
        return _OFF
    return Span(name, device, chain, attrs)


def mark(name, **attrs):
    """Record an instant, its parent the thread's innermost open span."""
    if not ON:
        return
    stack = getattr(_tls, "stack", None)
    parent, batch = (stack[-1].id, stack[-1].batch) if stack else (None, None)
    t = _perf_ns()
    _records.append((name, next(_ids), parent, batch, _get_ident(), t, t, "mark", *attrs,
                     *attrs.values()))


def spans():
    """The finished Records, oldest first, with their device times and
    counters read (waits for the card where a stamp has not landed)."""
    read_pending()
    out = []
    for r in list(_records):
        if type(r) is tuple:
            name, i, parent, batch, thread, t0, t1, kind, *kv = r
            n = len(kv) // 2
            out.append(Record(name, i, parent, batch, thread, t0, t1, dict(zip(kv[:n], kv[n:])),
                              None, None, kind, None))
        else:
            out.append(Record(r.name, r.id, r.parent, r.batch, r.thread, r.t0, r.t1, r.attrs,
                              r.device, r.device_ms, "span", r.stamps))
    return out


def clear():
    """Drop the finished records (the counters stay)."""
    read_pending()
    _records.clear()


# -- device stamps -------------------------------------------------------------


def _bind():
    """The stamp library and its page-locked slots, at the first device span
    (returns True)."""
    global _lib, _slots, _owner, _launch, _raw_stream, _device, _capturing
    with _lock:
        if _lib is not None:
            return True
        from ..ops import cuda_build

        lib = cuda_build.load("span_clock")
        lib.gitax_span_slots.argtypes = [ctypes.c_ulonglong]
        lib.gitax_span_slots.restype = ctypes.c_void_p
        lib.gitax_span_stamp.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p]
        lib.gitax_span_stamp.restype = ctypes.c_int
        lib.gitax_span_error_string.argtypes = [ctypes.c_int]
        lib.gitax_span_error_string.restype = ctypes.c_char_p
        ptr = lib.gitax_span_slots(SLOTS)
        if not ptr:
            raise RuntimeError("span_clock: cudaHostAlloc of {} stamp slots failed".format(SLOTS))
        # slot i: words 4i..4i+3, the timer, the counter's value, the
        # stamp's number, unused (a ctypes array reads a word as an int)
        _slots = (ctypes.c_uint64 * (4 * SLOTS)).from_address(ptr)
        _owner = [None] * SLOTS
        # the current device, a device's current stream and whether it is
        # capturing, one C call each (torch.cuda.current_stream() builds a
        # Stream: 5 us on the H100's host)
        _device = torch._C._cuda_getDevice
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _capturing = torch._C._cuda_isCurrentStreamCapturing
        _launch = lib.gitax_span_stamp
        _lib = lib
        return True


def _stamp(owner, stream, counter_ptr):
    """Launch the next stamp for `owner` on `stream`; returns its number.
    Where the slots' ring has come round to a span not read yet, that span
    is read now if its stamps have landed, else its device times are lost."""
    seq = next(_seq)
    slot = seq % SLOTS
    old = _owner[slot]
    if old is not None and old in _pending:
        with _lock:
            if old in _pending:
                del _pending[old]
                _read(old)
    _owner[slot] = owner
    rc = _launch(stream, seq, counter_ptr)
    if rc:
        raise RuntimeError("span_clock: the stamp's launch failed: cudaError {}: {}".format(
            rc, _lib.gitax_span_error_string(rc).decode()))
    return seq


def read_pending():
    """Read the device spans not read yet, waiting for the card where a
    stamp has not landed."""
    with _lock:
        todo = list(_pending)
        for s in todo:
            del _pending[s]
        for dev in {s._dev for s in todo if not _landed(s)}:
            with torch.cuda.device(dev):
                torch.cuda.synchronize()
        for s in todo:
            _read(s)


def _landed(s):
    """Whether the device span s's end stamp (and so its start) has run."""
    return _slots[4 * (s.stamps[1] % SLOTS) + 2] == s.stamps[1]


def _read(s):
    """Set the device span s's times and counter from its slots, or count it
    lost where a stamp has not landed or its slot was reused (under the
    lock)."""
    (a, b), copied = s.stamps, s._count
    sa, sb = 4 * (a % SLOTS), 4 * (b % SLOTS)
    s._count = None
    if _slots[sa + 2] != a or _slots[sb + 2] != b:
        count(lost=1)
        return
    t0, t1 = _slots[sa], _slots[sb]
    s.device, s.device_ms = (t0 / 1e6, t1 / 1e6), (t1 - t0) / 1e6
    if copied is not None:
        # `since` stamped before this span, so it was read before it
        key, _, since = copied
        v = _slots[sb + 1]
        s.value = v - (1 << 64) if v >> 63 else v  # the int64 counter's bits
        if since is None:
            s.attrs[key] = s.value
        elif since.value is not None:
            s.attrs[key] = s.value - since.value


def paired(records, kernels):
    """{record id: (start kernel, end kernel)} for the device spans among
    `records` whose stamps `kernels` hold: the trace's stamp kernels in the
    order they were launched (by correlation id), matched to the spans'
    stamps in theirs (by sequence number).  None where the counts differ
    (a stamp launched outside the records, or a kernel record lost)."""
    dev = [r for r in records if r.stamps is not None]
    seqs = sorted({s for r in dev for s in r.stamps})  # chained spans share a stamp
    if len(seqs) != len(kernels):
        return None
    at = dict(zip(seqs, kernels))
    return {r.id: (at[r.stamps[0]], at[r.stamps[1]]) for r in dev}


# -- the trace -----------------------------------------------------------------


def realtime_offset_ns():
    """time.time_ns() - time.perf_counter_ns(), read between two perf_counter
    reads, the narrowest of a few."""
    best = None
    for _ in range(5):
        a = _perf_ns()
        wall = time.time_ns()
        b = _perf_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


def trace_events(records, base_ns, offset_ns, placed=None):
    """The records as Chrome trace events on the `gitax_torch` track: host
    spans (perf_counter + offset_ns, microseconds after base_ns) on a row a
    thread, marks as instants, and device spans on a row of their own from
    `placed` ({record id: (start us, end us)} on the trace's timebase)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    tids = {}
    out = [{"ph": "M", "name": "process_name", "pid": TRACK_PID,
            "args": {"name": "gitax_torch"}}]

    def tid(thread):
        if thread not in tids:
            tids[thread] = len(tids) + 1
            out.append({"ph": "M", "name": "thread_name", "pid": TRACK_PID, "tid": tids[thread],
                        "args": {"name": names.get(thread, "thread {}".format(thread))}})
        return tids[thread]

    device_tid = 0
    for r in records:
        args = dict(r.attrs, id=r.id, parent=r.parent, batch=r.batch)
        ts = (r.t0 + offset_ns - base_ns) / 1e3
        if r.kind == "mark":
            out.append({"ph": "i", "s": "t", "name": r.name, "cat": "gitax_torch",
                        "pid": TRACK_PID, "tid": tid(r.thread), "ts": ts, "args": args})
            continue
        out.append({"ph": "X", "name": r.name, "cat": "gitax_torch", "pid": TRACK_PID,
                    "tid": tid(r.thread), "ts": ts, "dur": (r.t1 - r.t0) / 1e3, "args": args})
        if placed and r.id in placed:
            if not device_tid:
                device_tid = -1
                out.append({"ph": "M", "name": "thread_name", "pid": TRACK_PID,
                            "tid": device_tid, "args": {"name": "device spans"}})
            a, b = placed[r.id]
            out.append({"ph": "X", "name": r.name, "cat": "gitax_torch_device",
                        "pid": TRACK_PID, "tid": device_tid, "ts": a, "dur": b - a,
                        "args": args})
    return out


@contextlib.contextmanager
def trace(logdir="gitax_torch_trace"):
    """Capture a device trace of the enclosed block into `logdir`, as a
    Chrome trace (`trace.json`, viewable in Perfetto or chrome://tracing)
    of the host's calls, where a card is present its kernels, and the
    spans recorded inside the block (see the module docstring):

        with profiling.trace('traces/batch'):
            run_batch()

    The context yields the profiler (its `events()` and `key_averages()`
    are there after the block)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    if cuda:  # the marker's module loaded before the trace (CUDA loads lazily)
        torch.cuda._sleep(MARK_CYCLES)
    prof = profile(activities=activities)
    prof.start()
    t_open = _perf_ns()
    try:
        if cuda:  # the opening marker, on a drained card
            torch.cuda.synchronize()
            mark("trace.open")
            torch.cuda._sleep(MARK_CYCLES)
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        t_close = _perf_ns()
        prof.stop()
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
        records = [r for r in spans() if r.t0 >= t_open and r.t1 <= t_close]
        with open(path) as f:
            doc = json.load(f)
        events = doc.setdefault("traceEvents", [])
        kernels = sorted((e for e in events
                          if e.get("cat") == "kernel" and STAMP in e.get("name", "")),
                         key=lambda e: e.get("args", {}).get("correlation", 0))
        pairs = paired(records, kernels) or {}
        placed = {i: (a["ts"], b["ts"] + b.get("dur", 0)) for i, (a, b) in pairs.items()}
        events += trace_events(records, int(doc.get("baseTimeNanoseconds", 0)),
                               realtime_offset_ns(), placed)
        with open(path, "w") as f:
            json.dump(doc, f)
        logging.info("profiler trace written to %s (%d spans of gitax_torch, %d device spans "
                     "placed)", path, len(records), len(placed))
