"""The arithmetic of the metrics read from the program's own spans
(`program_spans.py` and its readers under metrics/) on a hand-made ctx:
records as `gitax_torch.runtime.profiling.spans()` returns them, a window,
and for the idle attribution a traced span of stand-in kernel records."""

import types

import pytest
from torch.autograd import DeviceType

from gitbench import program_spans as P
from gitbench import spec
from gitbench import trace as tr

FEED, POOL = 1, 2  # thread idents
OPEN = 100.0  # the window's opening, host seconds
MS = 1_000_000  # ns
NEW = ["device.idle.pool_wait", "device.idle.assemble", "device.idle.dispatch",
       "device.idle.resolve", "device.idle.write", "device.idle.unspanned", "engine.stack_ms",
       "engine.host_cast_ms", "engine.upload_ms", "engine.upload_wait_ms", "model.enqueue_ms",
       "search.launch_ms", "engine.to_host_wait_ms", "search.captures", "search.capture_s",
       "search.evictions", "engine.real_row_share", "decode.chunk_ms_per_row",
       "engine.device_batch_host_ms", "model.encode_device_ms", "model.prefill_device_ms",
       "search.device_ms_per_step", "device.idle.capture"]


class Rec(object):
    """A record of the recorder's shape."""

    _ids = iter(range(1, 10_000))

    def __init__(self, name, t0_ms, t1_ms, parent=None, batch=None, thread=FEED, device=None,
                 stamps=None, **attrs):
        self.name, self.id, self.thread, self.stamps = name, next(Rec._ids), thread, stamps
        self.parent = parent.id if parent is not None else None
        self.batch = batch.id if batch is not None else (parent.batch if parent else None)
        self.t0, self.t1 = int(OPEN * 1e9 + t0_ms * MS), int(OPEN * 1e9 + t1_ms * MS)
        self.attrs, self.device = attrs, device
        self.device_ms = None if device is None else device[1] - device[0]


def batch(t0, rows, real, cast, upload, wait, encode, prefill, launch, steps, capture=None):
    """A device batch from t0 (ms): its spans one after the other, each
    (host ms[, device ms]); returns its records."""
    b = Rec("engine.device_batch", t0, t0, rows=rows, real=real)
    b.batch = b.id
    out, at = [], t0
    for name, ms, dev, kw in (("engine.host_cast", cast, None, {}),
                              ("engine.upload", upload, None, {"bytes": 1}),
                              ("model.encode", encode[0], encode[1], {}),
                              ("model.prefill", prefill[0], prefill[1], {}),
                              ("search.capture", capture, None, {}),
                              ("search.launch", launch[0], launch[1], {"steps": steps})):
        if ms is None:
            continue
        r = Rec(name, at, at + ms, parent=b, device=None if dev is None else (0.0, dev), **kw)
        out.append(r)
        if name == "engine.upload" and wait:
            out.append(Rec("engine.upload_wait", at, at + wait, parent=r))
        at += ms
    b.t1 = int(OPEN * 1e9 + at * MS)
    return out + [b]


def ctx_of(records, deadline_ms=1000.0, **kw):
    ctx = types.SimpleNamespace(window={"window_open": OPEN, "deadline": OPEN + deadline_ms / 1e3},
                                span=None, profile=None, program_spans=records)
    ctx.__dict__.update(kw)
    return ctx


def read(name, ctx):
    return spec.reader(name)(ctx)


@pytest.fixture
def window():
    early = Rec("engine.device_batch", -50, -40, rows=32, real=1)  # before the window
    recs = [early]
    recs += batch(10, 32, 32, 5.0, 2.0, 1.0, (20.0, 40.0), (6.0, 12.0), (3.0, 26.0), 13,
                  capture=8.0)
    recs += batch(100, 32, 16, 7.0, 4.0, 0.0, (24.0, 44.0), (8.0, 14.0), (1.0, 30.0), 10)
    # returns after the deadline (900 ms): not in real_row_share
    recs += batch(890, 32, 8, 6.0, 3.0, 0.0, (22.0, 42.0), (6.0, 13.0), (1.0, 28.0), 12)
    recs += [Rec("engine.stack", 5, 9, rows=32, real=32), Rec("engine.stack", 95, 96),
             Rec("engine.stack", 880, 881),
             Rec("engine.to_host", 300, 330), Rec("engine.to_host", 400, 406),
             Rec("search.evict", 50, 50),
             Rec("decode.chunk", -10, 20, thread=POOL, rows=32),
             Rec("decode.chunk", 20, 60, thread=POOL, rows=8),
             Rec("decode.chunk", -90, -60, thread=POOL, rows=32)]
    return ctx_of(recs, deadline_ms=900.0)


def test_device_batch_means(window):
    got = {n: read(n, window) for n in (
        "engine.device_batch_host_ms", "engine.stack_ms", "engine.host_cast_ms",
        "engine.upload_ms", "engine.upload_wait_ms", "model.enqueue_ms", "search.launch_ms",
        "engine.to_host_wait_ms")}
    assert got == pytest.approx({
        "engine.device_batch_host_ms": (44 + 44 + 38) / 3,  # each batch's span, end to end
        "engine.stack_ms": (4 + 1 + 1) / 3,
        "engine.host_cast_ms": (5 + 7 + 6) / 3,
        "engine.upload_ms": (2 + 4 + 3) / 3,
        "engine.upload_wait_ms": 1 / 3,
        "model.enqueue_ms": (26 + 32 + 28) / 3,
        "search.launch_ms": (3 + 1 + 1) / 3,
        "engine.to_host_wait_ms": 36 / 3})


def test_counts_shares_and_device_times(window):
    assert read("search.captures", window) == 1
    assert read("search.capture_s", window) == pytest.approx(0.008)
    assert read("search.evictions", window) == 1
    # the two batches that returned by the deadline: 48 real of 64
    assert read("engine.real_row_share", window) == pytest.approx(48 / 64)
    # the chunks that ended in the window: 70 ms over 40 rows
    assert read("decode.chunk_ms_per_row", window) == pytest.approx(70 / 40)
    assert read("model.encode_device_ms", window) == pytest.approx(42.0)
    assert read("model.prefill_device_ms", window) == pytest.approx(13.0)
    assert read("search.device_ms_per_step", window) == pytest.approx((26 + 30 + 28) / 35)


def test_nothing_to_read_without_the_programs_spans():
    """A program without the recorder (or with it off) leaves every such
    metric out of the line: each reader returns None, and none raises."""
    ctx = ctx_of(None)
    assert all(read(n, ctx) is None for n in NEW)
    assert {m["name"] for m in spec.load()["per_layer"]} >= set(NEW)


class Kernel(object):
    _ids = iter(range(1, 10_000))  # correlation ids: the launches' order

    def __init__(self, name, a, b):
        self.name, self.device_type, self.id = name, DeviceType.CUDA, next(Kernel._ids)
        self.time_range = types.SimpleNamespace(start=a, end=b)


def idle_ctx(stamp_kernels=True):
    """A 10 ms traced span (markers at 1000 and 11000 trace us): kernels busy
    at 1000-2000 and 5000-6000 us, a search's device span at 8000-9000 us
    (its stamps 8 and 9, whose kernels the trace holds at 8000 and 9000
    us, after the encoder's stamps 5 and 6 and the chained prefill's 6
    and 7 at 5000, 5500 and 6000), so idle
    2-5 ms (midpoint 3.5), 6-8 (7) and 9-11 ms (10) of the trace; the
    feeding thread waits on the pool over the first, dispatches over the
    second (capturing a graph at its midpoint), and is in no span at the
    third (a pool thread's span there does not count)."""
    span = tr.Span(0.0, 1.0, None, None)
    span.t_open, span.t_close = OPEN + 0.5, OPEN + 0.6
    stamps = [Kernel("span_stamp_kernel", t, t) for t in (5000, 5500, 6000, 8000, 9000)]
    span.events = [Kernel(tr.MARK, 1000, 1001), Kernel("k", 1000, 2000),
                   Kernel("k", 5000, 6000), Kernel(tr.MARK, 11000, 11001)]
    span.events += stamps if stamp_kernels else stamps[1:]
    at = 500.0  # the span's opening, ms after the window's
    dispatch = Rec("engine.dispatch", at + 5.5, at + 6.5)
    recs = [Rec("tsv.pool_wait", at + 1.5, at + 3.0), dispatch,
            Rec("model.encode", at + 5.52, at + 5.55, parent=dispatch, device=(90.0, 90.5),
                stamps=(5, 6)),
            Rec("model.prefill", at + 5.55, at + 5.58, parent=dispatch, device=(90.5, 91.0),
                stamps=(6, 7)),
            Rec("search.capture", at + 5.8, at + 6.2, parent=dispatch),
            Rec("search.launch", at + 6.3, at + 6.4, parent=dispatch, device=(100.0, 101.0),
                stamps=(8, 9)),
            Rec("decode.chunk", at + 8.0, at + 10.0, thread=POOL, rows=4)]
    return ctx_of(recs, span=span, profile={"busy_s": 0.003, "window_s": 0.01})


def test_idle_attribution():
    """The six shares of idle_ctx's span, and the capture's within the
    dispatch's."""
    ctx = idle_ctx()
    shares = {n: read("device.idle." + n, ctx) for n in (
        "pool_wait", "assemble", "dispatch", "resolve", "write", "unspanned")}
    assert shares == pytest.approx({"pool_wait": 0.3, "assemble": 0.0, "dispatch": 0.2,
                                    "resolve": 0.0, "write": 0.0, "unspanned": 0.2})
    # the six sum to the span's idle share, the search's device span busy
    assert sum(shares.values()) == pytest.approx(1 - 0.003 / 0.01)
    assert read("device.idle.capture", ctx) == pytest.approx(0.2)


def test_idle_attribution_needs_every_stamp_kernel():
    """A stamp kernel missing from the profile: the stamps cannot be paired
    by launch order, so no share is read (rather than a search left out
    of the busy time)."""
    ctx = idle_ctx(stamp_kernels=False)
    assert all(read("device.idle." + n, ctx) is None for n in (
        "pool_wait", "assemble", "dispatch", "resolve", "write", "unspanned", "capture"))


def lost_marker_ctx(lost, counted=2):
    """idle_ctx with the marker kernel at `lost` trace us gone, its two
    busy kernels named as kernel 1's records, and `counted` launches of
    kernel 1 (none of kernel 2) by the port's counter in the span."""
    ctx = idle_ctx()
    ctx.span.t_close = ctx.span.t_open + 0.010  # the markers' 10 ms on the host too
    ctx.span.launched = {"decode_attention": counted, "flash_attention": 0}
    for e in ctx.span.events:
        if e.name == "k":
            e.name = "decode_attention_kernel"
    ctx.span.events = [e for e in ctx.span.events
                       if not (tr.MARK in e.name and e.time_range.start == lost)]
    return ctx


def cuda_kernels(ctx):
    return [e for e in ctx.span.events if e.device_type == DeviceType.CUDA]


@pytest.mark.parametrize("lost", [1000, 11000])
def test_a_lost_marker_kernel_is_replaced_by_the_host_clocks_length(lost):
    """A trace that lost its opening or its closing marker kernel and kept a
    record of each launch the port counted: the span ends at the kept
    marker and the host clock's length of the span, on the side where the
    other kernels lie; the shares are those of the whole trace, and the
    result says which marker went."""
    whole = idle_ctx()
    whole.span.t_close = whole.span.t_open + 0.010
    ctx = lost_marker_ctx(lost)
    assert ctx.span.bounds(cuda_kernels(ctx)) == pytest.approx((1000, 11000))
    for n in ("pool_wait", "dispatch", "unspanned", "capture"):
        assert read("device.idle." + n, ctx) == pytest.approx(read("device.idle." + n, whole))
    res = ctx.span.reduce([])
    assert res["markers"] == 1 and res["window_s"] == pytest.approx(0.010)
    assert res["lost"] == ("opening" if lost == 1000 else "closing")
    assert whole.span.reduce([])["lost"] is None


@pytest.mark.parametrize("lost", [1000, 11000])
def test_a_lost_marker_kernel_is_refused_where_a_counted_launch_went_too(lost):
    """One marker kept, but the port counted a launch whose record the trace
    lacks (the end of the activity may have gone with the marker), or no
    launch at all: no bounds, and the reduction raises; so it does with
    neither marker."""
    for counted in (3, 0):
        ctx = lost_marker_ctx(lost, counted)
        assert ctx.span.bounds(cuda_kernels(ctx)) is None
        with pytest.raises(RuntimeError, match="1 of its 2 marker kernels"):
            ctx.span.reduce([])
        assert read("device.idle.pool_wait", ctx) is None
    ctx = lost_marker_ctx(lost)
    ctx.span.events = [e for e in ctx.span.events if tr.MARK not in e.name]
    with pytest.raises(RuntimeError, match="0 of its 2 marker kernels"):
        ctx.span.reduce([])
