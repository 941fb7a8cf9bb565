"""The program's own spans and counters (`gitax_torch.runtime.profiling`),
read for the per-layer metrics that split the host's time and shadow the
benchmark's outside hooks.  Every reader returns None where the program
keeps no spans: a program without the recorder, or one run with
GITAX_TORCH_SPANS=0.

Windows: the device-batch metrics take the records from the window's
opening on (the outside hooks record until the window's last pass ends, so
do these); `engine.real_row_share` takes the batches that returned inside
the window, as `tsv.useful_rows` does; the idle attribution takes the
traced span, where the searches' device spans count as busy from their
stamp kernels in the profile (`paired`: the profiler keeps no kernel of a
graph captured while it runs).
"""

from __future__ import annotations


# the feeding thread's top-level spans (the thread that calls dispatch)
FEED_TOP = ("tsv.pool_wait", "tsv.assemble", "engine.dispatch", "engine.resolve", "tsv.write")
UNSPANNED = "other host work"  # trace.Span.reduce's name for a gap in no span
CAPTURE = "search.capture"  # a graph's warm-up and capture, inside engine.dispatch
STAMP = "span_stamp"  # the kernel that stamps a device span's start or end


def records(ctx):
    """The program's finished records (its device spans resolved), read
    once a run and kept on ctx; None without any."""
    if not hasattr(ctx, "program_spans"):
        ctx.program_spans = None
        try:
            from gitax_torch.runtime import profiling
        except ImportError:
            return None
        read = getattr(profiling, "spans", None)
        if read is not None:
            ctx.program_spans = read() or None
    return ctx.program_spans


def _open_ns(ctx):
    w = ctx.window or {}
    return None if "window_open" not in w else w["window_open"] * 1e9


def window(ctx, name):
    """The records named `name` that started at or after the window's
    opening, or None without records."""
    recs, t = records(ctx), _open_ns(ctx)
    if recs is None or t is None:
        return None
    return [r for r in recs if r.name == name and r.t0 >= t]


def host_ms(r):
    return (r.t1 - r.t0) / 1e6


def per_batch_ms(ctx, names, in_batch=True):
    """The host ms of the spans named in `names` over the window's device
    batches: those inside a batch of the window (in_batch), else every
    such span of the window; None without a batch."""
    batches = window(ctx, "engine.device_batch")
    if not batches:
        return None
    ids = {b.id for b in batches}
    total = 0.0
    for name in names:
        total += sum(host_ms(r) for r in window(ctx, name) if not in_batch or r.batch in ids)
    return total / len(batches)


def mean_device_ms(ctx, name):
    """The mean device ms of the window's device spans named `name`."""
    recs = [r for r in window(ctx, name) or () if r.device_ms is not None]
    return sum(r.device_ms for r in recs) / len(recs) if recs else None


def idle(ctx):
    """{top-level span name or UNSPANNED: idle seconds, and CAPTURE: the
    idle seconds under the feeding thread's graph captures (inside
    `engine.dispatch`)} and the window's seconds of the traced span: the
    device-idle gaps (kernels of the profile and the searches' own device
    spans busy) named by the feeding thread's span that holds each gap's
    midpoint (`trace.Span.reduce` on the program's spans).  Kept on ctx;
    None where there is nothing to read or the searches' stamps do not
    pair with the profile's stamp kernels."""
    if hasattr(ctx, "program_idle"):
        return ctx.program_idle
    ctx.program_idle = None
    span, recs = ctx.span, records(ctx)
    if recs is None or span is None or not ctx.profile or span.t_close is None:
        return None
    feed = {r.thread for r in recs if r.name == "engine.dispatch"}
    if len(feed) != 1:
        return None
    feed = feed.pop()
    lo, hi = span.t_open * 1e9, span.t_close * 1e9

    def of_feed(names, top):
        return [(r.name, r.t0 / 1e9, r.t1 / 1e9) for r in recs
                if r.thread == feed and r.name in names and (r.parent is None or not top)
                and r.t1 >= lo and r.t0 <= hi]

    searches = _searches(span, [r for r in recs if lo <= r.t0 and r.t1 <= hi])
    if searches is None:
        return None
    res = span.reduce(of_feed(FEED_TOP, True), searches)
    by_name = dict(res["idle_by_host"])
    by_name[CAPTURE] = span.reduce(of_feed((CAPTURE,), False), searches)[
        "idle_by_host"].get(CAPTURE, 0.0)
    ctx.program_idle = (by_name, res["window_s"])
    return ctx.program_idle


def _searches(span, inside):
    """The device intervals (ms after the span's opening, `trace.Span.bounds`) of the
    `search.launch` spans among `inside`, each from its start stamp's
    kernel to its end stamp's, or None where the stamps do not pair."""
    from torch.autograd import DeviceType

    kernels = [e for e in span.events if e.device_type == DeviceType.CUDA]
    ends = span.bounds(kernels)
    stamps = sorted((e for e in kernels if STAMP in e.name), key=lambda e: e.id)
    pairs = paired(inside, stamps)
    if pairs is None or ends is None:
        return None
    opening = ends[0]
    return [((pairs[r.id][0].time_range.start - opening) / 1e3,
             (pairs[r.id][1].time_range.end - opening) / 1e3)
            for r in inside if r.name == "search.launch" and r.id in pairs]


def paired(records, kernels):
    """{record id: (start kernel, end kernel)}: the device spans' stamps
    among `records`, in the order they were launched (their sequence
    numbers), matched to the profile's stamp kernels in theirs (`kernels`,
    by correlation id); None where the counts differ."""
    dev = [r for r in records if getattr(r, "stamps", None) is not None]
    seqs = sorted({s for r in dev for s in r.stamps})  # a chained span shares a stamp
    if len(seqs) != len(kernels):
        return None
    at = dict(zip(seqs, kernels))
    return {r.id: (at[r.stamps[0]], at[r.stamps[1]]) for r in dev}


def idle_share(ctx, name):
    """The share of the traced span's window the card sat idle while the
    feeding thread was in its top-level span `name` (UNSPANNED: in none;
    CAPTURE: in a graph capture, a part of `engine.dispatch`'s share)."""
    got = idle(ctx)
    if got is None or got[1] <= 0:
        return None
    by_name, window_s = got
    return by_name.get(name, 0.0) / window_s
