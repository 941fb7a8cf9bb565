"""search.device_ms_per_step: device ms of the window's `search.launch`
spans over the steps their own counters read (each search's bodies, from
its graph's device step counter, no settle); beside `search.ms_per_step`."""

from gitbench import program_spans as P


def read(ctx):
    recs = [r for r in P.window(ctx, "search.launch") or ()
            if r.device_ms is not None and "steps" in r.attrs]
    steps = sum(r.attrs["steps"] for r in recs)
    return sum(r.device_ms for r in recs) / steps if steps else None
