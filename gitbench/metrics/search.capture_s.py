"""search.capture_s: host seconds of the window's `search.capture` spans
(each a synchronising warm-up step and a capture)."""

from gitbench import program_spans as P


def read(ctx):
    recs = P.window(ctx, "search.capture")
    return None if recs is None else sum(P.host_ms(r) for r in recs) / 1e3
