"""search.captures: the search graphs captured in the window (`search.capture`
spans: a warm-up step and a capture each, on a key the graph cache missed)."""

from gitbench import program_spans as P


def read(ctx):
    recs = P.window(ctx, "search.capture")
    return None if recs is None else len(recs)
