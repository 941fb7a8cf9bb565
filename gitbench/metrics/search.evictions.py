"""search.evictions: the graphs the search's cache dropped in the window,
least recently used first (`search.evict` marks)."""

from gitbench import program_spans as P


def read(ctx):
    recs = P.window(ctx, "search.evict")
    return None if recs is None else len(recs)
