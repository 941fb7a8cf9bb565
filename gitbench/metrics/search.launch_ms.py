"""search.launch_ms: host ms of `search.launch` (the search's state copied
into its graph's, the predicate, the replays and the result enqueued) a
device batch of the window."""

from gitbench import program_spans as P


def read(ctx):
    return P.per_batch_ms(ctx, ["search.launch"])
