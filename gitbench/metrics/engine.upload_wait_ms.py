"""engine.upload_wait_ms: host ms of `engine.upload_wait` (the pinned ring
full: the host waits for the card to run the oldest copy) a device batch
of the window."""

from gitbench import program_spans as P


def read(ctx):
    return P.per_batch_ms(ctx, ["engine.upload_wait"])
