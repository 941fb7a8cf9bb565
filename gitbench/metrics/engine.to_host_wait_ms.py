"""engine.to_host_wait_ms: host ms of `engine.to_host` (the sequences read
back, the host's wait for the card) over the window's device batches."""

from gitbench import program_spans as P


def read(ctx):
    return P.per_batch_ms(ctx, ["engine.to_host"], in_batch=False)
