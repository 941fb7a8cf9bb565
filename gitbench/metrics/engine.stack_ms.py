"""engine.stack_ms: host ms of `engine.stack` (np.stack of a grid group's
arrays and its padding to the batch) over the window's device batches."""

from gitbench import program_spans as P


def read(ctx):
    return P.per_batch_ms(ctx, ["engine.stack"], in_batch=False)
