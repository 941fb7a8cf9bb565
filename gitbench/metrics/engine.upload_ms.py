"""engine.upload_ms: host ms of `engine.upload` (the images and prefixes
through the pinned ring, its waits included) a device batch of the
window."""

from gitbench import program_spans as P


def read(ctx):
    return P.per_batch_ms(ctx, ["engine.upload"])
