"""engine.host_cast_ms: host ms of `engine.host_cast` (a float batch cast
to the engine's dtype on the host) a device batch of the window."""

from gitbench import program_spans as P


def read(ctx):
    return P.per_batch_ms(ctx, ["engine.host_cast"])
