"""engine.device_batch_host_ms: host ms of `engine.device_batch` (one
`dispatch_device_batch`: cast, upload, the encoder and prefill enqueued,
graph captures, the search launched), the mean over the window's device
batches; beside `engine.dispatch_host_ms`."""

from gitbench import program_spans as P


def read(ctx):
    recs = P.window(ctx, "engine.device_batch")
    return sum(P.host_ms(r) for r in recs) / len(recs) if recs else None
