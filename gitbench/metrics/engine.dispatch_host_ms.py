"""engine.dispatch_host_ms: host milliseconds a `dispatch_device_batch` call
takes to return (the upload and the encoder, prefill and search enqueued),
the mean over the window's calls."""


def read(ctx):
    ms = ctx.hooks.dispatch_ms
    return sum(ms) / len(ms) if ms else None
