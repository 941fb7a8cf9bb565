"""textual.prefill_ms: device milliseconds of `prefill` a batch (CUDA events
around each call), the mean over the window."""


def read(ctx):
    ms = (ctx.span_ms or {}).get("prefill")
    return sum(ms) / len(ms) if ms else None
