"""search.ms_per_step: the searches' device time (the `generate` span less
`encode_images` and `prefill`, chip_smoke.py's SearchSpans.loop_ms) over
the beam steps run in the window (GitModel.decode_step_calls after
device_loop.settle(), replayed steps included)."""


def read(ctx):
    t = ctx.span_ms or {}
    if not t.get("generate") or not ctx.steps:
        return None
    loop = sum(t["generate"]) - sum(t.get("encode_images", [])) - sum(t.get("prefill", []))
    return loop / ctx.steps
