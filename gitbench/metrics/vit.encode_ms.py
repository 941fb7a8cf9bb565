"""vit.encode_ms: device milliseconds of `encode_images` a batch (CUDA
events around each call, chip_smoke.py's SearchSpans), the mean over the
window."""


def read(ctx):
    ms = (ctx.span_ms or {}).get("encode_images")
    return sum(ms) / len(ms) if ms else None
