"""flash_prefill_roofline: kernel 2's least time in the prefill
(`peaks.flash_prefill`: FLOPs over 989 TFLOP/s bf16 or bytes over 3.35 TB/s)
for the prefills of the traced span's batches on the traced card, each
over [frames x S memory; Tp text] with the decoder's heads, one call a
decoder layer, over the device time of the kernels named flash_attention
in the span, in percent.  Read only where every kernel-2 launch is a
prefill's: the `model.encode` spans of the traced span show S =
tokens / frames below 640, where the encoder stays off kernel 2, and the
port's own launch counter reads one launch a decoder layer a batch.
Nothing to read otherwise."""

from gitbench import peaks
from gitbench import program_spans as P
from gitbench.peaks import kernel_device_s

ENCODER_FLASH_S = 640  # the encoder takes kernel 2 from S = 640 (the port's auto rule)


def read(ctx):
    work = peaks.span_work(ctx, card=True)
    if not work or not ctx.profile:
        return None
    recs, span = P.records(ctx), ctx.span
    if recs is None:
        return None
    lo, hi = span.t_open * 1e9, span.t_close * 1e9
    encodes = [r for r in recs if r.name == "model.encode" and lo <= r.t0 <= hi]
    if not encodes or any("frames" not in r.attrs
                          or r.attrs["tokens"] // r.attrs["frames"] >= ENCODER_FLASH_S
                          for r in encodes):
        return None
    layers = ctx.cfg["num_layers"]
    if (span.launched or {}).get("flash_attention") != layers * len(work):
        return None
    device = kernel_device_s(ctx, "flash_attention")
    if not device:
        return None
    h = ctx.cfg["num_heads"]
    dh = ctx.cfg["hidden_size"] // h
    least = sum(peaks.least_s(*peaks.flash_prefill(rows, h, frames * s, tp, dh),
                              peaks.BF16_FLOPS)
                for rows, _, s, tp, _, frames in work)
    return 100.0 * least * layers / device
