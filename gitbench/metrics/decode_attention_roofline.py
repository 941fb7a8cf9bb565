"""decode_attention_roofline: kernel 1's least time (peaks.decode_attention:
bytes over 3.35 TB/s or f32 FLOPs over 67 TFLOP/s, each call's live text
rows) summed over the calls the traced span's batches made on the traced
card (on a mesh rank 0's, its data shard's rows), over the device time of
the kernels named decode_attention in the span, in percent."""

from gitbench import peaks
from gitbench.peaks import kernel_device_s


def read(ctx):
    work = peaks.span_work(ctx, card=True)
    if not work or not ctx.profile:
        return None
    device = kernel_device_s(ctx, "decode_attention")
    if not device:
        return None
    least = 0.0
    for rows, real, s, tp, steps, frames in work:
        whole = int(steps)
        least += peaks.least_decode_attention_s(ctx.cfg, rows, s, tp, whole, frames)
        least += (steps - whole) * (peaks.least_decode_attention_s(
            ctx.cfg, rows, s, tp, whole + 1, frames) - peaks.least_decode_attention_s(
                ctx.cfg, rows, s, tp, whole, frames))
    return 100.0 * least / device
