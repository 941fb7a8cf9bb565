"""flash_attention_roofline: kernel 2's least time (peaks.flash_encoder and
peaks.flash_prefill: FLOPs over 989 TFLOP/s bf16 or bytes over 3.35 TB/s)
for the encoder's and the prefill's calls of the traced span's batches on
the traced card (on a mesh rank 0's data shard), over the device time of
the kernels named flash_attention in the span, in percent.  Nothing to
read where the kernel does not run (S=257)."""

from gitbench import peaks
from gitbench.peaks import kernel_device_s


def read(ctx):
    work = peaks.span_work(ctx, card=True)
    if not work or not ctx.profile:
        return None
    device = kernel_device_s(ctx, "flash_attention")
    if not device:
        return None
    least = sum(peaks.least_flash_s(ctx.cfg, rows, s, tp, frames)
                for rows, _, s, tp, _, frames in work)
    return 100.0 * least / device
