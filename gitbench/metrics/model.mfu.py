"""model.mfu: the model FLOPs of the real items of the batches run in the
traced span (peaks.model_flops: from the config, each item's encoder
tokens, prefix length and beam steps; padded rows do not count) over the
span's seconds times the H100's 989 TFLOP/s bf16 dense peak, in percent."""

from gitbench import peaks


def read(ctx):
    work = peaks.span_work(ctx)
    if not work or not ctx.profile:
        return None
    flops = 0.0
    for rows, real, s, tp, steps in work:
        n = int(round(steps))
        flops += real * peaks.model_flops(ctx.cfg, s, tp, n)
    return 100.0 * flops / (ctx.profile["window_s"] * peaks.BF16_FLOPS)
