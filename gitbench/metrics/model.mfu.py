"""model.mfu: the model FLOPs of the real items of the batches run in the
traced span (peaks.model_flops: from the config, each item's frames,
encoder tokens, prefix length and beam steps; padded rows do not count)
over the span's seconds times the H100's 989 TFLOP/s bf16 dense peak times
the cell's cards, in percent.  On a mesh the span's steps are rank 0's
(its own data shard's searches, settled), taken for every shard."""

from gitbench import peaks


def read(ctx):
    work = peaks.span_work(ctx)
    if not work or not ctx.profile:
        return None
    flops = 0.0
    for rows, real, s, tp, steps, frames in work:
        n = int(round(steps))
        flops += real * peaks.model_flops(ctx.cfg, s, tp, n, frames)
    chips = int(ctx.cell.get("chips", 1))
    return 100.0 * flops / (ctx.profile["window_s"] * peaks.BF16_FLOPS * chips)
