"""device.idle.tsv: 1 - the union of the kernels' intervals (torch.profiler)
over the traced span of a TSV cell."""


def read(ctx):
    p = ctx.profile
    if not p or p["window_s"] <= 0:
        return None
    return 1.0 - p["busy_s"] / p["window_s"]
