"""engine.real_row_share: the real rows over the rows of the device batches
that returned in the window (`engine.device_batch`'s `real` and `rows`: the
rest is padding), the program's own count beside `tsv.useful_rows`."""

from gitbench import program_spans as P


def read(ctx):
    recs, w = P.window(ctx, "engine.device_batch"), ctx.window
    if not recs:
        return None
    inside = [r for r in recs if r.t1 <= w["deadline"] * 1e9]
    rows = sum(r.attrs["rows"] for r in inside)
    return sum(r.attrs["real"] for r in inside) / rows if rows else None
