"""tsv.useful_rows: the items of the batches dispatched in the window (the
rows each resolve returned) over the rows those batches put on the card
(`dispatch_device_batch`'s batch sizes): the share of device rows that are
not padding."""


def read(ctx):
    w = ctx.window
    if "deadline" not in w:
        return None
    inside = [b for b in ctx.batches if w["window_open"] <= b["t"] <= w["deadline"]]
    if not inside or any(b["real"] is None for b in inside):
        return None
    return sum(b["real"] for b in inside) / sum(b["rows"] for b in inside)
