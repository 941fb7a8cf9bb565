"""decode.chunk_ms_per_row: host ms of the decode pool's `decode.chunk` spans
over the rows they decoded, those that ended in the window or after, on
the pool's threads; beside `decode.host_ms_per_image`."""

from gitbench import program_spans as P


def read(ctx):
    recs, t = P.records(ctx), P._open_ns(ctx)
    if recs is None or t is None:
        return None
    chunks = [r for r in recs if r.name == "decode.chunk" and r.t1 >= t]
    rows = sum(r.attrs["rows"] for r in chunks)
    return sum(P.host_ms(r) for r in chunks) / rows if rows else None
