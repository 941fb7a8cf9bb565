"""decode.chunk_ms_per_frame: host ms of the decode pool's `decode.chunk`
spans over the frames they decoded (their `frames`: a clip's kept frames,
one an image), those that ended in the window or after, on the pool's
threads; a clip's JSON read and its frames' stacking count with its
frames.  Nothing to read where the chunks carry no `frames`."""

from gitbench import program_spans as P


def read(ctx):
    recs, t = P.records(ctx), P._open_ns(ctx)
    if recs is None or t is None:
        return None
    chunks = [r for r in recs if r.name == "decode.chunk" and r.t1 >= t]
    if not chunks or any("frames" not in r.attrs for r in chunks):
        return None
    frames = sum(r.attrs["frames"] for r in chunks)
    return sum(P.host_ms(r) for r in chunks) / frames if frames else None
