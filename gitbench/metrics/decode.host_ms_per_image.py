"""decode.host_ms_per_image: host milliseconds of the engine's decode pool
(JPEG decode and the transform) over the rows it decoded in the window, on
the pool's threads."""


def read(ctx):
    chunks = ctx.hooks.chunks
    rows = sum(n for _, n in chunks)
    if not rows:
        return None
    return sum(ms for ms, _ in chunks) / rows
