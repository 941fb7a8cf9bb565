"""setup_s: process start until the window opens (imports, the inputs and
weights made from the seed, the program built with its kernels loaded, the
warm-up of the traffic's shapes)."""


def read(ctx):
    return ctx.setup_s
