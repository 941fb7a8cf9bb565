"""device.idle.unspanned: the share of the traced span's window the card sat
idle while the feeding thread was in none of its top-level spans (pool
wait, assemble, dispatch, resolve, write): what the program's spans leave
unnamed."""

from gitbench import program_spans as P


def read(ctx):
    return P.idle_share(ctx, P.UNSPANNED)
