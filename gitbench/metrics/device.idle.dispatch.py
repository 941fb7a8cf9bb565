"""device.idle.dispatch: the share of the traced span's window the card sat
idle while the feeding thread dispatched (grid groups, the stack, each
device batch's cast, upload and enqueue) (`engine.dispatch`): the idle gaps
of the profile, the searches' own device spans counted busy, whose midpoint
falls in that top-level span."""

from gitbench import program_spans as P


def read(ctx):
    return P.idle_share(ctx, "engine.dispatch")
