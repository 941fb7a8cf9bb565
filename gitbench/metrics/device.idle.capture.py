"""device.idle.capture: the share of the traced span's window the card sat
idle while the feeding thread captured a search graph (`search.capture`:
the warm-up step, the capture, an eviction's release), a part of
`device.idle.dispatch`: the idle gaps of the profile, the searches' own
device spans counted busy, whose midpoint falls in such a span."""

from gitbench import program_spans as P


def read(ctx):
    return P.idle_share(ctx, P.CAPTURE)
