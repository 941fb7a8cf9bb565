"""device.idle.assemble: the share of the traced span's window the card sat
idle while the feeding thread assembled batches (keys, the questions'
prefixes, buckets, the chunks' payloads read) (`tsv.assemble`): the idle
gaps of the profile, the searches' own device spans counted busy, whose
midpoint falls in that top-level span."""

from gitbench import program_spans as P


def read(ctx):
    return P.idle_share(ctx, "tsv.assemble")
