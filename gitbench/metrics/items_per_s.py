"""items_per_s: items completed in the window over the window's seconds (an
image captioned, or an (image, question) pair answered), from its opening
to its close: every batch, pass boundary and stall in it."""


def read(ctx):
    w = ctx.window
    if "items" not in w or w["seconds"] <= 0 or not w["items"]:
        return None
    return w["items"] / w["seconds"]
