"""The device's idle share over the traced ticks (layer: device): 1 - the
seconds of the traced window in which some device op ran / the window's
seconds, ticks back to back.  Both from the traced stretch alone."""


def read(ctx, suffix):
    w = ctx.trace.window_s
    return 1.0 - ctx.trace.busy() / w if ctx.ticks and w > 0 else None
