"""The 99th percentile of the run's measured cycles, ms (layer: host node):
the tail of the same window whose median is ``cycle_ms_p50``, read from the
window's host clock.  Sporadic host stalls set it (10-45 ms cycles spread
over the window), so it spreads too widely between runs to carry a bound."""


def read(ctx, suffix):
    return ctx.window.get("cycle_ms_p99")
