"""``ipm_bwd_corr``'s launches: least time over device time, in percent."""
from benchmark.metrics import roofline


def read(ctx, suffix):
    return roofline(ctx, "ipm_bwd_corr")
