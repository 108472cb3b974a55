"""``ipm_kkt_fused``'s launches: least time over device time, in percent."""
from benchmark.metrics import roofline


def read(ctx, suffix):
    return roofline(ctx, "ipm_kkt_fused")
