"""The port's kernels together: their launches' least time over their device
time, in percent (layer: CUDA kernels)."""
from benchmark.metrics import roofline


def read(ctx, suffix):
    return roofline(ctx)
