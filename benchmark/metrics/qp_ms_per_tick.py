"""Device ms a tick of the QP solve: the IPM driver and its kernels (layer:
IPM driver and kernels), from the program's own marks on the card over the
untraced stretch (``benchmark/spans.py``): ``qp.end`` - ``qp.start`` of
each replay, summed over a tick's groups, mean over ticks.  None without the
program's records."""
from benchmark import spans


def read(ctx, suffix):
    return spans.per_tick_ms(ctx, lambda r: r.part("qp"))
