"""Device ms a tick of the controller outside the QP solve: the initial
state, the reference, the linearization, the expansion and the command
(layer: graphed tick), from the program's own marks on the card over the
untraced stretch (``benchmark/spans.py``): (``ctl.end`` - ``ctl.start``) -
(``qp.end`` - ``qp.start``) of each replay, summed over a tick's groups,
mean over ticks.  None without the program's records."""
from benchmark import spans


def read(ctx, suffix):
    def linearize(r):
        ctl, qp = r.part("ctl"), r.part("qp")
        return None if ctl is None or qp is None else ctl - qp

    return spans.per_tick_ms(ctx, linearize)
