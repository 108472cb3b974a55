"""Device ms a tick of the navigation tick outside the controller: paths,
windowing and the state machine (layer: graphed tick), from the program's
own marks on the card over the untraced stretch (``benchmark/spans.py``):
(``tick.end`` - ``tick.start``) - (``ctl.end`` - ``ctl.start``) of each
replay, summed over a tick's groups, mean over ticks.  None without the
program's records or a navigation tick."""
from benchmark import spans


def read(ctx, suffix):
    def nav(r):
        tick, ctl = r.part("tick"), r.part("ctl")
        return None if tick is None or ctl is None else tick - ctl

    return spans.per_tick_ms(ctx, nav)
