"""ms a tick of the card's timeline outside the program's graph replays
(layer: device): from one tick's first replay to the next tick's, less the
tick's replays on the card (``graph.start`` to ``graph.end`` of each), mean
over the untraced stretch's ticks (``benchmark/spans.py``): the eager work
between replays (the program's events, the benchmark's plant) and the
card's idle time.  None without the program's records."""
from benchmark import spans


def read(ctx, suffix):
    reps = spans.window(spans.program_records(), ctx)
    g = max(1, len(ctx.groups))
    ticks = [reps[i:i + g] for i in range(0, len(reps) - g + 1, g)]
    if len(ticks) < 2:
        return None
    outside = [nxt[0].device[0] - tick[0].device[0]
               - sum(r.device[1] - r.device[0] for r in tick)
               for tick, nxt in zip(ticks, ticks[1:])]
    return 1e-6 * sum(outside) / len(outside)
