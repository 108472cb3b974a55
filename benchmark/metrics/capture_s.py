"""Seconds of set-up in the program's graph captures (layer: graphed tick):
the sum of its ``graph.capture`` spans (the eager warm-up ticks, the
recording and the instantiation of each graph), read from the program's
records (``benchmark/spans.py``).  None without them."""
from benchmark import spans


def read(ctx, suffix):
    recs = spans.program_records()
    caps = [s.end - s.start for s in recs.spans if s.name == "graph.capture"] if recs else []
    return 1e-9 * sum(caps) if caps else None
