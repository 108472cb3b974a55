"""The program's own records of a run: its spans and tick phases.

With its tracing on (``telemetry.enable_tracing()`` in
``nmpc_nav_control_tpu_torch/utils/telemetry.py``, before the program's
objects are built), the program records host spans (``node.tick``,
``graph.replay``, ``fleet.tick``, ``graph.capture``, ...) and the phases of
each graphed tick, marked on the card at every replay (``tick.start`` /
``tick.end`` around ``node_tick``, ``ctl.*`` around ``controller_step``,
``qp.*`` around the QP solve, ``graph.*`` around the whole captured body),
all on its host clock; ``telemetry.records()``
reads them back.  A program without tracing, or a run that did not turn it
on, gives no records, and every function here then returns None.

``window`` takes from the records the replays of the run's untraced
stretch: those after the last ``graph.capture`` span (set-up) and before the
profiled ticks (``run.SETTLE_TICKS`` settling ticks and ``ctx.ticks`` traced
ticks, one replay a group each, the last of the run).  That is the warm-up
ticks after the captures and the measured window; the profiler's own cost
on the host is kept out.

``idle_gaps_by_span`` puts the records on the profiler's clock: it matches
the ``trace_mark`` kernels of the traced stretch, in order, to the last card
marks of the records, and labels each idle gap of the trace by the program
span open where the gap starts.
"""
from __future__ import annotations

import collections
import statistics

from benchmark import run

MARK_KERNEL = "trace_mark"


def program_records():
    """The program's records, or None where it records nothing."""
    try:
        from nmpc_nav_control_tpu_torch.utils import telemetry
    except ImportError:
        return None
    read = getattr(telemetry, "records", None)
    recs = read() if read is not None else None
    return recs if recs is not None and recs.spans else None


class Replay:
    """One graph replay of the window: its host span and its phases."""

    def __init__(self, span, phases: dict):
        self.span, self.phases = span, phases          # {phase: host ns}

    @property
    def device(self) -> tuple:
        """(``graph.start``, ``graph.end``): the whole replay on the card's
        timeline (its first and last mark where the graph lacks the pair)."""
        a, b = self.phases.get("graph.start"), self.phases.get("graph.end")
        if a is None or b is None:
            return min(self.phases.values()), max(self.phases.values())
        return a, b

    def part(self, name: str):
        """ns between ``<name>.start`` and ``<name>.end``; None unmarked."""
        a, b = self.phases.get(name + ".start"), self.phases.get(name + ".end")
        return None if a is None or b is None else b - a


def window(recs, ctx) -> list:
    """[Replay] of the untraced stretch, in order (replays with card marks)."""
    if recs is None:
        return []
    phases = collections.defaultdict(dict)
    for m in recs.marks:
        if m.replay >= 0:
            phases[m.replay][m.phase] = m.t
    set_up = max((s.end for s in recs.spans if s.name == "graph.capture"), default=0)
    reps = [Replay(s, phases[s.id]) for s in recs.spans
            if s.name == "graph.replay" and s.start > set_up and phases.get(s.id)]
    profiled = (run.SETTLE_TICKS + ctx.ticks) * max(1, len(ctx.groups))
    return reps[:-profiled] if len(reps) > profiled else []


def per_tick_ms(ctx, parts) -> float | None:
    """ms a tick of ``parts(replay)`` (ns, None where a replay lacks the
    marks) summed over the window's replays; a tick is one replay a group."""
    reps = window(program_records(), ctx)
    values = [parts(r) for r in reps]
    if not values or any(v is None for v in values):
        return None
    ticks = len(reps) / max(1, len(ctx.groups))
    return 1e-6 * sum(values) / ticks


def align(trace, recs):
    """(offset s, widest residual s): the profiler's clock minus the
    program's, from the traced stretch's ``trace_mark`` kernels matched in
    order to the records' last card marks; None where either has none."""
    ops = [op for op in trace.ops if MARK_KERNEL in op.name]
    marks = [m for m in recs.marks if m.replay >= 0] if recs is not None else []
    if not ops or len(marks) < len(ops):
        return None
    pairs = list(zip(ops, marks[-len(ops):]))
    offset = statistics.median(op.start - 1e-9 * m.t for op, m in pairs)
    return offset, max(abs(op.start - 1e-9 * m.t - offset) for op, m in pairs)


def idle_gaps_by_span(trace, recs=None):
    """The traced stretch's idle gaps, by the innermost program span open
    where each starts ("other" where none is): the ten largest [label, s];
    None without records or marks."""
    recs = program_records() if recs is None else recs
    aligned = align(trace, recs)
    if aligned is None:
        return None
    from nmpc_nav_control_tpu_torch.utils.telemetry import SpanIndex

    offset, index, by = aligned[0], SpanIndex(recs.spans), {}
    for a, b in trace.gaps():
        span = index.innermost(round(1e9 * (a - offset)))
        label = "other" if span is None else span.name
        by[label] = by.get(label, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:10]]
