"""The readers of the program's own records (``benchmark/spans.py`` and the
metrics that read it) on planted records, and the records put on a
profiler trace's clock by its ``trace_mark`` kernels."""
from __future__ import annotations

import json

import pytest

from benchmark import harness, run, spans
from benchmark.metrics import Context
from benchmark.trace import read_chrome_trace
from nmpc_nav_control_tpu_torch.utils.telemetry import Mark, Records, Span

# A planted replay on the card (ns after its host span starts): the whole
# graph 115, tick 100 of it, controller 70 of that, QP 40 of that.
PHASES = {"graph.start": 5, "tick.start": 10, "ctl.start": 30, "qp.start": 50, "qp.end": 90,
          "ctl.end": 100, "tick.end": 110, "graph.end": 120}
PERIOD = 1000                 # ns from one tick to the next
NEW = ("nav_ms_per_tick", "linearize_ms_per_tick", "qp_ms_per_tick", "host_ms_per_cycle",
       "outside_graphs_ms_per_tick", "capture_s")


def _records(groups: int, ticks: int, node: bool = False, phases=PHASES) -> Records:
    """A capture of 400 ns, then ``ticks`` ticks of ``groups`` replays each
    (under a node.tick of 270 ns for ``node``), and the profiled ticks."""
    span_list, marks = [Span(0, "graph.capture", 0, 400, -1, 0, None)], []
    n, tick = 1, 0
    for k in range(ticks):
        t = 1000 + k * PERIOD
        parent = -1
        if node:
            tick += 1
            span_list.append(Span(n, "node.tick", t - 20, t + 250, -1, tick, None))
            parent, n = n, n + 1
        for g in range(groups):
            t_g = t + 200 * g
            if not node:
                tick += 1
            span_list.append(Span(n, "graph.replay", t_g, t_g + 150, parent, tick,
                                  {"device": "cuda:0"}))
            marks += [Mark(p, t_g + dt, tick, "cuda:0", n) for p, dt in phases.items()]
            n += 1
    marks.append(Mark("tick.start", 5, 0, "host", -1))   # a warm-up tick's host mark
    return Records(span_list, sorted(marks, key=lambda m: m.t), {})


def _ctx(groups: int, traced: int) -> Context:
    return Context(None, traced, {f"tick.g{i}": (None, 1) for i in range(groups)}, {}, {})


def _read(monkeypatch, recs, ctx, name, suffix="ticks"):
    monkeypatch.setattr(spans, "program_records", lambda: recs)
    return harness.reader(name).read(ctx, suffix)


def test_robot_cycle_metrics(monkeypatch):
    traced = 20
    recs, ctx = _records(1, 50 + run.SETTLE_TICKS + traced, node=True), _ctx(1, traced)
    assert len(spans.window(recs, ctx)) == 50
    got = {m: _read(monkeypatch, recs, ctx, m, "cycle") for m in NEW}
    assert got["nav_ms_per_tick"] == pytest.approx(30e-6)
    assert got["linearize_ms_per_tick"] == pytest.approx(30e-6)
    assert got["qp_ms_per_tick"] == pytest.approx(40e-6)
    assert got["host_ms_per_cycle"] == pytest.approx(155e-6)       # 270 - 115
    assert got["outside_graphs_ms_per_tick"] == pytest.approx(885e-6)
    assert got["capture_s"] == pytest.approx(400e-9)


def test_fleet_sums_a_tick_over_its_groups(monkeypatch):
    traced = 4
    recs, ctx = _records(3, 10 + run.SETTLE_TICKS + traced), _ctx(3, traced)
    assert len(spans.window(recs, ctx)) == 30
    assert _read(monkeypatch, recs, ctx, "nav_ms_per_tick.ticks") == pytest.approx(90e-6)
    assert _read(monkeypatch, recs, ctx, "qp_ms_per_tick.ticks") == pytest.approx(120e-6)
    # Each tick: 1000 ns from first replay to first replay, three replays of 115 ns.
    assert _read(monkeypatch, recs, ctx, "outside_graphs_ms_per_tick.ticks") == pytest.approx(
        655e-6)
    assert _read(monkeypatch, recs, ctx, "host_ms_per_cycle.ticks") is None    # no node


def test_the_sweep_has_no_navigation_tick(monkeypatch):
    ctl_only = {p: t for p, t in PHASES.items() if not p.startswith("tick.")}
    recs, ctx = _records(1, 30, phases=ctl_only), _ctx(1, 5)
    assert _read(monkeypatch, recs, ctx, "nav_ms_per_tick.ticks") is None
    assert _read(monkeypatch, recs, ctx, "linearize_ms_per_tick.ticks") == pytest.approx(30e-6)
    assert _read(monkeypatch, recs, ctx, "outside_graphs_ms_per_tick.ticks") == pytest.approx(
        885e-6)
    # A graph without the graph.* pair: a replay on the card is its first to last mark.
    bare = {p: t for p, t in ctl_only.items() if not p.startswith("graph.")}
    recs = _records(1, 30, phases=bare)
    assert _read(monkeypatch, recs, ctx, "outside_graphs_ms_per_tick.ticks") == pytest.approx(
        930e-6)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(name, monkeypatch):
    # Only the profiled ticks after set-up: an empty window.
    recs, ctx = _records(1, run.SETTLE_TICKS + 20, node=True), _ctx(1, 20)
    if name != "capture_s":          # set-up's captures are read whatever the window
        assert _read(monkeypatch, recs, ctx, name, "cycle") is None
    # A program that records nothing (tracing off, or a program without it).
    assert _read(monkeypatch, None, ctx, name, "cycle") is None


def test_program_records_without_tracing_is_none():
    from nmpc_nav_control_tpu_torch.utils import telemetry

    telemetry.disable_tracing()
    telemetry.reset_records()
    assert spans.program_records() is None


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_records_on_the_profiler_clock_label_its_idle_gaps(tmp_path):
    # Host clock (ns) 4.99 s ahead of the trace's: host 5.0015 s is 11,500 us.
    tick = [Span(0, "node.tick", 5_000_000_000, 5_010_000_000, -1, 1, None),
            Span(1, "graph.replay", 5_001_000_000, 5_002_000_000, 0, 1, None),
            Span(2, "node.fetch", 5_003_000_000, 5_009_000_000, 0, 1, None)]
    marks = [Mark("tick.start", 5_001_500_000, 1, "cuda:0", 1),
             Mark("tick.end", 5_003_500_000, 1, "cuda:0", 1)]
    recs = Records(tick, marks, {})
    ev = [_event("user_annotation", "traced_window", 0, 20_000),
          _event("kernel", "trace_mark_kernel(long long*, unsigned long long*, int, unsigned "
                 "long long)", 11_500, 2),
          _event("kernel", "elementwise_kernel", 11_502, 1_996),
          _event("kernel", "trace_mark_kernel(long long*, unsigned long long*, int, unsigned "
                 "long long)", 13_500, 2)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    trace = read_chrome_trace(path)
    offset, residual = spans.align(trace, recs)
    assert offset == pytest.approx(-4.99) and residual == pytest.approx(0.0, abs=1e-9)
    gaps = dict(spans.idle_gaps_by_span(trace, recs))
    assert gaps == pytest.approx({"other": 0.0115, "node.fetch": 0.0065})
    # No marks in the trace (a program without them): nothing to align.
    path.write_text(json.dumps({"traceEvents": ev[:1] + ev[2:3]}))
    assert spans.idle_gaps_by_span(read_chrome_trace(path), recs) is None
