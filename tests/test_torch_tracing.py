"""The port's tracing (``utils/telemetry.py``): host spans, the tick's phase
marks, the card's ring of marks and its clock, and what reads them.

CPU:
- with tracing off a node tick records nothing and ``span`` is one shared
  no-op; ``timing_stats()`` reads the same in both modes, and the
  ``node.tick`` span is the node's own cycle time, to the nanosecond;
- spans nest: ``node.tick`` holds ``node.upload``, ``node.replay``,
  ``node.fetch`` and ``node.decode``, one tick id a cycle; the fleet's
  ``fleet.tick`` holds a ``fleet.group`` a group; events are spans;
- an eager CPU ``node_tick`` and ``controller_step`` mark, on the host
  clock, ``tick.start <= ctl.start <= qp.start <= qp.end <= ctl.end <=
  tick.end``, one tick id each;
- the card's ring, with the mark kernel played by a host function on CPU
  tensors and a graph by replaying what its capture enqueued: each replay's
  marks come back tied to its ``graph.replay`` span and tick, on the host
  clock within the calibration's uncertainty, and ``outside_graphs_by_span``
  labels the stretches between replays; the card's ring and the span ring
  wrap and keep the newest entries, and ``outside_graphs_by_span`` labels
  planted records;
- ``export_tick`` with tracing on exports no mark;
- ``run --spans`` writes a Chrome trace of spans and phases and prints the
  card's time outside the graphs; the node builds its per-cycle debug
  records only where their channel is on.

``gpu`` (skip without a card; run with ``--noconftest`` where JAX is not
installed):
- a capture with tracing off holds no mark: the launches are one tick's
  kernels and the graph has the node count of a capture with tracing on less
  its marks; with tracing on the captured graph writes its marks at every
  replay, ``graph.start`` and ``graph.end`` around the rest;
- the calibration's uncertainty is reported and under 50 us;
- the graphed robot's phases sum, a tick, to within 10% of the device time
  ``torch.profiler`` reads for replays of the same graph on the same
  inputs, and so does the whole graph's span, which holds them.
"""
import json
import logging
import statistics
import time

import pytest
import torch

from nmpc_nav_control_tpu_torch import __main__ as cli
from nmpc_nav_control_tpu_torch.control import make_controller
from nmpc_nav_control_tpu_torch.control import state_machine as sm
from nmpc_nav_control_tpu_torch.control.controllers import controller_init, controller_step
from nmpc_nav_control_tpu_torch.ops import trace_mark
from nmpc_nav_control_tpu_torch.parallel.fleet import Fleet, FleetGroup
from nmpc_nav_control_tpu_torch.runtime import aot
from nmpc_nav_control_tpu_torch.runtime import node as node_mod
from nmpc_nav_control_tpu_torch.runtime.config import from_dict
from nmpc_nav_control_tpu_torch.runtime.messages import PoseStamped
from nmpc_nav_control_tpu_torch.runtime.node import NmpcNavControlNode
from nmpc_nav_control_tpu_torch.utils import telemetry

torch.set_num_threads(1)

RAW = {
    "steering_geometry": "diff",
    "control_freq": 40,
    "tf_ini": 0.25,                   # N = 10
    "rob_dist_between_wh": 0.27,
    "rob_wh_vel_time_const": 0.1,
    "rob_wh_max_vel": 1.0,
    "rob_wh_max_ace": 2.0,
    "cost_matrix_weights_state_diag": [10.0, 10.0, 5.0, 0, 0, 0, 0],
    "cost_matrix_weights_input_diag": [1.0, 1.0],
    "final_position_error": 0.03,
    "final_orientation_error": 3.0,
}
ORDER = ("tick.start", "ctl.start", "qp.start", "qp.end", "ctl.end", "tick.end")
PER_TICK = {"ipm_bwd_fused": 8, "ipm_fwd_affine": 8, "ipm_bwd_corr": 8, "ipm_fwd_corr": 8,
            "ipm_kkt_fused": 1}


@pytest.fixture
def tracing():
    telemetry.enable_tracing()
    telemetry.reset_records()
    yield telemetry
    telemetry.disable_tracing()
    telemetry.reset_records()


def _node(device="cpu", raw=RAW):
    node = NmpcNavControlNode(from_dict(raw), device=device)
    node.on_pose_goal(PoseStamped(frame_id="map", x=1.0, y=0.0, theta=0.0))
    return node


def _tick(node, k=0):
    return node.tick((0.01 * k, 0.0, 0.0), (0.0, 0.0, 0.0))


# --------------------------------------------------------------------------- #
# CPU
# --------------------------------------------------------------------------- #


def test_off_records_nothing_and_span_is_one_no_op():
    telemetry.disable_tracing()
    node = _node()
    telemetry.reset_records()
    _tick(node)
    recs = telemetry.records()
    assert recs.spans == [] and recs.marks == []
    assert telemetry.span("a") is telemetry.span("b", k=1) is telemetry._NO_SPAN
    assert telemetry.begin("node.tick") is None
    with telemetry.span("x"):
        telemetry.mark("tick.start", torch.zeros(1))
    assert telemetry.records().spans == []


def test_timing_stats_read_alike_and_the_tick_span_is_the_cycle_time(tracing):
    stats = {}
    for on in (False, True):
        (telemetry.enable_tracing if on else telemetry.disable_tracing)()
        node = _node()
        for k in range(3):
            _tick(node, k)
        stats[on] = node.timing_stats()
        if on:
            ticks = [s for s in telemetry.records().spans if s.name == "node.tick"]
            assert [(s.end - s.start) * 1e-9 for s in ticks] == list(node._cycle_times)
    assert stats[False].keys() == stats[True].keys()
    assert stats[False]["cycles"] == stats[True]["cycles"] == 3
    assert stats[False]["budget_ms"] == stats[True]["budget_ms"] == 25.0


def test_spans_nest_with_one_tick_id_a_cycle(tracing):
    node = _node()
    telemetry.reset_records()
    for k in range(2):
        _tick(node, k)
    spans = telemetry.records().spans
    ticks = [s for s in spans if s.name == "node.tick"]
    assert len(ticks) == 2 and ticks[0].tick != ticks[1].tick and all(s.tick for s in ticks)
    assert all(s.parent == -1 for s in ticks)
    for t in ticks:
        kids = [s for s in spans if s.parent == t.id]
        assert [s.name for s in kids] == ["node.upload", "node.replay", "node.fetch",
                                          "node.decode"]
        assert all(s.tick == t.tick and t.start <= s.start <= s.end <= t.end for s in kids)
    # Outside a tick a span has no tick; graph.replay opens one, and spans
    # opened inside another tick take its id.
    with telemetry.span("outer") as outer:
        with telemetry.span("graph.replay", graph=7) as rep:
            with telemetry.span("inner"):
                pass
    spans = {s.name: s for s in telemetry.records().spans}
    assert spans["outer"].tick == 0 and spans["graph.replay"].tick > ticks[1].tick
    assert spans["inner"].tick == spans["graph.replay"].tick
    assert spans["inner"].parent == rep.id and spans["graph.replay"].parent == outer.id
    assert spans["graph.replay"].fields == {"graph": 7}


def test_fleet_and_event_spans(tracing):
    raw = dict(RAW, path_capacity=8)
    conf = from_dict(raw)
    spec, data = make_controller("diff", conf.dt, conf.horizon, dtype=torch.float32,
                                 device="cpu", **conf.controller_kwargs())
    fleet = Fleet({"a": FleetGroup(spec, data, conf.nav, 2), "b": FleetGroup(spec, data,
                                                                              conf.nav, 3)})
    goal = torch.tensor([[1.0, 0.0, 0.0]])
    for name in ("a", "b"):
        fleet.set_states(name, sm.on_goal_pose(fleet.states[name], goal))

    def meas(B):
        z, ok = torch.zeros(B, 3), torch.ones(B, dtype=torch.bool)
        return sm.Measurements(z, z.clone(), z[:, 0].clone(), ok, ok.clone(), ok.clone())

    fleet.tick({"a": meas(2), "b": meas(3)})
    spans = telemetry.records().spans
    names = [s.name for s in spans]
    assert names.count("nav.on_goal") == 2 and names.count("nav.load_state") == 2
    (tick,) = [s for s in spans if s.name == "fleet.tick"]
    groups = [s for s in spans if s.name == "fleet.group"]
    assert [g.fields for g in groups] == [{"group": "a"}, {"group": "b"}]
    assert all(g.parent == tick.id and g.tick == tick.tick > 0 for g in groups)
    marks = telemetry.records().marks
    assert [m.phase for m in marks if m.tick == tick.tick] == list(ORDER) * 2


def test_eager_ticks_mark_their_phases_in_order_on_the_host_clock(tracing):
    node = _node()
    telemetry.reset_records()
    for k in range(2):
        _tick(node, k)
    recs = telemetry.records()
    by_tick = {}
    for m in recs.marks:
        assert m.device == "host" and m.replay == -1
        by_tick.setdefault(m.tick, []).append(m)
    assert len(by_tick) == 2 and all(by_tick)
    for tick, marks in by_tick.items():
        assert [m.phase for m in marks] == list(ORDER)
        assert all(a.t <= b.t for a, b in zip(marks, marks[1:]))
        (span,) = [s for s in recs.spans if s.name == "node.tick" and s.tick == tick]
        assert span.start <= marks[0].t and marks[-1].t <= span.end
    # controller_step alone marks the controller's and the QP's phases.
    conf = from_dict(RAW)
    spec, data = make_controller("diff", conf.dt, conf.horizon, dtype=torch.float32,
                                 device="cpu", **conf.controller_kwargs())
    telemetry.reset_records()
    with telemetry.span("fleet.tick") as t:
        controller_step(spec, data, controller_init(spec, 2, torch.float32, "cpu"),
                        torch.zeros(2, 3), torch.zeros(2, 3), torch.zeros(2, conf.horizon + 1, 3),
                        torch.ones(2, dtype=torch.long))
    marks = telemetry.records().marks
    assert [m.phase for m in marks] == list(ORDER[1:-1])
    tick = next(s.tick for s in telemetry.records().spans if s.id == t.id)
    assert {m.tick for m in marks} == {tick}


class _FakeCard:
    """The mark kernel played on CPU tensors by the host, its clock 7 s
    ahead of the host's; a "graph" is what a capture enqueued, and a replay
    enqueues it again."""

    AHEAD = 7_000_000_000

    def __init__(self):
        self.enqueued = None

    def mark(self, ring, cursor, code):
        if self.enqueued is not None:          # capturing: recorded, not run
            self.enqueued.append((ring, cursor, code))
            return
        at = int(cursor[0]) % ring.shape[0]
        ring[at, 0], ring[at, 1] = code, time.perf_counter_ns() + self.AHEAD
        cursor[0] += 1


def test_card_marks_tie_to_their_replays_on_the_host_clock(tracing, monkeypatch):
    card = _FakeCard()
    monkeypatch.setattr(trace_mark, "mark", card.mark)
    monkeypatch.setattr(telemetry._tracer, "rings", {})     # the fake card's ring stays here
    conf = from_dict(RAW)
    spec, data = make_controller("diff", conf.dt, conf.horizon, dtype=torch.float32,
                                 device="cpu", **conf.controller_kwargs())
    state = sm.node_init(spec, conf.nav, 1, torch.float32, "cpu")
    z, ok = torch.zeros(1, 3), torch.ones(1, dtype=torch.bool)
    meas = sm.Measurements(z, z.clone(), z[:, 0].clone(), ok, ok.clone(), ok.clone())
    with telemetry.recording("cpu") as marks:
        card.enqueued = []
        sm.node_tick(spec, data, conf.nav, state, meas)
        graph, card.enqueued = card.enqueued, None
    assert marks.count == len(ORDER) == len(graph)
    for k in range(3):
        with telemetry.span("node.tick"):
            with telemetry.replay(marks):
                for args in graph:
                    card.mark(*args)
            time.sleep(0.002)
    recs = telemetry.records()
    (clock,) = recs.clocks["cpu"][-1:]
    assert 0 < clock.uncertainty_ns < 5_000_000
    assert abs(clock.device_ns - clock.host_ns - card.AHEAD) <= clock.uncertainty_ns
    replays = [s for s in recs.spans if s.name == "graph.replay"]
    assert len(replays) == 3 and [m.phase for m in recs.marks] == list(ORDER) * 3
    slack = 2 * max(c.uncertainty_ns for c in recs.clocks["cpu"])
    for rep in replays:
        mine = [m for m in recs.marks if m.replay == rep.id]
        assert [m.phase for m in mine] == list(ORDER)
        assert all(m.tick == rep.tick > 0 and m.device == "cpu" for m in mine)
        assert rep.start - slack <= mine[0].t and mine[-1].t <= rep.end + slack
        assert rep.fields["marks"] == len(ORDER)
    outside = telemetry.outside_graphs_by_span(recs)
    assert set(outside) <= {"graph.replay", "node.tick"} and sum(outside.values()) > 0.004
    # Marks from replays with tracing off are counted, not recorded.
    telemetry.disable_tracing()
    with telemetry.replay(marks):
        for args in graph:
            card.mark(*args)
    telemetry.enable_tracing()
    assert len(telemetry.records().marks) == 3 * len(ORDER)


def test_the_card_ring_wraps_and_keeps_the_newest_marks(tracing, monkeypatch):
    card = _FakeCard()
    monkeypatch.setattr(trace_mark, "mark", card.mark)
    monkeypatch.setattr(telemetry._tracer, "rings", {})
    monkeypatch.setattr(telemetry, "RING", 64)
    like = torch.zeros(1)
    with telemetry.recording("cpu") as marks:       # 20 calibration marks: 0-19
        card.enqueued = []
        for phase in ORDER:
            telemetry.mark(phase, like)
        graph, card.enqueued = card.enqueued, None
    for _ in range(10):                               # marks 20-79
        with telemetry.replay(marks):
            for args in graph:
                card.mark(*args)
    recs = telemetry.records()                        # 20 more calibration marks: 80-99
    # The ring holds marks 36-99: the replays' last 44, the first two of them
    # the end of the third replay.
    assert len(recs.marks) == 44
    assert [m.phase for m in recs.marks[:2]] == list(ORDER[-2:])
    replays = sorted({m.replay for m in recs.marks})
    assert len(replays) == 8 and all(
        [m.phase for m in recs.marks if m.replay == r] == list(ORDER) for r in replays[1:])


def test_export_with_tracing_on_holds_no_mark(tracing):
    blob = aot.export_tick(from_dict(RAW), platforms=("cpu",))
    assert b"trace_mark" not in blob
    assert telemetry.records().marks == []
    tick = aot.load_tick(blob, device="cpu")
    assert "trace_mark" not in str(tick.program.graph)


def test_run_writes_spans_as_a_chrome_trace(tmp_path, capsys):
    conf = tmp_path / "diff.yaml"
    conf.write_text("\n".join(f"{k}: {json.dumps(v)}" for k, v in RAW.items()))
    out = tmp_path / "spans.json"
    try:
        rc = cli.main(["run", "--config", str(conf), "--goal", "1.0", "0.0", "0.0", "--ticks",
                       "3", "--device", "cpu", "--no-rt", "--spans", str(out)])
    finally:
        telemetry.disable_tracing()
        telemetry.reset_records()
    printed = capsys.readouterr().out
    assert rc == 0 and f"-> {out}" in printed
    assert "card time outside the graph replays (s, by host span): {}" in printed   # no card
    events = json.loads(out.read_text())["traceEvents"]
    names = [e["name"] for e in events if e["ph"] == "X"]
    for name in ("node.tick", "node.upload", "node.replay", "node.fetch", "node.decode",
                 "nav.on_goal"):
        assert name in names
    assert names.count("tick") == names.count("ctl") == names.count("qp") == 3


class _Recorder:
    """A channel that records its debug events."""

    def __init__(self, channel, calls):
        self.isEnabledFor, self.calls = channel.isEnabledFor, calls

    def debug(self, event, **fields):
        self.calls.append((event, fields))


def test_debug_records_are_built_only_where_their_channel_is_on(monkeypatch):
    calls = []
    for name in ("_log_cycle", "_log_solver"):
        monkeypatch.setattr(node_mod, name, _Recorder(getattr(node_mod, name), calls))
    node = _node()
    telemetry.configure(level=logging.INFO, force=True)
    _tick(node)
    assert calls == []
    telemetry.configure(level=logging.DEBUG, force=True)
    try:
        _tick(node)
    finally:
        telemetry.configure(level=logging.INFO, force=True)
    assert [c[0] for c in calls] == ["tick", "solve"]
    assert set(calls[0][1]) == {"cycle_ms", "budget_ms"}


class TestPortTracing:
    """The tracing switch, the span ring and the idle attribution on their
    own."""

    def test_off_span_is_one_shared_no_op(self):
        telemetry.disable_tracing()
        assert telemetry.span("a") is telemetry.span("b", group="x") is telemetry._NO_SPAN
        assert telemetry.begin("node.tick") is None and telemetry.end(None) is None

    def test_the_span_ring_keeps_the_newest(self, monkeypatch):
        tracer = telemetry._Tracer(capacity=8)
        monkeypatch.setattr(telemetry, "_tracer", tracer)
        monkeypatch.setattr(telemetry, "_on", True)
        for k in range(20):
            with telemetry.span(f"s{k}"):
                telemetry.mark("p", torch.zeros(1))
        spans = telemetry.records().spans
        assert [s.name for s in spans] == [f"s{k}" for k in range(12, 20)]
        assert [s.id for s in spans] == list(range(12, 20))
        assert len(telemetry.records().marks) == 8
        # One span open across the wrap is dropped, not given another's times.
        token = telemetry.begin("long")
        for k in range(8):
            with telemetry.span(f"t{k}"):
                pass
        telemetry.end(token)
        assert "long" not in [s.name for s in telemetry.records().spans]

    def test_outside_graphs_by_span_on_planted_records(self):
        S, M = telemetry.Span, telemetry.Mark
        spans = [S(0, "fleet.tick", 0, 52, -1, 1, None), S(1, "graph.replay", 10, 20, 0, 1, None),
                 S(2, "events", 30, 40, 0, 1, None), S(3, "graph.replay", 44, 50, 0, 1, None)]
        marks = [M("graph.start", 15, 1, "cuda:0", 1), M("graph.end", 25, 1, "cuda:0", 1),
                 M("graph.start", 35, 1, "cuda:0", 3), M("graph.end", 55, 1, "cuda:0", 3),
                 M("graph.start", 120, 2, "cuda:0", 9), M("tick.start", 33, 0, "host", -1)]
        spans.append(S(9, "graph.replay", 110, 115, -1, 2, None))
        out = telemetry.outside_graphs_by_span(telemetry.Records(spans, marks, {}))
        assert out == pytest.approx({"fleet.tick": 10e-9, "other": 65e-9})
        index = telemetry.SpanIndex(spans)
        assert index.innermost(35).name == "events" and index.innermost(60) is None


# --------------------------------------------------------------------------- #
# gpu
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mark kernel and CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _controller_inputs(B, N, device):
    g = torch.Generator().manual_seed(0)
    pose = (torch.rand(B, 3, generator=g) - 0.5).to(device)
    traj = torch.zeros(B, N + 1, 3, device=device)
    traj[:, 0, 0] = 1.0
    return pose, torch.zeros(B, 3, device=device), traj, torch.ones(B, dtype=torch.long,
                                                                    device=device)


@pytest.mark.gpu
def test_a_capture_with_tracing_off_holds_no_mark(cuda_device, monkeypatch):
    from nmpc_nav_control_tpu_torch.control import GraphedController

    monkeypatch.setenv("NMPC_TPU_TILED_IPM", "1")
    conf = from_dict(dict(RAW, tf_ini=1.0))
    spec, data = make_controller("diff", conf.dt, conf.horizon, dtype=torch.float32,
                                 device=cuda_device, **conf.controller_kwargs())
    inputs = _controller_inputs(256, conf.horizon, cuda_device)
    got = {}
    for on in (False, True):
        (telemetry.enable_tracing if on else telemetry.disable_tracing)()
        try:
            graphed = GraphedController(spec, data, 256)
            graphed.load_inputs(*inputs)
            got[on] = (graphed.capture(), graphed.capture_nodes)
            before = telemetry.metrics().snapshot().get("graph.replays", 0)
            for _ in range(3):
                graphed.step(*inputs)
            assert telemetry.metrics().snapshot()["graph.replays"] == before + 3
            recs = telemetry.records()
        finally:
            telemetry.disable_tracing()
    assert got[False][0] == PER_TICK
    assert got[True][0] == dict(PER_TICK, trace_mark=6)
    assert got[True][1] == got[False][1] + 6
    replays = [s for s in recs.spans if s.name == "graph.replay"]
    for rep in replays[-3:]:
        mine = [m for m in recs.marks if m.replay == rep.id]
        assert [m.phase for m in mine] == ["graph.start", *ORDER[1:-1], "graph.end"]
        assert all(m.tick == rep.tick and m.device.startswith("cuda") for m in mine)


@pytest.mark.gpu
def test_the_clock_calibration_is_tight(cuda_device, tracing):
    node = _node(cuda_device, dict(RAW, tf_ini=2.0))
    for k in range(3):
        _tick(node, k)
    clocks = telemetry.records().clocks
    assert clocks and all(len(c) >= 2 for c in clocks.values())
    for card in clocks.values():
        assert all(0 < c.uncertainty_ns < 50_000 for c in card)


@pytest.mark.gpu
def test_the_robot_phases_sum_to_the_profiled_device_time(cuda_device, tracing):
    """The marks of 20 replays against the device time the profiler reads
    for 20 more of the same graph on the same inputs.  Under the profiler a
    replay's span on the card stretches (its kernels' own times hold), so
    the marks are read from the replays it does not watch."""
    from torch.profiler import ProfilerActivity, profile

    node = _node(cuda_device, dict(RAW, tf_ini=2.0))
    for _ in range(30):
        _tick(node)
    telemetry.reset_records()
    for _ in range(20):
        _tick(node)
    recs = telemetry.records()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            _tick(node)
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "trace_mark" not in e.key)
    phases = {}
    for m in recs.marks:
        if m.replay >= 0:
            phases.setdefault(m.replay, {})[m.phase] = m.t
    whole = ["graph.start", *ORDER, "graph.end"]
    assert len(phases) == 20 and all(list(p) == whole for p in phases.values())
    parts = [(p["tick.end"] - p["ctl.end"] + p["ctl.start"] - p["tick.start"],
              p["ctl.end"] - p["ctl.start"] - p["qp.end"] + p["qp.start"],
              p["qp.end"] - p["qp.start"]) for p in phases.values()]
    assert all(min(x) > 0 for x in parts)
    marked_ms = statistics.mean(sum(x) for x in parts) * 1e-6
    profiled_ms = device_us / 20 * 1e-3
    assert marked_ms == pytest.approx(profiled_ms, rel=0.1), (marked_ms, profiled_ms)
    # The whole graph's span holds the tick's and the state copy after it.
    graph_ms = statistics.mean(p["graph.end"] - p["graph.start"] for p in phases.values()) * 1e-6
    assert marked_ms < graph_ms == pytest.approx(profiled_ms, rel=0.1), (graph_ms, profiled_ms)
