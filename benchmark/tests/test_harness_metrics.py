"""The metric arithmetic on made-up timings and traces."""
from __future__ import annotations

import json
import math
import time

import pytest

from benchmark import harness, loop
from benchmark import kernels as K
from benchmark.drivers import robot as robot_driver
from benchmark.metrics import Context
from benchmark.reference.models import robot_from_yaml
from benchmark.tests.conftest import HERE
from benchmark.trace import read_chrome_trace


def test_percentile_is_nearest_rank_over_every_value():
    v = list(range(1, 1001))
    assert harness.percentile(v, 50) == 500 and harness.percentile(v, 99) == 990
    assert harness.percentile([3.0, math.inf, 1.0], 99) == math.inf


def _rate(stall_at=None):
    def tick(k):
        time.sleep(0.2 if k == stall_at else 0.002)

    ticks, t0, t1, done = loop.closed_loop(tick, 0.6, "cpu")
    return ticks / (t1 - t0), loop.thirds(done, t0, t1, 1)


def test_a_stall_mid_window_moves_the_rate():
    steady, _ = _rate()
    stalled, thirds = _rate(stall_at=60)
    assert stalled < 0.8 * steady
    assert min(thirds) < 0.6 * max(thirds)


class _FakeClock:
    """Simulated time: a cycle takes 1 ms, and 60 ms once; sleeping jumps."""

    def __init__(self):
        self.t = 100.0

    def clock(self):
        return self.t

    def sleep_until(self, t):
        self.t = max(self.t, t)


def _tail(monkeypatch, stall_at=None):
    fake = _FakeClock()
    monkeypatch.setattr(loop, "clock", fake.clock)
    monkeypatch.setattr(loop, "sleep_until", fake.sleep_until)
    k = [0]

    def cycle():
        fake.t += 0.06 if k[0] == stall_at else 0.001
        k[0] += 1
        return object(), type("S", (), {"status": 1})(), (0.0, 0.0, 0.0), {}

    d = object.__new__(robot_driver.Driver)
    d.cycle, d.between, d.period, d.plan, d.samples = cycle, lambda *a: None, 0.01, set(), []
    d.sampling = False
    lat, failed = d.run(100, fake.t + 0.01)
    ms = [x * 1e3 for x in lat]
    return harness.percentile(ms, 50), harness.percentile(ms, 99), failed


def test_a_stall_moves_the_tail_of_cycles_timed_from_their_due_times(monkeypatch):
    p50, p99, failed = _tail(monkeypatch)
    assert failed == 0 and p50 == pytest.approx(1.0) and p99 == pytest.approx(1.0)
    s50, s99, _ = _tail(monkeypatch, stall_at=40)
    # the 60 ms cycle delays the next five too: they count from their due times
    assert s99 == pytest.approx(51.0) and s50 == pytest.approx(1.0)


def _event(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_readers_on_a_made_up_trace(tmp_path):
    robot = robot_from_yaml(json.loads((HERE / "configs" / "diff_n80.json").read_text()))
    ev = [
        _event("user_annotation", "tick.node", -5_000, 3_000),     # a settling tick, not traced
        _event("user_annotation", "traced_window", 0, 10_000),
        _event("user_annotation", "tick.node", 1_000, 3_000),
        _event("user_annotation", "plant", 5_000, 500),
        _event("cuda_runtime", "cudaGraphLaunch", 1_100, 50, corr=1),
        _event("cuda_runtime", "cudaLaunchKernel", 5_100, 10, corr=2),
        _event("kernel", "void (anonymous namespace)::bwd_fused_kernel<DiffConfig>(x)", 1_200,
               400, corr=1),
        _event("kernel", "elementwise_kernel", 1_600, 600, corr=1),
        _event("kernel", "plant_kernel", 5_200, 200, corr=2),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = read_chrome_trace(path)
    assert [op.label for op in t.ops] == ["tick.node", "tick.node", "plant"]
    assert t.window_s == pytest.approx(0.01) and t.busy() == pytest.approx(0.0012)
    d = K.dims(robot)
    ctx = Context(t, 1, {"tick.node": (robot, 1)}, K.load_all(), {"tick.node": d})
    least = K.least_seconds(K.load_all()["ipm_bwd_fused"], d, robot.N, 1)
    assert harness.reader("kernels_roofline.cycle").read(ctx, "cycle") == pytest.approx(
        100 * least / 0.0004)
    assert harness.reader("ipm_kkt_fused_roofline.cycle").read(ctx, "cycle") is None
    assert harness.reader("torch_ops_ms_per_tick.cycle").read(ctx, "cycle") == pytest.approx(0.6)
    # ticks: 1.2 ms of device time in the 10 ms traced window
    assert harness.reader("device_idle_frac.ticks").read(ctx, "ticks") == pytest.approx(0.88)
    assert t.label_at(5_100e-6) == "plant" and t.label_at(9_000e-6) == "other"
    # the window's tail, read from the run's own window and not from the trace
    assert harness.reader("cycle_ms_p99").read(ctx, "") is None
    ctx.window = {"cycle_ms_p50": 8.5, "cycle_ms_p99": 12.25}
    assert harness.reader("cycle_ms_p99").read(ctx, "") == 12.25


def test_the_roofline_reckons_a_float64_launch_at_8_byte_entries(tmp_path):
    """The same launch on the same trace, counted at a float64 cell's
    precision: these sweeps are bound by their bytes at either rate, so the
    least time, and with it the share of the roofline, doubles."""
    import torch

    robot = robot_from_yaml(json.loads((HERE / "configs" / "omni4_n80.json").read_text()))
    ev = [_event("user_annotation", "traced_window", 0, 10_000),
          _event("user_annotation", "tick.node", 1_000, 3_000),
          _event("cuda_runtime", "cudaGraphLaunch", 1_100, 50, corr=1),
          _event("kernel", "void (anonymous namespace)::fwd_kernel<Omni4Config, true>(P)",
                 1_200, 300, corr=1)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = read_chrome_trace(path)
    d, kern = K.dims(robot), K.load_all()["ipm_fwd_corr"]
    assert K.moved_bytes(kern, d, robot.N, 1) / 3.35e12 > kern.flops(d, robot.N, 1) / 34e12
    read = {}
    for dtype in (torch.float32, torch.float64):
        ctx = Context(t, 1, {"tick.node": (robot, 1)}, K.load_all(), {"tick.node": d},
                      dtype=dtype)
        read[dtype] = harness.reader("ipm_fwd_corr_roofline.cycle").read(ctx, "cycle")
        assert read[dtype] == harness.reader("kernels_roofline.cycle").read(ctx, "cycle")
    assert read[torch.float32] == pytest.approx(
        100 * 4 * kern.entries(d, robot.N, 1) / 3.35e12 / 0.0003)
    assert read[torch.float64] == pytest.approx(2 * read[torch.float32])


def test_node_gaps_are_also_split_by_samples_on_a_new_path():
    import torch

    M, N = 3, 4
    zeros = lambda *shape: torch.zeros(*shape)  # noqa: E731
    ref = dict(cmd=zeros(M, 3), publish=torch.ones(M, dtype=torch.bool),
               status_code=torch.zeros(M, dtype=torch.long), us=zeros(M, N, 2),
               post=dict(xs=zeros(M, N + 1, 3), carry=zeros(M, 3), u=zeros(M),
                         **{k: torch.zeros(M, dtype=torch.long)
                            for k in ("status", "head", "active", "total")}))
    prog = {k: (dict((j, w.clone()) for j, w in v.items()) if isinstance(v, dict)
                else v.clone()) for k, v in ref.items()}
    prog["cmd"][0, 1] = 1e-6
    prog["us"][1, 2, 0] = 1e-3
    prog["post"]["xs"][1, 0, 0] = 2e-3
    assert not any(k.endswith("_path") for k in loop.gaps(prog, ref))
    out = loop.gaps(dict(prog, new_path=torch.tensor([False, True, False])), ref)
    assert out["cmd_gap"] == out["cmd_gap_on_path"] == pytest.approx(1e-6)
    assert out["cmd_gap_new_path"] == 0.0
    assert out["us_gap"] == out["us_gap_new_path"] == pytest.approx(1e-3)
    assert out["us_gap_on_path"] == 0.0
    assert out["state_rel_gap_new_path"] == pytest.approx(2e-3)
    assert out["state_rel_gap_on_path"] == 0.0
