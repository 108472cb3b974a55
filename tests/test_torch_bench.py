"""The port's measurement surface against ``bench.py`` and
``bench_scaling.py``, on the CPU.

- ``nmpc_nav_control_tpu_torch/bench.py``: the flop and streaming-byte
  counts equal ``bench.py``'s to the integer; ``_build`` gives
  ``bench._build``'s controllers (dims, sparsity, bounds, weights); on
  ``bench.py``'s seeded inputs one tick in f64 agrees with
  ``jax.vmap(controller_step)`` to 1e-9; ``configs`` selects what
  ``bench.py::main`` selects (its selection code run from its source);
  ``_emit`` gives ``bench._emit``'s records but for ``f32_peak_frac`` and
  ``config.device``; ``main`` on the CPU prints one record for a custom
  config and writes ``BENCH_torch_partial.json``; the full sweep's record
  order, its aggregate file and its exit code when a probe fails (timings
  stubbed: the sweep's batches are the card's sizes).
- ``bench_scaling.py``: ``measure_scaling`` on a mesh that names ``cpu``
  twice gives ``bench_scaling.py``'s record keys, and its two lane blocks
  end where one unsharded eager chain over all lanes ends.
- ``tools/phase_probe.py`` and ``tools/node_probe.py`` print their phases.

Timings on the CPU prove nothing: only structure and agreement are held.
"""
import ast
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_scaling
from nmpc_nav_control_tpu.control import controller_init as jinit
from nmpc_nav_control_tpu.control import controller_step as jstep
from nmpc_nav_control_tpu.control import make_controller as jmake
from nmpc_nav_control_tpu_torch import bench as tbench
from nmpc_nav_control_tpu_torch import bench_scaling as tscaling
from nmpc_nav_control_tpu_torch.control import controller_init, controller_step
from nmpc_nav_control_tpu_torch.tools import node_probe, phase_probe

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRIES = ("diff", "omni4", "tric")
BENCH_VARS = ("BENCH_SWEEP", "BENCH_GEOMETRY", "BENCH_HORIZON", "BENCH_BATCH", "BENCH_REPS",
              "BENCH_CHAIN_LO", "BENCH_CHAIN_HI")


def _function(path, name):
    tree = ast.parse(open(path).read(), path)
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _bench_args(jspec, N):
    """``bench.py::_measure_config``'s arguments of its counts."""
    m = jspec.dims.model
    asp, bsp = jspec.rti.spars
    return (m.nx, m.nu, sum(sum(r) for r in asp), sum(sum(r) for r in bsp), len(m.idxbx),
            len(m.idxbu), N, jspec.rti.ipm_iters)


@pytest.mark.parametrize("N", [40, 80])
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_counts_equal_bench(geom, N):
    jspec, _ = bench._build(jnp, geom, N)
    spec, _ = tbench._build(geom, N, device="cpu")
    args = _bench_args(jspec, N)
    assert tbench._counts(spec, N) == (bench._flops_per_solve(*args),
                                       bench._hbm_bytes_per_solve(*args))


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_build_equals_bench(geom):
    jspec, jdata = bench._build(jnp, geom, 40)
    spec, data = tbench._build(geom, 40, device="cpu")
    jm, m = jspec.dims.model, spec.dims.model
    assert (m.nx, m.nu, m.idxbx, m.idxbu) == (jm.nx, jm.nu, tuple(jm.idxbx), tuple(jm.idxbu))
    assert (spec.dims.N, spec.dims.dt, spec.rti.ipm_iters) == (jspec.dims.N, jspec.dims.dt,
                                                                jspec.rti.ipm_iters)
    assert spec.rti.spars == jspec.rti.spars
    assert data._fields == jdata._fields
    for name, got, want in zip(data._fields, data, jdata):
        assert got.dtype == torch.float32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


def _bench_inputs(B, N):
    """``bench.py:155-162``'s inputs, in f64."""
    rng = np.random.default_rng(0)
    poses = rng.normal(size=(B, 3)) * 0.1
    vels = rng.normal(size=(B, 3)) * 0.1
    trajs = np.zeros((B, N + 1, 3))
    trajs[:, 0, 0] = rng.uniform(0.3, 1.5, size=(B,))
    return poses, vels, trajs, np.ones((B,), np.int32)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_bench_tick_matches_jax_f64(geom):
    N, B = 10, 4
    inputs = _bench_inputs(B, N)
    got = tbench._inputs(B, N, "cpu")
    for g, w in zip(got, inputs):
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype))
    jspec, jdata = jmake(geom, 1.0 / 40.0, N, ipm_iters=8, dtype=jnp.float64,
                         **tbench.CONTROLLER_KW[geom])
    jst = jax.tree_util.tree_map(lambda x: jnp.tile(x[None], (B,) + (1,) * x.ndim),
                                 jinit(jspec, jnp.float64))
    jst, jcmd, jstats = jax.jit(jax.vmap(lambda *a: jstep(jspec, jdata, *a)))(
        jst, *(jnp.asarray(x) for x in inputs))
    spec, data = tbench._build(geom, N, dtype=torch.float64, device="cpu")
    st, cmd, stats = controller_step(spec, data, controller_init(spec, B, torch.float64, "cpu"),
                                     *(torch.from_numpy(x) for x in inputs))
    for got, want in ((st, jst), (cmd, jcmd), (stats, jstats)):
        for name in got._fields:
            np.testing.assert_allclose(np.asarray(getattr(got, name), np.float64),
                                       np.asarray(getattr(want, name), np.float64),
                                       rtol=0.0, atol=1e-9, err_msg=f"{geom} {name}")
    assert bool(stats.ok.all())


def _bench_selection(env):
    """``bench.py::main``'s selection, run from its source: its statements
    from ``reps = ...`` through the ``if custom`` that sets ``configs``."""
    body = _function(os.path.join(ROOT, "bench.py"), "main").body
    start = next(i for i, s in enumerate(body) if isinstance(s, ast.Assign)
                 and s.targets[0].id == "reps")
    end = next(i for i, s in enumerate(body) if isinstance(s, ast.If)
               and getattr(s.test, "id", None) == "custom")
    scope = {"os": type("os", (), {"environ": env})}
    exec(compile(ast.Module(body=body[start:end + 1], type_ignores=[]), "bench.py", "exec"),
         scope)
    return scope["sweep"], scope["configs"]


@pytest.mark.parametrize("env", [
    {},
    {"BENCH_SWEEP": "full"},
    {"BENCH_SWEEP": "headline"},
    {"BENCH_SWEEP": "headline", "BENCH_BATCH": "512"},
    {"BENCH_GEOMETRY": "omni4", "BENCH_HORIZON": "80", "BENCH_BATCH": "16"},
    {"BENCH_HORIZON": "12"},
], ids=["default", "full", "headline", "headline-batch", "custom", "custom-horizon"])
def test_configs_equal_bench(env):
    sweep, want = _bench_selection(env)
    assert tbench.configs(env.get("BENCH_SWEEP", "full"), env) == want
    assert sweep == env.get("BENCH_SWEEP", "full")


@pytest.mark.parametrize("case", [("diff", 40, 2048, 1.7e-3, None),
                                  ("tric", 80, 4096, 9.1e-3, {"fleet_nav_ticks_per_s": 1.5})])
def test_emit_equals_bench(case, capsys):
    geom, N, B, per_step, extra = case
    jspec, _ = bench._build(jnp, geom, N)
    args = _bench_args(jspec, N)
    fps, hbm = bench._flops_per_solve(*args), bench._hbm_bytes_per_solve(*args)
    want = bench._emit(geom, N, B, per_step, fps, hbm, extra=dict(extra or {}) or None)
    want_line = json.loads(capsys.readouterr().out)
    got = tbench._emit(geom, N, B, per_step, fps, hbm, extra=extra, device="cpu")
    assert json.loads(capsys.readouterr().out) == got and want_line == want
    assert set(got) - set(want) == {"f32_peak_frac"}
    assert set(want) - set(got) == {"vpu_peak_frac"}
    assert got["config"] == dict(want["config"], device="cpu")
    for key in set(got) & set(want) - {"config", "hbm_roofline_frac"}:
        assert got[key] == want[key], key
    solves = B / per_step
    assert got["hbm_roofline_frac"] == round(hbm * solves / 3.35e12, 4)
    assert got["f32_peak_frac"] == round(fps * solves / 67e12, 4)


def _clear_bench_env(monkeypatch):
    for name in BENCH_VARS:
        monkeypatch.delenv(name, raising=False)


def test_main_on_the_cpu(tmp_path, capsys, monkeypatch):
    _clear_bench_env(monkeypatch)
    for name, value in (("BENCH_GEOMETRY", "diff"), ("BENCH_HORIZON", "6"), ("BENCH_BATCH", "4"),
                        ("BENCH_REPS", "2"), ("BENCH_CHAIN_HI", "9")):
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(tbench, "ROOT", str(tmp_path))
    assert tbench.main(["--device", "cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(lines) == 1
    rec = lines[0]
    assert rec["metric"] == "nmpc_solves_per_s_per_chip_N6" and rec["value"] > 0
    assert rec["config"] == {"geometry": "diff", "N": 6, "batch": 4, "ipm_iters": 8,
                             "dtype": "float32", "device": "cpu"}
    assert sorted(os.listdir(tmp_path)) == ["BENCH_torch_partial.json"]
    assert json.load(open(tmp_path / "BENCH_torch_partial.json")) == {"records": [rec]}


FULL_METRICS = [
    "nmpc_solves_per_s_per_chip_N40", "nmpc_solves_per_s_per_chip_N80",
    "nmpc_solves_per_s_per_chip_N80", "nmpc_solves_per_s_per_chip_N40_omni4",
    "nmpc_solves_per_s_per_chip_N40_omni4", "nmpc_solves_per_s_per_chip_N80_omni4",
    "nmpc_solves_per_s_per_chip_N40_tric", "nmpc_solves_per_s_per_chip_N40_tric",
    "nmpc_solves_per_s_per_chip_N80_tric", "single_robot_tick_latency_ms_N40",
    "fleet_nav_ticks_per_s_per_chip_N40", "nmpc_solves_per_s_per_chip_N40",
]


@pytest.mark.parametrize("failing", [None, "latency", "fleet"])
def test_full_sweep_records_and_exit_code(failing, tmp_path, capsys, monkeypatch):
    """The full sweep's order and files, the timings stubbed (its batches
    are the card's): bench.py's twelve metrics, the headline last with the
    latency and fleet values folded in; a failed probe prints an error line
    in its place and makes main return 1."""
    _clear_bench_env(monkeypatch)
    monkeypatch.setattr(tbench, "ROOT", str(tmp_path))

    def measure_config(geom, N, B, reps, k_lo, k_hi, device):
        if failing == "latency" and B == 1:
            raise RuntimeError("stub failure")
        return 1e-3 * N / 40, *tbench._counts(tbench._build(geom, N, device="cpu")[0], N)

    def measure_fleet(geom, N, B, reps, k_lo, k_hi, device):
        if failing == "fleet":
            raise RuntimeError("stub failure")
        return 4e-3

    monkeypatch.setattr(tbench, "_measure_config", measure_config)
    monkeypatch.setattr(tbench, "_measure_fleet", measure_fleet)
    rc = tbench.main(["--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["metric"] for r in lines] == FULL_METRICS
    assert [("error" in r) for r in lines] == [
        m == {"latency": FULL_METRICS[9], "fleet": FULL_METRICS[10]}.get(failing)
        for m in FULL_METRICS]
    assert rc == (0 if failing is None else 1)
    records = json.load(open(tmp_path / "BENCH_torch.json"))["records"]
    assert records == [r for r in lines if "error" not in r]
    head = lines[-1]
    assert head["config"]["batch"] == 2048 and head["value"] == 2048 / 1e-3
    folded = {k: head.get(k) for k in ("single_robot_tick_latency_ms", "fleet_nav_ticks_per_s")}
    assert folded == {"single_robot_tick_latency_ms": None if failing == "latency" else 1.0,
                      "fleet_nav_ticks_per_s": None if failing == "fleet" else 512000.0}
    assert all(r["config"]["device"] == "cpu" for r in records)
    assert os.listdir(tmp_path) == ["BENCH_torch.json"]


def _record_keys(path):
    """The keys of the dict literals ``measure_scaling`` emits, in order."""
    fn = _function(path, "measure_scaling")
    return [[k.value for k in d.keys] for d in ast.walk(fn)
            if isinstance(d, ast.Dict) and any(getattr(k, "value", None) == "metric"
                                               for k in d.keys)]


def test_scaling_on_a_cpu_mesh(monkeypatch):
    from nmpc_nav_control_tpu_torch import control

    calls = []
    step = control.controller_step

    def recording_step(spec, data, state, *inputs):
        out = step(spec, data, state, *inputs)
        calls.append((state, out[0]))
        return out

    monkeypatch.setattr(control, "controller_step", recording_step)
    lines, ends = [], []

    def emit(line):
        lines.append(line)
        ends.append(len(calls))            # a count's record follows its run

    recs = tscaling.measure_scaling(device_counts=[1, 2], batch_per_chip=8, N=6, reps=1, k_lo=1,
                                    k_hi=3, emit=emit, devices=["cpu"] * 2)
    rec_keys, eff_keys = _record_keys(os.path.join(ROOT, "bench_scaling.py"))
    assert [list(r) for r in recs] == [rec_keys, rec_keys]
    assert [r["devices"] for r in recs] == [1, 2] and [r["batch"] for r in recs] == [8, 16]
    assert all(r["value"] > 0 for r in recs)
    parsed = [json.loads(line) for line in lines]
    assert parsed[:2] == recs and list(parsed[2]) == eff_keys
    assert parsed[2]["metric"] == "scaling_efficiency" and parsed[2]["value"] > 0

    # The two-device run ticks its two blocks of 8 lanes in turn; the last
    # two calls end a chain, whose length the calls' inputs trace back.
    two_dev = calls[ends[0]:ends[1]]
    assert len(two_dev) % 2 == 0 and all(out.xs.shape[0] == 8 for _, out in two_dev)
    parent = {id(out): state for state, out in two_dev}
    ticks, state = 0, two_dev[-2][1]
    while id(state) in parent:
        ticks, state = ticks + 1, parent[id(state)]
    assert ticks >= 3
    final = [torch.cat(x) for x in zip(two_dev[-2][1], two_dev[-1][1])]
    spec, data = control.make_controller(
        "diff", 0.025, 6, dist_b=0.27, tau_v=0.1, v_max=1.0, a_max=2.0,
        q_diag=[10.0, 10.0, 5.0, 0, 0, 0, 0], r_diag=[1.0, 1.0], device="cpu")
    inputs = tscaling._lanes(16, 6)
    state = controller_init(spec, 16, torch.float32, "cpu")
    for _ in range(ticks):
        state = step(spec, data, state, *inputs)[0]
    gap = max(float((g - w).abs().max()) for g, w in zip(final, state))
    assert gap <= 3.6e-6, gap


@pytest.mark.parametrize("probe, phases", [
    (phase_probe, ["full_tick", "qp_solve", "linearize", "yref_build"]),
    (node_probe, ["node_tick", "controller_step", "discretizer_march", "discretizer_fast",
                  "projection", "windowing"]),
], ids=["phase_probe", "node_probe"])
def test_probes_on_the_cpu(probe, phases, capsys, monkeypatch):
    for name, value in (("BENCH_REPS", "1"), ("BENCH_CHAIN_LO", "1"), ("BENCH_CHAIN_HI", "3"),
                        ("NODE_PROBE_MARCH", "1")):
        monkeypatch.setenv(name, value)
    assert probe.main(["diff", "6", "4", "--device", "cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["phase"] for r in lines] == phases
    for r in lines:
        assert math.isfinite(r["per_batch_ms"]), r
        assert r["device_ms"] is None and r["kernel_ms"] is None
        assert r["config"] == {"geometry": "diff", "N": 6, "batch": 4, "device": "cpu"}
