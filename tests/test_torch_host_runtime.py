"""The port's host runtime beyond the node against the JAX package's.

On the CPU, with the same seeded inputs through both packages:
- ingest (``runtime/ingest.py``): the unwrap, staleness and finite-
  difference functions, and a ``TfStateProvider`` sequence across +-pi,
  equal within 1e-12;
- ``utils/profiling.py``: ``LatencyStats`` summaries equal on the same
  samples (budget and ring); the chained-slope timer and the trace on the
  CPU;
- the plant (``runtime/simulation.py``): ``SimulatedRobot`` bit for bit,
  per geometry, for seeded commands, actuation and measurement noise;
- the executor: the summary of the cycles after the first, and its warning
  when the native timer cannot be built (the closed loop against JAX's is
  in ``test_torch_closed_loop.py``);
- ``runtime/checkpoint.py``: a round trip resumes bit for bit; a structure,
  shape or dtype mismatch raises; a checkpoint JAX's ``save_state`` wrote
  mid-mission, carried over by ``convert.node_state_from_numpy``, resumes
  within 1e-9 of the resumed JAX state;
- ``runtime/models_config.py``: the same sections, errors and messages,
  and the same ``OCPData`` for each section of ``config/models.yaml``; the
  YAML files under ``config/`` read as ``yaml.safe_load`` reads them;
- ``runtime/native.py``: the ring and the timer, built into a temporary
  build directory.
"""
import json
import logging
import math
import os
import re
import struct
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import nmpc_nav_control_tpu.runtime as JR
import nmpc_nav_control_tpu.runtime.checkpoint as jckpt
import nmpc_nav_control_tpu.runtime.ingest as jingest
import nmpc_nav_control_tpu.runtime.simulation as jsim
import nmpc_nav_control_tpu.utils.profiling as jprof
import nmpc_nav_control_tpu_torch.runtime as TR
import nmpc_nav_control_tpu_torch.runtime.checkpoint as tckpt
import nmpc_nav_control_tpu_torch.runtime.executor as texec
import nmpc_nav_control_tpu_torch.runtime.ingest as tingest
import nmpc_nav_control_tpu_torch.runtime.native as native
import nmpc_nav_control_tpu_torch.runtime.simulation as tsim
import nmpc_nav_control_tpu_torch.utils.profiling as tprof
from nmpc_nav_control_tpu_torch.convert import node_state_from_numpy
from test_torch_runtime import DIFF_RAW, OMNI4_RAW, TRIC_RAW

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.join(ROOT, "config", f) for f in os.listdir(os.path.join(ROOT, "config")))
RAWS = {"diff": DIFF_RAW, "omni4": OMNI4_RAW, "tric": TRIC_RAW}
TOL = 1e-9


# --------------------------------------------------------------------------- #
# Ingest and latency stats
# --------------------------------------------------------------------------- #


def test_ingest_functions_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        a, b = rng.uniform(-8.0, 8.0, 2)
        assert tingest.unwrap_pose_theta(a, b) == jingest.unwrap_pose_theta(a, b)
        t, now, timeout = rng.uniform(0.0, 1.0, 3)
        assert tingest.pose_is_fresh(t, now, timeout) == jingest.pose_is_fresh(t, now, timeout)
        p = rng.uniform(-4.0, 4.0, (2, 4))
        p[:, 0] = np.sort(rng.uniform(0.0, 0.3, 2))
        got = tingest.velocity_from_poses(tingest.StampedPose(*p[0]), tingest.StampedPose(*p[1]),
                                          0.2)
        want = jingest.velocity_from_poses(jingest.StampedPose(*p[0]),
                                           jingest.StampedPose(*p[1]), 0.2)
        assert got[1] == want[1]
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12)


def test_tf_state_provider_sequence_across_pi_matches_jax():
    """A robot turning through +-pi at a stamp rate with jitter and a stale
    sample: the wrapped yaw is unwrapped, the velocity finite-differenced
    and the staleness gate applied alike."""
    rng = np.random.default_rng(1)
    t = np.cumsum(rng.uniform(0.02, 0.03, 80))
    t[40] = t[39] + 0.5                                  # one gap past the timeout
    t[41:] += 0.5
    theta = 2.6 + 1.2 * np.linspace(0.0, 1.5, 80) + rng.normal(0.0, 1e-3, 80)
    xy = np.cumsum(rng.normal(0.0, 0.02, (80, 2)), axis=0)
    wrapped = np.arctan2(np.sin(theta), np.cos(theta))
    assert (np.diff(np.sign(wrapped)) != 0).any()         # the yaw crosses +-pi

    def source(mod):
        it = iter(range(80))

        def get():
            k = next(it)
            return mod.StampedPose(t[k], xy[k, 0], xy[k, 1], wrapped[k]), "map"
        return get

    now = iter(t + 0.01)
    now2 = iter(t + 0.01)
    tp = tingest.TfStateProvider(source(tingest), transform_timeout=0.2, clock=lambda: next(now))
    jp = jingest.TfStateProvider(source(jingest), transform_timeout=0.2, clock=lambda: next(now2))
    valids = []
    for _ in range(80):
        (gp, gv, gok, gf), (wp, wv, wok, wf) = tp.get_state(), jp.get_state()
        assert (gok, gf) == (wok, wf)
        np.testing.assert_allclose([*gp, *gv], [*wp, *wv], rtol=0, atol=1e-12)
        valids.append(gok)
    assert not valids[0] and not valids[40] and sum(valids) == 78


def test_latency_stats_match_jax():
    rng = np.random.default_rng(2)
    samples = rng.lognormal(-4.0, 0.5, 300)
    for kw in (dict(budget_s=0.025), dict(max_samples=64), dict(budget_s=0.02, max_samples=50),
               {}):
        got, want = tprof.LatencyStats(**kw), jprof.LatencyStats(**kw)
        assert got.summary() == want.summary() == {"count": 0}
        for s in samples:
            got.record(float(s))
            want.record(float(s))
        assert got.summary() == want.summary(), kw
        got.reset()
        assert got.summary() == {"count": 0} and got.violations == 0


def test_steady_state_timer_and_trace_on_the_cpu(tmp_path):
    calls = []

    def step(c):
        calls.append(1)
        return c * 1.0000001 + 0.1

    per_step = tprof.steady_state_seconds_per_step(step, torch.ones(64), k_lo=1, k_hi=5, reps=2,
                                                   device="cpu")
    assert math.isfinite(per_step) and per_step < 0.5
    assert len(calls) == 3 * 1 + 3 * 5                     # one untimed chain, two timed each
    with tprof.device_trace(str(tmp_path)) as prof:
        torch.ones(8) @ torch.ones(8)
    assert prof.key_averages() and os.path.getsize(tmp_path / "trace.json") > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tprof.steady_state_seconds_per_step(step, torch.ones(4))


# --------------------------------------------------------------------------- #
# The plant
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("geometry", ["diff", "omni4", "tric"])
def test_plant_matches_jax_bit_for_bit(geometry):
    """The same commands, statuses and noise seeds through both plants
    (a stub node holds the config and ``last_cmd``): equal states,
    measurements and raw poses."""
    rng = np.random.default_rng(3)
    robots = []
    for mod, sim in ((TR, tsim), (JR, jsim)):
        stub = types.SimpleNamespace(config=mod.from_dict(RAWS[geometry]), last_cmd=None,
                                     steer=[])
        stub.set_steering_wheel_angle = stub.steer.append
        robots.append((stub, sim.SimulatedRobot(stub, substeps=7, noise_sigma=0.05, seed=11,
                                                start_pose=(0.1, -0.2, 3.0),
                                                meas_noise_sigma=0.01)))
    cmds = rng.uniform(-0.8, 0.8, (60, 3))
    for k, cmd in enumerate(cmds):
        outs = []
        for stub, robot in robots:
            got = [robot.get_state()]
            if k % 3 == 0:
                raw = robot.get_raw_pose()
                got.append((raw.t, raw.x, raw.y, raw.theta))
            if k % 5 != 4:                              # some ticks publish no command
                stub.last_cmd = tuple(cmd)
                robot.publish_cmd_vel(None)
            robot.publish_status(TR.ControlStatus(status=k % 3))
            outs.append((got, robot.pose.copy(), robot.act.copy(), robot.sim_time,
                         list(stub.steer)))
        (g, gp, ga, gt, gs), (w, wp, wa, wt, ws) = outs
        assert g == w and gt == wt and gs == ws, k
        assert np.array_equal(gp, wp) and np.array_equal(ga, wa), k
    (_, t_robot), (_, j_robot) = robots
    assert np.array_equal(np.stack(t_robot.trajectory), np.stack(j_robot.trajectory))
    assert t_robot.last_status == TR.ControlStatus(status=59 % 3)


# --------------------------------------------------------------------------- #
# The executor
# --------------------------------------------------------------------------- #


def test_steady_latency_stats_leave_out_the_first_cycle():
    node = types.SimpleNamespace(config=types.SimpleNamespace(dt=0.025))
    ex = texec.RealTimeExecutor(node, None, None, use_native_timer=False)
    assert ex.steady_latency_stats() == {"count": 0}
    samples = [0.1, 0.01, 0.02, 0.03, 0.005]
    ex.first_cycle_s = samples[0]
    for s in samples:
        ex.latency.record(s)
    want = tprof.LatencyStats(budget_s=0.025)
    for s in samples[1:]:
        want.record(s)
    assert ex.steady_latency_stats() == want.summary()
    assert ex.latency_stats()["violations"] == 2 and want.summary()["violations"] == 1
    ex.latency = tprof.LatencyStats(budget_s=0.025, max_samples=3)   # a ring that wrapped
    for s in samples:
        ex.latency.record(s)
    got = ex.steady_latency_stats()
    assert got["count"] == 4 and got["violations"] == 1
    assert got["max_ms"] == 30.0 and got["p50_ms"] == 20.0


def test_executor_warns_without_the_native_timer(monkeypatch, caplog):
    monkeypatch.setattr(native, "available", lambda: False)
    node = TR.NmpcNavControlNode(TR.from_dict(DIFF_RAW), dtype=torch.float64, device="cpu")
    with caplog.at_level(logging.WARNING, logger="nmpc_nav_control_tpu_torch.executor"):
        ex = texec.RealTimeExecutor(node, None, None)
    assert ex.timer_stats() == {}
    assert [r.getMessage() for r in caplog.records] == ["native_timer_unavailable"]


# --------------------------------------------------------------------------- #
# Checkpoints
# --------------------------------------------------------------------------- #


def _diff_tick_setup():
    node = TR.NmpcNavControlNode(TR.from_dict(DIFF_RAW), dtype=torch.float64, device="cpu")
    return node, lambda x: ((x, 0.02 * x, 0.01), (0.2, 0.0, 0.05))


def test_checkpoint_round_trip_resumes_bit_for_bit(tmp_path):
    node, meas = _diff_tick_setup()
    node.on_pose_goal(TR.PoseStamped("map", 0.4, 0.05, 0.0))
    for i in range(4):
        node.tick(*meas(0.01 * i))
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_state(path, node.state)
    fresh, _ = _diff_tick_setup()
    fresh.set_state(tckpt.load_state(path, fresh.state))
    for a, b in zip(tckpt._flatten(fresh.state)[1], tckpt._flatten(node.state)[1]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for i in range(4, 8):
        ta, sa = node.tick(*meas(0.01 * i))
        tb, sb = fresh.tick(*meas(0.01 * i))
        assert ta == tb and sa == sb and node.last_cmd == fresh.last_cmd
    for a, b in zip(tckpt._flatten(fresh.state)[1], tckpt._flatten(node.state)[1]):
        assert torch.equal(a, b)


def test_checkpoint_mismatch_raises(tmp_path):
    node, _ = _diff_tick_setup()
    state = node.state
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_state(path, state)
    _, leaves = tckpt._flatten(state)
    with pytest.raises(ValueError, match="structure does not match"):
        tckpt.load_state(path, tuple(leaves))               # same leaves, other structure
    small = TR.NmpcNavControlNode(TR.from_dict({**DIFF_RAW, "path_capacity": 4}),
                                  dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_state(path, small.state)
    f32 = TR.NmpcNavControlNode(TR.from_dict(DIFF_RAW), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        tckpt.load_state(path, f32.state)
    np.savez(str(tmp_path / "short.npz"), leaf_0=np.zeros(1))
    with pytest.raises(ValueError, match="no __fields__ descriptor"):
        tckpt.load_state(str(tmp_path / "short.npz"), state)
    with np.load(path) as data:
        np.savez(str(tmp_path / "few.npz"), __fields__=data["__fields__"], leaf_0=data["leaf_0"])
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_state(str(tmp_path / "few.npz"), state)


def test_jax_checkpoint_carried_across(tmp_path):
    """JAX's ``save_state`` mid-mission (a path, then 6 ticks), its leaves
    rebuilt into JAX's NodeState and carried over by
    ``convert.node_state_from_numpy``: the port node resumes within 1e-9 of
    the JAX node resumed from the same file, over 6 more ticks."""
    raw = DIFF_RAW
    jnode = JR.NmpcNavControlNode(JR.from_dict(raw), dtype=jnp.float64)
    path = [JR.ParametricPath("map", [0.0, 0.5], [0.0, 0.1], velocity=0.4)]
    jnode.on_path_no_stack_up_2(JR.ParametricPathSet2(paths=path, request_id=3))

    def meas(k):
        return (0.012 * k, 0.002 * k, 0.01 * k), (0.3, 0.0, 0.02)

    for k in range(6):
        jnode.tick(*meas(k))
    ck = str(tmp_path / "jax.npz")
    jckpt.save_state(ck, jnode.state)
    jresumed = JR.NmpcNavControlNode(JR.from_dict(raw), dtype=jnp.float64)
    jresumed.state = jckpt.load_state(ck, jresumed.state)
    with np.load(ck) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(jax.tree_util.tree_leaves(jnode.state)))]
    jstate = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jnode.state), leaves)
    tnode = TR.NmpcNavControlNode(TR.from_dict(raw), dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="no __fields__ descriptor"):
        tckpt.load_state(ck, tnode.state)                  # JAX's format is not the port's
    tnode.set_state(node_state_from_numpy(jstate, device="cpu", dtype=torch.float64))
    for k in range(6, 12):
        jt, js = jresumed.tick(*meas(k))
        tt, ts = tnode.tick(*meas(k))
        assert (ts.status, ts.request_id) == (js.status, js.request_id) and ts.status == 1
        np.testing.assert_allclose([tt.linear_x, tt.angular_z], [jt.linear_x, jt.angular_z],
                                   rtol=0, atol=TOL)
    want = jax.tree_util.tree_leaves(jresumed.state)
    _, got = tckpt._flatten(tnode.state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=0, atol=TOL)


# --------------------------------------------------------------------------- #
# Models config and YAML
# --------------------------------------------------------------------------- #


def test_models_config_matches_jax(tmp_path):
    models = os.path.join(ROOT, "config", "models.yaml")
    got, want = TR.load_models_config(models), JR.load_models_config(models)
    assert got == want and set(got) == {"diff", "omni4", "tric"}
    for geom, params in got.items():
        tspec, tdata = TR.controller_from_models_params(geom, params, dtype=torch.float64,
                                                        device="cpu")
        jspec, jdata = JR.controller_from_models_params(geom, params, dtype=jnp.float64)
        assert tspec.dims.N == jspec.dims.N == 80 and tspec.dims.dt == jspec.dims.dt
        for name in jdata._fields:
            np.testing.assert_array_equal(getattr(tdata, name).numpy(),
                                          np.asarray(getattr(jdata, name)), err_msg=name)
    bad = {"missing": "diff_params:\n  tf_ini: 1.0\n", "empty": "unrelated: 1\n",
           "blank": ""}
    for name, text in bad.items():
        p = tmp_path / f"{name}.yaml"
        p.write_text(text)
        with pytest.raises(ValueError) as jerr:
            JR.load_models_config(str(p))
        with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
            TR.load_models_config(str(p))
    with pytest.raises(ValueError, match="unknown steering geometry"):
        TR.controller_from_models_params("ackermann", got["diff"], device="cpu")


def test_yaml_files_load_as_safe_load(tmp_path):
    """Every file under ``config/`` and the CLI tests' YAMLs: the models
    sections and the runtime configs are what ``yaml.safe_load`` reads,
    and what the JAX loaders make of them."""
    from test_torch_cli import TINY_MODELS_YAML, TINY_RUNTIME_YAML

    tiny = []
    for name, text in (("models.yaml", TINY_MODELS_YAML), ("runtime.yaml", TINY_RUNTIME_YAML)):
        p = tmp_path / name
        p.write_text(text)
        tiny.append(str(p))
    for path in CONFIGS + tiny:
        with open(path) as fh:
            raw = yaml.safe_load(fh)
        if "steering_geometry" in raw:
            got = TR.load_config(path)
            assert got == TR.from_dict(raw)
            want = JR.load_config(path)
            assert {k: v for k, v in got.__dict__.items() if k != "nav"} == \
                {k: v for k, v in want.__dict__.items() if k != "nav"}
            assert got.nav.__dict__ == want.nav.__dict__
        else:
            sections = {g: raw[f"{g}_params"] for g in ("omni4", "diff", "tric")
                        if f"{g}_params" in raw}
            assert TR.load_models_config(path) == sections == JR.load_models_config(path)


# --------------------------------------------------------------------------- #
# The native runtime
# --------------------------------------------------------------------------- #


@pytest.fixture
def native_lib(tmp_path, monkeypatch):
    """The runtime built into a temporary build directory."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    if not native.available():
        pytest.fail("g++ could not build native/rt_runtime.cpp")
    built = list((tmp_path / "native").glob("*/libnmpc_rt.so"))
    assert len(built) == 1 and native.build() == built[0]
    return built[0]


def test_native_ring(native_lib):
    r = native.SpscRing(record_size=8, capacity_pow2=4)
    assert r.pop() is None and r.pop_latest() is None
    for i in range(4):
        assert r.push(struct.pack("<d", float(i)), overwrite=False), i
    assert len(r) == 4
    ts, payload = r.pop()
    assert struct.unpack("<d", payload)[0] == 0.0 and ts > 0
    ts, payload, dropped = r.pop_latest()
    assert struct.unpack("<d", payload)[0] == 3.0 and dropped == 2 and len(r) == 0
    for i in range(10):                                              # overwrite policy
        assert r.push(struct.pack("<d", float(i)))
    assert struct.unpack("<d", r.pop_latest()[1])[0] == 9.0
    with pytest.raises(ValueError):
        r.push(b"123")
    with pytest.raises(ValueError, match="power of two"):
        native.SpscRing(record_size=8, capacity_pow2=3)
    assert native.now_ns() > 0


def test_native_timer(native_lib):
    t = native.RtTimer(0.005)
    t0 = time.perf_counter()
    for _ in range(20):
        assert t.wait() >= 0
    assert time.perf_counter() - t0 >= 0.09
    stats = t.jitter_stats()
    assert 0 <= stats["p50_ns"] <= stats["p99_ns"] <= stats["max_ns"]
    time.sleep(0.02)                                   # blow through several deadlines
    assert t.wait() > 0 and t.overruns >= 1
    node = TR.NmpcNavControlNode(TR.from_dict({**DIFF_RAW, "control_freq": 100}),
                                 dtype=torch.float64, device="cpu")
    overruns = []

    def slow_state():                                  # every cycle overruns the 10 ms period
        time.sleep(0.015)
        return (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), True

    ex = TR.RealTimeExecutor(node, types.SimpleNamespace(get_state=slow_state),
                             types.SimpleNamespace(publish_cmd_vel=lambda tw: None,
                                                   publish_status=lambda st: None),
                             on_overrun=overruns.append)
    ex.run(3)
    assert set(ex.timer_stats()) == {"p50_ns", "p99_ns", "max_ns"}
    assert ex.overruns == len(overruns) == 3 and ex.latency_stats()["count"] == 3
    assert json.dumps(ex.latency_stats())
