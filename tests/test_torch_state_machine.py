"""The port's navigation tick (``control/state_machine.py``) against JAX.

Mixed batches of single-lane node states, built by the JAX package's event
functions and carried into the port with ``convert.node_state_from_numpy``,
tick side by side: the port's batched ``node_tick`` (plain kernel versions
on CPU tensors) and ``jax.jit(jax.vmap(node_tick))`` on JAX's CPU path,
from the same seeded measurements, for diff, omni4 and tric at N=10 with
``NavConfig(path_capacity=8)``.  The lanes: idle, GoToPose (near, too far,
invalid velocity, invalid steering angle), FollowPath (tracking, at the
end of a curve with upcoming segments behind a velocity-sign barrier, a
frame barrier, off the path), Break, and an empty path set.  Over 6 ticks:
every integer and bool leaf of the state and the outputs equal and every
float leaf within 1e-9 in f64; in f32 the commands within the golden bound
2.5e-3 and the statuses equal.  Also: the port's event functions against
JAX's, a seeded random event sequence (the port's statuses equal JAX's),
the "march" discretizer through the tick, and ``node_init``'s default
device (the card).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmpc_nav_control_tpu.control.state_machine as JS
from nmpc_nav_control_tpu.control import make_controller as jmake
from nmpc_nav_control_tpu.paths import make_line_segment as jline
from nmpc_nav_control_tpu_torch import convert
from nmpc_nav_control_tpu_torch.control import make_controller
from nmpc_nav_control_tpu_torch.control import state_machine as TS

torch.set_num_threads(1)

N, CAP, TICKS = 10, 8, 6
FLOAT_TOL = 1e-9
CMD_TOL_F32 = 2.5e-3          # the golden bound (tests/test_rti_oracle.py)
GEOMETRIES = {
    "diff": dict(dist_b=0.27, tau_v=0.1, v_max=1.0, a_max=2.0,
                 q_diag=[10.0, 10.0, 5.0, 0, 0, 0, 0], r_diag=[1.0, 1.0]),
    "omni4": dict(l1_plus_l2=0.535, tau_v=0.1, v_max=1.0, a_max=1.0,
                  q_diag=[10.0, 10.0, 5.0] + [0.0] * 8, r_diag=[1.0] * 4),
    "tric": dict(dist_d=1.05, tau_v=0.1, tau_a=0.1, v_max=1.0, a_max=2.0,
                 alpha_min=-math.radians(60.0), alpha_max=math.radians(60.0),
                 dalpha_max=math.radians(90.0), q_diag=[10.0, 10.0, 5.0, 0, 0, 0, 0],
                 r_diag=[1.0, 1.0]),
}
CFG = dict(path_capacity=CAP, final_position_error=0.03, final_orientation_error=np.deg2rad(3))


def _jdtype(dtype):
    return jnp.float64 if dtype == "float64" else jnp.float32


@functools.lru_cache(maxsize=None)
def _pair(geometry, dtype, discretizer="fast"):
    """(JAX spec, data, cfg, jitted vmapped tick; port spec, data, cfg)."""
    jspec, jdata = jmake(geometry, 0.025, N, dtype=_jdtype(dtype), **GEOMETRIES[geometry])
    spec, data = make_controller(geometry, 0.025, N, dtype=getattr(torch, dtype), device="cpu",
                                 **GEOMETRIES[geometry])
    jcfg = JS.NavConfig(discretizer=discretizer, **CFG)
    cfg = TS.NavConfig(discretizer=discretizer, **CFG)
    tick = jax.jit(jax.vmap(lambda s, m: JS.node_tick(jspec, jdata, jcfg, s, m)))
    return jspec, jdata, jcfg, tick, spec, data, cfg


def _padded(segs, dtype):
    st = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *segs)
    return jax.tree_util.tree_map(
        lambda x: jnp.pad(x.astype(dtype) if x.dtype.kind == "f" else x,
                          [(0, CAP - len(segs))] + [(0, 0)] * (x.ndim - 1)), st)


def _lanes(jspec, jcfg, dtype):
    """(single-lane JAX states, lane poses [B, 3], vel-valid, steer-valid)."""
    dt = _jdtype(dtype)

    def fresh():
        return JS.node_init(jspec, jcfg, dt)

    def path(*segs, n=None, rid=1):
        return JS.on_path_set(fresh(), jcfg, _padded(segs, dt), len(segs) if n is None else n, rid)

    goal = jnp.asarray([0.5, 0.1, 0.2], dt)
    lanes = [
        (fresh(), (0.0, 0.0, 0.0)),
        (JS.on_goal_pose(fresh(), goal), (0.0, 0.0, 0.0)),
        (JS.on_goal_pose(fresh(), jnp.asarray([5.0, 0.0, 0.0], dt)), (0.0, 0.0, 0.0)),
        (path(jline((0, 0), (1.0, 0), velocity=0.5), jline((1.0, 0), (2.0, 0.5), velocity=0.5),
              rid=7), (0.02, 0.01, 0.05)),
        # At the end of a curve; a velocity-sign flip holds the next one back.
        (path(jline((0, 0), (0.2, 0), velocity=0.5), jline((0.2, 0), (0.0, 0), velocity=-0.5)),
         (0.19, 0.0, 0.0)),
        # A frame change holds the second curve back.
        (path(jline((0, 0), (0.3, 0), velocity=0.4, frame_id=1),
              jline((0.3, 0), (0.6, 0.1), velocity=0.4, frame_id=2)), (0.1, 0.0, 0.0)),
        (path(jline((0, 0), (1.0, 0), velocity=0.5)), (0.0, 1.0, 0.0)),      # off the path
        (JS.on_command(JS.on_goal_pose(fresh(), goal), "break"), (0.0, 0.0, 0.0)),
        (path(jline((0, 0), (1.0, 0), velocity=0.5), n=0), (0.0, 0.0, 0.0)),  # empty set
        (JS.on_goal_pose(fresh(), goal), (0.0, 0.0, 0.0)),                   # vel invalid
        (JS.on_goal_pose(fresh(), goal), (0.0, 0.0, 0.0)),                   # steer invalid
    ]
    states = [s for s, _ in lanes]
    poses = np.array([p for _, p in lanes])
    vel_valid = np.ones(len(lanes), bool)
    vel_valid[-2] = False
    steer_valid = np.ones(len(lanes), bool)
    steer_valid[-1] = False
    return states, poses, vel_valid, steer_valid


def _stack(states):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


def _to_port(jstate, dtype):
    return convert.node_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                         device="cpu", dtype=getattr(torch, dtype))


def _meas(rng, poses, vel_valid, steer_valid, dtype):
    B = len(poses)
    m = JS.Measurements(
        pose=poses + rng.normal(size=(B, 3)) * 0.002,
        vel=rng.normal(size=(B, 3)) * 0.05,
        steer_angle=rng.uniform(-0.1, 0.1, B),
        pose_valid=np.ones(B, bool), vel_valid=vel_valid, steer_valid=steer_valid)
    jm = JS.Measurements(*(jnp.asarray(x, _jdtype(dtype)) if x.dtype.kind == "f"
                           else jnp.asarray(x) for x in m))
    return jm, convert.measurements_from_numpy(m, device="cpu", dtype=getattr(torch, dtype))


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _assert_match(got, want, what):
    for i, (g, w) in enumerate(zip(_leaves(tuple(got)), _leaves(want))):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=FLOAT_TOL, err_msg=f"{what} leaf {i}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("geometry", ["diff", "omni4", "tric"])
def test_node_tick_matches_jax_on_a_mixed_batch(geometry, dtype):
    jspec, jdata, jcfg, jtick, spec, data, cfg = _pair(geometry, dtype)
    states, poses, vel_valid, steer_valid = _lanes(jspec, jcfg, dtype)
    jstate = _stack(states)
    state = _to_port(jstate, dtype)
    rng = np.random.default_rng(11)
    seen = set()
    for k in range(TICKS):
        jm, m = _meas(rng, poses, vel_valid, steer_valid, dtype)
        jstate, jout = jtick(jstate, jm)
        state, out = TS.node_tick(spec, data, cfg, state, m)
        np.testing.assert_array_equal(state.status.numpy(), np.asarray(jstate.status))
        np.testing.assert_array_equal(out.status_code.numpy(), np.asarray(jout.status_code))
        np.testing.assert_array_equal(out.publish_cmd.numpy(), np.asarray(jout.publish_cmd))
        if dtype == "float64":
            _assert_match(state, jstate, f"tick {k} state")
            _assert_match(out, jout, f"tick {k} output")
        else:
            for g, w in zip(out.cmd, jout.cmd):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=CMD_TOL_F32)
        seen.update(np.asarray(jstate.status).tolist())
    # The batch visits every status but BREAK, which falls to IDLE in a tick.
    assert seen == {TS.IDLE, TS.GO_TO_POSE, TS.FOLLOW_PATH, TS.ERROR}
    want = np.asarray(jstate.status)
    assert want[2] == TS.IDLE and want[6] == TS.ERROR and want[7] == TS.IDLE
    assert want[9] == TS.ERROR and want[10] == (TS.ERROR if geometry == "tric" else TS.GO_TO_POSE)
    # Lane 4 rotated its window at the end of its first curve.
    assert np.asarray(jstate.window.head)[4] == 1 and state.window.head[4] == 1


def test_event_functions_match_jax():
    jspec, jdata, jcfg, jtick, spec, data, cfg = _pair("diff", "float64")
    states, *_ = _lanes(jspec, jcfg, "float64")
    jstate = _stack(states)
    state = _to_port(jstate, "float64")
    segs = _padded([jline((0, 0), (1.0, 0), velocity=0.5, frame_id=0),
                    jline((1.0, 0), (2.0, 0), velocity=-0.5), jline((2.0, 0), (3.0, 0))],
                   jnp.float64)
    tsegs = convert.path_segment_from_numpy(jax.tree_util.tree_map(np.asarray, segs),
                                            device="cpu")
    B = state.status.shape[0]
    goal = np.array([1.0, -0.5, 0.3])
    pairs = [
        (TS.on_goal_pose(state, torch.as_tensor(goal)),
         jax.vmap(lambda s: JS.on_goal_pose(s, jnp.asarray(goal)))(jstate)),
        (TS.on_path_set(state, cfg, type(tsegs)(*(x.expand(B, *x.shape) for x in tsegs)), 3, 5),
         jax.vmap(lambda s: JS.on_path_set(s, jcfg, segs, 3, 5))(jstate)),
        (TS.on_path_set(state, cfg, type(tsegs)(*(x.expand(B, *x.shape) for x in tsegs)), 0, 2),
         jax.vmap(lambda s: JS.on_path_set(s, jcfg, segs, 0, 2))(jstate)),
        (TS.on_command(state, "break"), jax.vmap(lambda s: JS.on_command(s, "break"))(jstate)),
        (TS.on_command(state, "idle"), jax.vmap(lambda s: JS.on_command(s, "idle"))(jstate)),
        (TS.on_command(state, "go"), jstate),
    ]
    for k, (got, want) in enumerate(pairs):
        _assert_match(got, want, f"event {k}")


def test_random_event_sequence_statuses_match_jax():
    """The JAX package's event-sequence property test, one lane, seeded:
    after every event the port's status equals JAX's, and after every tick
    the published status too."""
    jspec, jdata, jcfg, jtick, spec, data, cfg = _pair("diff", "float64")
    seg = _padded([jline((-10.0, 0.0), (30.0, 0.0), velocity=0.5)], jnp.float64)
    tseg = convert.path_segment_from_numpy(jax.tree_util.tree_map(np.asarray, seg), device="cpu")
    tseg = type(tseg)(*(x[None] for x in tseg))
    jsegs1 = jax.tree_util.tree_map(lambda x: x[None], seg)
    goal = np.array([[0.5, 0.2, 0.0]])
    jstate = _stack([JS.node_init(jspec, jcfg, jnp.float64)])
    state = _to_port(jstate, "float64")
    rng = np.random.default_rng(7)
    kinds = []
    for step in range(40):
        ev = rng.choice(["tick", "tick", "tick", "goal", "path", "break", "idle"])
        valid = bool(rng.random() > 0.15)
        kinds.append(ev)
        if ev == "goal":
            jstate = jax.vmap(JS.on_goal_pose)(jstate, jnp.asarray(goal))
            state = TS.on_goal_pose(state, torch.as_tensor(goal))
        elif ev == "path":
            jstate = jax.vmap(lambda s, g: JS.on_path_set(s, jcfg, g, 1, step))(jstate, jsegs1)
            state = TS.on_path_set(state, cfg, tseg, 1, step)
        elif ev in ("break", "idle"):
            jstate = jax.vmap(lambda s, e=str(ev): JS.on_command(s, e))(jstate)
            state = TS.on_command(state, str(ev))
        else:
            flags = np.array([valid])
            jm, m = _meas(rng, np.zeros((1, 3)), flags, flags, "float64")
            jstate, jout = jtick(jstate, jm)
            state, out = TS.node_tick(spec, data, cfg, state, m)
            assert int(out.status_code[0]) == int(jout.status_code[0]), (step, kinds[-6:])
        assert int(state.status[0]) == int(jstate.status[0]), (step, kinds[-6:])
    assert {"tick", "goal", "path", "break", "idle"} <= set(kinds)


def test_march_discretizer_through_the_tick_matches_jax():
    jspec, jdata, jcfg, jtick, spec, data, cfg = _pair("diff", "float64", "march")
    states, poses, vel_valid, steer_valid = _lanes(jspec, jcfg, "float64")
    keep = [3, 4]                                    # the FollowPath lanes
    jstate = _stack([states[i] for i in keep])
    state = _to_port(jstate, "float64")
    rng = np.random.default_rng(5)
    for k in range(3):
        jm, m = _meas(rng, poses[keep], vel_valid[keep], steer_valid[keep], "float64")
        jstate, jout = jtick(jstate, jm)
        state, out = TS.node_tick(spec, data, cfg, state, m)
        _assert_match(state, jstate, f"march tick {k} state")
        _assert_match(out, jout, f"march tick {k} output")


def test_node_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default works")
    spec, _ = make_controller("diff", 0.025, N, device="cpu", **GEOMETRIES["diff"])
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda|NVIDIA"):
        TS.node_init(spec, TS.NavConfig(), 2)
    for what, call in (("node_state_from_numpy", convert.node_state_from_numpy),
                       ("measurements_from_numpy", convert.measurements_from_numpy)):
        jspec, _, jcfg, *_ = _pair("diff", "float64")
        x = (jax.tree_util.tree_map(np.asarray, JS.node_init(jspec, jcfg, jnp.float64))
             if what.startswith("node") else
             JS.Measurements(np.zeros(3), np.zeros(3), np.zeros(()), *([np.ones((), bool)] * 3)))
        with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda|NVIDIA"):
            call(x)
            pytest.fail(f"{what} ran without a card")
