"""The port's batched controller tick against JAX, end to end on the CPU.

Five chained ``controller_step`` ticks at N=10, B=8 through the port
(plain versions of the kernels on CPU tensors) and through ``jax.jit(
jax.vmap(controller_step))`` on JAX's default CPU path (the serial
per-problem IPM), from the same numpy inputs: pose-goal lanes,
path-following lanes whose reference headings cross +-pi, and goals far
enough away to saturate the input bounds.  diff runs on the default route;
omni4, tric and the tricycle's bug-compatible model run on both IPM routes
(``NMPC_TPU_TILED_IPM`` 1: the fused sweeps, 0: the Riccati solve), with
measured steering angles for tric.  f64 agrees to rounding (the port's IPM
guards follow the dtype as the JAX serial path's do); f32 within the
batched-vs-serial bound of ``tests/test_qp.py``.  Also: ``convert.py``
round-trips state between the packages for every geometry, a tick reads
its route once, geometry arguments are checked, and the entry points
default to the card.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_nav_control_tpu.control import controller_init as jinit
from nmpc_nav_control_tpu.control import controller_step as jstep
from nmpc_nav_control_tpu.control import make_controller as jmake
from nmpc_nav_control_tpu.rti.step import RTIState as JRTIState
from nmpc_nav_control_tpu_torch.control import (
    controller_init,
    controller_reset,
    controller_step,
    make_controller,
)
from nmpc_nav_control_tpu_torch.rti import rti_init
from nmpc_nav_control_tpu_torch.convert import (
    ocp_data_from_numpy,
    rti_state_from_numpy,
    rti_state_to_numpy,
)

torch.set_num_threads(1)

N, B, TICKS = 10, 8, 5
KW = dict(dist_b=0.27, tau_v=0.1, v_max=1.0, a_max=2.0,
          q_diag=[10.0, 10.0, 5.0, 0, 0, 0, 0], r_diag=[1.0, 1.0], ipm_iters=8)
# geometry -> (make_controller geometry, its arguments): bench.py's settings,
# with input bounds tight enough that these inputs make them active.
GEOMETRIES = {
    "diff": ("diff", KW),
    "omni4": ("omni4", dict(l1_plus_l2=0.535, tau_v=0.1, v_max=1.0, a_max=0.1,
                            q_diag=[10.0, 10.0, 5.0] + [0.0] * 8, r_diag=[1.0] * 4)),
    "tric": ("tric", dict(dist_d=1.05, tau_v=0.1, tau_a=0.1, v_max=1.0, a_max=0.2,
                          alpha_min=-math.radians(60.0), alpha_max=math.radians(60.0),
                          dalpha_max=0.2, q_diag=[10.0, 10.0, 5.0, 0, 0, 0, 0],
                          r_diag=[1.0, 1.0])),
}
GEOMETRIES["tric_bug"] = ("tric", dict(GEOMETRIES["tric"][1], a_max=0.03, dalpha_max=0.03,
                                       tric_bug_compat=True))
TOL = {"float64": dict(rtol=0.0, atol=1e-8), "float32": dict(rtol=1e-3, atol=3e-4)}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    poses = rng.normal(size=(B, 3)) * 0.3
    vels = rng.normal(size=(B, 3)) * 0.3
    trajs = np.zeros((B, N + 1, 3))
    trajs[:, 0] = np.stack([rng.uniform(0.3, 3.0, B), rng.uniform(-2.0, 2.0, B),
                            rng.uniform(-3.1, 3.1, B)], -1)
    n_valid = np.ones(B, np.int32)
    # Lanes 0-2 follow a path window; its headings wrap across +-pi.
    for lane in range(3):
        s = np.linspace(0.0, 1.0, N + 1)
        trajs[lane] = np.stack([s, 0.3 * s * (lane + 1),
                                np.mod(3.0 + 0.4 * s * (lane + 1) + np.pi, 2 * np.pi) - np.pi], -1)
        n_valid[lane] = N + 1 - 3 * lane
    return poses, vels, trajs, n_valid


def _jax_tick(jspec, jdata):
    return jax.jit(jax.vmap(lambda s, p, v, t, n, a: jstep(jspec, jdata, s, p, v, t, n,
                                                           steer_angle=a)))


def _jax_state(jspec, jdt):
    st0 = jinit(jspec, jdt)
    return jax.tree_util.tree_map(lambda x: jnp.tile(x[None], (B,) + (1,) * x.ndim), st0)


@functools.lru_cache(maxsize=None)
def _jax_run(geometry, dtype):
    """JAX's TICKS chained ticks (states, commands, stats per tick), once
    per geometry and dtype: both port routes are held against it."""
    name, kw = GEOMETRIES[geometry]
    jdt = getattr(jnp, dtype)
    jspec, jdata = jmake(name, 0.025, N, dtype=jdt, **kw)
    tick = _jax_tick(jspec, jdata)
    poses, vels, trajs, n_valid = _inputs()
    steer = np.random.default_rng(9).uniform(-0.5, 0.5, (TICKS, B))
    jst, out = _jax_state(jspec, jdt), []
    for k in range(TICKS):
        jst, jcmd, jstats = tick(jst, jnp.asarray(poses, jdt), jnp.asarray(vels, jdt),
                                 jnp.asarray(trajs, jdt), jnp.asarray(n_valid),
                                 jnp.asarray(steer[k], jdt))
        out.append(jax.tree_util.tree_map(np.asarray, (jst, jcmd, jstats)))
        poses = poses + 0.02 * vels   # the robots move between ticks
    return jspec.rti.spars, steer, out


def _check_ticks(geometry, dtype):
    name, kw = GEOMETRIES[geometry]
    tdt = getattr(torch, dtype)
    spars, steer, want = _jax_run(geometry, dtype)
    spec, data = make_controller(name, 0.025, N, dtype=tdt, device="cpu", **kw)
    assert spec.rti.spars == spars
    poses, vels, trajs, n_valid = _inputs()
    st = controller_init(spec, B, tdt, "cpu")
    tol = TOL[dtype]
    for k, (jst, jcmd, jstats) in enumerate(want):
        st, cmd, stats = controller_step(
            spec, data, st, torch.tensor(poses, dtype=tdt), torch.tensor(vels, dtype=tdt),
            torch.tensor(trajs, dtype=tdt), torch.tensor(n_valid),
            steer_angle=torch.tensor(steer[k], dtype=tdt))
        for field in ("us", "xs", "x0_carry"):
            np.testing.assert_allclose(getattr(st, field).numpy(), getattr(jst, field),
                                       err_msg=f"tick {k} {field}", **tol)
        for field in ("kkt_res", "mu"):
            np.testing.assert_allclose(getattr(stats, field).numpy(), getattr(jstats, field),
                                       err_msg=f"tick {k} {field}", **tol)
        for field in ("v", "vn", "w"):
            np.testing.assert_allclose(getattr(cmd, field).numpy(), getattr(jcmd, field),
                                       err_msg=f"tick {k} cmd.{field}", **tol)
        assert bool(stats.ok.all()) and bool(jstats.ok.all())
        poses = poses + 0.02 * vels
    # Some lanes ran against their input bounds (the active-set case).
    assert np.abs(st.us.numpy()).max() > 0.99 * float(data.ubu.abs().min())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_batched_ticks_match_jax(dtype):
    _check_ticks("diff", dtype)


@pytest.mark.parametrize("route", ["1", "0"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("geometry", ["omni4", "tric", "tric_bug"])
def test_geometry_ticks_match_jax(geometry, dtype, route, monkeypatch):
    monkeypatch.setenv("NMPC_TPU_TILED_IPM", route)
    _check_ticks(geometry, dtype)


@pytest.mark.parametrize("route", [True, False])
def test_rti_step_reads_the_route_once(route, monkeypatch):
    """A tick reads the route once and hands that reading to
    ``solve_box_qp``, so its linearization pattern and its solve follow one
    choice even where the environment says otherwise."""
    import nmpc_nav_control_tpu_torch.rti.step as step

    reads, routes = [], []
    monkeypatch.setattr(step, "tiled_ipm_ok", lambda: reads.append(1) or route)
    solve = step.solve_box_qp
    monkeypatch.setattr(step, "solve_box_qp",
                        lambda *a, **k: routes.append(k["tiled"]) or solve(*a, **k))
    monkeypatch.setenv("NMPC_TPU_TILED_IPM", "0" if route else "1")
    name, kw = GEOMETRIES["diff"]
    spec, data = make_controller(name, 0.025, N, dtype=torch.float64, device="cpu", **kw)
    poses, vels, trajs, n_valid = _inputs()
    _, _, stats = controller_step(spec, data, controller_init(spec, B, torch.float64, "cpu"),
                                  torch.tensor(poses), torch.tensor(vels), torch.tensor(trajs),
                                  torch.tensor(n_valid))
    assert reads == [1] and routes == [route]
    assert bool(stats.ok.all())


@pytest.mark.parametrize("geometry", ["diff", "omni4", "tric"])
def test_convert_round_trips_state_between_packages(geometry):
    """A JAX state continues in the port and comes back to JAX unchanged."""
    name, kw = GEOMETRIES[geometry]
    jspec, jdata = jmake(name, 0.025, N, dtype=jnp.float64, **kw)
    spec, data = make_controller(name, 0.025, N, dtype=torch.float64, device="cpu", **kw)
    port_data = ocp_data_from_numpy(jax.tree_util.tree_map(np.asarray, jdata), device="cpu")
    for got, want in zip(port_data, data):
        assert torch.equal(got, want)
    tick = _jax_tick(jspec, jdata)
    poses, vels, trajs, n_valid = _inputs(1)
    steer = np.full(B, 0.1)
    jargs = (jnp.asarray(poses), jnp.asarray(vels), jnp.asarray(trajs), jnp.asarray(n_valid),
             jnp.asarray(steer))
    targs = (torch.tensor(poses), torch.tensor(vels), torch.tensor(trajs), torch.tensor(n_valid))
    jst, _, _ = tick(_jax_state(jspec, jnp.float64), *jargs)

    st = rti_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst), device="cpu",
                              dtype=torch.float64)
    back = JRTIState(*rti_state_to_numpy(st))
    for a, b in zip(back, jst):
        np.testing.assert_array_equal(a, np.asarray(b))
    st, _, _ = controller_step(spec, port_data, st, *targs, steer_angle=torch.tensor(steer))
    jst, _, _ = tick(jst, *jargs)
    np.testing.assert_allclose(rti_state_to_numpy(st).us, np.asarray(jst.us), rtol=0, atol=1e-8)

    one = rti_state_from_numpy(jax.tree_util.tree_map(lambda x: np.asarray(x[0]), jst),
                               device="cpu")
    assert one.xs.shape == (1, N + 1, spec.dims.model.nx)
    reset = controller_reset(st)
    assert not bool(reset.xs.any()) and torch.equal(reset.x0_carry, st.x0_carry)


@pytest.mark.parametrize("geometry", ["omni4", "tric"])
def test_geometries_not_ported_yet_raise(geometry):
    """omni4 and tric are ported: they build; what still raises is a call
    without their physical parameters, or a geometry the package lacks."""
    name, kw = GEOMETRIES[geometry]
    spec, _ = make_controller(name, 0.025, N, device="cpu", **kw)
    assert spec.geometry == geometry
    needed = "l1_plus_l2" if geometry == "omni4" else "dist_d"
    with pytest.raises(ValueError, match=needed):
        make_controller(name, 0.025, N, device="cpu",
                        **{k: v for k, v in kw.items() if k != needed})
    with pytest.raises(ValueError, match="unknown steering geometry"):
        make_controller("ackermann", 0.025, N, device="cpu", **kw)


def test_entry_points_default_to_the_card():
    """Without a device argument every entry point puts its tensors on the
    card, and on a machine without one it raises rather than carry on on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default works")
    name, kw = GEOMETRIES["diff"]
    spec, _ = make_controller(name, 0.025, N, device="cpu", **kw)
    jspec, jdata = jmake(name, 0.025, N, dtype=jnp.float64, **kw)
    jst = jax.tree_util.tree_map(np.asarray, _jax_state(jspec, jnp.float64))
    calls = {
        "make_controller": lambda: make_controller(name, 0.025, N, **kw),
        "controller_init": lambda: controller_init(spec, B),
        "rti_init": lambda: rti_init(spec.dims, B),
        "ocp_data_from_numpy": lambda: ocp_data_from_numpy(
            jax.tree_util.tree_map(np.asarray, jdata)),
        "rti_state_from_numpy": lambda: rti_state_from_numpy(jst),
    }
    for what, call in calls.items():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
            call()
            pytest.fail(f"{what} ran without a card")
