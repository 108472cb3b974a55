"""The port's batched diff controller tick against JAX, end to end on the CPU.

Five chained ``controller_step`` ticks at diff N=10, B=8 through the port
(plain sweeps on CPU tensors) and through ``jax.jit(jax.vmap(
controller_step))`` on JAX's default CPU path (the serial per-problem IPM),
from the same numpy inputs: pose-goal lanes, path-following lanes whose
reference headings cross +-pi, and goals far enough away to saturate the
input bounds.  f64 agrees to rounding (the port's IPM guards follow the
dtype as the JAX serial path's do); f32 within the batched-vs-serial bound
of ``tests/test_qp.py``.  Also: ``convert.py`` round-trips state between
the packages, and the geometries not ported yet raise.
"""
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
from nmpc_nav_control_tpu_torch.convert import (
    ocp_data_from_numpy,
    rti_state_from_numpy,
    rti_state_to_numpy,
)

torch.set_num_threads(1)

N, B, TICKS = 10, 8, 5
KW = dict(dist_b=0.27, tau_v=0.1, v_max=1.0, a_max=2.0,
          q_diag=[10.0, 10.0, 5.0, 0, 0, 0, 0], r_diag=[1.0, 1.0], ipm_iters=8)
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
    return jax.jit(jax.vmap(lambda s, p, v, t, n: jstep(jspec, jdata, s, p, v, t, n)))


def _jax_state(jspec, jdt):
    st0 = jinit(jspec, jdt)
    return jax.tree_util.tree_map(lambda x: jnp.tile(x[None], (B,) + (1,) * x.ndim), st0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_batched_ticks_match_jax(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jspec, jdata = jmake("diff", 0.025, N, dtype=jdt, **KW)
    spec, data = make_controller("diff", 0.025, N, dtype=tdt, **KW)
    assert spec.rti.spars == jspec.rti.spars
    tick = _jax_tick(jspec, jdata)
    poses, vels, trajs, n_valid = _inputs()
    jst, st = _jax_state(jspec, jdt), controller_init(spec, B, tdt)
    tol = TOL[dtype]
    for k in range(TICKS):
        jst, jcmd, jstats = tick(jst, jnp.asarray(poses, jdt), jnp.asarray(vels, jdt),
                                 jnp.asarray(trajs, jdt), jnp.asarray(n_valid))
        st, cmd, stats = controller_step(
            spec, data, st, torch.tensor(poses, dtype=tdt), torch.tensor(vels, dtype=tdt),
            torch.tensor(trajs, dtype=tdt), torch.tensor(n_valid))
        for name in ("us", "xs", "x0_carry"):
            np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(jst, name)),
                                       err_msg=f"tick {k} {name}", **tol)
        for name in ("kkt_res", "mu"):
            np.testing.assert_allclose(getattr(stats, name).numpy(),
                                       np.asarray(getattr(jstats, name)),
                                       err_msg=f"tick {k} {name}", **tol)
        for name in ("v", "vn", "w"):
            np.testing.assert_allclose(getattr(cmd, name).numpy(), np.asarray(getattr(jcmd, name)),
                                       err_msg=f"tick {k} cmd.{name}", **tol)
        assert bool(stats.ok.all()) and bool(np.asarray(jstats.ok).all())
        poses = poses + 0.02 * vels   # the robots move between ticks
    # Some lanes ran against their input bounds (the active-set case).
    assert np.abs(st.us.numpy()).max() > 0.99 * KW["a_max"]


def test_convert_round_trips_state_between_packages():
    """A JAX state continues in the port and comes back to JAX unchanged."""
    jspec, jdata = jmake("diff", 0.025, N, dtype=jnp.float64, **KW)
    spec, data = make_controller("diff", 0.025, N, dtype=torch.float64, **KW)
    port_data = ocp_data_from_numpy(jax.tree_util.tree_map(np.asarray, jdata))
    for got, want in zip(port_data, data):
        assert torch.equal(got, want)
    tick = _jax_tick(jspec, jdata)
    poses, vels, trajs, n_valid = _inputs(1)
    jargs = (jnp.asarray(poses), jnp.asarray(vels), jnp.asarray(trajs), jnp.asarray(n_valid))
    targs = (torch.tensor(poses), torch.tensor(vels), torch.tensor(trajs), torch.tensor(n_valid))
    jst, _, _ = tick(_jax_state(jspec, jnp.float64), *jargs)

    st = rti_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst), dtype=torch.float64)
    back = JRTIState(*rti_state_to_numpy(st))
    for a, b in zip(back, jst):
        np.testing.assert_array_equal(a, np.asarray(b))
    st, _, _ = controller_step(spec, port_data, st, *targs)
    jst, _, _ = tick(jst, *jargs)
    np.testing.assert_allclose(rti_state_to_numpy(st).us, np.asarray(jst.us), rtol=0, atol=1e-8)

    one = rti_state_from_numpy(jax.tree_util.tree_map(lambda x: np.asarray(x[0]), jst))
    assert one.xs.shape == (1, N + 1, 7)
    reset = controller_reset(st)
    assert not bool(reset.xs.any()) and torch.equal(reset.x0_carry, st.x0_carry)


@pytest.mark.parametrize("geometry", ["omni4", "tric"])
def test_geometries_not_ported_yet_raise(geometry):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_controller(geometry, 0.025, N, q_diag=[1.0] * 7, r_diag=[1.0] * 2)
