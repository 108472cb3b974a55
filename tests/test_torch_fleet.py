"""The port's mixed-geometry fleet (``parallel/fleet.py``) against JAX's.

``tests/test_fleet.py``'s diff + omni4 fleet plus a tric group, each lane a
GoToPose node with its own goal, ticks 3 times in the JAX package's
``Fleet`` on its 8-device CPU mesh and in the port's ``Fleet`` on the CPU:
without a mesh (one eager batched ``node_tick`` a group) and on a mesh
naming ``cpu`` eight times with 13 tric lanes (ragged blocks of 2 and 1).
From the same seeded measurements, every integer and bool leaf of the
outputs and states is equal and every float leaf within 1e-9 (f64).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmpc_nav_control_tpu.control.state_machine as JS
from nmpc_nav_control_tpu.control import make_controller as jmake
from nmpc_nav_control_tpu.parallel import make_mesh as jmesh
from nmpc_nav_control_tpu.parallel.fleet import Fleet as JFleet
from nmpc_nav_control_tpu.parallel.fleet import FleetGroup as JGroup
from nmpc_nav_control_tpu_torch import convert
from nmpc_nav_control_tpu_torch.control import make_controller
from nmpc_nav_control_tpu_torch.control import state_machine as TS
from nmpc_nav_control_tpu_torch.parallel import Sharded, gather, make_mesh
from nmpc_nav_control_tpu_torch.parallel.fleet import Fleet, FleetGroup
from nmpc_nav_control_tpu_torch.parallel.sharding import leaves

torch.set_num_threads(1)

N, DT, LANES, TICKS, TRIC_RAGGED = 10, 0.025, 16, 3, 13
GEOMETRIES = {
    "diff": dict(dist_b=0.27, tau_v=0.1, v_max=1.0, a_max=2.0,
                 q_diag=[10, 10, 5, 0, 0, 0, 0], r_diag=[1, 1]),
    "omni4": dict(l1_plus_l2=0.535, tau_v=0.1, v_max=1.0, a_max=1.0,
                  q_diag=[10.0, 10.0, 10.0] + [0.0] * 8, r_diag=[1.0] * 4),
    "tric": dict(dist_d=1.05, tau_v=0.1, tau_a=0.1, v_max=1.0, a_max=2.0,
                 alpha_min=-math.radians(60.0), alpha_max=math.radians(60.0),
                 dalpha_max=math.radians(90.0), q_diag=[10, 10, 5, 0, 0, 0, 0], r_diag=[1, 1]),
}


def _goals(k):
    rng = np.random.default_rng(k)
    return np.stack([rng.uniform(0.2, 0.9, LANES), rng.uniform(-0.3, 0.3, LANES),
                     rng.uniform(-0.5, 0.5, LANES)], -1)


def _meas(k, tick):
    """Seeded per-lane measurements for one tick (numpy leaves)."""
    rng = np.random.default_rng(100 * k + tick)
    return JS.Measurements(
        pose=rng.normal(size=(LANES, 3)) * 0.05, vel=rng.normal(size=(LANES, 3)) * 0.05,
        steer_angle=rng.normal(size=(LANES,)) * 0.05, pose_valid=np.ones(LANES, bool),
        vel_valid=np.ones(LANES, bool), steer_valid=np.ones(LANES, bool))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX fleet on its 8-device mesh: (initial states, [(states,
    outputs)] a tick), numpy leaves by group."""
    groups = {g: JGroup(*jmake(g, DT, N, ipm_iters=6, dtype=jnp.float64, **kw),
                        cfg=JS.NavConfig(path_capacity=4), batch=LANES)
              for g, kw in GEOMETRIES.items()}
    fleet = JFleet(groups, mesh=jmesh((8,), ("data",)), dtype=jnp.float64)
    init = {}
    for k, g in enumerate(groups):
        init[g] = jax.vmap(JS.on_goal_pose)(fleet.states[g], jnp.asarray(_goals(k)))
        fleet.set_states(g, init[g])
    ticks = []
    for t in range(TICKS):
        outs = fleet.tick({g: jax.tree_util.tree_map(jnp.asarray, _meas(k, t))
                           for k, g in enumerate(groups)})
        ticks.append({g: (jax.tree_util.tree_map(np.asarray, fleet.states[g]),
                          jax.tree_util.tree_map(np.asarray, outs[g])) for g in groups})
    return {g: jax.tree_util.tree_map(np.asarray, s) for g, s in init.items()}, ticks


def _compare(got, want, lanes, what):
    got_l = [x.numpy() for x in leaves(got)]
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l), what
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        w = w[:lanes]
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9, err_msg=f"{what} leaf {i}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("on_mesh", [False, True])
def test_fleet_matches_jax(jax_run, on_mesh):
    init, ticks = jax_run
    lanes = {g: TRIC_RAGGED if (on_mesh and g == "tric") else LANES for g in GEOMETRIES}
    groups = {g: FleetGroup(*make_controller(g, DT, N, ipm_iters=6, dtype=torch.float64,
                                             device="cpu", **kw),
                            cfg=TS.NavConfig(path_capacity=4), batch=lanes[g])
              for g, kw in GEOMETRIES.items()}
    mesh = make_mesh((8,), ("data",), devices=["cpu"] * 8) if on_mesh else None
    fleet = Fleet(groups, mesh=mesh, dtype=torch.float64)
    assert fleet.total_scenarios == sum(lanes.values())
    for g in groups:
        state = convert.node_state_from_numpy(init[g], device="cpu", dtype=torch.float64)
        fleet.set_states(g, TS.NodeState(*(_first_lanes(x, lanes[g]) for x in state)))
    if on_mesh:
        navs = fleet.navigators["tric"]
        assert [n.state.status.shape[0] for n in navs] == [2, 2, 2, 2, 2, 1, 1, 1]
    for t in range(TICKS):
        meas = {g: convert.measurements_from_numpy(_meas(k, t), device="cpu", dtype=torch.float64)
                for k, g in enumerate(groups)}
        outs = fleet.tick({g: _first_lanes(m, lanes[g]) for g, m in meas.items()})
        for g in groups:
            assert isinstance(outs[g], Sharded) == on_mesh
            assert isinstance(fleet.states[g], Sharded) == on_mesh
            want_state, want_out = ticks[t][g]
            _compare(gather(outs[g]), want_out, lanes[g], f"{g} tick {t} outputs")
            _compare(gather(fleet.states[g]), want_state, lanes[g], f"{g} tick {t} state")
    status = gather(fleet.states["diff"]).status
    assert (status == TS.GO_TO_POSE).all()


def _first_lanes(tree, lanes):
    """The first ``lanes`` lanes of a port tree."""
    if isinstance(tree, tuple):
        return type(tree)(*(_first_lanes(x, lanes) for x in tree))
    return tree[:lanes]
