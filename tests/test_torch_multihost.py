"""The port's multi-process layer (``parallel/multihost.py``) and 2-D mesh
solve (``parallel/mesh2d.py``), mirroring ``tests/test_multihost.py`` and
``tests/test_distributed.py``.

One pytest process plays one host on a mesh that names ``cpu`` eight
times: the process-major layout, ``local_batch``, the host-local round
trip, and a fleet tick through the I/O.  ``solve_box_qp_2d`` on a (2, 4)
(data, stage) mesh equals JAX's 2-D solve and the port's 1-D
stage-parallel solve within 1e-10 (f64), also at a horizon that 4 does not
divide.  Two real processes on gloo (``torch_distributed_worker.py``) run
the two-host fleet loop; their lanes equal a single-process run of the
port bit for bit and JAX's single-process fleet within 1e-9.
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_distributed_worker as worker
from nmpc_nav_control_tpu.control import make_controller as jmake
from nmpc_nav_control_tpu.control.state_machine import Measurements as JMeas
from nmpc_nav_control_tpu.control.state_machine import NavConfig as JNavConfig
from nmpc_nav_control_tpu.control.state_machine import on_goal_pose as jgoal
from nmpc_nav_control_tpu.parallel import make_mesh as jmesh
from nmpc_nav_control_tpu.parallel import solve_box_qp_2d as jsolve_2d
from nmpc_nav_control_tpu.parallel.fleet import Fleet as JFleet
from nmpc_nav_control_tpu.parallel.fleet import FleetGroup as JGroup
from nmpc_nav_control_tpu.qp.ipm import BoxQP as JBoxQP
from nmpc_nav_control_tpu.qp.ipm import solve_box_qp as jsolve
from nmpc_nav_control_tpu_torch.parallel import (
    Sharded,
    global_data_mesh,
    global_to_local,
    init_distributed,
    local_batch,
    local_to_global,
    make_mesh,
    qp_2d_shardings,
    solve_box_qp_2d,
)
from nmpc_nav_control_tpu_torch.parallel.fleet import Fleet
from nmpc_nav_control_tpu_torch.qp import BoxQP, solve_box_qp

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CPU8 = ["cpu"] * 8


def test_global_data_mesh_layout():
    mesh = global_data_mesh(devices=CPU8)
    assert mesh.axis_names == ("data",)
    assert mesh.size == 8 and mesh.shape == {"data": 8}
    procs = list(mesh.process_index)
    assert procs == sorted(procs) and len(mesh.local_devices()) == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            global_data_mesh()


def test_local_batch_divides():
    assert local_batch(32) == 32
    init_distributed()                       # nothing configured: a no-op
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("lanes", [16, 13])
def test_local_global_roundtrip(lanes):
    mesh = global_data_mesh(devices=CPU8)
    tree = {"a": np.arange(lanes, dtype=np.float32).reshape(lanes, 1),
            "b": np.ones((lanes, 3, 2), np.float64)}
    g = local_to_global(mesh, tree)
    assert isinstance(g, Sharded) and len(g.blocks) == 8
    assert [b["a"].shape[0] for b in g.blocks] == [lanes // 8 + (i < lanes % 8) for i in range(8)]
    back = global_to_local(g)
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["b"], tree["b"])
    assert global_to_local({"g": g})["g"]["b"].dtype == np.float64


def _qp(N, B=4, nx=4, nu=2, seed=2):
    """tests/test_multihost.py's 2-D instance."""
    rng = np.random.default_rng(seed)
    return dict(
        A=rng.normal(size=(B, N, nx, nx)) * 0.2 + np.eye(nx) * 0.9,
        B=rng.normal(size=(B, N, nx, nu)) * 0.4,
        c=rng.normal(size=(B, N, nx)) * 0.05,
        Qd=rng.uniform(0.5, 2.0, size=(B, N + 1, nx)),
        qx=rng.normal(size=(B, N + 1, nx)) * 0.5,
        Rd=rng.uniform(0.5, 2.0, size=(B, N, nu)),
        qu=rng.normal(size=(B, N, nu)) * 0.5,
        dx0=rng.normal(size=(B, nx)) * 0.1,
        lbx=np.full((B, N, 2), -1.0), ubx=np.full((B, N, 2), 1.0),
        lbu=np.full((B, N, 2), -2.0), ubu=np.full((B, N, 2), 2.0),
    )


@pytest.mark.parametrize("N", [16, 14])
def test_2d_mesh_box_ipm_matches_1d_and_jax(N):
    """N=16 against JAX's 2-D solve; N=14 (not a multiple of 4: stage
    blocks of 4, 4, 4, 2) against JAX's 1-D stage-parallel solve, as JAX's
    own 2-D solve needs the horizon to divide evenly."""
    idxbx, idxbu = (1, 3), (0, 1)
    d = _qp(N)
    mesh = make_mesh((2, 4), ("data", "stage"), devices=CPU8)
    assert qp_2d_shardings(mesh).A == ("data", "stage") and qp_2d_shardings(mesh).Qd == ("data",)
    qp = BoxQP(**{k: torch.tensor(v) for k, v in d.items()})
    sol_2d = solve_box_qp_2d(qp, idxbx, idxbu, mesh, iters=12)
    assert len(sol_2d.blocks) == 2
    sol_2d = sol_2d.gather()
    sol_1d = solve_box_qp(qp, idxbx, idxbu, iters=12, stage_parallel=True)
    jqp = JBoxQP(**{k: jnp.asarray(v) for k, v in d.items()})
    if N % 4 == 0:
        want = jsolve_2d(jqp, idxbx, idxbu, jmesh((2, 4), ("data", "stage")), iters=12)
    else:
        want = jax.jit(jax.vmap(lambda q: jsolve(q, idxbx, idxbu, iters=12,
                                                 stage_parallel=True)))(jqp)
    for name in ("dxs", "dus", "mu", "kkt_res"):
        got = getattr(sol_2d, name).numpy()
        np.testing.assert_allclose(got, getattr(sol_1d, name).numpy(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(got, np.asarray(getattr(want, name)), rtol=0, atol=1e-10)
    assert float(sol_2d.mu.max()) < 1e-8


def test_fleet_tick_through_multihost_io():
    """The documented loop in one process: host-local numpy robots in,
    a sharded tick, this host's lanes out; equal to the fleet without a
    mesh."""
    mesh = global_data_mesh(devices=CPU8)
    B = local_batch(worker.GLOBAL_B)
    on_mesh = worker.run(Fleet({"diff": worker.group(B)}, mesh=mesh, dtype=torch.float64), B,
                         worker.goals(), lambda m: local_to_global(mesh, m))
    plain = worker.run(Fleet({"diff": worker.group(B)}, dtype=torch.float64), B,
                       worker.goals(), _tensors)
    assert on_mesh["v"].shape == (worker.TICKS, B)
    assert np.isfinite(on_mesh["kkt"]).all() and (on_mesh["status"] == 1).all()
    for k in ("v", "w", "kkt"):
        np.testing.assert_allclose(on_mesh[k], plain[k], rtol=0, atol=1e-12)


def _tensors(meas):
    return type(meas)(*(torch.as_tensor(x) for x in meas))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_fleet():
    """JAX's single-process fleet on the same 16 robots: v, w [T, 16]."""
    spec, data = jmake("diff", worker.DT, worker.N, dtype=jnp.float64, **worker.DIFF)
    fleet = JFleet({"diff": JGroup(spec=spec, data=data, cfg=JNavConfig(path_capacity=4),
                                   batch=worker.GLOBAL_B)}, dtype=jnp.float64)
    fleet.set_states("diff", jax.vmap(jgoal)(fleet.states["diff"], jnp.asarray(worker.goals())))
    B = worker.GLOBAL_B
    meas = JMeas(pose=jnp.zeros((B, 3)), vel=jnp.zeros((B, 3)), steer_angle=jnp.zeros(B),
                 pose_valid=jnp.ones(B, bool), vel_valid=jnp.ones(B, bool),
                 steer_valid=jnp.ones(B, bool))
    outs = [fleet.tick({"diff": meas})["diff"] for _ in range(worker.TICKS)]
    return (np.stack([np.asarray(o.cmd.v) for o in outs]),
            np.stack([np.asarray(o.cmd.w) for o in outs]))


def test_two_process_fleet_matches_single_process(tmp_path):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "WORLD_SIZE", "RANK")}
    outs = [str(tmp_path / f"out_{pid}.npz") for pid in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_distributed_worker.py"),
                               str(pid), "2", str(port), outs[pid]],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for pid in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode())
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    d0, d1 = np.load(outs[0]), np.load(outs[1])
    assert d0["v"].shape == (worker.TICKS, 8)
    two = {k: np.concatenate([d0[k], d1[k]], axis=-1) for k in ("v", "w", "kkt", "status")}
    assert (two["status"] == 1).all()

    mesh = global_data_mesh(devices=CPU8)
    one = worker.run(Fleet({"diff": worker.group(worker.GLOBAL_B)}, mesh=mesh,
                           dtype=torch.float64), worker.GLOBAL_B, worker.goals(),
                     lambda m: local_to_global(mesh, m))
    for k in ("v", "w", "kkt", "status"):
        np.testing.assert_array_equal(two[k], one[k], err_msg=k)
    jv, jw = _jax_fleet()
    np.testing.assert_allclose(two["v"], jv, rtol=0, atol=1e-9)
    np.testing.assert_allclose(two["w"], jw, rtol=0, atol=1e-9)
