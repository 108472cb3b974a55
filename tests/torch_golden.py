"""Replay a committed golden closed loop through the torch port.

The goldens (``tests/goldens/*.npz``) hold closed-loop u-trajectories of the
NumPy float64 RTI oracle (``tests/oracle/numpy_rti.py``).  ``track`` drives
the same scenario through the port's batched ``controller_step`` with one
lane, on a given device, against the same f64 plant, and returns the
deviations that ``tests/test_rti_oracle.py`` bounds.  No JAX: shared by
``tests/test_torch_rti_oracle.py`` (CPU) and ``chip_smoke.py`` (the card).
The IPM route follows ``NMPC_TPU_TILED_IPM`` as everywhere in the port.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from nmpc_nav_control_tpu_torch.control import (
    GraphedController,
    controller_init,
    controller_step,
    make_controller,
)
from oracle.numpy_rti import Scenario, closed_loop

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")

# The bounds of tests/test_rti_oracle.py for the f32 production path.
U_TOL = 5e-3
U_MEAN_TOL = 2e-4
POSE_TOL = 5e-3


def load(name):
    data = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    meta = json.loads(bytes(data["meta"]).decode())
    meta = {k: (tuple(v) if isinstance(v, list) else v) for k, v in meta.items()}
    return Scenario(**meta), data


def make_port_controller(sc: Scenario, dtype=torch.float32, device="cpu"):
    """The port's controller for a golden scenario (any geometry), built as
    ``tests/test_rti_oracle.py`` builds the JAX one."""
    kw = dict(q_diag=list(sc.q), r_diag=list(sc.r), dtype=dtype, device=device)
    if sc.geometry == "diff":
        return make_controller("diff", sc.dt, sc.N, dist_b=sc.p[0], tau_v=sc.p[1],
                               v_max=sc.ubx[0], a_max=sc.ubu[0], **kw)
    if sc.geometry == "omni4":
        return make_controller("omni4", sc.dt, sc.N, l1_plus_l2=sc.p[0], tau_v=sc.p[1],
                               v_max=sc.ubx[0], a_max=sc.ubu[0], **kw)
    return make_controller(
        "tric", sc.dt, sc.N, dist_d=sc.p[0], tau_v=sc.p[1], tau_a=sc.p[2],
        v_max=sc.ubx[0], a_max=sc.ubu[0], alpha_min=sc.lbx[1], alpha_max=sc.ubx[1],
        dalpha_max=sc.ubu[1], tric_bug_compat=(sc.geometry == "tric_bug"), **kw)


def port_step_fn(sc: Scenario, dtype=torch.float32, device="cpu", graphed=False):
    """``closed_loop`` step function backed by the port; ``graphed`` runs
    each tick as a replay of ``GraphedController`` (a CUDA device only)."""
    spec, data = make_port_controller(sc, dtype, device)
    holder = {"state": controller_init(spec, 1, dtype, device)}
    if graphed:
        tick = GraphedController(spec, data, 1).step
    else:
        def tick(*args, steer_angle):
            return controller_step(spec, data, holder["state"], *args, steer_angle=steer_angle)

    def lane(x):
        return torch.as_tensor(np.asarray(x, float)[None], dtype=dtype, device=device)

    def step_fn(pose, vel, steer, traj, n_valid):
        state, cmd, stats = tick(lane(pose), lane(vel), lane(traj),
                                 torch.tensor([n_valid], device=device), steer_angle=lane(steer))
        holder["state"] = state
        return (state.us[0, 0].double().cpu().numpy(),
                torch.stack([cmd.v, cmd.vn, cmd.w], -1)[0].double().cpu().numpy())

    return step_fn


def track(name, dtype=torch.float32, device="cpu", graphed=False):
    """Max/mean |u - u_gold|, final pose divergence and max |cmd - cmd_gold|."""
    sc, gold = load(name)
    run = closed_loop(sc, step_fn=port_step_fn(sc, dtype, device, graphed))
    du = np.abs(run["us"] - gold["us"])
    return dict(
        u_max=float(du.max()), u_mean=float(du.mean()),
        pose=float(np.abs(run["xs_plant"][-1, :3] - gold["xs_plant"][-1, :3]).max()),
        cmd_max=float(np.abs(run["cmds"] - gold["cmds"]).max()),
    )


def within_tolerance(err) -> bool:
    return (err["u_max"] < U_TOL and err["u_mean"] < U_MEAN_TOL
            and err["pose"] < POSE_TOL and err["cmd_max"] < 5 * U_TOL)
