"""Replay a committed golden closed loop through the torch port.

The goldens (``tests/goldens/*.npz``) hold closed-loop u-trajectories of the
NumPy float64 RTI oracle (``tests/oracle/numpy_rti.py``).  ``track`` drives
the same scenario through the port's batched ``controller_step`` with one
lane, on a given device, against the same f64 plant, and returns the
deviations that ``tests/test_rti_oracle.py`` bounds.  No JAX: shared by
``tests/test_torch_rti_oracle.py`` (CPU) and ``chip_smoke.py`` (the card).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from nmpc_nav_control_tpu_torch.control import (
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


def port_step_fn(sc: Scenario, dtype=torch.float32, device="cpu"):
    """``closed_loop`` step function backed by the port (diff geometry)."""
    spec, data = make_controller(
        "diff", sc.dt, sc.N, dist_b=sc.p[0], tau_v=sc.p[1], v_max=sc.ubx[0],
        a_max=sc.ubu[0], q_diag=list(sc.q), r_diag=list(sc.r), dtype=dtype,
        device=device)
    holder = {"state": controller_init(spec, 1, dtype, device)}

    def lane(x):
        return torch.as_tensor(np.asarray(x, float)[None], dtype=dtype, device=device)

    def step_fn(pose, vel, steer, traj, n_valid):
        state, cmd, stats = controller_step(
            spec, data, holder["state"], lane(pose), lane(vel), lane(traj),
            torch.tensor([n_valid], device=device))
        holder["state"] = state
        return (state.us[0, 0].double().cpu().numpy(),
                torch.stack([cmd.v, cmd.vn, cmd.w], -1)[0].double().cpu().numpy())

    return step_fn


def track(name, dtype=torch.float32, device="cpu"):
    """Max/mean |u - u_gold|, final pose divergence and max |cmd - cmd_gold|."""
    sc, gold = load(name)
    run = closed_loop(sc, step_fn=port_step_fn(sc, dtype, device))
    du = np.abs(run["us"] - gold["us"])
    return dict(
        u_max=float(du.max()), u_mean=float(du.mean()),
        pose=float(np.abs(run["xs_plant"][-1, :3] - gold["xs_plant"][-1, :3]).max()),
        cmd_max=float(np.abs(run["cmds"] - gold["cmds"]).max()),
    )


def within_tolerance(err) -> bool:
    return (err["u_max"] < U_TOL and err["u_mean"] < U_MEAN_TOL
            and err["pose"] < POSE_TOL and err["cmd_max"] < 5 * U_TOL)
