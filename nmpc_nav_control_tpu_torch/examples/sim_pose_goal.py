"""Closed-loop pose-goal simulation demo.

Port of ``examples/sim_pose_goal.py``: a noisy plant driven by the
controller at 40 Hz, with an optional matplotlib trajectory plot.  On the
card the controller is a ``control.GraphedController`` (its tick one CUDA
graph); with ``--device cpu`` it runs ``controller_step`` eagerly.

Usage:
  python -m nmpc_nav_control_tpu_torch.examples.sim_pose_goal [diff|omni4|tric]
      [--goal X Y THETA] [--noise 0.05] [--ticks 600] [--horizon 40]
      [--device cuda] [--seed 0] [--plot]

Actuation noise comes from a seeded ``torch.Generator`` on the CPU, so a
run is the same on any device but differs from the JAX script's
``jax.random`` stream; at ``--noise 0`` both are deterministic.  The plant
and its kinematics (``measure``, ``references``, ``plant_step``) take a
batch of robots and the controller's model parameters ``p`` (the JAX
script writes the same numbers as constants), so a fleet of any
controller's robots can drive them (``chip_smoke.py`` phase 13).
"""
from __future__ import annotations

import argparse
import math

import torch

from nmpc_nav_control_tpu_torch.control import (
    GraphedController,
    controller_init,
    controller_step,
    make_controller,
)
from nmpc_nav_control_tpu_torch.models import diff, omni4
from nmpc_nav_control_tpu_torch.ocp.integrator import rk4_step

DT = 0.025
# The reference horizon is N = 80 (tf_ini = 2 s at 40 Hz); the JAX script
# runs N = 40 by default: pass --horizon 80 for the reference's.
N = 40
DTYPE = torch.float32


def build(geometry: str, dtype, N, device="cuda"):
    """The script's controller for a geometry."""
    if geometry == "diff":
        return make_controller(
            "diff", DT, N, dist_b=0.27, tau_v=0.1, v_max=1.0, a_max=2.0,
            q_diag=[10.0, 10.0, 5.0, 0, 0, 0, 0], r_diag=[1.0, 1.0], dtype=dtype, device=device)
    if geometry == "omni4":
        return make_controller(
            "omni4", DT, N, l1_plus_l2=0.535, tau_v=0.1, v_max=1.0, a_max=1.0,
            q_diag=[10.0, 10.0, 10.0] + [0.0] * 8, r_diag=[1.0] * 4, dtype=dtype, device=device)
    return make_controller(
        "tric", DT, N, dist_d=0.27, tau_v=0.1, tau_a=0.5, v_max=1.0, a_max=1.0,
        alpha_min=-math.radians(30), alpha_max=math.radians(30),
        dalpha_max=math.radians(120),
        q_diag=[10.0, 10.0, 5.0, 0, 0, 0, 0], r_diag=[1.0, 1.0], dtype=dtype, device=device)


def plant_size(geometry: str) -> int:
    """diff (x, y, theta, vl, vr), omni4 (x, y, theta, v1..v4), tric
    (x, y, theta, v, alpha)."""
    return 7 if geometry == "omni4" else 5


def measure(geometry: str, plant, p):
    """What the controller reads from plants [B, nxp]: (pose [B, 3],
    vel [B, 3] body (v, vn, w), steering angle [B]); ``p`` the
    controller's parameters (diff: dist_b, tau_v; omni4: l1_plus_l2,
    tau_v; tric: dist_d, tau_v, tau_a)."""
    zero = torch.zeros_like(plant[:, 0])
    if geometry == "diff":
        vl, vr = plant[:, 3], plant[:, 4]
        return plant[:, :3], torch.stack([(vl + vr) / 2, zero, (vr - vl) / p[0]], -1), zero
    if geometry == "omni4":
        vel = omni4.inverse_kinematics(*plant[:, 3:7].unbind(-1), p[0])
        return plant[:, :3], torch.stack(vel, -1), zero
    return plant[:, :3], torch.stack([plant[:, 3], zero, zero], -1), plant[:, 4]


def references(geometry: str, cmd, p):
    """The actuator references [B, nu] of a command: wheel speeds (diff,
    omni4) or (v_ref, alpha_ref) (tric)."""
    if geometry == "diff":
        return torch.stack(diff.direct_kinematics(cmd.v, cmd.w, p[0]), -1)
    if geometry == "omni4":
        return torch.stack(omni4.direct_kinematics(cmd.v, cmd.vn, cmd.w, p[0]), -1)
    return torch.stack([cmd.v, cmd.w], -1)


def _plant_f(geometry: str):
    """Continuous plant dynamics, batched: xp [B, nxp], u [B, nu]; the
    actuators follow their references with the controller's time
    constants."""
    if geometry == "diff":
        def f(xp, u, p):
            th, vl, vr = xp[:, 2], xp[:, 3], xp[:, 4]
            vb = 0.5 * (vl + vr)
            return torch.stack([vb * torch.cos(th), vb * torch.sin(th), (vr - vl) / p[0],
                                (u[:, 0] - vl) / p[1], (u[:, 1] - vr) / p[1]], -1)
    elif geometry == "omni4":
        def f(xp, u, p):
            th, wv = xp[:, 2], xp[:, 3:7]
            v, vn, w = omni4.inverse_kinematics(*wv.unbind(-1), p[0])
            ct, st = torch.cos(th), torch.sin(th)
            return torch.cat([torch.stack([v * ct - vn * st, v * st + vn * ct, w], -1),
                              (u - wv) / p[1]], -1)
    else:
        def f(xp, u, p):
            th, v, al = xp[:, 2], xp[:, 3], xp[:, 4]
            return torch.stack([v * torch.cos(th) * torch.cos(al),
                                v * torch.sin(th) * torch.cos(al),
                                v / p[0] * torch.sin(al),
                                (u[:, 0] - v) / p[1], (u[:, 1] - al) / p[2]], -1)
    return f


def plant_step(geometry: str, plant, refs, p):
    """One RK4 step of DT of plants [B, nxp] under references [B, nu]."""
    return rk4_step(_plant_f(geometry), plant, refs, p, DT)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("geometry", nargs="?", default="diff", choices=["diff", "omni4", "tric"])
    ap.add_argument("--goal", nargs=3, type=float, default=[1.0, 0.3, 0.5])
    ap.add_argument("--noise", type=float, default=0.05,
                    help="actuation noise sigma (acados_sim_diff.py:148-159)")
    ap.add_argument("--ticks", type=int, default=600)
    ap.add_argument("--horizon", type=int, default=N)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="seed of the actuation noise")
    ap.add_argument("--plot", action="store_true")
    args = ap.parse_args(argv)

    device, dtype, geom, n = torch.device(args.device), DTYPE, args.geometry, args.horizon
    spec, data = build(geom, dtype, n, device)
    traj = torch.zeros((1, n + 1, 3), dtype=dtype, device=device)
    traj[0, 0] = torch.tensor(args.goal, dtype=dtype)
    n_valid = torch.ones(1, dtype=torch.long, device=device)
    if device.type == "cuda":
        graphed = GraphedController(spec, data, 1)

        def control(pose, vel, steer):
            return graphed.step(pose, vel, traj, n_valid, steer)[1:]
    else:
        state = controller_init(spec, 1, dtype, device)

        def control(pose, vel, steer):
            nonlocal state
            state, cmd, stats = controller_step(spec, data, state, pose, vel, traj, n_valid,
                                                steer_angle=steer)
            return cmd, stats

    gen = torch.Generator().manual_seed(args.seed)
    plant = torch.zeros((1, plant_size(geom)), dtype=dtype, device=device)
    xs, ys = [], []
    for t in range(args.ticks):
        cmd, stats = control(*measure(geom, plant, data.p))
        refs = references(geom, cmd, data.p)
        noise = torch.randn(refs.shape, generator=gen, dtype=dtype).to(device)
        plant = plant_step(geom, plant, refs + args.noise * noise, data.p)
        p = plant[0].tolist()
        xs.append(p[0])
        ys.append(p[1])
        if t % 80 == 0:
            print(f"t={t * DT:5.2f}s pos=({p[0]:+.3f},{p[1]:+.3f}) "
                  f"theta={p[2]:+.3f} kkt={float(stats.kkt_res[0]):.2e}")

    p = plant[0].tolist()
    err = math.hypot(p[0] - args.goal[0], p[1] - args.goal[1])
    print(f"final position error: {err * 100:.1f} cm (noise sigma={args.noise})")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.plot(xs, ys, "-")
        plt.plot([args.goal[0]], [args.goal[1]], "r*", markersize=12)
        plt.axis("equal")
        plt.savefig("sim_pose_goal.png", dpi=120)
        print("saved sim_pose_goal.png")
    return dict(xs=xs, ys=ys, plant=p, final_error=err)


if __name__ == "__main__":
    main()
