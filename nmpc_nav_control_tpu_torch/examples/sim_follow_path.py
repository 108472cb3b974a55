"""Closed-loop path-following simulation demo.

Port of ``examples/sim_follow_path.py``: the whole navigation stack (path
ingest, windowing, nearest-point projection, discretization, safety
checks, NMPC) through the port's host node, ``runtime.NmpcNavControlNode``
(its tick a CUDA graph on the card, eager with ``--device cpu``), against a
simulated differential-drive plant.

Usage:
  python -m nmpc_nav_control_tpu_torch.examples.sim_follow_path [--ticks 1200]
      [--device cuda] [--seed 0] [--plot]

The plant has no noise; ``--seed`` seeds torch's generators for the form
of the command line the pose-goal demo shares.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from nmpc_nav_control_tpu_torch.runtime import (
    NmpcNavControlNode,
    ParametricPath,
    ParametricPathSet2,
    from_dict,
)

DTYPE = torch.float32


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=1200)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plot", action="store_true")
    args = ap.parse_args(argv)
    torch.manual_seed(args.seed)

    node = NmpcNavControlNode(from_dict({
        "steering_geometry": "diff",
        "control_freq": 40, "tf_ini": 1.0,
        "rob_dist_between_wh": 0.27, "rob_wh_vel_time_const": 0.1,
        "rob_wh_max_vel": 1.0, "rob_wh_max_ace": 2.0,
        "cost_matrix_weights_state_diag": [10, 10, 5, 0, 0, 0, 0],
        "cost_matrix_weights_input_diag": [1, 1],
        "final_position_error": 0.03, "final_orientation_error": 3.0,
    }), dtype=DTYPE, device=args.device, debug_outputs=True)

    # An S-shaped two-segment path: straight then a gentle arc (quadratic).
    node.on_path_no_stack_up_2(ParametricPathSet2(paths=[
        ParametricPath(frame_id="map", cx=[0.0, 1.0], cy=[0.0, 0.0], velocity=0.5),
        ParametricPath(frame_id="map", cx=[1.0, 1.0, 0.0], cy=[0.0, 0.0, 0.3], velocity=0.5),
    ], request_id=1))

    plant = np.zeros(5)  # x, y, theta, vl, vr
    xs, ys, finished = [], [], None
    for t in range(args.ticks):
        vl, vr = plant[3], plant[4]
        vel = ((vl + vr) / 2, 0.0, (vr - vl) / 0.27)
        twist, status = node.tick(tuple(plant[:3]), vel)
        if status.status == 0:  # finished -> Idle
            finished = t
            print(f"path finished at t={t * 0.025:.2f}s")
            break
        if twist is None:
            print(f"no command at t={t * 0.025:.2f}s (status {status.status})")
            break
        vl_ref = twist.linear_x - 0.5 * 0.27 * twist.angular_z
        vr_ref = twist.linear_x + 0.5 * 0.27 * twist.angular_z
        for _ in range(5):  # 5 kHz Euler plant
            v = (plant[3] + plant[4]) / 2
            w = (plant[4] - plant[3]) / 0.27
            plant[0] += v * math.cos(plant[2]) * 0.005
            plant[1] += v * math.sin(plant[2]) * 0.005
            plant[2] += w * 0.005
            plant[3] += (vl_ref - plant[3]) / 0.1 * 0.005
            plant[4] += (vr_ref - plant[4]) / 0.1 * 0.005
        xs.append(plant[0])
        ys.append(plant[1])
        if t % 80 == 0:
            print(f"t={t*0.025:5.2f}s pos=({plant[0]:+.3f},{plant[1]:+.3f}) "
                  f"remains={status.path_remains:.2f}")

    print(f"final pos=({plant[0]:.3f},{plant[1]:.3f}) — path end (2.0, 0.3)")
    stats = node.timing_stats()
    print(f"cycles={stats['cycles']} p50={stats['p50_ms']:.1f}ms "
          f"p99={stats['p99_ms']:.1f}ms budget={stats['budget_ms']:.0f}ms")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.plot(xs, ys, label="robot")
        u = np.linspace(0, 1, 50)
        plt.plot(u, 0 * u, "--", label="segment 1")
        plt.plot(1 + u, 0.3 * u * u, "--", label="segment 2")
        plt.axis("equal")
        plt.legend()
        plt.savefig("sim_follow_path.png", dpi=120)
        print("saved sim_follow_path.png")
    return dict(xs=xs, ys=ys, plant=plant.tolist(), finished=finished, stats=stats)


if __name__ == "__main__":
    main()
