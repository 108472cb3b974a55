"""The simulated robots the benchmark drives: batched plants on any device.

Each robot's true state is (x, y, theta) and its lagged actuators: diff the
wheel speeds (vl, vr), omni4 (v1..v4), tric (v, alpha).  Actuators follow the
command's references with the configuration's time constants; one step is an
RK4 step of the control period, noise-free.  The pattern of
``examples/sim_pose_goal.py`` and ``runtime/simulation.py``, written again so
that the yardstick does not move with the program.
"""
from __future__ import annotations

import torch

from benchmark.reference.models import Robot, body_of_wheels, wheels_of_body


def size(robot: Robot) -> int:
    return 3 + robot.nu


def measure(robot: Robot, plant):
    """(pose [B, 3], body velocity (v, vn, w) [B, 3], steering angle [B])."""
    act, zero = plant[:, 3:], torch.zeros_like(plant[:, 0])
    if robot.geometry == "diff":
        vl, vr = act.unbind(-1)
        vel = [(vl + vr) / 2, zero, (vr - vl) / robot.p[0]]
        return plant[:, :3], torch.stack(vel, -1), zero
    if robot.geometry == "omni4":
        return plant[:, :3], torch.stack(body_of_wheels(robot, act), -1), zero
    return plant[:, :3], torch.stack([act[:, 0], zero, zero], -1), act[:, 1]


def references(robot: Robot, cmd, steer):
    """The actuator references [B, nu] of a command (v, vn, w) [B, 3]; tric's
    ``w`` is the steering-angle reference."""
    if robot.geometry == "tric":
        return cmd[:, [0, 2]]
    return wheels_of_body(robot, cmd, steer)


def _rates(robot: Robot, xp, ref):
    g, p = robot.geometry, robot.p
    th, act = xp[:, 2], xp[:, 3:]
    if g == "diff":
        v, w = (act[:, 0] + act[:, 1]) / 2, (act[:, 1] - act[:, 0]) / p[0]
        vx, vy, lag = v * torch.cos(th), v * torch.sin(th), (ref - act) / p[1]
    elif g == "omni4":
        v, vn, w = body_of_wheels(robot, act)
        vx, vy = v * torch.cos(th) - vn * torch.sin(th), v * torch.sin(th) + vn * torch.cos(th)
        lag = (ref - act) / p[1]
    else:
        v, al = act[:, 0], act[:, 1]
        vx, vy, w = v * torch.cos(th) * torch.cos(al), v * torch.sin(th) * torch.cos(al), \
            v * torch.sin(al) / p[0]
        lag = torch.stack([(ref[:, 0] - v) / p[1], (ref[:, 1] - al) / p[2]], -1)
    return torch.cat([torch.stack([vx, vy, w], -1), lag], -1)


def step(robot: Robot, plant, ref):
    """One control period on under the references ref [B, nu]."""
    h = robot.dt
    k1 = _rates(robot, plant, ref)
    k2 = _rates(robot, plant + h / 2 * k1, ref)
    k3 = _rates(robot, plant + h / 2 * k2, ref)
    k4 = _rates(robot, plant + h * k3, ref)
    return plant + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
