"""Plain reference of the three wheeled-robot models and their parameters.

Written from the upstream project's model equations (JorgeDFR/nmpc_nav_control,
``scripts/*/*_model.py``) and parameter names (``config/nmpc_nav_control.yaml``),
not from the measured program.  States, inputs and their orderings:

  diff   x = (x, y, theta, vl, vr, vl_ref, vr_ref),  u = (dvl_ref, dvr_ref)
  omni4  x = (x, y, theta, v1..v4, v1_ref..v4_ref),  u = (dv1_ref..dv4_ref)
  tric   x = (x, y, theta, v, alpha, v_ref, alpha_ref), u = (dv_ref, dalpha_ref)

Every function takes entries on the LAST axis and any leading axes.
"""
from __future__ import annotations

import dataclasses
import math

import torch

DEG = math.pi / 180.0


@dataclasses.dataclass(frozen=True)
class Robot:
    """One configuration's controller, as the upstream YAML states it."""

    geometry: str
    dt: float
    N: int
    p: tuple                 # model parameters
    lbx: tuple               # bounds of the reference states, stages 1..N
    ubx: tuple
    lbu: tuple               # bounds of the inputs, stages 0..N-1
    ubu: tuple
    q: tuple                 # state weights (also the terminal weights)
    r: tuple                 # input weights
    nav: dict                # the navigation limits (angles in radians)

    @property
    def nx(self) -> int:
        return 11 if self.geometry == "omni4" else 7

    @property
    def nu(self) -> int:
        return 4 if self.geometry == "omni4" else 2

    @property
    def ibx(self) -> list:
        """The bounded (reference) states: the last nu entries."""
        return list(range(self.nx - self.nu, self.nx))


def robot_from_yaml(raw: dict) -> Robot:
    """A ``Robot`` from the upstream parameter names (degrees converted)."""
    g = raw["steering_geometry"]
    dt = 1.0 / float(raw["control_freq"])
    N = int(math.ceil(float(raw["tf_ini"]) / dt))
    tau_v, v_max, a_max = (float(raw[k]) for k in
                           ("rob_wh_vel_time_const", "rob_wh_max_vel", "rob_wh_max_ace"))
    if g == "diff":
        p = (float(raw["rob_dist_between_wh"]), tau_v)
        lbx, ubx, lbu, ubu = (-v_max,) * 2, (v_max,) * 2, (-a_max,) * 2, (a_max,) * 2
    elif g == "omni4":
        p = (float(raw["rob_dist_between_front_back_wh"])
             + float(raw["rob_dist_between_left_right_wh"]), tau_v)
        lbx, ubx, lbu, ubu = (-v_max,) * 4, (v_max,) * 4, (-a_max,) * 4, (a_max,) * 4
    elif g == "tric":
        p = (float(raw["rob_dist_between_steering_back_wh"]), tau_v,
             float(raw["rob_steer_wh_angle_time_const"]))
        lbx = (-v_max, float(raw["rob_steer_wh_min_angle"]) * DEG)
        ubx = (v_max, float(raw["rob_steer_wh_max_angle"]) * DEG)
        dal = float(raw["rob_steer_wh_max_angle_var"]) * DEG
        lbu, ubu = (-a_max, -dal), (a_max, dal)
    else:
        raise ValueError(f"unknown steering geometry {g!r}")
    nav = dict(
        final_position_error=float(raw["final_position_error"]),
        final_orientation_error=float(raw["final_orientation_error"]) * DEG,
        enable_safe_conditions=bool(raw["enable_safe_conditions"]),
        max_goal_pose_dist=float(raw["max_goal_pose_dist"]),
        max_pos_error_to_path=float(raw["max_pos_error_to_path"]),
        max_ori_error_to_path=float(raw["max_ori_error_to_path"]) * DEG,
        max_active_path_length=float(raw["max_active_path_length"]),
    )
    return Robot(g, dt, N, p, lbx, ubx, lbu, ubu,
                 tuple(map(float, raw["cost_matrix_weights_state_diag"])),
                 tuple(map(float, raw["cost_matrix_weights_input_diag"])), nav)


def xdot(robot: Robot, x, u):
    """Continuous dynamics: x [..., nx], u [..., nu] -> [..., nx]."""
    g, p = robot.geometry, robot.p
    th = x[..., 2]
    if g == "diff":
        vl, vr = x[..., 3], x[..., 4]
        v = (vl + vr) / 2
        rates = [v * torch.cos(th), v * torch.sin(th), (vr - vl) / p[0],
                 (x[..., 5] - vl) / p[1], (x[..., 6] - vr) / p[1]]
    elif g == "omni4":
        v, vn, w = body_of_wheels(robot, x[..., 3:7])
        rates = [v * torch.cos(th) - vn * torch.sin(th), v * torch.sin(th) + vn * torch.cos(th), w]
        rates += [(x[..., 7 + i] - x[..., 3 + i]) / p[1] for i in range(4)]
    else:
        v, al = x[..., 3], x[..., 4]
        rates = [v * torch.cos(th) * torch.cos(al), v * torch.sin(th) * torch.cos(al),
                 v * torch.sin(al) / p[0], (x[..., 5] - v) / p[1], (x[..., 6] - al) / p[2]]
    return torch.cat([torch.stack(rates, -1), u], -1)


def rk4(robot: Robot, x, u):
    """One classical Runge-Kutta step of ``robot.dt``."""
    h = robot.dt
    k1 = xdot(robot, x, u)
    k2 = xdot(robot, x + h / 2 * k1, u)
    k3 = xdot(robot, x + h / 2 * k2, u)
    k4 = xdot(robot, x + h * k3, u)
    return x + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def wheels_of_body(robot: Robot, vel, steer):
    """The measured actuator entries of the state from the body velocity
    (v, vn, w) [..., 3] and the steering angle [...]: [..., nu]."""
    v, vn, w = vel.unbind(-1)
    if robot.geometry == "diff":
        b = robot.p[0]
        return torch.stack([v - b / 2 * w, v + b / 2 * w], -1)
    if robot.geometry == "omni4":
        hw = robot.p[0] / 2 * w
        return torch.stack([v - vn - hw, -v - vn - hw, v + vn - hw, -v + vn - hw], -1)
    return torch.stack([v, steer], -1)


def body_of_wheels(robot: Robot, wheels):
    """omni4 wheel speeds [..., 4] -> body (v, vn, w)."""
    v1, v2, v3, v4 = wheels.unbind(-1)
    return ((v1 - v2 + v3 - v4) / 4, (-v1 - v2 + v3 + v4) / 4,
            -(v1 + v2 + v3 + v4) / (2 * robot.p[0]))


def command_of_refs(robot: Robot, refs):
    """The published (v, vn, w) of the integrated actuator references."""
    if robot.geometry == "diff":
        vl, vr = refs.unbind(-1)
        return torch.stack([(vl + vr) / 2, torch.zeros_like(vl), (vr - vl) / robot.p[0]], -1)
    if robot.geometry == "omni4":
        return torch.stack(body_of_wheels(robot, refs), -1)
    return torch.stack([refs[..., 0], torch.zeros_like(refs[..., 0]), refs[..., 1]], -1)
