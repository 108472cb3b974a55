"""Host-side state ingest: the TF-acquisition boundary.

The reference pulls robot state from tf2 (``NMPCNavControlROS.cpp:401-506``);
here it is the host-side boundary where measurements enter the node's
tick.  Port of ``nmpc_nav_control_tpu/runtime/ingest.py`` (plain ``math``,
no tensors).  This module reproduces the reference's estimation
logic so any pose source (mocap, localization, sim) plugs in:

  - ``unwrap_pose_theta``: the +-2pi unwrap-vs-last-theta hack applied to the
    measured yaw ("Bug fix for the angle wrap in acados solver", ``:413-423``)
    including the +-2pi range clamp;
  - ``velocity_from_poses``: finite-difference body velocity from two stamped
    poses using the mid-yaw rotation into the robot frame (``:438-484``);
  - staleness gates matching ``transform_timeout`` (``:425-430, :449-453``).
"""
from __future__ import annotations

import dataclasses
import math

__all__ = [
    "StampedPose", "unwrap_pose_theta", "velocity_from_poses",
    "pose_is_fresh", "TfStateProvider",
]


@dataclasses.dataclass
class StampedPose:
    t: float        # seconds
    x: float
    y: float
    theta: float    # yaw


def _norm_ang_rad(a: float) -> float:
    return math.fmod(a + math.pi, 2 * math.pi) + (
        2 * math.pi if math.fmod(a + math.pi, 2 * math.pi) < 0 else 0.0
    ) - math.pi


def unwrap_pose_theta(curr_theta: float, last_theta: float) -> float:
    """The getRobotPose unwrap hack (``:413-423``): one +-2pi correction
    against the previous tick's theta, then clamp into (-2pi, 2pi)."""
    delta = curr_theta - last_theta
    if delta > math.pi:
        curr_theta -= 2.0 * math.pi
    elif delta < -math.pi:
        curr_theta += 2.0 * math.pi
    while curr_theta >= 2.0 * math.pi:
        curr_theta -= 2.0 * math.pi
    while curr_theta <= -2.0 * math.pi:
        curr_theta += 2.0 * math.pi
    return curr_theta


def pose_is_fresh(pose_t: float, now: float, transform_timeout: float) -> bool:
    """Staleness gate (``:425-430``)."""
    return (now - pose_t) <= transform_timeout


def velocity_from_poses(p1: StampedPose, p2: StampedPose,
                        transform_timeout: float):
    """Finite-difference body velocity (``getRobotVel``, ``:438-484``).

    Returns ((v, vn, w), valid).  Invalid when dt <= 0 or dt > timeout
    (``:449-453``).
    """
    dt = p2.t - p1.t
    if dt <= 0.0 or dt > transform_timeout:
        return (0.0, 0.0, 0.0), False
    dx = p2.x - p1.x
    dy = p2.y - p1.y
    dyaw = _norm_ang_rad(p2.theta - p1.theta)
    mid_yaw = p1.theta + dyaw / 2.0
    vx_g = dx / dt
    vy_g = dy / dt
    cos_y = math.cos(-mid_yaw)
    sin_y = math.sin(-mid_yaw)
    v = vx_g * cos_y - vy_g * sin_y
    vn = vx_g * sin_y + vy_g * cos_y
    w = dyaw / dt
    return (v, vn, w), True


class TfStateProvider:
    """``StateProvider`` built on raw stamped poses: the full
    ``getRobotPose``/``getRobotVel`` parity layer wired into the executor
    loop (reference ``NMPCNavControlROS.cpp:401-484``).

    Per cycle it (a) applies the theta-unwrap hack against the previous
    tick's theta, (b) gates on pose staleness vs ``transform_timeout``, and
    (c) computes the body velocity by finite-differencing the previous and
    current stamped poses with the mid-yaw rotation — exactly how the
    reference estimates velocity from TF (it never consumes a measured
    twist).  The first cycle is invalid (no previous pose, matching the
    failing t-dt lookup).

    Args:
      pose_source: callable -> ``StampedPose`` or ``(StampedPose, frame_id)``.
      transform_timeout: staleness limit in seconds (``transform_timeout``).
      clock: optional "now" supplier for the staleness gate; defaults to the
        pose's own stamp (always fresh — e.g. a lock-stepped simulator).
    """

    def __init__(self, pose_source, transform_timeout: float = 0.2,
                 clock=None):
        self.pose_source = pose_source
        self.transform_timeout = transform_timeout
        self.clock = clock
        self._last_theta = 0.0
        self._prev: StampedPose | None = None

    def get_state(self):
        out = self.pose_source()
        frame = None
        if isinstance(out, tuple):
            sp, frame = out
        else:
            sp = out
        now = self.clock() if self.clock is not None else sp.t
        theta_u = unwrap_pose_theta(sp.theta, self._last_theta)
        self._last_theta = theta_u
        sp_u = StampedPose(t=sp.t, x=sp.x, y=sp.y, theta=theta_u)
        valid = pose_is_fresh(sp.t, now, self.transform_timeout)
        vel = (0.0, 0.0, 0.0)
        if self._prev is not None:
            vel, vel_valid = velocity_from_poses(
                self._prev, sp_u, self.transform_timeout
            )
            valid = valid and vel_valid
        else:
            valid = False
        self._prev = sp_u
        pose = (sp_u.x, sp_u.y, theta_u)
        if frame is None:
            return pose, vel, valid
        return pose, vel, valid, frame
