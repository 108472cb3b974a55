"""Host-side simulated robot plants: the fake-backend analog.

The reference's only integration backend besides a real robot is the family
of standalone sim scripts (``scripts/test_scripts/acados_sim_*.py``), each
pairing the solver with a noisy Euler plant.  Here that plant is a reusable
``SimulatedRobot`` that plugs into ``RealTimeExecutor`` as a
``StateProvider``/``CommandSink`` pair, closing the loop through the full
node (state machine, path manager, solver) for any geometry.

Plant dynamics mirror each model's actuation chain (first-order lags on
wheel velocities / steering angle) driven by the node's raw controller
command — for tric that is (v_ref, alpha_ref), with the measured steering
angle fed back via ``set_steering_wheel_angle`` exactly as the reference's
TF-based measurement path does (``NMPCNavControlROS.cpp:486-506``).

Port of ``nmpc_nav_control_tpu/runtime/simulation.py`` (numpy, on the host):
it reads the node's ``config`` and ``last_cmd`` only, so it drives the
graphed node on the card and the eager one on the CPU alike.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from nmpc_nav_control_tpu_torch.runtime.messages import ControlStatus, Twist
from nmpc_nav_control_tpu_torch.runtime.node import NmpcNavControlNode

__all__ = ["SimulatedRobot"]


class SimulatedRobot:
    """Euler plant + state provider + command sink for one simulated robot.

    Args:
      node: the controller node (provides config/geometry and last_cmd).
      substeps: Euler sub-steps per control period.
      noise_sigma: Gaussian actuation noise on the commanded references
        (the ``acados_sim_diff.py:148-159`` pattern).
      seed: plant noise seed.
    """

    def __init__(self, node: NmpcNavControlNode, substeps: int = 10,
                 noise_sigma: float = 0.0, seed: int = 0,
                 start_pose=(0.0, 0.0, 0.0), meas_noise_sigma: float = 0.0):
        self.node = node
        cfg = node.config
        self.geometry = cfg.steering_geometry
        self.dt = cfg.dt
        self.substeps = substeps
        self.noise_sigma = noise_sigma
        # State-estimate noise fed back to the solver (the
        # ``acados_sim_diff_v2.py:158,174`` robustness scenario): the plant
        # integrates the TRUE state, the controller sees a perturbed one.
        self.meas_noise_sigma = meas_noise_sigma
        self.sim_time = 0.0
        self.rng = np.random.default_rng(seed)
        self.tau_v = cfg.tau_v
        self.tau_a = cfg.tau_a
        if self.geometry == "diff":
            self.geom_const = cfg.dist_b
            n_act = 2
        elif self.geometry == "omni4":
            self.geom_const = cfg.l1_plus_l2
            n_act = 4
        else:
            self.geom_const = cfg.dist_d
            n_act = 2  # (v, alpha)
        self.pose = np.asarray(start_pose, float).copy()
        self.act = np.zeros(n_act)      # lagged actuator states
        self.trajectory = [self.pose.copy()]
        self.statuses: list[ControlStatus] = []
        self._cmd_seen = False
        self._last_refs = np.zeros(n_act)

    # ------------------------------------------------------------------ #
    # StateProvider
    # ------------------------------------------------------------------ #

    def get_state(self):
        g = self.geometry
        if g == "diff":
            vl, vr = self.act
            vel = ((vl + vr) / 2.0, 0.0, (vr - vl) / self.geom_const)
        elif g == "omni4":
            v1, v2, v3, v4 = self.act
            vel = ((v1 - v2 + v3 - v4) / 4.0,
                   (-v1 - v2 + v3 + v4) / 4.0,
                   -(v1 + v2 + v3 + v4) / (2.0 * self.geom_const))
        else:
            v, alpha = self.act
            vel = (v, 0.0, v / self.geom_const * math.sin(alpha))
            self.node.set_steering_wheel_angle(alpha)
        pose = tuple(self.pose)
        if self.meas_noise_sigma:
            n = self.meas_noise_sigma * self.rng.standard_normal(6)
            pose = tuple(np.asarray(pose) + n[:3])
            vel = tuple(np.asarray(vel) + n[3:])
        return pose, vel, True

    def get_raw_pose(self):
        """Raw stamped pose with WRAPPED theta, for driving the
        ``TfStateProvider`` ingest layer (the TF-lookup analog): theta is
        wrapped into (-pi, pi] like a quaternion yaw, so the provider's
        unwrap hack is exercised across +-pi crossings."""
        from nmpc_nav_control_tpu_torch.runtime.ingest import StampedPose

        g = self.geometry
        if g == "tric":
            self.node.set_steering_wheel_angle(self.act[1])
        x, y, th = self.pose
        if self.meas_noise_sigma:
            n = self.meas_noise_sigma * self.rng.standard_normal(3)
            x, y, th = x + n[0], y + n[1], th + n[2]
        wrapped = math.atan2(math.sin(th), math.cos(th))
        return StampedPose(t=self.sim_time, x=x, y=y, theta=wrapped)

    # ------------------------------------------------------------------ #
    # CommandSink
    # ------------------------------------------------------------------ #

    def publish_cmd_vel(self, twist: Twist) -> None:
        cmd = self.node.last_cmd
        if cmd is None:
            return
        v, vn, w = cmd
        g = self.geometry
        b = self.geom_const
        if g == "diff":
            refs = np.array([v - 0.5 * b * w, v + 0.5 * b * w])
        elif g == "omni4":
            # direct kinematics (``NMPCNavControlOmni4.cpp:185-192``)
            refs = np.array([
                v - vn - 0.5 * b * w,
                -v - vn - 0.5 * b * w,
                v + vn - 0.5 * b * w,
                -v + vn - 0.5 * b * w,
            ])
        else:
            refs = np.array([v, w])  # (v_ref, alpha_ref)
        if self.noise_sigma:
            refs = refs + self.noise_sigma * self.rng.standard_normal(refs.shape)
        self._cmd_seen = True
        self._last_refs = refs
        self._integrate(refs)

    def publish_status(self, status: ControlStatus) -> None:
        self.statuses.append(status)
        # Physical time passes even on ticks that publish no command
        # (Idle/Error): coast the plant toward the LAST commanded references
        # (zero after a stop command) so stamped poses keep advancing (the
        # TF stream never pauses).
        if not self._cmd_seen:
            self._integrate(self._last_refs)
        self._cmd_seen = False

    # ------------------------------------------------------------------ #

    def _integrate(self, refs: np.ndarray) -> None:
        h = self.dt / self.substeps
        g = self.geometry
        x, y, th = self.pose
        for _ in range(self.substeps):
            if g == "diff":
                vl, vr = self.act
                v = 0.5 * (vl + vr)
                w = (vr - vl) / self.geom_const
                x += v * math.cos(th) * h
                y += v * math.sin(th) * h
                th += w * h
                self.act += (refs - self.act) / self.tau_v * h
            elif g == "omni4":
                v1, v2, v3, v4 = self.act
                v = (v1 - v2 + v3 - v4) / 4.0
                vn = (-v1 - v2 + v3 + v4) / 4.0
                w = -(v1 + v2 + v3 + v4) / (2.0 * self.geom_const)
                ct, st = math.cos(th), math.sin(th)
                x += (v * ct - vn * st) * h
                y += (v * st + vn * ct) * h
                th += w * h
                self.act += (refs - self.act) / self.tau_v * h
            else:
                v, alpha = self.act
                ca = math.cos(alpha)
                x += v * math.cos(th) * ca * h
                y += v * math.sin(th) * ca * h
                th += v / self.geom_const * math.sin(alpha) * h
                self.act[0] += (refs[0] - v) / self.tau_v * h
                self.act[1] += (refs[1] - alpha) / self.tau_a * h
        self.pose[:] = (x, y, th)
        self.sim_time += self.dt
        self.trajectory.append(self.pose.copy())

    @property
    def last_status(self) -> Optional[ControlStatus]:
        return self.statuses[-1] if self.statuses else None
