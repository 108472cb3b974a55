"""Host-side controller node: the ``NMPCNavControlROS`` equivalent.

Port of ``nmpc_nav_control_tpu/runtime/node.py``.  The node owns the static
controller (spec/data/cfg) and one robot's ``NodeState``, exposes
message-level callbacks and a per-cycle ``tick`` that takes measurements
and returns the outgoing messages.  On a CUDA device the tick replays a
``control.graph.GraphedNavigator`` at B=1 (the port's counterpart of the
JAX node's jitted tick); on ``device="cpu"`` it runs ``node_tick``
eagerly.  Without a card and without ``device="cpu"`` it raises.  Each tick
copies the measurements to the device and makes one device-to-host copy of
the outputs it reads.

Reference behaviors carried over:
  - callbacks: pose_goal / path_no_stack_up(_2) / control_command
    (``NMPCNavControlROS.cpp:304-336``);
  - Twist encoding incl. the tric quirk: ``angular.z`` carries the *measured*
    steering-wheel angle, even for stop commands (``pubCmdVel``, ``:338-362``);
  - control_status publishing every tick (``:364-388``);
  - per-cycle wall-time + solver-time accounting (the ROS_DEBUG timing hooks,
    ``:508-514,715``) surfaced as p50/p99 stats.

With tracing on (``utils/telemetry.py``) a cycle is a ``node.tick`` span
over the same two clock readings as its wall time, holding ``node.upload``
(measurements into the static buffers), ``node.replay`` (the tick),
``node.fetch`` (the output copy, which waits for the device) and
``node.decode`` (twist, status, actual path).
"""
from __future__ import annotations

import collections
import logging
import time
from typing import Optional

import numpy as np
import torch

from nmpc_nav_control_tpu_torch.control import make_controller
from nmpc_nav_control_tpu_torch.control.graph import GraphedNavigator
from nmpc_nav_control_tpu_torch.control.state_machine import (
    Measurements,
    NodeState,
    TickOutput,
    node_init,
    node_tick,
    on_command,
    on_goal_pose,
    on_path_set,
)
from nmpc_nav_control_tpu_torch.runtime.config import RobotConfig
from nmpc_nav_control_tpu_torch.runtime.messages import (
    ControlStatus,
    FrameTable,
    ParametricPathSet,
    ParametricPathSet2,
    PoseStamped,
    Twist,
    decode_path_set,
    encode_path_set,
)
from nmpc_nav_control_tpu_torch.utils import telemetry
from nmpc_nav_control_tpu_torch.utils.telemetry import channel, metrics

__all__ = ["NmpcNavControlNode"]

# Structured-log channels, named after the reference's ROS logger channels
# (``ROS_DEBUG_NAMED("main_cycle", ...)`` at ``NMPCNavControlROS.cpp:513``,
# ``ROS_DEBUG_NAMED("nmpc_solver", ...)`` at ``:715``; warnings/errors use
# the node channel like the un-named ROS_WARN/ERROR sites).
_log_cycle = channel("main_cycle")
_log_solver = channel("nmpc_solver")
_log_node = channel("node")
_STATUS_NAMES = {0: "idle", 1: "working", 2: "error"}

# TickOutput fields the host reads, fetched in one device-to-host copy.
_READ = ("publish_cmd", "status_code", "request_id", "path_remains", "kkt_res",
         "debug_path", "publish_debug", "active_path_u", "publish_actual", "actual_cx",
         "actual_cy", "actual_ch", "actual_velocity", "actual_frame", "next_frame")


def _fetch(out: TickOutput) -> dict:
    """Lane 0 of the outputs the host reads, as numpy, through one copy:
    every field packed into one f64 tensor on the device (exact for the
    f32/f64 values, int32 codes and bools), copied, and split."""
    parts = {"v": out.cmd.v, "vn": out.cmd.vn, "w": out.cmd.w}
    parts.update((f, getattr(out, f)) for f in _READ)
    flat = torch.cat([t[0].reshape(-1).to(torch.float64) for t in parts.values()])
    host = flat.cpu().numpy()
    fetched, at = {}, 0
    for name, t in parts.items():
        n = t[0].numel()
        fetched[name] = host[at:at + n].reshape(t.shape[1:])
        at += n
    return fetched


class NmpcNavControlNode:
    """Single-robot host controller (the batched/fleet path uses
    ``control.state_machine.node_tick`` or ``control.GraphedNavigator``
    directly)."""

    def __init__(self, config: RobotConfig, dtype=torch.float32, device="cuda",
                 debug_outputs: bool = False):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("NmpcNavControlNode: no CUDA device (pass device='cpu' to "
                               "run the tick eagerly on the CPU)")
        self.config = config
        self.dtype = dtype
        self.device = device
        self.debug_outputs = debug_outputs
        self.last_debug_path = None      # [N+1, 3] poses (pubDebugDiscretizedPath)
        self.last_actual_path_u = 0.0    # AuxNum0 of the actual_path topic
        # actual_path re-publication: the front active curve + AuxNum0 = u,
        # refreshed on every solving FollowPath tick (``pubActualPath``,
        # ``NMPCNavControlROS.cpp:390-399,696``); None when not published.
        self.last_actual_path: Optional[ParametricPathSet] = None
        self.frames = FrameTable()
        # Frame-transform hook (the tf2 lookup boundary): callable
        # (pose (x,y,theta), from_frame, to_frame) -> pose or None on
        # failure.  The reference re-acquires the pose in the frame of the
        # goal / the front active curve every tick (``mainCycle``,
        # ``:520-524``).
        self.frame_transformer = None
        self._required_frame = config.global_frame_id
        self.spec, self.data = make_controller(
            config.steering_geometry, config.dt, config.horizon, dtype=dtype, device=device,
            **config.controller_kwargs())
        self.cfg = config.nav
        if device.type == "cuda":
            self._graphed: Optional[GraphedNavigator] = GraphedNavigator(
                self.spec, self.data, self.cfg, 1)
        else:
            self._graphed = None
            self._state = node_init(self.spec, self.cfg, 1, dtype, device)
        self._steer_angle = 0.0
        # Bounded history windows: 4096 samples ≈ 100 s at 40 Hz.
        self._cycle_times: collections.deque = collections.deque(maxlen=4096)
        self._solver_kkt: collections.deque = collections.deque(maxlen=4096)
        self._total_cycles = 0
        # Raw controller command from the last publishing tick, pre
        # Twist-encoding: (v, vn, w); for tric, w is alpha_ref.
        self.last_cmd: Optional[tuple] = None
        self._last_status_code: Optional[int] = None
        self._metrics = metrics()

    # ------------------------------------------------------------------ #
    # State (the graphed navigator's static state on the card)
    # ------------------------------------------------------------------ #

    @property
    def state(self) -> NodeState:
        return self._state if self._graphed is None else self._graphed.state

    def set_state(self, state: NodeState) -> None:
        """Replace the NodeState (a checkpoint's, say): on the card it is
        copied into the graphed navigator's static buffers."""
        if self._graphed is None:
            self._state = state
        else:
            self._graphed.load_state(state)

    @property
    def capture_launches(self) -> Optional[dict]:
        """Kernel launches of the graphed tick's capture (one tick's); None
        on the CPU and before the first tick."""
        return None if self._graphed is None else self._graphed.capture_launches

    # ------------------------------------------------------------------ #
    # Callbacks (subscriber equivalents)
    # ------------------------------------------------------------------ #

    def on_pose_goal(self, msg: PoseStamped) -> None:
        """``goalPoseReceivedCallback`` (``:304-310``).  GoToPose ticks
        acquire the pose in the GOAL's frame (``mainCycle``, ``:520``)."""
        goal = torch.tensor([msg.x, msg.y, msg.theta], dtype=self.dtype, device=self.device)
        self.set_state(on_goal_pose(self.state, goal))
        self._required_frame = msg.frame_id or self.config.global_frame_id

    def on_path_no_stack_up(self, msg: ParametricPathSet) -> None:
        """v1 path topic: request_id forced to 0 (``:312-317``)."""
        self._ingest_paths(msg.paths, request_id=0)

    def on_path_no_stack_up_2(self, msg: ParametricPathSet2) -> None:
        """v2 path topic with request_id (``:319-327``)."""
        self._ingest_paths(msg.paths, request_id=msg.request_id)

    def _ingest_paths(self, paths, request_id: int) -> None:
        segs, n = decode_path_set(ParametricPathSet(paths=list(paths)), self.frames,
                                  self.cfg.path_capacity, self.dtype, self.device)
        segs = type(segs)(*(leaf[None] for leaf in segs))
        self.set_state(on_path_set(self.state, self.cfg, segs, n, request_id))
        # FollowPath ticks acquire the pose in the FRONT ACTIVE curve's frame
        # (``mainCycle``, ``:523``): the first valid segment after ingest.
        for p in paths:
            if p.frame_id:
                self._required_frame = p.frame_id
                break

    def on_control_command(self, command: str) -> bool:
        """``controlCommandReceivedCallback`` (``:329-336``).  Returns False
        for an invalid command (the host logs the error)."""
        if command not in ("break", "idle"):
            _log_node.error("invalid_control_command", command=command)
            return False
        self.set_state(on_command(self.state, command))
        return True

    def set_steering_wheel_angle(self, angle: float) -> None:
        """tric steering-angle ingest (``getSteeringWheelAngle``, ``:486-506``)."""
        self._steer_angle = float(angle)

    # ------------------------------------------------------------------ #
    # Control cycle
    # ------------------------------------------------------------------ #

    def required_frame(self) -> str:
        """Frame the measured pose must be expressed in this tick (goal frame
        in GoToPose, front active curve's frame in FollowPath — ``mainCycle``,
        ``:520-524``)."""
        return self._required_frame

    def tick(self, pose, vel, pose_valid=True, vel_valid=True,
             steer_valid=True, pose_frame: Optional[str] = None):
        """One control cycle. Returns (Twist | None, ControlStatus).

        ``pose``: (x, y, theta); ``vel``: (v, vn, w) body velocity.  When
        ``pose_frame`` is given and differs from :meth:`required_frame`, the
        pose is re-expressed via ``frame_transformer``.  A failed/missing
        transform invalidates the measurements — the tf2-exception path that
        drives the reference to Error (``getRobotPose`` catch, ``:431-434``).
        A ``None`` Twist means no cmd_vel is published this tick (Idle/Error).
        """
        t0 = time.perf_counter_ns()
        cycle = telemetry.begin("node.tick", t0)
        try:
            twist, status, kkt = self._cycle(pose, vel, pose_valid, vel_valid, steer_valid,
                                             pose_frame)
        finally:
            t1 = time.perf_counter_ns()
            telemetry.end(cycle, t1)
        cycle_s = (t1 - t0) * 1e-9
        self._cycle_times.append(cycle_s)
        self._solver_kkt.append(kkt)
        self._total_cycles += 1

        m = self._metrics
        m.counter("node.ticks").inc()
        if twist is not None:
            m.counter("node.cmds_published").inc()
        m.gauge("node.cycle_ms").set(cycle_s * 1e3)
        m.gauge("node.kkt_res").set(kkt)
        m.gauge("node.status").set(status.status)
        if status.status != self._last_status_code:
            name = _STATUS_NAMES.get(status.status, str(status.status))
            log = _log_node.warning if status.status == 2 else _log_node.info
            log("status_change", status=name, request_id=status.request_id,
                path_remains=round(status.path_remains, 3))
            if status.status == 2:
                m.counter("node.error_transitions").inc()
            self._last_status_code = status.status
        if _log_cycle.isEnabledFor(logging.DEBUG):
            _log_cycle.debug("tick", cycle_ms=round(cycle_s * 1e3, 3),
                             budget_ms=round(self.config.dt * 1e3, 3))
        if _log_solver.isEnabledFor(logging.DEBUG):
            _log_solver.debug("solve", kkt_res=kkt, status=status.status)
        return twist, status

    def _cycle(self, pose, vel, pose_valid, vel_valid, steer_valid, pose_frame):
        """The cycle's work between its two clock readings: (Twist | None,
        ControlStatus, kkt_res)."""
        with telemetry.span("node.upload"):
            required = self.required_frame()
            if pose_frame is not None and pose_frame != required:
                new_pose = None
                if self.frame_transformer is not None:
                    new_pose = self.frame_transformer(pose, pose_frame, required)
                if new_pose is None:
                    _log_node.warning("pose_transform_failed",
                                      from_frame=pose_frame, to_frame=required)
                    pose_valid = False
                    vel_valid = False
                else:
                    pose = new_pose

            def lane(x, dtype=self.dtype):
                return torch.tensor([x], dtype=dtype)

            meas = Measurements(
                pose=lane(list(pose)), vel=lane(list(vel)), steer_angle=lane(self._steer_angle),
                pose_valid=lane(bool(pose_valid), torch.bool),
                vel_valid=lane(bool(vel_valid), torch.bool),
                steer_valid=lane(bool(steer_valid), torch.bool),
            )
            if self._graphed is not None:
                self._graphed.load_measurements(meas)
        with telemetry.span("node.replay"):
            if self._graphed is None:
                self._state, out = node_tick(self.spec, self.data, self.cfg, self._state, meas)
            else:
                _, out = self._graphed.step()
        with telemetry.span("node.fetch"):
            out = _fetch(out)

        with telemetry.span("node.decode"):
            publish = bool(out["publish_cmd"])
            twist: Optional[Twist] = None
            if publish:
                v, vn, w = float(out["v"]), float(out["vn"]), float(out["w"])
                self.last_cmd = (v, vn, w)
                if self.spec.geometry == "tric":
                    # Reference quirk: cmd_vel.angular.z carries the MEASURED
                    # steering angle, not alpha_ref, even when stopping
                    # (``pubCmdVel``, ``:351-355``).
                    twist = Twist(linear_x=v, linear_y=0.0, angular_z=self._steer_angle)
                elif self.spec.geometry == "diff":
                    twist = Twist(linear_x=v, linear_y=0.0, angular_z=w)
                else:
                    twist = Twist(linear_x=v, linear_y=vn, angular_z=w)

            status = ControlStatus(
                status=int(out["status_code"]),
                request_id=int(out["request_id"]),
                path_remains=float(out["path_remains"]),
            )
            # actual_path re-publication (``pubActualPath``, ``:390-399,696``).
            if bool(out["publish_actual"]):
                self.last_actual_path = encode_path_set(
                    out["actual_cx"], out["actual_cy"], out["actual_ch"], out["actual_velocity"],
                    out["actual_frame"], self.frames, out["active_path_u"])
            else:
                self.last_actual_path = None
            # The frame the NEXT FollowPath tick needs (the window may have
            # rotated into a new frame_id this tick).
            nf = int(out["next_frame"])
            if nf > 0:
                self._required_frame = self.frames.name(nf)
            if self.debug_outputs:
                # debug_discretized_path payload (``pubDebugDiscretizedPath``,
                # ``:722-738``).
                self.last_debug_path = out["debug_path"] if bool(out["publish_debug"]) else None
                self.last_actual_path_u = float(out["active_path_u"])
            return twist, status, float(out["kkt_res"])

    # ------------------------------------------------------------------ #
    # Observability (the ROS_DEBUG timing hooks, ``:508-514,715``)
    # ------------------------------------------------------------------ #

    def timing_stats(self) -> dict:
        if not self._cycle_times:
            return {}
        t = np.asarray(self._cycle_times) * 1e3
        return {
            "cycles": self._total_cycles,
            "window": len(t),
            "p50_ms": float(np.percentile(t, 50)),
            "p99_ms": float(np.percentile(t, 99)),
            "max_ms": float(t.max()),
            "budget_ms": self.config.dt * 1e3,
            "last_kkt": self._solver_kkt[-1],
        }
