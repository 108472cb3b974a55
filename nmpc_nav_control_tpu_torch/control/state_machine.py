"""Navigation state machine, batched: the ROS node's control cycle in torch.

Port of ``nmpc_nav_control_tpu/control/state_machine.py``
(``NMPCNavControlROS``'s per-tick logic, ``NMPCNavControlROS.cpp:516-720``).
``node_tick`` runs the whole tick for every lane of a batch: state
dispatch, nearest-point projection, path windowing, discretization, safety
checks, termination tests and the NMPC solve, every branch a masked lane as
under the JAX package's ``vmap``.  It reads no value on the host, so a CUDA
graph can capture it (``control/graph.py::GraphedNavigator``).

Statuses (``NMPCNavControlROS.h``): IDLE, GO_TO_POSE, FOLLOW_PATH, BREAK,
ERROR.  Replicated as the JAX package replicates them, bug for bug where
observable:
  - the pose-validity flag is overwritten by the velocity-validity flag
    (``:549-550``); only tric ANDs the steering-angle validity (``:551``);
  - GoToPose safety: distance to goal >= max_goal_pose_dist -> stop + IDLE
    (``:620-627``);
  - termination compares the signed normalized angle error, no abs()
    (``:638-639``, ``:683-684``);
  - FollowPath safety: position/orientation error to the path -> stop +
    ERROR (``:654-664``; this orientation check does use fabs);
  - omni4 uses the holonomic path heading; reverse driving adds pi
    (``:654-655``);
  - end of trajectory: rotate buffers if upcoming segments remain, else
    IDLE (``:682-694``);
  - BREAK publishes a stop command and falls to IDLE (``:612-616``);
  - ERROR is terminal until a new goal/path arrives (``:531-532``).

Every tensor has a leading batch axis [B].  The event functions
(``on_goal_pose``, ``on_path_set``, ``on_command``) act on every lane of
the state they are given, as the JAX package's act on the state they are
given; a mixed batch is the concatenation of single-lane states.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from nmpc_nav_control_tpu_torch.control.controllers import (
    CmdVel,
    ControllerSpec,
    controller_init,
    controller_step,
)
from nmpc_nav_control_tpu_torch.ocp.spec import OCPData
from nmpc_nav_control_tpu_torch.paths.discretizer import (
    get_next_n_poses,
    get_next_n_poses_fast,
)
from nmpc_nav_control_tpu_torch.paths.pathlist import take_rows
from nmpc_nav_control_tpu_torch.paths.projection import project_to_path
from nmpc_nav_control_tpu_torch.paths.segment import PathSegment
from nmpc_nav_control_tpu_torch.paths.windowing import (
    active_path_list,
    ingest,
    path_remains,
    pop_completed,
    rotate_end_of_curve,
    select_rows,
    top_up,
    window_init,
)
from nmpc_nav_control_tpu_torch.rti.step import rti_reset
from nmpc_nav_control_tpu_torch.tick_types import Measurements, NodeState, TickOutput
from nmpc_nav_control_tpu_torch.utils.angles import dist, norm_ang_rad

__all__ = [
    "IDLE", "GO_TO_POSE", "FOLLOW_PATH", "BREAK", "ERROR",
    "STATUS_IDLE", "STATUS_WORKING", "STATUS_ERROR",
    "NavConfig", "NodeState", "Measurements", "TickOutput",
    "node_init", "on_goal_pose", "on_path_set", "on_command", "node_tick",
]

# Status enum (NMPCNavControlROS.h).
IDLE, GO_TO_POSE, FOLLOW_PATH, BREAK, ERROR = range(5)
# Published control_status codes (parametric_trajectories_control_status).
STATUS_IDLE, STATUS_WORKING, STATUS_ERROR = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class NavConfig:
    """Static runtime parameters (``readParam``, ``NMPCNavControlROS.cpp:
    44-77``; YAML ``config/nmpc_nav_control.yaml``).  Angles in radians.
    ``discretizer``: "fast" (the chord-table resampler, default) or "march"
    (the reference's loop, for parity runs)."""

    final_position_error: float = 0.01
    final_orientation_error: float = 0.017453292519943295  # 1 deg
    enable_safe_conditions: bool = True
    max_goal_pose_dist: float = 2.0
    max_pos_error_to_path: float = 0.5
    max_ori_error_to_path: float = 1.0471975511965976      # 60 deg
    max_active_path_length: float = 5.0
    path_capacity: int = 16
    discretizer: str = "fast"


def node_init(spec: ControllerSpec, cfg: NavConfig, batch: int, dtype=torch.float32,
              device="cuda") -> NodeState:
    """``batch`` idle nodes, on the card unless ``device`` says otherwise."""
    def zeros(*shape, dtype=dtype):
        return torch.zeros((batch,) + shape, dtype=dtype, device=device)

    return NodeState(
        status=zeros(dtype=torch.int32) + IDLE,
        goal_pose=zeros(3),
        window=window_init(cfg.path_capacity, batch, dtype, device),
        active_path_u=zeros(),
        rti=controller_init(spec, batch, dtype, device),
        request_id=zeros(dtype=torch.int32),
    )


def on_goal_pose(state: NodeState, goal_pose) -> NodeState:
    """pose_goal received (``goalPoseReceivedCallback``, ``:304-310``);
    goal_pose [3] or [B, 3]."""
    return state._replace(
        status=torch.full_like(state.status, GO_TO_POSE),
        goal_pose=goal_pose.to(state.goal_pose).expand_as(state.goal_pose).clone(),
        rti=rti_reset(state.rti),
    )


def on_path_set(state: NodeState, cfg: NavConfig, new_segs: PathSegment, n_new,
                request_id=0) -> NodeState:
    """Path set received (``pathNoStackUp2ReceivedCallback`` +
    ``processPathReceived``, ``:319-327,555-574``): ``new_segs`` leaves
    [B, CAP, ...], ``n_new`` and ``request_id`` ints or [B].  Status becomes
    FOLLOW_PATH even for an empty set, and an empty set leaves the buffers
    untouched (the reference sets the status and returns before clearing
    them, ``:557-562``)."""
    if not isinstance(n_new, torch.Tensor):
        n_new = torch.full_like(state.status, n_new)
    if not isinstance(request_id, torch.Tensor):
        request_id = torch.full_like(state.request_id, request_id)
    nonempty = n_new > 0
    window = ingest(state.window, new_segs, n_new, cfg.max_active_path_length)
    return state._replace(
        status=torch.full_like(state.status, FOLLOW_PATH),
        window=_where(nonempty, window, state.window),
        active_path_u=torch.where(nonempty, 0.0, state.active_path_u),
        rti=rti_reset(state.rti),
        request_id=request_id.to(state.request_id).expand_as(state.request_id).clone(),
    )


def on_command(state: NodeState, command: str) -> NodeState:
    """'break' / 'idle' operator command (``controlCommandReceivedCallback``,
    ``:329-336``); any other command leaves the state unchanged (the host
    layer logs it)."""
    if command == "break":
        return state._replace(status=torch.full_like(state.status, BREAK))
    if command == "idle":
        return state._replace(status=torch.full_like(state.status, IDLE))
    return state


def _where(take, new, old):
    """Per-lane select over a NamedTuple of [B, ...] tensors (nested)."""
    if isinstance(new, tuple):
        return type(new)(*(_where(take, a, b) for a, b in zip(new, old)))
    return torch.where(take.reshape(take.shape + (1,) * (new.dim() - 1)), new, old)


def node_tick(spec: ControllerSpec, data: OCPData, cfg: NavConfig, state: NodeState,
              meas: Measurements):
    """One 40 Hz control cycle for every lane (``mainCycle``, ``:516-538``).
    Returns (new_state, TickOutput)."""
    dims = spec.dims
    dtype = state.goal_pose.dtype
    N = dims.N
    is_omni = spec.geometry == "omni4"
    is_tric = spec.geometry == "tric"
    pose, vel = meas.pose, meas.vel
    px, py, pth = pose[:, 0], pose[:, 1], pose[:, 2]

    # Input validity: the overwrite bug leaves the pose flag unread; only vel
    # (and the steering angle for tric) gate (``:545-553``).
    valid_input = meas.vel_valid & meas.steer_valid if is_tric else meas.vel_valid
    active = (state.status == GO_TO_POSE) | (state.status == FOLLOW_PATH) | (
        state.status == BREAK)
    status = torch.where(active & ~valid_input, ERROR, state.status)

    # ---- GoToPose plan (``processGoToPose``) ----
    goal = state.goal_pose
    d_goal = dist(goal[:, 0], goal[:, 1], px, py)
    too_far = cfg.enable_safe_conditions & (d_goal >= cfg.max_goal_pose_dist)
    ang_goal = norm_ang_rad(pth - goal[:, 2])            # signed, no abs (ref)
    at_goal = (d_goal <= cfg.final_position_error) & (ang_goal <= cfg.final_orientation_error)
    gtp_stop = too_far | at_goal
    traj_gtp = torch.cat([goal[:, None], torch.zeros_like(goal[:, None]).expand(-1, N, 3)], 1)

    # ---- FollowPath plan (``processFollowPath``) ----
    cap = cfg.path_capacity
    proj = project_to_path(active_path_list(state.window, cap), px, py)
    win_popped, u_popped = pop_completed(state.window, proj.u)
    win_fp = top_up(win_popped, u_popped, cfg.max_active_path_length)
    plist = active_path_list(win_fp, cap)

    if is_omni:
        theta_path = proj.theta_holonomic
    else:
        front_vel = plist.segs.velocity[:, 0]
        theta_path = torch.where(front_vel < 0.0, proj.theta + math.pi, proj.theta)
    pos_err = dist(proj.x, proj.y, px, py)
    ori_err = torch.abs(norm_ang_rad(theta_path - pth))
    fp_unsafe = cfg.enable_safe_conditions & (
        (pos_err >= cfg.max_pos_error_to_path) | (ori_err >= cfg.max_ori_error_to_path))

    discretize = get_next_n_poses_fast if cfg.discretizer == "fast" else get_next_n_poses
    traj_fp = discretize(plist, u_popped, dims.dt, N + 1, is_holonomic=is_omni).to(dtype)
    last_pose = traj_fp[:, -1]
    d_end = dist(px, py, last_pose[:, 0], last_pose[:, 1])
    ang_end = norm_ang_rad(pth - last_pose[:, 2])        # signed, no abs (ref)
    fp_at_end = (d_end <= cfg.final_position_error) & (ang_end <= cfg.final_orientation_error)
    has_upcoming = win_fp.total_count > win_fp.active_count
    fp_stop = fp_unsafe | fp_at_end

    # ---- Status-dependent selection ----
    in_gtp = status == GO_TO_POSE
    in_fp = status == FOLLOW_PATH
    in_break = status == BREAK
    solve = (in_gtp & ~gtp_stop) | (in_fp & ~fp_stop)
    traj = torch.where(in_fp[:, None, None], traj_fp, traj_gtp)
    n_valid = torch.where(in_fp, N + 1, 1)
    # Window and parameter updates apply in FollowPath only.
    win_after = _where(in_fp, _where(fp_at_end & has_upcoming, rotate_end_of_curve(win_fp),
                                     win_fp), state.window)
    u_after = torch.where(in_fp, u_popped, state.active_path_u)

    # ---- Solve, kept where the lane solves ----
    new_rti, cmd, stats = controller_step(spec, data, state.rti, pose, vel, traj, n_valid,
                                          steer_angle=meas.steer_angle)
    solve_ok = stats.ok | ~solve
    rti_after = _where(solve, new_rti, state.rti)

    # ---- Command output: zeroed when stopping (the tric Twist quirk is the
    # runtime encoder's, ``pubCmdVel``, ``:338-362``). ----
    stop_cmd = (in_gtp & gtp_stop) | (in_fp & fp_stop) | in_break
    publish = stop_cmd | (solve & stats.ok)
    cmd_out = CmdVel(*(torch.where(stop_cmd, 0.0, c) for c in cmd))

    # ---- Status transitions: GoToPose too far or at goal -> IDLE; FollowPath
    # unsafe -> ERROR, at the end with nothing upcoming -> IDLE; BREAK ->
    # IDLE; solver failure -> ERROR (``executeNMPC``'s catch, ``:716-719``). ----
    status = torch.where(in_gtp & gtp_stop, IDLE, status)
    status = torch.where(in_fp & fp_unsafe, ERROR, status)
    status = torch.where(in_fp & ~fp_unsafe & fp_at_end & ~has_upcoming, IDLE, status)
    status = torch.where(in_break, IDLE, status)
    status = torch.where(solve & ~stats.ok, ERROR, status).to(torch.int32)

    # ---- control_status output (``pubControlStatus``) ----
    status_code = torch.where(
        (status == IDLE) | (status == BREAK), STATUS_IDLE,
        torch.where(status == ERROR, STATUS_ERROR, STATUS_WORKING)).to(torch.int32)
    remains = torch.where(in_fp, path_remains(win_after, u_after), 0.0)

    new_state = NodeState(status=status, goal_pose=state.goal_pose, window=win_after,
                          active_path_u=u_after, rti=rti_after, request_id=state.request_id)
    # actual_path payload: the front active curve of the popped and topped-up
    # window (pubActualPath runs before any rotation, ``:696``).
    front_fp = select_rows(win_fp.segs, win_fp.head)
    next_front = take_rows(win_after.segs.frame_id, win_after.head.clamp(0, cap - 1))
    next_frame = torch.where(in_fp & (win_after.active_count > 0), next_front, 0)
    out = TickOutput(
        cmd=cmd_out,
        publish_cmd=publish,
        status_code=status_code,
        request_id=state.request_id,
        path_remains=remains,
        kkt_res=stats.kkt_res,
        solve_ok=solve_ok,
        debug_path=traj_fp,
        publish_debug=in_fp & ~fp_unsafe,
        active_path_u=u_after,
        publish_actual=in_fp & ~fp_stop & (win_fp.active_count > 0),
        actual_cx=front_fp.cx,
        actual_cy=front_fp.cy,
        actual_ch=front_fp.ch,
        actual_velocity=front_fp.velocity,
        actual_frame=front_fp.frame_id,
        next_frame=next_frame.to(torch.int32),
    )
    return new_state, out
