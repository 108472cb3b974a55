"""The NamedTuples that a navigation tick takes and returns.

``control.state_machine.node_tick`` maps (``NodeState``, ``Measurements``)
to (``NodeState``, ``TickOutput``); the state nests ``PathWindow`` (of
``PathSegment`` rows) and ``RTIState``, the output ``CmdVel``.  They are
defined here, with nothing but torch imported, so that a loaded tick
artifact (``runtime/aot.py``) can rebuild them without the model code;
``paths``, ``rti``, ``control`` and ``runtime`` import them from here under
their usual names.  Shapes are given for the batched tick (leading [B]).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CmdVel", "Measurements", "NodeState", "PathSegment", "PathWindow", "RTIState",
           "TickOutput"]


class PathSegment(NamedTuple):
    """cx, cy, ch [..., DEG] coefficients, p(u) = sum_i c[i] u^i;
    velocity [...] signed nominal velocity; frame_id [...] int32 frame code;
    length [...] arc length."""

    cx: torch.Tensor
    cy: torch.Tensor
    ch: torch.Tensor
    velocity: torch.Tensor
    frame_id: torch.Tensor
    length: torch.Tensor


class PathWindow(NamedTuple):
    segs: PathSegment          # leaves [B, CAP, ...]
    head: torch.Tensor         # [B] int32
    active_count: torch.Tensor
    total_count: torch.Tensor  # active + upcoming (counted from head)


class RTIState(NamedTuple):
    """Warm-start state: xs [B, N+1, nx], us [B, N, nu], x0_carry [B, nx]
    (next tick's initial state with the integrated reference entries)."""

    xs: torch.Tensor
    us: torch.Tensor
    x0_carry: torch.Tensor


class CmdVel(NamedTuple):
    """Command triple per lane.

    diff:  (v, 0, w) from the integrated wheel references;
    omni4: (v, vn, w) from the integrated wheel references;
    tric:  (v_ref, 0, alpha_ref), the integrated references themselves.
    """

    v: torch.Tensor
    vn: torch.Tensor
    w: torch.Tensor


class NodeState(NamedTuple):
    status: torch.Tensor          # [B] int32
    goal_pose: torch.Tensor       # [B, 3]
    window: PathWindow
    active_path_u: torch.Tensor   # [B] fractional parameter into the window
    rti: RTIState
    request_id: torch.Tensor      # [B] int32 (ParametricPathSet2 request_id)


class Measurements(NamedTuple):
    """Host-side state ingest (the TF-acquisition boundary, ``:401-506``)."""

    pose: torch.Tensor          # [B, 3] (x, y, theta), theta pre-unwrapped
    vel: torch.Tensor           # [B, 3] (v, vn, w) body velocity
    steer_angle: torch.Tensor   # [B] measured steering-wheel angle (tric)
    pose_valid: torch.Tensor    # [B] bool
    vel_valid: torch.Tensor     # [B] bool
    steer_valid: torch.Tensor   # [B] bool


class TickOutput(NamedTuple):
    cmd: CmdVel                    # command triple, zeroed when stopping
    publish_cmd: torch.Tensor      # [B] bool: cmd_vel published this tick
    status_code: torch.Tensor      # [B] int32 STATUS_* (control_status)
    request_id: torch.Tensor       # [B] int32
    path_remains: torch.Tensor     # [B]
    kkt_res: torch.Tensor          # [B] solver KKT residual
    solve_ok: torch.Tensor         # [B] bool
    debug_path: torch.Tensor       # [B, N+1, 3] discretized reference poses
                                   #   (``pubDebugDiscretizedPath``, ``:722-738``)
    publish_debug: torch.Tensor    # [B] bool: FollowPath ticks only (``:670``)
    active_path_u: torch.Tensor    # [B] u for the actual_path topic (``:390-399``)
    # actual_path payload: the front active curve on solving FollowPath
    # ticks (``pubActualPath``, ``:390-399,696``).
    publish_actual: torch.Tensor   # [B] bool
    actual_cx: torch.Tensor        # [B, DEG]
    actual_cy: torch.Tensor        # [B, DEG]
    actual_ch: torch.Tensor        # [B, DEG]
    actual_velocity: torch.Tensor  # [B]
    actual_frame: torch.Tensor     # [B] int32 frame code of that curve
    # Frame the measured pose must be expressed in next tick: the front
    # active curve after any end-of-curve rotation (``mainCycle``,
    # ``:520-524``); 0 = no active path.
    next_frame: torch.Tensor       # [B] int32
