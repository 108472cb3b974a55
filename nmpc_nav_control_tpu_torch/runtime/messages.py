"""ROS-shaped message dataclasses.

Host-side equivalents of the topic payloads in SURVEY.md §2.3, so a real
ROS1/ROS2 bridge is a thin serialization shim:

  - ``PoseStamped``          (geometry_msgs/PoseStamped — pose_goal input)
  - ``Twist``                (geometry_msgs/Twist — cmd_vel output)
  - ``ParametricPath``       (itrci_nav/ParametricPath)
  - ``ParametricPathSet``    (itrci_nav/ParametricPathSet; AuxNum0 carries the
                              path parameter u, ``NMPCNavControlROS.cpp:397``)
  - ``ParametricPathSet2``   (adds request_id, ``:319-325``)
  - ``ControlStatus``        (itrci_nav/parametric_trajectories_control_status)
  - ``PosePath``             (nav_msgs/Path — debug_discretized_path)

The parametric-path payload carries polynomial coefficients directly (the
external ``parametric_trajectories_common`` wire format is not part of the
reference repo; the behavioral contract it must satisfy is the TPath
evaluator surface, implemented in ``paths/segment.py``).

Port of ``nmpc_nav_control_tpu/runtime/messages.py``: the same dataclasses;
``decode_path_set`` builds torch tensors, on the card unless ``device``
says otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from nmpc_nav_control_tpu_torch.paths.segment import DEG, PathSegment, seg_arc_length

__all__ = [
    "PoseStamped", "Twist", "ParametricPath", "ParametricPathSet",
    "ParametricPathSet2", "ControlStatus", "PosePath", "FrameTable",
    "decode_path_set", "encode_path", "encode_path_set",
]


@dataclasses.dataclass
class PoseStamped:
    frame_id: str
    x: float
    y: float
    theta: float  # yaw (the bridge converts quaternion <-> yaw)


@dataclasses.dataclass
class Twist:
    linear_x: float = 0.0
    linear_y: float = 0.0
    angular_z: float = 0.0


@dataclasses.dataclass
class ParametricPath:
    """One parametric curve: x(u), y(u) polynomial coefficients (low order
    first, up to DEG), optional holonomic-heading polynomial, signed nominal
    velocity, frame id."""

    frame_id: str
    cx: Sequence[float]
    cy: Sequence[float]
    velocity: float = 1.0
    ch: Sequence[float] = (0.0,)


@dataclasses.dataclass
class ParametricPathSet:
    paths: List[ParametricPath]
    aux_num0: float = 0.0


@dataclasses.dataclass
class ParametricPathSet2:
    paths: List[ParametricPath]
    aux_num0: float = 0.0
    request_id: int = 0


@dataclasses.dataclass
class ControlStatus:
    """``parametric_trajectories_control_status`` analog
    (``pubControlStatus``, ``NMPCNavControlROS.cpp:364-388``)."""

    status: int            # STATUS_IDLE / STATUS_WORKING / STATUS_ERROR
    request_id: int = 0
    path_remains: float = 0.0


@dataclasses.dataclass
class PosePath:
    frame_id: str
    poses: np.ndarray      # [n, 3] (x, y, theta)


class FrameTable:
    """Bidirectional frame-string <-> int-code map (code 0 = empty/invalid,
    matching the reference's empty-frame-id skip, ``:569``)."""

    def __init__(self):
        self._to_code = {"": 0}
        self._to_name = {0: ""}

    def code(self, name: str) -> int:
        if name not in self._to_code:
            code = len(self._to_code)
            self._to_code[name] = code
            self._to_name[code] = name
        return self._to_code[name]

    def name(self, code: int) -> str:
        return self._to_name.get(int(code), "")


def decode_path_set(msg: ParametricPathSet, frames: FrameTable, capacity: int,
                    dtype=torch.float32, device="cuda"):
    """``TPathSetRosDecode::fromRos`` analog: message -> padded PathSegment
    stack + count.  Returns (segments with leading [capacity], n)."""
    n = min(len(msg.paths), capacity)
    cx = np.zeros((capacity, DEG), np.float64)
    cy = np.zeros((capacity, DEG), np.float64)
    ch = np.zeros((capacity, DEG), np.float64)
    vel = np.zeros((capacity,), np.float64)
    fid = np.zeros((capacity,), np.int32)
    for i, p in enumerate(msg.paths[:capacity]):
        cx[i, : len(p.cx)] = p.cx
        cy[i, : len(p.cy)] = p.cy
        ch[i, : len(p.ch)] = p.ch
        vel[i] = p.velocity
        fid[i] = frames.code(p.frame_id)

    def t(x, dtype=dtype):
        return torch.as_tensor(x, dtype=dtype, device=device)

    cxt, cyt = t(cx), t(cy)
    segs = PathSegment(cx=cxt, cy=cyt, ch=t(ch), velocity=t(vel),
                       frame_id=t(fid, torch.int32), length=seg_arc_length(cxt, cyt))
    return segs, n


def encode_path(cx, cy, ch, velocity, frame_code, frames: FrameTable
                ) -> ParametricPath:
    """``TPathRosDecode::toRos`` analog: one curve's arrays -> message
    payload (used by the ``actual_path`` re-publication,
    ``NMPCNavControlROS.cpp:390-399``)."""
    return ParametricPath(
        frame_id=frames.name(int(frame_code)),
        cx=[float(v) for v in np.asarray(cx)],
        cy=[float(v) for v in np.asarray(cy)],
        ch=[float(v) for v in np.asarray(ch)],
        velocity=float(velocity),
    )


def encode_path_set(cx, cy, ch, velocity, frame_code, frames: FrameTable,
                    aux_num0: float) -> ParametricPathSet:
    """``pubActualPath`` payload: the front active curve as a one-element
    ``ParametricPathSet`` with ``AuxNum0`` = the fractional path parameter u
    (``NMPCNavControlROS.cpp:390-399``)."""
    return ParametricPathSet(
        paths=[encode_path(cx, cy, ch, velocity, frame_code, frames)],
        aux_num0=float(aux_num0),
    )
