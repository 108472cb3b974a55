"""Conversion between the JAX package's data and the port's tensors.

The numeric data of a controller (``OCPData``), its warm-start state
(``RTIState``), and a navigation node's state, measurements and path
segments (``NodeState``, ``Measurements``, ``PathSegment``) are what
weights are to a model.  These functions take the
JAX package's NamedTuples with their leaves as numpy arrays (``np.asarray``
of each JAX leaf, batched or not) and build the port's tensors on a device,
and turn a port state back into numpy leaves under the same field names, so
``nmpc_nav_control_tpu.rti.RTIState(*rti_state_to_numpy(s))`` rebuilds the
JAX state.  The functions carry every geometry's data alike (diff, omni4,
tric); tensors land on the card unless ``device`` says otherwise, and
``dtype`` applies to the float leaves (integer and bool leaves keep their
type: int32 frame codes, statuses and cursors).  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from nmpc_nav_control_tpu_torch.control.state_machine import Measurements, NodeState
from nmpc_nav_control_tpu_torch.ocp.spec import OCPData
from nmpc_nav_control_tpu_torch.paths.segment import PathSegment
from nmpc_nav_control_tpu_torch.paths.windowing import PathWindow
from nmpc_nav_control_tpu_torch.rti.step import RTIState

__all__ = ["measurements_from_numpy", "node_state_from_numpy", "node_state_to_numpy",
           "ocp_data_from_numpy", "path_segment_from_numpy", "rti_state_from_numpy",
           "rti_state_to_numpy"]


def _tensor(x, device, dtype):
    x = np.array(x)
    if not np.issubdtype(x.dtype, np.floating):
        dtype = None          # int32 and bool leaves keep their type
    return torch.as_tensor(x, dtype=dtype, device=device)


def _build(cls, x, device, dtype):
    """``cls`` (a NamedTuple; the nested ones of ``_NESTED``) from an object
    with the same field names and numpy-like leaves."""
    fields = []
    for name in cls._fields:
        v = getattr(x, name)
        sub = _NESTED.get((cls, name))
        fields.append(_tensor(v, device, dtype) if sub is None else _build(sub, v, device, dtype))
    return cls(*fields)


_NESTED = {(NodeState, "window"): PathWindow, (NodeState, "rti"): RTIState,
           (PathWindow, "segs"): PathSegment}


def _to_numpy(x):
    if isinstance(x, tuple):
        return type(x)(*(_to_numpy(v) for v in x))
    return x.detach().cpu().numpy()


def ocp_data_from_numpy(data, device="cuda", dtype=None) -> OCPData:
    """OCPData-like (p, lbx, ubx, lbu, ubu, q_diag, r_diag, qe_diag) -> port
    ``OCPData``; leaves keep their batch axis, if any."""
    return _build(OCPData, data, device, dtype)


def rti_state_from_numpy(state, device="cuda", dtype=None) -> RTIState:
    """RTIState-like (xs, us, x0_carry) -> port ``RTIState`` with a leading
    batch axis (an unbatched state becomes a batch of one)."""
    out = _build(RTIState, state, device, dtype)
    return _batched(out) if out.xs.dim() == 2 else out


def rti_state_to_numpy(state: RTIState) -> RTIState:
    """Port ``RTIState`` -> the same NamedTuple with batched numpy leaves."""
    return _to_numpy(state)


def path_segment_from_numpy(seg, device="cuda", dtype=None) -> PathSegment:
    """PathSegment-like (cx, cy, ch, velocity, frame_id, length) -> port
    ``PathSegment``; leaves keep their leading axes (none, [M] or
    [B, M])."""
    return _build(PathSegment, seg, device, dtype)


def node_state_from_numpy(state, device="cuda", dtype=None) -> NodeState:
    """NodeState-like (status, goal_pose, window, active_path_u, rti,
    request_id; window and rti nested under the JAX field names) -> port
    ``NodeState`` with a leading batch axis (an unbatched state, status of
    shape [], becomes a batch of one)."""
    out = _build(NodeState, state, device, dtype)
    return _batched(out) if out.status.dim() == 0 else out


def node_state_to_numpy(state: NodeState) -> NodeState:
    """Port ``NodeState`` -> the same nested NamedTuples with batched numpy
    leaves (for JAX: ``jax.tree_util.tree_unflatten`` of the JAX state's
    structure over its leaves, which come in the same order)."""
    return _to_numpy(state)


def measurements_from_numpy(meas, device="cuda", dtype=None) -> Measurements:
    """Measurements-like (pose, vel, steer_angle, pose_valid, vel_valid,
    steer_valid) -> port ``Measurements``, a batch of one where unbatched
    (steer_angle of shape [])."""
    out = _build(Measurements, meas, device, dtype)
    return _batched(out) if out.steer_angle.dim() == 0 else out


def _batched(x):
    if isinstance(x, tuple):
        return type(x)(*(_batched(v) for v in x))
    return x[None]
