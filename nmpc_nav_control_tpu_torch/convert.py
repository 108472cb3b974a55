"""Conversion between the JAX package's data and the port's tensors.

The numeric data of a controller (``OCPData``) and its warm-start state
(``RTIState``) are what weights are to a model.  These functions take the
JAX package's NamedTuples with their leaves as numpy arrays (``np.asarray``
of each JAX leaf, batched or not) and build the port's tensors on a device,
and turn a port state back into numpy leaves under the same field names, so
``nmpc_nav_control_tpu.rti.RTIState(*rti_state_to_numpy(s))`` rebuilds the
JAX state.  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from nmpc_nav_control_tpu_torch.ocp.spec import OCPData
from nmpc_nav_control_tpu_torch.rti.step import RTIState

__all__ = ["ocp_data_from_numpy", "rti_state_from_numpy", "rti_state_to_numpy"]


def _tensor(x, device, dtype):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def ocp_data_from_numpy(data, device="cpu", dtype=None) -> OCPData:
    """OCPData-like (p, lbx, ubx, lbu, ubu, q_diag, r_diag, qe_diag) -> port
    ``OCPData``; leaves keep their batch axis, if any."""
    return OCPData(*(_tensor(getattr(data, f), device, dtype) for f in OCPData._fields))


def rti_state_from_numpy(state, device="cpu", dtype=None) -> RTIState:
    """RTIState-like (xs, us, x0_carry) -> port ``RTIState`` with a leading
    batch axis (an unbatched state becomes a batch of one)."""
    xs, us, x0 = (_tensor(getattr(state, f), device, dtype) for f in RTIState._fields)
    if xs.ndim == 2:
        xs, us, x0 = xs[None], us[None], x0[None]
    return RTIState(xs=xs, us=us, x0_carry=x0)


def rti_state_to_numpy(state: RTIState) -> RTIState:
    """Port ``RTIState`` -> the same NamedTuple with batched numpy leaves."""
    return RTIState(*(t.detach().cpu().numpy() for t in state))
