"""Differential-drive AMR model ('diff2amr').

Port of ``nmpc_nav_control_tpu/models/diff.py``; orderings as there:
  x = (x, y, theta, vl, vr, vl_ref, vr_ref)          nx = 7
  u = (dvl_ref, dvr_ref)                             nu = 2
  p = (dist_b, tau_v)                                npar = 2
"""
from __future__ import annotations

import torch

from nmpc_nav_control_tpu_torch.models.base import ModelSpec

__all__ = ["SPEC", "f", "direct_kinematics", "inverse_kinematics", "make_params"]

X, Y, THETA, VL, VR, VL_REF, VR_REF = range(7)
DVL_REF, DVR_REF = range(2)
P_DIST_B, P_TAU_V = range(2)


def f(x, u, p):
    """Continuous-time dynamics xdot = f(x, u, p), entries on the first axis."""
    dist_b = p[P_DIST_B]
    tau_v = p[P_TAU_V]
    theta = x[THETA]
    vl, vr = x[VL], x[VR]
    v = 0.5 * (vr + vl)
    return torch.stack(
        [
            v * torch.cos(theta),
            v * torch.sin(theta),
            (vr - vl) / dist_b,
            (x[VL_REF] - vl) / tau_v,
            (x[VR_REF] - vr) / tau_v,
            u[DVL_REF],
            u[DVR_REF],
        ]
    )


def direct_kinematics(v, w, dist_b):
    """Body (v, w) -> wheel (vl, vr)."""
    return v - 0.5 * dist_b * w, v + 0.5 * dist_b * w


def inverse_kinematics(vl, vr, dist_b):
    """Wheel (vl, vr) -> body (v, w)."""
    return 0.5 * (vr + vl), (vr - vl) / dist_b


def make_params(dist_b: float, tau_v: float, dtype=torch.float64, device="cuda"):
    return torch.tensor([dist_b, tau_v], dtype=dtype, device=device)


SPEC = ModelSpec(
    name="diff",
    nx=7,
    nu=2,
    npar=2,
    idxbx=(VL_REF, VR_REF),
    idxbu=(DVL_REF, DVR_REF),
    f=f,
)
