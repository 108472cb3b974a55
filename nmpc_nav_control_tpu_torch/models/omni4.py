"""4-wheel omnidirectional AMR model ('omni4amr').

Port of ``nmpc_nav_control_tpu/models/omni4.py``; orderings as there:
  x = (x, y, theta, v1..v4, v1_ref..v4_ref)          nx = 11
  u = (dv1_ref..dv4_ref)                             nu = 4
  p = (l1_plus_l2, tau_v)                            npar = 2
Body velocities from the wheels: v = (v1 - v2 + v3 - v4)/4,
vn = (-v1 - v2 + v3 + v4)/4, w = -(v1 + v2 + v3 + v4)/(2 (l1+l2)).
"""
from __future__ import annotations

import torch

from nmpc_nav_control_tpu_torch.models.base import ModelSpec

__all__ = ["SPEC", "f", "direct_kinematics", "inverse_kinematics", "make_params"]

X, Y, THETA, V1, V2, V3, V4, V1_REF, V2_REF, V3_REF, V4_REF = range(11)
DV1_REF, DV2_REF, DV3_REF, DV4_REF = range(4)
P_L1_PLUS_L2, P_TAU_V = range(2)


def f(x, u, p):
    """Continuous-time dynamics xdot = f(x, u, p), entries on the first axis."""
    l12 = p[P_L1_PLUS_L2]
    tau_v = p[P_TAU_V]
    theta = x[THETA]
    v, vn, w = inverse_kinematics(x[V1], x[V2], x[V3], x[V4], l12)
    ct, st = torch.cos(theta), torch.sin(theta)
    lag = (x[V1_REF:V4_REF + 1] - x[V1:V4 + 1]) / tau_v
    return torch.cat([torch.stack([v * ct - vn * st, v * st + vn * ct, w]), lag, u])


def direct_kinematics(v, vn, w, l1_plus_l2):
    """Body (v, vn, w) -> wheel velocities (v1, v2, v3, v4)."""
    half_lw = 0.5 * l1_plus_l2 * w
    return v - vn - half_lw, -v - vn - half_lw, v + vn - half_lw, -v + vn - half_lw


def inverse_kinematics(v1, v2, v3, v4, l1_plus_l2):
    """Wheel velocities -> body (v, vn, w)."""
    v = (v1 - v2 + v3 - v4) / 4.0
    vn = (-v1 - v2 + v3 + v4) / 4.0
    w = -(v1 + v2 + v3 + v4) / (2.0 * l1_plus_l2)
    return v, vn, w


def make_params(l1_plus_l2: float, tau_v: float, dtype=torch.float64, device="cpu"):
    return torch.tensor([l1_plus_l2, tau_v], dtype=dtype, device=device)


SPEC = ModelSpec(
    name="omni4",
    nx=11,
    nu=4,
    npar=2,
    idxbx=(V1_REF, V2_REF, V3_REF, V4_REF),
    idxbu=(DV1_REF, DV2_REF, DV3_REF, DV4_REF),
    f=f,
)
