"""Tricycle AMR model ('tric3amr').

Port of ``nmpc_nav_control_tpu/models/tric.py``; orderings as there:
  x = (x, y, theta, v, alpha, v_ref, alpha_ref)      nx = 7
  u = (dv_ref, dalpha_ref)                           nu = 2
  p = (dist_d, tau_v, tau_a)                         npar = 3
Intended kinematics: x_dot = v cos(theta) cos(alpha), y_dot = v sin(theta)
cos(alpha), theta_dot = (v / dist_d) sin(alpha), first-order lags on
(v, alpha) and integrator states (v_ref, alpha_ref).

The reference's generated solver uses sin(alpha) where cos(alpha) is
intended in x_dot / y_dot; ``f`` is the intended model and
``f_bug_compat`` / ``SPEC_BUG_COMPAT`` reproduce the reference as generated,
for parity runs, exactly as the JAX package does.
"""
from __future__ import annotations

import torch

from nmpc_nav_control_tpu_torch.models.base import ModelSpec

__all__ = ["SPEC", "SPEC_BUG_COMPAT", "f", "f_bug_compat", "make_params"]

X, Y, THETA, V, ALPHA, V_REF, ALPHA_REF = range(7)
DV_REF, DALPHA_REF = range(2)
P_DIST_D, P_TAU_V, P_TAU_A = range(3)


def _f(x, u, p, cos_alpha_fn):
    dist_d, tau_v, tau_a = p[P_DIST_D], p[P_TAU_V], p[P_TAU_A]
    theta, v, alpha = x[THETA], x[V], x[ALPHA]
    ca = cos_alpha_fn(alpha)
    return torch.stack(
        [
            v * torch.cos(theta) * ca,
            v * torch.sin(theta) * ca,
            v / dist_d * torch.sin(alpha),
            (x[V_REF] - v) / tau_v,
            (x[ALPHA_REF] - alpha) / tau_a,
            u[DV_REF],
            u[DALPHA_REF],
        ]
    )


def f(x, u, p):
    """Intended tricycle dynamics (cos(alpha) in the position rates)."""
    return _f(x, u, p, torch.cos)


def f_bug_compat(x, u, p):
    """The reference as generated: sin(alpha) where cos(alpha) is intended."""
    return _f(x, u, p, torch.sin)


def make_params(dist_d: float, tau_v: float, tau_a: float, dtype=torch.float64,
                device="cpu"):
    return torch.tensor([dist_d, tau_v, tau_a], dtype=dtype, device=device)


SPEC = ModelSpec(
    name="tric",
    nx=7,
    nu=2,
    npar=3,
    idxbx=(V_REF, ALPHA_REF),
    idxbu=(DV_REF, DALPHA_REF),
    f=f,
)

SPEC_BUG_COMPAT = ModelSpec(
    name="tric_bug_compat",
    nx=7,
    nu=2,
    npar=3,
    idxbx=(V_REF, ALPHA_REF),
    idxbu=(DV_REF, DALPHA_REF),
    f=f_bug_compat,
)
