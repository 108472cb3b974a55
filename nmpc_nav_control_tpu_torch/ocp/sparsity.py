"""Structural sparsity detection for the discrete stage Jacobians.

Port of ``nmpc_nav_control_tpu/ocp/sparsity.py``: evaluate the RK4 Jacobians
at a few random states/inputs with the controller's concrete parameters and
OR the nonzero masks.  The sample points come from the same numpy generator
and seed as the JAX package, so both packages detect the same pattern.  The
pattern must over-approximate: a false zero would silently drop dynamics
terms in the IPM kernels, which skip structural zeros.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd

from nmpc_nav_control_tpu_torch.ocp.integrator import make_discrete_dynamics

__all__ = ["detect_jacobian_sparsity"]


def detect_jacobian_sparsity(f, dt: float, nx: int, nu: int, p,
                             samples: int = 4, seed: int = 0):
    """Return static (A_pattern, B_pattern) as nested bool tuples.

    ``p``: concrete model parameters; evaluated on the CPU in p's dtype.
    """
    p_cpu = torch.as_tensor(p).detach().cpu()
    jac = jacfwd(make_discrete_dynamics(f, dt), argnums=(0, 1))
    rng = np.random.default_rng(seed)
    accA = np.zeros((nx, nx), bool)
    accB = np.zeros((nx, nu), bool)
    for _ in range(samples):
        x = torch.as_tensor(rng.normal(size=nx), dtype=p_cpu.dtype)
        u = torch.as_tensor(rng.normal(size=nu), dtype=p_cpu.dtype)
        A, B = jac(x, u, p_cpu)
        accA |= A.numpy() != 0.0
        accB |= B.numpy() != 0.0
    return (
        tuple(tuple(bool(v) for v in row) for row in accA),
        tuple(tuple(bool(v) for v in row) for row in accB),
    )
