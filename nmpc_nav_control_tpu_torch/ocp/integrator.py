"""Explicit RK4 integration with forward sensitivities.

Port of ``nmpc_nav_control_tpu/ocp/integrator.py``: one classical RK4 step
per shooting interval; stage Jacobians A = dF/dx, B = dF/du by forward-mode
differentiation (``torch.func.jacfwd``) through the RK4 step.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import jacfwd, vmap

__all__ = ["rk4_step", "make_discrete_dynamics", "linearize_trajectory", "rollout"]


def rk4_step(f: Callable, x, u, p, dt):
    """One classical RK4 step of xdot = f(x, u, p) over step size dt."""
    k1 = f(x, u, p)
    k2 = f(x + 0.5 * dt * k1, u, p)
    k3 = f(x + 0.5 * dt * k2, u, p)
    k4 = f(x + dt * k3, u, p)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def make_discrete_dynamics(f: Callable, dt: float) -> Callable:
    """Return the discrete one-step map F(x, u, p) (single RK4 step)."""

    def F(x, u, p):
        return rk4_step(f, x, u, p, dt)

    return F


def linearize_trajectory(f: Callable, dt: float, xs, us, p):
    """Linearize the discrete dynamics along one trajectory.

    xs [N+1, nx] (only xs[:N] used), us [N, nu], p [npar] ->
    (x_next [N, nx], A [N, nx, nx], B [N, nx, nu]).
    """
    F = make_discrete_dynamics(f, dt)

    def stage(x, u):
        A, B = jacfwd(F, argnums=(0, 1))(x, u, p)
        return F(x, u, p), A, B

    return vmap(stage)(xs[:-1], us)


def rollout(f: Callable, dt: float, x0, us, p):
    """Roll the discrete dynamics forward from x0 under us [N, nu] -> [N+1, nx]."""
    F = make_discrete_dynamics(f, dt)
    xs = [x0]
    for k in range(us.shape[0]):
        xs.append(F(xs[-1], us[k], p))
    return torch.stack(xs)
