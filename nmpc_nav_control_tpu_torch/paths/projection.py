"""Nearest-point projection onto a path list, batched.

Port of ``nmpc_nav_control_tpu/paths/projection.py`` (the reference's
``TPathProcessMinDist(10, 0.01)``, ``NMPCNavControlROS.cpp:597-601``): for
each lane, the fractional global parameter u* nearest the robot position
and the pose there.  Fixed work, no data-dependent loop:

  1. coarse grid: GRID samples per segment across the capacity, invalid
     segments at +inf, one argmin (the first minimum, as ``jnp.argmin``);
  2. NEWTON_ITERS Newton steps on g(u) = |P(u) - r|^2 / 2 within the
     winning segment, clamped to [0, 1].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from nmpc_nav_control_tpu_torch.paths.pathlist import PathList, path_capacity, take_rows
from nmpc_nav_control_tpu_torch.paths.segment import (
    jnp_linspace,
    poly_deriv_eval,
    poly_eval,
    seg_theta,
    seg_theta_holonomic,
)

__all__ = ["MinDistResult", "project_to_path"]

GRID = 32
NEWTON_ITERS = 10


class MinDistResult(NamedTuple):
    u: torch.Tensor                # [B] fractional global parameter
    x: torch.Tensor                # [B] nearest point
    y: torch.Tensor
    theta: torch.Tensor            # [B] tangent heading (no reverse correction)
    theta_holonomic: torch.Tensor  # [B] holonomic heading


def _poly_second_deriv(c, u):
    deg = c.shape[-1]
    out = c[..., -1] * (deg - 1) * (deg - 2)
    for i in range(deg - 2, 1, -1):
        out = out * u + c[..., i] * i * (i - 1)
    return out


def project_to_path(plist: PathList, rx, ry) -> MinDistResult:
    """GetMinDist analog for robot positions rx, ry [B].  u is relative to
    the current path list (segment index + local u); the caller pops
    completed segments (``NMPCNavControlROS.cpp:603-609``)."""
    M = path_capacity(plist)
    dtype = plist.segs.cx.dtype
    rx, ry = rx.to(dtype), ry.to(dtype)

    # Coarse pass: [B, M, GRID] distances, invalid segments at +inf.
    ugrid = jnp_linspace(GRID, dtype, rx.device)
    xg = poly_eval(plist.segs.cx[..., None, :], ugrid)
    yg = poly_eval(plist.segs.cy[..., None, :], ugrid)
    d2 = (xg - rx[:, None, None]) ** 2 + (yg - ry[:, None, None]) ** 2
    seg_valid = torch.arange(M, device=rx.device) < plist.count[:, None]
    d2 = torch.where(seg_valid[..., None], d2, torch.inf)
    flat = torch.argmin(d2.reshape(d2.shape[0], -1), 1)
    seg_idx = flat // GRID
    u = (flat % GRID).to(dtype) / (GRID - 1)
    # Only the polynomials are read: gather those three leaves.
    seg = plist.segs._replace(**{f: take_rows(getattr(plist.segs, f), seg_idx)
                                 for f in ("cx", "cy", "ch")})

    # Newton refinement; the curvature guard falls back to a gradient step.
    for _ in range(NEWTON_ITERS):
        px = poly_eval(seg.cx, u) - rx
        py = poly_eval(seg.cy, u) - ry
        dx = poly_deriv_eval(seg.cx, u)
        dy = poly_deriv_eval(seg.cy, u)
        ddx = _poly_second_deriv(seg.cx, u)
        ddy = _poly_second_deriv(seg.cy, u)
        g1 = px * dx + py * dy
        g2 = dx * dx + dy * dy + px * ddx + py * ddy
        g2 = torch.where(g2 > 1e-9, g2, dx * dx + dy * dy + 1e-9)
        u = torch.clamp(u - g1 / g2, 0.0, 1.0)

    return MinDistResult(
        u=seg_idx.to(dtype) + u,
        x=poly_eval(seg.cx, u),
        y=poly_eval(seg.cy, u),
        theta=seg_theta(seg, u),
        theta_holonomic=seg_theta_holonomic(seg, u),
    )
