"""Parametric path segments (the TPath contract), as tensors.

Port of ``nmpc_nav_control_tpu/paths/segment.py``.  A segment is a pair of
fixed-degree polynomials x(u), y(u), u in [0, 1], plus a holonomic-heading
polynomial, a signed nominal velocity, a frame code (0 = empty/invalid) and
its arc length.  Leaves carry any leading axes: one segment, a path list
[M], or a batch of path lists [B, M].

Orientation semantics (reference ``PathDiscretizer.cpp:76-90``):
  theta(u)           = atan2(y'(u), x'(u))   (+ pi for a negative velocity,
                                              applied by the caller)
  theta_holonomic(u) = the dedicated polynomial.
"""
from __future__ import annotations

import numpy as np
import torch

from nmpc_nav_control_tpu_torch.tick_types import PathSegment
from nmpc_nav_control_tpu_torch.utils.index import kept

__all__ = [
    "ARC_SAMPLES",
    "DEG",
    "PathSegment",
    "jnp_linspace",
    "make_cubic_segment",
    "make_line_segment",
    "poly_deriv_eval",
    "poly_eval",
    "seg_arc_length",
    "seg_dxy",
    "seg_theta",
    "seg_theta_holonomic",
    "seg_xy",
]

# Polynomial coefficient count (degree DEG-1): quintics with headroom.
DEG = 8
# Chord samples for the numeric arc length (the reference calls
# SetPathLength(1000) on ingest, ``NMPCNavControlROS.cpp:571``).
ARC_SAMPLES = 256


def jnp_linspace(n: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` as JAX computes it: ``i * (1 / (n - 1))``
    in ``dtype`` for i < n - 1, then exactly 1 (``torch.linspace`` rounds
    differently by an ulp, which can move the discrete decisions built on
    these grids).  Made once per (n, dtype, device) (``utils.index.kept``),
    so only a tick's first, uncaptured call makes it; callers must not
    write to it."""
    def make():
        div = n - 1
        delta = torch.ones((), dtype=dtype, device=device) / div
        head = torch.arange(div, dtype=dtype, device=device) * delta
        return torch.cat([head, torch.ones(1, dtype=dtype, device=device)])

    return kept(("linspace", n, dtype, device), make)


def poly_eval(c, u):
    """Horner evaluation of p(u) = sum_i c[i] u^i; c: [..., DEG]."""
    out = c[..., -1]
    for i in range(DEG - 2, -1, -1):
        out = out * u + c[..., i]
    return out


def poly_deriv_eval(c, u):
    """p'(u), Horner in the JAX package's order."""
    out = c[..., -1] * (DEG - 1)
    for i in range(DEG - 2, 0, -1):
        out = out * u + c[..., i] * i
    return out


def seg_xy(seg: PathSegment, u):
    return poly_eval(seg.cx, u), poly_eval(seg.cy, u)


def seg_dxy(seg: PathSegment, u):
    return poly_deriv_eval(seg.cx, u), poly_deriv_eval(seg.cy, u)


def seg_theta(seg: PathSegment, u):
    """Tangent heading: GetTheta(u) = atan2(y', x')."""
    dx, dy = seg_dxy(seg, u)
    return torch.atan2(dy, dx)


def seg_theta_holonomic(seg: PathSegment, u):
    """GetThetaHolomonic(u): independent heading profile."""
    return poly_eval(seg.ch, u)


def seg_arc_length(cx, cy, samples: int = ARC_SAMPLES):
    """Chord-sum arc length over u in [0, 1] (SetPathLength analog);
    cx, cy [..., DEG] -> [...]."""
    u = jnp_linspace(samples + 1, cx.dtype, cx.device)
    xs = poly_eval(cx[..., None, :], u)
    ys = poly_eval(cy[..., None, :], u)
    return torch.sum(torch.sqrt(torch.diff(xs) ** 2 + torch.diff(ys) ** 2), -1)


def _make_segment(cx, cy, ch, velocity, frame_id, dtype, device) -> PathSegment:
    def coeffs(c):
        out = np.zeros(DEG)
        out[: len(c)] = c
        return torch.as_tensor(out, dtype=dtype, device=device)

    cx, cy = coeffs(cx), coeffs(cy)
    return PathSegment(
        cx=cx, cy=cy, ch=coeffs(ch),
        velocity=torch.as_tensor(velocity, dtype=dtype, device=device),
        frame_id=torch.as_tensor(frame_id, dtype=torch.int32, device=device),
        length=seg_arc_length(cx, cy),
    )


def make_line_segment(p0, p1, velocity=1.0, frame_id=1, theta_holonomic=0.0,
                      dtype=torch.float32, device="cuda") -> PathSegment:
    """Straight segment from p0 to p1, on the card unless ``device`` says
    otherwise."""
    (x0, y0), (x1, y1) = np.asarray(p0, float), np.asarray(p1, float)
    return _make_segment([x0, x1 - x0], [y0, y1 - y0], [theta_holonomic], velocity, frame_id,
                    dtype, device)


def make_cubic_segment(cx_coeffs, cy_coeffs, velocity=1.0, frame_id=1, ch_coeffs=(0.0,),
                       dtype=torch.float32, device="cuda") -> PathSegment:
    """Segment from explicit polynomial coefficients (low order first)."""
    return _make_segment(list(cx_coeffs), list(cy_coeffs), list(ch_coeffs), velocity, frame_id,
                    dtype, device)
