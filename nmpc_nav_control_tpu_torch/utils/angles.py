"""Angle / distance helpers (elementwise torch).

Port of ``nmpc_nav_control_tpu/utils/angles.py``:
  - ``norm_ang_rad``  — reference ``include/nmpc_nav_control/utils.h:33-47``
  - ``norm_ang_deg``  — reference ``include/nmpc_nav_control/utils.h:17-31``
  - ``unwrap_angle``  — reference ``src/nmpc_nav_control/NMPCNavControl.cpp:25-31``
  - ``dist``          — reference ``include/nmpc_nav_control/utils.h:8-14``
"""
from __future__ import annotations

import math

import torch

__all__ = ["norm_ang_rad", "norm_ang_deg", "unwrap_angle", "dist"]


def norm_ang_rad(angle):
    """Normalize an angle to [-pi, pi).

    ``torch.remainder`` takes the sign of the divisor, like ``jnp.mod``.
    """
    return torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi


def norm_ang_deg(angle):
    """Normalize an angle in degrees to [-180, 180)."""
    return torch.remainder(angle + 180.0, 360.0) - 180.0


def unwrap_angle(current, previous):
    """Single-step unwrap: shift ``current`` by +/- 2 pi once if it jumps by
    more than pi relative to ``previous`` (an ``if/else if``, not a loop)."""
    delta = current - previous
    current = torch.where(delta > math.pi, current - 2.0 * math.pi, current)
    return torch.where(delta < -math.pi, current + 2.0 * math.pi, current)


def dist(x1, y1, x2, y2):
    """Euclidean distance."""
    return torch.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)
