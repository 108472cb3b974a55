"""The one generator of every traffic mix: goals and multi-segment paths.

A traffic file (``benchmark/traffic/<name>.json``) names its driver and the
parameters read here.  Everything is drawn from ``numpy.random`` seeded by
(run seed, stream), so the same seed gives the same traffic and the program
only ever sees what these functions made.

Paths are drawn in a local frame (start at the origin, heading 0) and placed
at a robot's pose when sent.  A segment is a straight line or a circular arc
given as a cubic Hermite polynomial x(u), y(u), u in [0, 1] (an arc's end
tangents scaled 4 tan(phi/4) / phi of its length, the usual cubic arc), with
the heading polynomial ``ch`` going linearly from the start heading to the end
heading (omni4 robots hold it).
"""
from __future__ import annotations

import math

import numpy as np
import torch

CAP, DEG = 16, 8          # the node's path capacity and coefficients per curve


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 63, stream])


def uniform(g: np.random.Generator, lohi, size=None):
    lo, hi = lohi
    return g.uniform(lo, hi, size)


def paths(g: np.random.Generator, n: int, mix: dict) -> dict:
    """``n`` paths in the local frame: cx, cy, ch [n, CAP, DEG], vel [n, CAP]
    and count [n] (unused rows zero)."""
    out = {k: np.zeros((n, CAP, DEG)) for k in ("cx", "cy", "ch")}
    out["vel"] = np.zeros((n, CAP))
    out["count"] = g.integers(mix["segments"][0], mix["segments"][1] + 1, n)
    speed = uniform(g, mix["path_speed"], n)
    p, h = np.zeros((n, 2)), np.zeros(n)
    for j in range(CAP):
        length = uniform(g, mix["segment_m"], n)
        arc = g.random(n) >= mix["line_share"]
        phi = np.where(arc, np.radians(uniform(g, mix["turn_deg"], n)) * g.choice([-1.0, 1.0], n),
                       0.0)
        safe = np.where(arc, phi, 1.0)
        chord = np.stack([np.sin(h + phi) - np.sin(h), np.cos(h) - np.cos(h + phi)], -1)
        end = np.where(arc[:, None], chord * (length / safe)[:, None],
                       length[:, None] * np.stack([np.cos(h), np.sin(h)], -1)) + p
        tang = np.where(arc, length * 4 * np.tan(safe / 4) / safe, length)[:, None]
        d0 = tang * np.stack([np.cos(h), np.sin(h)], -1)
        d1 = tang * np.stack([np.cos(h + phi), np.sin(h + phi)], -1)
        c = np.stack([p, d0, 3 * (end - p) - 2 * d0 - d1, 2 * (p - end) + d0 + d1], 1)
        use = j < out["count"]
        out["cx"][use, j, :4], out["cy"][use, j, :4] = c[use, :, 0], c[use, :, 1]
        out["ch"][use, j, 0], out["ch"][use, j, 1] = h[use], phi[use]
        out["vel"][use, j] = speed[use]
        p, h = end, h + phi
    return out


def place(path: dict, pose) -> dict:
    """Paths (torch leaves [n, CAP, DEG] / [n, CAP]) moved to start at poses
    [n, 3]: rotated by the heading, shifted to the position."""
    c, s = torch.cos(pose[:, 2])[:, None, None], torch.sin(pose[:, 2])[:, None, None]
    cx, cy, ch = path["cx"], path["cy"], path["ch"]
    valid = (path["vel"] != 0)[..., None]
    shift = torch.zeros_like(cx)
    shift[..., 0] = 1.0
    shift = shift * valid
    return dict(path, cx=c * cx - s * cy + shift * pose[:, 0, None, None],
                cy=s * cx + c * cy + shift * pose[:, 1, None, None],
                ch=ch + shift * pose[:, 2, None, None])


def goal_offsets(g: np.random.Generator, shape, mix: dict) -> np.ndarray:
    """Goals relative to a robot [*shape, 3]: a distance in ``goal_m``, any
    bearing, and a final heading within ``goal_heading_deg`` of the bearing."""
    r = uniform(g, mix["goal_m"], shape)
    bearing = g.uniform(-math.pi, math.pi, shape)
    head = bearing + np.radians(uniform(g, [-1, 1], shape) * mix["goal_heading_deg"])
    return np.stack([r * np.cos(bearing), r * np.sin(bearing), head], -1)


def relative_to(pose, offset):
    """The goal [B, 3] at ``offset`` [B, 3] in the frame of ``pose`` [B, 3]."""
    c, s = torch.cos(pose[:, 2]), torch.sin(pose[:, 2])
    return torch.stack([pose[:, 0] + c * offset[:, 0] - s * offset[:, 1],
                        pose[:, 1] + s * offset[:, 0] + c * offset[:, 1],
                        pose[:, 2] + offset[:, 2]], -1)


def ticks(g: np.random.Generator, expected: int, n: int) -> list:
    """``n`` distinct ticks of the window, in [1, expected), that the
    correctness check compares."""
    return sorted(int(t) for t in g.choice(np.arange(1, max(expected, n + 1)), n, replace=False))


def lanes(g: np.random.Generator, batch: int, n: int) -> np.ndarray:
    """``n`` distinct lanes of a batch, sorted."""
    return np.sort(g.choice(batch, min(n, batch), replace=False))
