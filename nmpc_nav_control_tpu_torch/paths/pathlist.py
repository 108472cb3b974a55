"""Fixed-capacity path lists and pose/velocity sampling, batched.

Port of ``nmpc_nav_control_tpu/paths/pathlist.py`` (the reference's
``std::list<TPath>`` and ``PathDiscretizer::getPoseSample`` /
``getVelSample``, ``PathDiscretizer.cpp:66-102``): a global parameter
``u in [0, count]`` indexes segment ``floor(u)`` at local parameter
``u - floor(u)``, clamped to the first/last segment outside the range.

A ``PathList`` holds a batch of lists: every segment leaf is [B, M, ...]
and ``count`` [B] int32.  The JAX package selects a segment with a one-hot
contraction, a TPU workaround for gathers; here it is a ``torch.gather``
with the index clamped, which gives the same values for finite leaves.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from nmpc_nav_control_tpu_torch.paths.segment import (
    PathSegment,
    seg_dxy,
    seg_theta,
    seg_theta_holonomic,
    seg_xy,
)

__all__ = ["PathList", "make_path_list", "path_capacity", "pose_sample", "take_rows",
           "vel_sample"]


class PathList(NamedTuple):
    segs: PathSegment      # every leaf [B, M, ...]
    count: torch.Tensor    # [B] int32 number of valid segments


def path_capacity(plist: PathList) -> int:
    return plist.segs.cx.shape[1]


def make_path_list(segments, capacity: int) -> PathList:
    """Stack a Python list of single segments (``make_line_segment``'s) into
    a one-lane PathList ([1, capacity, ...]), zero-padded, on their device."""
    n = len(segments)
    if n > capacity:
        raise ValueError(f"{n} segments > capacity {capacity}")

    def stack(*xs):
        x = torch.stack(xs)
        pad = torch.zeros((capacity - n,) + x.shape[1:], dtype=x.dtype, device=x.device)
        return torch.cat([x, pad])[None]

    segs = PathSegment(*(stack(*leaves) for leaves in zip(*segments)))
    count = torch.full((1,), n, dtype=torch.int32, device=segs.cx.device)
    return PathList(segs=segs, count=count)


def take_rows(leaf, idx):
    """``leaf[b, idx[b, ...]]``: leaf [B, M, *T], idx [B, *S] integer in
    [0, M) -> [B, *S, *T], one ``torch.gather``."""
    B, tail = leaf.shape[0], leaf.shape[2:]
    flat = idx.reshape(B, -1).long()
    index = flat.reshape(flat.shape + (1,) * len(tail)).expand(flat.shape + tail)
    return torch.gather(leaf, 1, index).reshape(idx.shape + tail)


def _lane(x, like):
    """A [B] tensor shaped to broadcast against ``like`` [B, *S]."""
    return x.reshape(x.shape + (1,) * (like.dim() - 1))


def _locate(plist: PathList, sample_u, fields):
    """Global u [B, *S] -> (segment with the ``fields`` selected, [B, *S]
    leaves; local u; whether the lane has a segment), with the reference
    clamping (``PathDiscretizer.cpp:68-75``).  A lane with count 0 has no
    segment: the JAX package's one-hot selects zeros there, so callers zero
    what they return for it."""
    count = _lane(plist.count, sample_u)
    path_num = torch.floor(sample_u).to(torch.int32)
    u = sample_u - path_num.to(sample_u.dtype)
    over = path_num >= count
    under = path_num < 0
    path_num = torch.minimum(path_num.clamp(min=0), count - 1)
    u = torch.where(over, torch.ones_like(u), torch.where(under, torch.zeros_like(u), u))
    idx = path_num.clamp(min=0)
    seg = PathSegment(*(take_rows(getattr(plist.segs, f), idx) if f in fields else None
                        for f in PathSegment._fields))
    return seg, u, path_num >= 0


def pose_sample(plist: PathList, sample_u, is_holonomic: bool):
    """(x, y, theta) [B, *S, 3] at global u [B, *S]
    (``PathDiscretizer::getPoseSample``, ``PathDiscretizer.cpp:66-90``):
    non-holonomic theta is the tangent heading, +pi where the segment's
    nominal velocity is negative (reverse driving); holonomic theta is the
    dedicated heading profile."""
    fields = ("cx", "cy", "ch") if is_holonomic else ("cx", "cy", "velocity")
    seg, u, has = _locate(plist, sample_u, fields)
    x, y = seg_xy(seg, u)
    if is_holonomic:
        theta = seg_theta_holonomic(seg, u)
    else:
        theta = seg_theta(seg, u)
        theta = torch.where(seg.velocity >= 0, theta, theta + math.pi)
    return torch.where(has[..., None], torch.stack([x, y, theta], -1), 0.0)


def vel_sample(plist: PathList, sample_u):
    """(dx/du, dy/du) [B, *S, 2] at global u [B, *S]
    (``PathDiscretizer::getVelSample``, ``PathDiscretizer.cpp:92-102``)."""
    seg, u, has = _locate(plist, sample_u, ("cx", "cy"))
    dx, dy = seg_dxy(seg, u)
    return torch.where(has[..., None], torch.stack([dx, dy], -1), 0.0)
