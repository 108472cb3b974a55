"""Active/upcoming path-buffer windowing, batched.

Port of ``nmpc_nav_control_tpu/paths/windowing.py`` (the reference's
``active_path_`` / ``upcoming_path_`` lists, ``NMPCNavControlROS.cpp:
555-610,682-694``), every leaf with a leading batch axis [B]:

  - ``ingest``: new path set -> valid segments become upcoming, buffers
    cleared, then top-up (``processPathReceived``, ``:555-574``);
  - ``top_up``: move upcoming segments into the active window until its arc
    length reaches ``max_active_path_length``, stopping at a velocity-sign or
    frame-id change between the active tail and the upcoming head
    (``processPathBuffers``, ``:576-595``);
  - ``pop_completed``: drop ``floor(u)`` passed segments, rebase u
    (``processNearestPoint``, ``:603-609``);
  - ``rotate_end_of_curve``: drop the front active segment and pull in the
    next upcoming one (``processFollowPath``, ``:687-689``).

State: a segment store ``segs`` [B, CAP] and three cursors per lane:
``head`` (first active segment), ``active_count``, ``total_count`` (active +
upcoming, counted from head).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from nmpc_nav_control_tpu_torch.paths.pathlist import PathList, take_rows
from nmpc_nav_control_tpu_torch.paths.segment import DEG, PathSegment

__all__ = ["PathWindow", "window_init", "ingest", "top_up", "pop_completed",
           "rotate_end_of_curve", "active_path_list", "active_length",
           "path_remains", "select_rows"]


def select_rows(segs: PathSegment, idx) -> PathSegment:
    """``segs[b, idx[b]]`` for every leaf: idx [B] or [B, K] -> leaves
    [B, ...] or [B, K, ...], a clamped ``torch.gather``.

    The JAX package's one-hot form returns zeros for an index outside
    [0, CAP); this one clamps it.  Every caller clips the index into range
    first (``active_path_list`` here, the front-segment selects of
    ``node_tick``), and ``project_to_path``'s index is in range by
    construction, so on every call the tick makes the two agree."""
    cap = segs.frame_id.shape[1]
    idx = idx.clamp(0, cap - 1)
    return PathSegment(*(take_rows(leaf, idx) for leaf in segs))


class PathWindow(NamedTuple):
    segs: PathSegment          # leaves [B, CAP, ...]
    head: torch.Tensor         # [B] int32
    active_count: torch.Tensor
    total_count: torch.Tensor  # active + upcoming (counted from head)


def window_init(capacity: int, batch: int, dtype=torch.float32, device="cuda") -> PathWindow:
    """Empty windows for ``batch`` lanes, on the card unless ``device`` says
    otherwise."""
    def zeros(*shape, dtype=dtype):
        return torch.zeros((batch,) + shape, dtype=dtype, device=device)

    # Every leaf its own tensor: static buffers (GraphedNavigator) are
    # written leaf by leaf.
    z = zeros(capacity, DEG)
    segs = PathSegment(cx=z, cy=z.clone(), ch=z.clone(), velocity=zeros(capacity),
                       frame_id=zeros(capacity, dtype=torch.int32), length=zeros(capacity))
    zero = zeros(dtype=torch.int32)
    return PathWindow(segs=segs, head=zero, active_count=zero.clone(), total_count=zero.clone())


def ingest(win: PathWindow, new_segs: PathSegment, n_new,
           max_active_path_length: float) -> PathWindow:
    """New path set: clear both buffers, keep the first ``n_new`` rows with a
    valid frame id (the reference skips empty frame strings, ``:569``),
    compacted to the front in order, then top-up (``:566-573``).
    ``new_segs`` leaves [B, CAP, ...]; ``n_new`` an int or [B]."""
    cap = win.segs.frame_id.shape[1]
    idx = torch.arange(cap, device=new_segs.frame_id.device)
    if isinstance(n_new, torch.Tensor):
        n_new = n_new.reshape(-1, 1)
    valid = (idx < n_new) & (new_segs.frame_id != 0)
    # Stable sort of an integer key (0 = valid first), as jnp.argsort(~valid).
    order = torch.argsort((~valid).to(torch.int32), dim=1, stable=True)
    segs = PathSegment(*(take_rows(leaf, order) for leaf in new_segs))
    zero = torch.zeros_like(win.head)
    win = PathWindow(segs=segs, head=zero, active_count=zero,
                     total_count=valid.sum(1, dtype=torch.int32))
    return top_up(win, torch.zeros_like(segs.length[:, 0]), max_active_path_length)


def active_length(win: PathWindow, active_path_u) -> torch.Tensor:
    """Arc length [B] of the active window; the first segment contributes
    ``length * (1 - u)`` (the reference's 'aproximation', ``:578-582``)."""
    cap = win.segs.frame_id.shape[1]
    idx = torch.arange(cap, device=win.head.device)
    head = win.head[:, None]
    in_active = (idx >= head) & (idx < head + win.active_count[:, None])
    frac = torch.where(idx == head, 1.0 - active_path_u[:, None], 1.0)
    return torch.sum(torch.where(in_active, win.segs.length * frac, 0.0), 1)


def top_up(win: PathWindow, active_path_u, max_active_path_length: float) -> PathWindow:
    """Extend the active window to ~max_active_path_length meters, stopping
    at velocity-sign or frame-id barriers (``processPathBuffers``,
    ``:576-595``): the JAX package's capacity-long scan, as a loop of
    batched steps.  Each step reads (velocity, frame, length) of the active
    tail and of the upcoming head from one packed table with one gather per
    row (frame codes are small integers, exact in the float dtype)."""
    cap = win.segs.frame_id.shape[1]
    length = active_length(win, active_path_u)
    s = win.segs
    table = torch.stack([s.velocity, s.frame_id.to(s.velocity.dtype), s.length], -1)
    active_count = win.active_count
    for _ in range(cap):
        upcoming_left = win.total_count - active_count
        tail = take_rows(table, (win.head + active_count - 1).clamp(0, cap - 1))
        head_up = take_rows(table, (win.head + active_count).clamp(0, cap - 1))
        sign_break = tail[:, 0] * head_up[:, 0] < 0.0
        frame_break = tail[:, 1] != head_up[:, 1]
        barrier = (active_count > 0) & (sign_break | frame_break)
        take = (length < max_active_path_length) & (upcoming_left > 0) & ~barrier
        active_count = active_count + take.to(torch.int32)
        length = torch.where(take, length + head_up[:, 2], length)
    return win._replace(active_count=active_count)


def pop_completed(win: PathWindow, active_path_u):
    """Drop floor(u) passed segments; rebase u (``processNearestPoint``,
    ``:603-609``).  Returns (window, rebased u)."""
    n_pop = torch.floor(active_path_u).to(torch.int32)
    n_pop = torch.minimum(n_pop.clamp(min=0), win.active_count)
    return (
        win._replace(head=win.head + n_pop, active_count=win.active_count - n_pop,
                     total_count=win.total_count - n_pop),
        active_path_u - n_pop.to(active_path_u.dtype),
    )


def rotate_end_of_curve(win: PathWindow) -> PathWindow:
    """End of trajectory with upcoming left: pop the front active segment and
    pull in the next upcoming one (``processFollowPath``, ``:687-689``);
    active_count is unchanged (one popped, one appended)."""
    has_upcoming = (win.total_count > win.active_count).to(torch.int32)
    return win._replace(head=win.head + has_upcoming,
                        total_count=win.total_count - has_upcoming)


def active_path_list(win: PathWindow, capacity: int) -> PathList:
    """The active window as a PathList starting at index 0; ``capacity`` is
    the static output size (>= the most active segments)."""
    idx = win.head[:, None] + torch.arange(capacity, device=win.head.device)
    idx = idx.clamp(0, win.segs.frame_id.shape[1] - 1)
    return PathList(segs=select_rows(win.segs, idx),
                    count=win.active_count.clamp(max=capacity))


def path_remains(win: PathWindow, active_path_u):
    """The ``patch_remains`` status value: active + upcoming segment count
    minus the consumed fraction (``pubControlStatus``, ``:373-377``)."""
    total = win.total_count.to(active_path_u.dtype)
    return torch.where(total > 0, total - active_path_u, total)
