"""Path discretization: resample a parametric path into horizon poses, batched.

Port of ``nmpc_nav_control_tpu/paths/discretizer.py``
(``PathDiscretizer::getNextNPoses``, ``PathDiscretizer.cpp:14-63``): from
the nearest-point parameter, emit a pose every ``|vel| * dt`` of
accumulated chord length, padding the tail with the end-of-path pose.
Every function takes a batch of path lists and returns [B, num_poses, 3].

  - ``get_next_n_poses_fast`` (``NavConfig``'s default, the one a captured
    tick runs): chord tables and an exact per-segment solve of the emission
    recurrence, no data-dependent loop.
  - ``get_next_n_poses``: the reference's adaptive march as a fixed loop of
    ``num_poses * num_points_per_cycle * OVERSHOOT`` masked steps, for
    parity runs ("march").
"""
from __future__ import annotations

import torch

from nmpc_nav_control_tpu_torch.paths.pathlist import (
    PathList,
    pose_sample,
    take_rows,
    vel_sample,
)
from nmpc_nav_control_tpu_torch.paths.segment import jnp_linspace, poly_eval

__all__ = ["get_next_n_poses", "get_next_n_poses_fast"]

PERCENT_ERROR_DIST_THRESHOLD = 1e-2   # PathDiscretizer.cpp:8
OVERSHOOT = 2                          # iteration-budget safety factor


def _segment_rows(plist: PathList, u):
    """(segment index clamped into [0, count - 1], whether the lane has a
    segment) for global u [B, *S]; the index is -1 on a lane with count 0,
    where the JAX package's one-hot select gives zeros."""
    count = plist.count.reshape(plist.count.shape + (1,) * (u.dim() - 1))
    idx = torch.minimum(torch.floor(u).to(torch.int32).clamp(min=0), count - 1)
    return idx, idx >= 0


def _seg_speed(plist: PathList, u):
    """|GetVelocity()| of the segment holding u [B, *S] (clamped to the last
    valid segment, ``PathDiscretizer.cpp:26,45``); 0 on an empty list."""
    idx, has = _segment_rows(plist, u)
    speed = take_rows(plist.segs.velocity, idx.clamp(min=0)).abs()
    return torch.where(has, speed, 0.0)


def get_next_n_poses(plist: PathList, nearest_u, sample_period: float, num_poses: int,
                     is_holonomic: bool = False):
    """Resample ``num_poses`` poses spaced |vel|*dt in arc length by the
    reference's march: nearest_u [B] -> [B, num_poses, 3].  Each masked step
    costs a few tens of ops, so this runs ~800 steps at num_poses = 41: the
    parity path, not the card's."""
    dtype = plist.segs.cx.dtype
    n_cycle = 20 if sample_period >= 1.0 else 10
    budget = num_poses * n_cycle * OVERSHOOT
    n_end = plist.count.to(dtype)
    u = nearest_u.to(dtype)

    goal = _seg_speed(plist, u) * sample_period
    rel = goal / n_cycle
    old = pose_sample(plist, u, is_holonomic)
    dxy = vel_sample(plist, u)
    step = rel / torch.sqrt(dxy[:, 0] ** 2 + dxy[:, 1] ** 2)
    curr = torch.zeros_like(u)
    emitted = torch.zeros_like(plist.count)
    emits, slots, news = [], [], []
    for _ in range(budget):
        active = (u < n_end) & (emitted < num_poses)
        u_new = torch.minimum(u + step, n_end)
        new = pose_sample(plist, u_new, is_holonomic)
        curr_new = curr + torch.sqrt((new[:, 0] - old[:, 0]) ** 2 + (new[:, 1] - old[:, 1]) ** 2)
        emit = active & ((goal - curr_new) <= PERCENT_ERROR_DIST_THRESHOLD * goal)
        emits.append(emit)
        slots.append(emitted)
        news.append(new)
        goal = torch.where(emit, _seg_speed(plist, u_new) * sample_period, goal)
        rel = torch.where(emit, goal / n_cycle, rel)
        curr_new = torch.where(emit, torch.zeros_like(curr_new), curr_new)
        emitted = emitted + emit.to(emitted.dtype)
        dxy = vel_sample(plist, u_new)
        step_new = rel / torch.sqrt(dxy[:, 0] ** 2 + dxy[:, 1] ** 2)
        # Frozen when inactive.
        u = torch.where(active, u_new, u)
        old = torch.where(active[:, None], new, old)
        step = torch.where(active, step_new, step)
        curr = torch.where(active, curr_new, curr)
    # One scatter-add builds the pose table: each output row is written by
    # exactly one emitting step (slots strictly increase at emissions).
    emits, slots, news = torch.stack(emits, 1), torch.stack(slots, 1), torch.stack(news, 1)
    index = slots.clamp(0, num_poses - 1).long()[..., None].expand(news.shape)
    poses = torch.zeros(u.shape + (num_poses, 3), dtype=dtype, device=u.device)
    poses = poses.scatter_add(1, index, torch.where(emits[..., None], news, 0.0))
    # Tail padding with the end-of-path pose (``PathDiscretizer.cpp:57-62``).
    last = pose_sample(plist, n_end, is_holonomic)
    idx = torch.arange(num_poses, device=u.device)
    return torch.where((idx < emitted[:, None])[..., None], poses, last[:, None])


def get_next_n_poses_fast(plist: PathList, nearest_u, sample_period: float, num_poses: int,
                          is_holonomic: bool = False, coarse_samples: int = 64,
                          fine_samples: int = 512):
    """Arc-length resampler with the contract of :func:`get_next_n_poses`,
    parallel instead of marched (the JAX package's ``get_next_n_poses_fast``,
    whose docstring derives it): nearest_u [B] -> [B, num_poses, 3].

      1. a coarse chord table over [u0, n_end] bounds the parameter window
         that holds the horizon's arc (``num_poses * dt * max_speed``);
      2. a fine chord table s(u) over that window;
      3. the emission recurrence t_k = t_{k-1} + |vel(u_{k-1})| * dt has
         piecewise-constant speeds and is solved exactly by one static pass
         over the M segments; then one table inversion gives every u_k.

    The JAX package inverts the table with a masked compare-reduce over it
    (a TPU workaround for gathers); here ``torch.searchsorted`` finds the
    cell, which is the same cell because s is a cumulative sum of
    non-negative chords, hence non-decreasing.  The per-segment end arcs S_j
    use ``searchsorted`` on the table's u grid the same way.  As in the JAX
    package (its deliberate deviation from the march), a zero-tangent
    segment counts as zero arc and resampling goes on past it, where the
    reference's du = rel / |dP/du| -> inf jumps to the path end.
    """
    dtype = plist.segs.cx.dtype
    device = plist.count.device
    n_end = plist.count.to(dtype)
    u0 = torch.minimum(nearest_u.to(dtype), n_end)
    eps = 1e-6
    deg = plist.segs.cx.shape[-1]
    cxy = torch.cat([plist.segs.cx, plist.segs.cy], -1)          # [B, M, 2 DEG]

    def xy_sample(us):
        """[B, n] global u -> [B, n, 2] points (positions only)."""
        seg_i, has = _segment_rows(plist, us)
        lu = torch.clamp(us - seg_i.to(dtype), 0.0, 1.0)
        cc = torch.where(has[..., None], take_rows(cxy, seg_i.clamp(min=0)), 0.0)
        return torch.stack([poly_eval(cc[..., :deg], lu), poly_eval(cc[..., deg:], lu)], -1)

    def chord_table(lo, hi, n):
        """Chord-cumulative arc lengths [B, n+1] over a uniform u grid on
        [lo, hi]; returns (du [B], s)."""
        us = lo[:, None] + (hi - lo)[:, None] * jnp_linspace(n + 1, dtype, device)
        pts = xy_sample(us)
        seglen = torch.sqrt(torch.sum(torch.diff(pts, dim=1) ** 2, -1))
        s = torch.cat([torch.zeros_like(seglen[:, :1]), torch.cumsum(seglen, 1)], 1)
        return (hi - lo) / n, s

    def invert_arc(t, s, u_lo, du):
        """u(t) [B, P] by linear interpolation in the (uniform-u, s) table;
        queries beyond the table clamp to its last point."""
        n = s.shape[1] - 1
        idx = (torch.searchsorted(s, t, right=True) - 1).clamp(0, n)
        s_lo = torch.gather(s, 1, idx)
        s_hi = torch.gather(s, 1, (idx + 1).clamp(max=n))
        frac = torch.clamp((t - s_lo) / torch.clamp(s_hi - s_lo, min=eps), 0.0, 1.0)
        return u_lo[:, None] + torch.clamp(idx.to(dtype) + frac, max=n) * du[:, None]

    # 1. Coarse window bound.
    M = plist.segs.velocity.shape[1]
    valid = torch.arange(M, device=device) < plist.count[:, None]
    max_speed = torch.amax(torch.where(valid, plist.segs.velocity.abs(), 0.0), 1)
    arc_needed = num_poses * sample_period * max_speed * 1.02 + eps
    duc, sc = chord_table(u0, torch.maximum(n_end, u0 + eps), coarse_samples)
    u_hi = invert_arc(arc_needed[:, None], sc, u0, duc)[:, 0]   # clamps at n_end
    u_hi = torch.minimum(u_hi + duc, n_end)                     # +1 cell margin
    u_hi = torch.maximum(u_hi, u0 + eps)

    # 2. Fine arc table.
    duf, sf = chord_table(u0, u_hi, fine_samples)
    s_total = sf[:, -1]

    # 3. Exact per-segment solve of the emission recurrence: inside segment
    # j targets advance by spacing_j = dt |vel_j| until they cross its end
    # arc S_j; the crossing step keeps j's spacing (the march's goal rule).
    spacing = torch.clamp(plist.segs.velocity.abs() * sample_period, min=eps)   # [B, M]
    # S_j: the table's arc at the last grid point u0 + i duf <= j + 1, else 0.
    u_tab = u0[:, None] + torch.arange(sf.shape[1], dtype=dtype, device=device) * duf[:, None]
    jb = (torch.arange(M, dtype=dtype, device=device) + 1.0) + 1e-9
    last = torch.searchsorted(u_tab, jb.expand(u0.shape[0], M).contiguous(), right=True) - 1
    S = torch.where(last >= 0, torch.gather(sf, 1, last.clamp(min=0)), 0.0)   # [B, M]

    P = num_poses
    a = _seg_speed(plist, u0) * sample_period      # first target (the march's goal0)
    k = torch.zeros_like(a)
    a_in, K, n_in = [], [], []
    for j in range(M):                             # static loop over the segments
        sp = spacing[:, j]
        room = S[:, j] - a
        n = torch.where(room >= -1e-12, torch.floor(room / sp) + 1.0, 0.0)
        n = torch.minimum(n.clamp(min=0.0), P - k)
        a_in.append(a)
        K.append(k)
        n_in.append(n)
        a = a + n * sp
        k = k + n
    # Targets past the last segment's arc keep stepping with its spacing
    # (they fall off the table and clamp to the path end anyway).
    a_in.append(a)
    K.append(k)
    n_in.append(P - k)
    a_in, K, n_in = torch.stack(a_in, 1), torch.stack(K, 1), torch.stack(n_in, 1)
    sp_all = torch.cat([spacing, spacing[:, -1:]], 1)
    ks = torch.arange(P, dtype=dtype, device=device)
    K3, a3 = K[..., None], a_in[..., None]
    in_j = (ks >= K3) & (ks < (K + n_in)[..., None])                       # [B, M+1, P]
    t = torch.sum(torch.where(in_j, a3 + (ks - K3) * sp_all[..., None], 0.0), 1)   # [B, P]
    sp_prev = torch.diff(torch.cat([torch.zeros_like(t[:, :1]), t], 1), dim=1)

    # 4. Emission mask, poses, tail padding.  The march's 1% rule counts a
    # >= 99%-complete final interval as emitted; mirrored so the emitted
    # count matches at the path end.
    emit = (t - 0.01 * sp_prev) <= s_total[:, None]
    u_em = torch.where(emit, invert_arc(t, sf, u0, duf), n_end[:, None])
    poses = pose_sample(plist, u_em, is_holonomic)
    last_pose = pose_sample(plist, n_end, is_holonomic)
    emitted = emit.sum(1)
    idx = torch.arange(P, device=device)
    return torch.where((idx < emitted[:, None])[..., None], poses, last_pose[:, None])
