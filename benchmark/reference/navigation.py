"""Plain reference of one navigation tick: the ROS node's control cycle.

Follows ``NMPCNavControlROS::mainCycle`` of the upstream project
(JorgeDFR/nmpc_nav_control, ``NMPCNavControlROS.cpp:516-720``) with the
path handling of a parallel node: the nearest point on the active path by a
32-point grid per segment and 10 Newton steps, passed segments dropped, the
active window topped up to ``max_active_path_length`` (stopping where the
velocity sign or the frame changes), and the horizon's poses placed every
|v| dt of chord length by a 64-cell and a 512-cell chord table, one pass
over the segments and linear inversion of the table.  Then the safety and
termination checks and the controller tick (``controller.py``).

A node's state is a dict of tensors with a leading sample axis [M]:
``status``, ``goal`` [M, 3], the segment store ``cx``, ``cy``, ``ch``
[M, CAP, 8], ``vel``, ``frame`` [M, CAP] (each curve's length is worked out again
here), the cursors ``head``,
``active``, ``total``, the parameter ``u``, and the solver memory ``xs``,
``us``, ``carry``.  Status codes as upstream: IDLE, GO_TO_POSE,
FOLLOW_PATH, BREAK, ERROR = 0..4; published codes idle 0, working 1,
error 2.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference.controller import Prec, controller_tick
from benchmark.reference.models import Robot

IDLE, GO_TO_POSE, FOLLOW_PATH, BREAK, ERROR = range(5)
GRID, NEWTON, COARSE, FINE = 32, 10, 64, 512


def grid01(n, like):
    """n points on [0, 1]: i / (n - 1) as a float product, the last exactly 1."""
    g = torch.arange(n - 1, dtype=like.dtype, device=like.device) * (1.0 / (n - 1))
    return torch.cat([g, torch.ones(1, dtype=like.dtype, device=like.device)])


def poly(c, u, d=0):
    """The d-th derivative (d <= 2) of sum_i c_i u^i by Horner's rule; c
    [..., 8] against u [...]."""
    def term(i):
        return c[..., i] if d == 0 else c[..., i] * i if d == 1 else c[..., i] * i * (i - 1)

    out = term(c.shape[-1] - 1)
    for i in range(c.shape[-1] - 2, d - 1, -1):
        out = out * u + term(i)
    return out


def arc_length(cx, cy, n=256):
    """Sum of the chords of n equal parameter steps of each curve."""
    g = grid01(n + 1, cx)
    pts = torch.stack([poly(cx[..., None, :], g), poly(cy[..., None, :], g)], -1)
    return (pts.diff(dim=-2) ** 2).sum(-1).sqrt().sum(-1)


def dist(x1, y1, x2, y2):
    return torch.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)


def norm_angle(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def rows(x, idx):
    """x[m, idx[m, ...]] for x [M, CAP, ...]."""
    M = x.shape[0]
    flat = idx.reshape(M, -1).long()
    out = x[torch.arange(M, device=x.device)[:, None], flat]
    return out.reshape(idx.shape + x.shape[2:])


def active_list(st, cap):
    """The active segments from ``head``, clamped into the store, and their count."""
    idx = (st["head"][:, None] + torch.arange(cap, device=st["head"].device)).clamp(0, cap - 1)
    segs = {k: rows(st[k], idx) for k in ("cx", "cy", "ch", "vel", "frame", "length")}
    return segs, st["active"].clamp(max=cap)


def locate(segs, count, u):
    """(segment index, local parameter, has-a-segment) of global u [M, P]."""
    n = count[:, None]
    k = torch.floor(u).long()
    loc = u - k.to(u.dtype)
    loc = torch.where(k >= n, torch.ones_like(loc), torch.where(k < 0, torch.zeros_like(loc), loc))
    k = torch.minimum(k.clamp(min=0), n - 1)
    return k.clamp(min=0), loc, k >= 0


def pose_at(segs, count, u, holonomic):
    """(x, y, theta) [M, P, 3] at global u [M, P]; theta the tangent (+pi on
    a negative velocity) or the holonomic heading polynomial."""
    k, loc, has = locate(segs, count, u)
    cx, cy = rows(segs["cx"], k), rows(segs["cy"], k)
    x, y = poly(cx, loc), poly(cy, loc)
    if holonomic:
        th = poly(rows(segs["ch"], k), loc)
    else:
        th = torch.atan2(poly(cy, loc, 1), poly(cx, loc, 1))
        th = torch.where(rows(segs["vel"], k) >= 0, th, th + math.pi)
    return torch.where(has[..., None], torch.stack([x, y, th], -1), 0.0)


def project(segs, count, px, py):
    """Nearest point: (global u, x, y, tangent heading, holonomic heading)."""
    M, cap = segs["cx"].shape[:2]
    g = grid01(GRID, px)
    d2 = (poly(segs["cx"][..., None, :], g) - px[:, None, None]) ** 2 + (
        poly(segs["cy"][..., None, :], g) - py[:, None, None]) ** 2
    valid = torch.arange(cap, device=px.device)[None] < count[:, None]
    best = torch.where(valid[..., None], d2, math.inf).reshape(M, -1).argmin(1)
    k = best // GRID
    u = (best % GRID).to(px.dtype) / (GRID - 1)
    cx, cy = rows(segs["cx"], k), rows(segs["cy"], k)
    for _ in range(NEWTON):
        ex, ey = poly(cx, u) - px, poly(cy, u) - py
        dx, dy, ddx, ddy = poly(cx, u, 1), poly(cy, u, 1), poly(cx, u, 2), poly(cy, u, 2)
        g1 = ex * dx + ey * dy
        g2 = dx * dx + dy * dy + ex * ddx + ey * ddy
        g2 = torch.where(g2 > 1e-9, g2, dx * dx + dy * dy + 1e-9)
        u = (u - g1 / g2).clamp(0.0, 1.0)
    th = torch.atan2(poly(cy, u, 1), poly(cx, u, 1))
    return k.to(px.dtype) + u, poly(cx, u), poly(cy, u), th, poly(rows(segs["ch"], k), u)


def top_up(st, u, max_len, cap):
    """Move upcoming segments into the active window (in place on ``st``)."""
    idx = torch.arange(cap, device=u.device)[None]
    head, active = st["head"][:, None], st["active"]
    inside = (idx >= head) & (idx < head + active[:, None])
    frac = torch.where(idx == head, 1.0 - u[:, None], 1.0)
    length = torch.where(inside, st["length"] * frac, 0.0).sum(1)
    for _ in range(cap):
        left = st["total"] - active
        tail = (st["head"] + active - 1).clamp(0, cap - 1)
        nxt = (st["head"] + active).clamp(0, cap - 1)
        tv, nv = rows(st["vel"], tail), rows(st["vel"], nxt)
        other_frame = rows(st["frame"], tail) != rows(st["frame"], nxt)
        barrier = (active > 0) & ((tv * nv < 0) | other_frame)
        take = (length < max_len) & (left > 0) & ~barrier
        active = active + take.long()
        length = torch.where(take, length + rows(st["length"], nxt), length)
    st["active"] = active


def on_path(st, take, path, max_len):
    """A path set received by the lanes of ``take`` [M] (the upstream
    ``processPathReceived``): the store holds the path's ``count`` curves
    (``cx``, ``cy``, ``ch`` [M, CAP, 8], ``vel`` [M, CAP]) from its front,
    the window is cleared and topped up from u = 0, the status becomes
    FOLLOW_PATH and the solver's trajectory is zeroed (its carried initial
    state kept).  A new state dict."""
    cap = st["vel"].shape[1]
    new = dict(st, cx=path["cx"], cy=path["cy"], ch=path["ch"], vel=path["vel"],
               frame=(torch.arange(cap, device=take.device)[None]
                      < path["count"][:, None]).long())
    new["length"] = arc_length(new["cx"], new["cy"])
    zero = torch.zeros_like(st["head"])
    new.update(head=zero, active=zero, total=path["count"].long(),
               u=torch.zeros_like(st["u"]))
    top_up(new, new["u"], max_len, cap)
    new.update(status=torch.full_like(st["status"], FOLLOW_PATH),
               xs=torch.zeros_like(st["xs"]), us=torch.zeros_like(st["us"]))
    return _select(take, new, st)


def on_goal(st, take, goal):
    """A goal pose received by the lanes of ``take``: GO_TO_POSE towards
    ``goal`` [M, 3], the solver's trajectory zeroed."""
    new = dict(st, status=torch.full_like(st["status"], GO_TO_POSE), goal=goal,
               xs=torch.zeros_like(st["xs"]), us=torch.zeros_like(st["us"]))
    return _select(take, new, st)


def _select(take, new, old):
    return {k: torch.where(take.reshape(-1, *[1] * (old[k].dim() - 1)), new[k], old[k])
            for k in old}


def next_poses(segs, count, u0, dt, P, holonomic):
    """The horizon's P poses from the nearest parameter u0 [M]."""
    M, cap = segs["vel"].shape
    dtype, dev = u0.dtype, u0.device
    n_end = count.to(dtype)
    u0 = torch.minimum(u0, n_end)
    eps = 1e-6

    def xy(us):
        k, _, has = locate(segs, count, us)
        loc = (us - k.to(dtype)).clamp(0.0, 1.0)
        x, y = poly(rows(segs["cx"], k), loc), poly(rows(segs["cy"], k), loc)
        return torch.where(has[..., None], torch.stack([x, y], -1), 0.0)

    def table(lo, hi, n):
        us = lo[:, None] + (hi - lo)[:, None] * grid01(n + 1, lo)
        chords = (xy(us).diff(dim=1) ** 2).sum(-1).sqrt()
        return (hi - lo) / n, torch.cat([torch.zeros_like(chords[:, :1]), chords.cumsum(1)], 1)

    def invert(t, s, lo, du):
        n = s.shape[1] - 1
        i = (torch.searchsorted(s, t, right=True) - 1).clamp(0, n)
        s0, s1 = s.gather(1, i), s.gather(1, (i + 1).clamp(max=n))
        f = ((t - s0) / (s1 - s0).clamp(min=eps)).clamp(0.0, 1.0)
        return lo[:, None] + (i.to(dtype) + f).clamp(max=n) * du[:, None]

    def speed_at(u):
        k, _, has = locate(segs, count, u[:, None])
        return torch.where(has[:, 0], rows(segs["vel"], k)[:, 0].abs(), 0.0)

    valid = torch.arange(cap, device=dev)[None] < count[:, None]
    vmax = torch.where(valid, segs["vel"].abs(), 0.0).amax(1)
    need = P * dt * vmax * 1.02 + eps
    duc, sc = table(u0, torch.maximum(n_end, u0 + eps), COARSE)
    hi = torch.minimum(invert(need[:, None], sc, u0, duc)[:, 0] + duc, n_end)
    duf, sf = table(u0, torch.maximum(hi, u0 + eps), FINE)
    total = sf[:, -1]
    spacing = (segs["vel"].abs() * dt).clamp(min=eps)
    ugrid = u0[:, None] + torch.arange(FINE + 1, dtype=dtype, device=dev) * duf[:, None]
    ends = (torch.arange(cap, dtype=dtype, device=dev) + 1.0 + 1e-9).expand(M, cap).contiguous()
    last = torch.searchsorted(ugrid, ends, right=True) - 1
    S = torch.where(last >= 0, sf.gather(1, last.clamp(min=0)), 0.0)
    # Targets advance by each segment's spacing until they pass its end arc.
    a, k = speed_at(u0) * dt, torch.zeros_like(u0)
    t = torch.zeros(M, P, dtype=dtype, device=dev)
    ks = torch.arange(P, dtype=dtype, device=dev)[None]
    for j in range(cap + 1):
        sp = spacing[:, min(j, cap - 1)]
        if j < cap:
            room = S[:, j] - a
            n = torch.where(room >= -1e-12, torch.floor(room / sp) + 1.0, 0.0)
            n = torch.minimum(n.clamp(min=0.0), P - k)
        else:
            n = P - k
        inside = (ks >= k[:, None]) & (ks < (k + n)[:, None])
        t = torch.where(inside, a[:, None] + (ks - k[:, None]) * sp[:, None], t)
        a, k = a + n * sp, k + n
    prev_sp = torch.cat([torch.zeros_like(t[:, :1]), t], 1).diff(dim=1)
    emit = (t - 0.01 * prev_sp) <= total[:, None]
    u = torch.where(emit, invert(t, sf, u0, duf), n_end[:, None])
    poses = pose_at(segs, count, u, holonomic)
    end = pose_at(segs, count, n_end[:, None], holonomic)
    n_emit = emit.sum(1)
    return torch.where((torch.arange(P, device=dev)[None] < n_emit[:, None])[..., None], poses, end)


def node_tick(robot: Robot, prec: Prec, st: dict, pose, vel, steer, valid):
    """One cycle for M samples: the new state and the outputs (``cmd`` [M, 3],
    ``publish``, ``status_code``, ``solve_ok``), in ``prec``."""
    nav, N, cap = robot.nav, robot.N, st["vel"].shape[1]
    st = {k: (v.to(prec.dtype) if v.is_floating_point() else v.long()) for k, v in st.items()}
    st["length"] = arc_length(st["cx"], st["cy"])
    pose, vel, steer = (x.to(prec.dtype) for x in (pose, vel, steer))
    omni, tric = robot.geometry == "omni4", robot.geometry == "tric"
    px, py, pth = pose.unbind(-1)
    safe = nav["enable_safe_conditions"]
    active = (st["status"] == GO_TO_POSE) | (st["status"] == FOLLOW_PATH) | (st["status"] == BREAK)
    status = torch.where(active & ~valid, ERROR, st["status"])

    goal = st["goal"]
    d_goal = dist(goal[:, 0], goal[:, 1], px, py)
    gtp_stop = (safe & (d_goal >= nav["max_goal_pose_dist"])) | (
        (d_goal <= nav["final_position_error"])
        & (norm_angle(pth - goal[:, 2]) <= nav["final_orientation_error"]))
    traj_gtp = torch.cat([goal[:, None], torch.zeros_like(goal)[:, None].expand(-1, N, 3)], 1)

    segs, count = active_list(st, cap)
    u, nx_, ny_, th, th_h = project(segs, count, px, py)
    pop = torch.minimum(torch.floor(u).long().clamp(min=0), st["active"])
    fp = dict(st, head=st["head"] + pop, active=st["active"] - pop, total=st["total"] - pop)
    u = u - pop.to(u.dtype)
    top_up(fp, u, nav["max_active_path_length"], cap)
    segs, count = active_list(fp, cap)
    if omni:
        th_path = th_h
    else:
        th_path = torch.where(segs["vel"][:, 0] < 0, th + math.pi, th)
    unsafe = safe & ((dist(nx_, ny_, px, py) >= nav["max_pos_error_to_path"])
                     | (norm_angle(th_path - pth).abs() >= nav["max_ori_error_to_path"]))
    traj_fp = next_poses(segs, count, u, robot.dt, N + 1, omni)
    end = traj_fp[:, -1]
    at_end = (dist(px, py, end[:, 0], end[:, 1]) <= nav["final_position_error"]) & (
        norm_angle(pth - end[:, 2]) <= nav["final_orientation_error"])
    upcoming = fp["total"] > fp["active"]
    fp_stop = unsafe | at_end

    in_gtp, in_fp, in_break = status == GO_TO_POSE, status == FOLLOW_PATH, status == BREAK
    solve = (in_gtp & ~gtp_stop) | (in_fp & ~fp_stop)
    traj = torch.where(in_fp[:, None, None], traj_fp, traj_gtp)
    n_valid = torch.where(in_fp, N + 1, 1)
    rot = at_end & upcoming
    fp["head"] = fp["head"] + rot.long()
    fp["total"] = fp["total"] - rot.long()
    after = {k: torch.where(in_fp.reshape(-1, *[1] * (st[k].dim() - 1)), fp[k], st[k])
             for k in ("head", "active", "total")}
    u_after = torch.where(in_fp, u, st["u"])

    out = controller_tick(robot, prec, st["xs"], st["us"], st["carry"], pose, vel, steer, traj,
                          n_valid)
    def keep(new, old):
        return torch.where(solve.reshape(-1, *[1] * (old.dim() - 1)), new, old)

    stop = (in_gtp & gtp_stop) | (in_fp & fp_stop) | in_break
    publish = stop | (solve & out["ok"])
    cmd = torch.where(stop[:, None], 0.0, out["cmd"])
    status = torch.where(in_gtp & gtp_stop, IDLE, status)
    status = torch.where(in_fp & unsafe, ERROR, status)
    status = torch.where(in_fp & ~unsafe & at_end & ~upcoming, IDLE, status)
    status = torch.where(in_break, IDLE, status)
    status = torch.where(solve & ~out["ok"], ERROR, status)
    code = torch.where((status == IDLE) | (status == BREAK), 0, torch.where(status == ERROR, 2, 1))
    new = dict(st, status=status, u=u_after, xs=keep(out["xs"], st["xs"]),
               us=keep(out["us"], st["us"]), carry=keep(out["carry"], st["carry"]), **after)
    return new, dict(cmd=cmd, publish=publish, status_code=code, solve_ok=out["ok"] | ~solve)


def follow(robot: Robot, prec: Prec, pre: dict, own: dict, event: dict, pose, vel, steer):
    """One cycle of M sampled lanes, followed from the program's carried
    state before the cycle's events (``pre``: cursors, parameter, status and
    solver memory), with the path store and goal rebuilt from what the
    benchmark itself sent: ``own`` (``cx``, ``cy``, ``ch``, ``vel``,
    ``count``, ``goal``) the last path and goal each lane got before this
    cycle, ``event`` (the same keys and ``path``, ``goal_set`` masks) what
    it gets now.  The new state and the outputs, as ``node_tick``."""
    def cast(d):
        return {k: (v.to(prec.dtype) if v.is_floating_point() else v.long()) for k, v in d.items()}

    pre, own, event = cast(pre), cast(own), cast(event)
    cap = pre["vel"].shape[1]
    st = dict(pre, cx=own["cx"], cy=own["cy"], ch=own["ch"], vel=own["vel"], goal=own["goal"],
              frame=(torch.arange(cap, device=pose.device)[None]
                     < own["count"][:, None]).long())
    st = on_goal(st, event["goal_set"].bool(), event["goal"])
    st = on_path(st, event["path"].bool(), event, robot.nav["max_active_path_length"])
    valid = torch.ones(pose.shape[0], dtype=torch.bool, device=pose.device)
    return node_tick(robot, prec, st, pose, vel, steer, valid)
