"""Plain reference of one controller tick: a real-time iteration of the NMPC.

Follows the upstream controller (a Gauss-Newton RTI step of acados' SQP_RTI
with a HPIPM-like box-constrained interior point, ``NMPCNavControl.cpp``) as
the configuration states it: the pose reference unwrapped from the measured
heading, diagonal weights (the diff robot's x100 terminal pose weight when the
last two pose references agree), one linearization by RK4 along the previous
solution, and 8 Mehrotra predictor-corrector iterations with the step scaled
by 0.995 of the distance to the boundary, slacks started at 0.3, lanes frozen
below mu_min, slacks floored and barrier terms capped by the guards of the
arithmetic (``Prec.guards``), and 1e-8 added to the input Hessian.  Each
Newton system is solved by a dense stagewise Riccati recursion with
``torch.linalg``; Jacobians come from forward-mode AD.  Every tensor has a
leading sample axis [M, ...].

``Prec`` sets the arithmetic, and ``reference``/``control`` give the two a
configuration's precision calls for.  Float32: float32 with TF32 off for the
comparison (``REF``), and float32 with every matrix product taken in TF32
(inputs rounded to 10 mantissa bits, as the tensor cores round them) for the
control that must fail it (``TF32``).  Against float64 the program's float32
solves differ by what float32 itself costs on these QPs (up to ~1e-3 in the
input trajectory where bounds are near active), as much as TF32 costs; two
float32 computations agree far closer.  Float64: float64 for the comparison
(``F64``), and plain float32 (``REF``) for the control, the nearest
precision below: a program that computes in float32 where its configuration
states float64 must fail.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.func import jacfwd, vmap

from benchmark.reference.models import Robot, command_of_refs, rk4, wheels_of_body

ITERS, TAU, MU0, S_MIN, REG = 8, 0.995, 1.0, 0.3, 1e-8
# (mu_min, slack floor, barrier cap) of each arithmetic: a converged lane
# stops stepping below mu_min, before its slacks underflow, and the floor and
# the cap keep every lam/s finite near active bounds.  Float64's are tighter,
# as its finer rounding allows: they are part of what a configuration states
# when it asks for float64 (the same values as the port's float64 solve,
# written out here, not read from it).
GUARDS = {torch.float32: (1e-7, 1e-9, 1e10), torch.float64: (1e-14, 1e-11, 1e14)}
TERMINAL_SCALE = 100.0


@dataclasses.dataclass(frozen=True)
class Prec:
    dtype: torch.dtype = torch.float32
    tf32: bool = False

    @property
    def guards(self) -> tuple:
        """(mu_min, slack floor, barrier cap) of this arithmetic."""
        return GUARDS[self.dtype]

    def mm(self, a, b):
        if self.tf32:
            a, b = to_tf32(a), to_tf32(b)
        return a @ b


REF = Prec()
TF32 = Prec(tf32=True)
F64 = Prec(torch.float64)


def reference(dtype) -> Prec:
    """The arithmetic of the comparison for a configuration's ``dtype``."""
    return {torch.float32: REF, torch.float64: F64}[dtype]


def control(dtype) -> Prec:
    """The control's arithmetic for ``dtype``: the nearest precision below."""
    return {torch.float32: TF32, torch.float64: REF}[dtype]


def to_tf32(x):
    """Round float32 values to TF32's 10-bit mantissa (to nearest)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def unwrap(cur, prev):
    d = cur - prev
    cur = torch.where(d > math.pi, cur - 2 * math.pi, cur)
    return torch.where(d < -math.pi, cur + 2 * math.pi, cur)


def pose_reference(N, theta0, traj, n_valid):
    """[M, N+1, 3]: rows past n_valid repeat the last valid row; headings
    unwrapped one step at a time from the measured heading."""
    rows, prev, last = [], theta0, torch.zeros_like(traj[:, 0])
    for i in range(N + 1):
        th = unwrap(traj[:, i, 2], prev)
        row = torch.stack([traj[:, i, 0], traj[:, i, 1], th], -1)
        row = torch.where((n_valid > i)[:, None], row, last)
        rows.append(row)
        prev, last = row[:, 2], row
    return torch.stack(rows, 1)


def linearize(robot: Robot, xs, us):
    """A [M, N, nx, nx], B [M, N, nx, nu], x_next [M, N, nx] along (xs, us)."""
    M, N, nx = xs.shape[0], us.shape[1], robot.nx
    x, u = xs[:, :N].reshape(-1, nx), us.reshape(M * N, -1)
    A, Bm = vmap(jacfwd(lambda a, b: rk4(robot, a, b), argnums=(0, 1)))(x, u)
    xn = rk4(robot, x, u)
    dt = xs.dtype
    return (A.reshape(M, N, nx, nx).to(dt), Bm.reshape(M, N, nx, -1).to(dt),
            xn.reshape(M, N, nx))


def _ftb(vs, dvs):
    """Per sample, the largest a with v + a dv >= 0 over every group."""
    out = None
    for v, dv in zip(vs, dvs):
        r = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0), math.inf).flatten(1).amin(1)
        out = r if out is None else torch.minimum(out, r)
    return out


def solve_qp(prec: Prec, A, Bm, c, Qd, qx, Rd, qu, dx0, bounds, ibx):
    """The box QP in delta form (stages 0..N, bounds on dx_1..N[ibx] and on
    du_0..N-1) by the interior point above: (dxs, dus, mu)."""
    M, N, nx, nu = Bm.shape
    lbx, ubx, lbu, ubu = bounds
    mu_min, s_floor, d_cap = prec.guards
    n_con = 2 * N * (lbx.shape[-1] + nu)
    mv = lambda Mat, v: prec.mm(Mat, v[..., None])[..., 0]  # noqa: E731
    At, Bt = A.mT, Bm.mT

    def gaps(dxs, dus):
        zx, zu = dxs[:, 1:][..., ibx], dus
        return zx - lbx, ubx - zx, zu - lbu, ubu - zu

    dxs = torch.zeros(M, N + 1, nx, dtype=prec.dtype, device=A.device)
    dus = torch.zeros(M, N, nu, dtype=prec.dtype, device=A.device)
    s = [g.clamp(min=S_MIN) for g in gaps(dxs, dus)]
    lam = [(MU0 / s_).clamp(min=S_MIN) for s_ in s]
    for _ in range(ITERS):
        rp = [g - s_ for g, s_ in zip(gaps(dxs, dus), s)]
        mu = sum((a * b).flatten(1).sum(1) for a, b in zip(s, lam)) / n_con
        Qb = Qd.clone()
        Qb[:, 1:, ibx] += (lam[0] / s[0] + lam[1] / s[1]).clamp(max=d_cap)
        Rb = Rd + REG + (lam[2] / s[2] + lam[3] / s[3]).clamp(max=d_cap)
        # Riccati factorization of the barrier-augmented Hessian.
        P = torch.diag_embed(Qb[:, N])
        Ps, Ks, Ls = [None] * (N + 1), [None] * N, [None] * N
        Ps[N] = P
        for k in reversed(range(N)):
            PA, PB = prec.mm(P, A[:, k]), prec.mm(P, Bm[:, k])
            Quu = prec.mm(Bt[:, k], PB) + torch.diag_embed(Rb[:, k])
            Qux = prec.mm(Bt[:, k], PA)
            L, info = torch.linalg.cholesky_ex(Quu)
            # A factorization that fails (Quu not positive definite in the
            # precision at hand) gives NaN, and the step is rejected below.
            L = torch.where((info != 0)[:, None, None], math.nan, L)
            K = -torch.cholesky_solve(Qux, L)
            P = prec.mm(At[:, k], PA) + prec.mm(Qux.mT, K) + torch.diag_embed(Qb[:, k])
            P = (P + P.mT) / 2
            Ps[k], Ks[k], Ls[k] = P, K, L
        r_dyn = mv(A, dxs[:, :N]) + mv(Bm, dus) + c - dxs[:, 1:]
        r_init = dx0 - dxs[:, 0]

        def newton(sigma_mu=None, corr=None):
            if corr is None:
                le = [-(l_ / s_) * r_ for l_, s_, r_ in zip(lam, s, rp)]
            else:
                le = [(sigma_mu[:, None, None] - c_) / s_ - (l_ / s_) * r_
                      for l_, s_, r_, c_ in zip(lam, s, rp, corr)]
            gx = Qd * dxs + qx
            gx[:, 1:, ibx] += le[1] - le[0]
            gu = Rd * dus + qu + le[3] - le[2]
            p, kff = gx[:, N], [None] * N
            for k in reversed(range(N)):
                tmp = p + mv(Ps[k + 1], r_dyn[:, k])
                qb = gu[:, k] + mv(Bt[:, k], tmp)
                kff[k] = -torch.cholesky_solve(qb[..., None], Ls[k])[..., 0]
                p = gx[:, k] + mv(At[:, k], tmp) + mv(Ks[k].mT, qb)
            dx, ddx, ddu = r_init, [r_init], []
            for k in range(N):
                du = mv(Ks[k], dx) + kff[k]
                dx = mv(A[:, k], dx) + mv(Bm[:, k], du) + r_dyn[:, k]
                ddx.append(dx)
                ddu.append(du)
            ddx, ddu = torch.stack(ddx, 1), torch.stack(ddu, 1)
            zx, zu = ddx[:, 1:][..., ibx], ddu
            ds = [rp[0] + zx, rp[1] - zx, rp[2] + zu, rp[3] - zu]
            dl = [-(lam[0] / s[0]) * zx + le[0] - lam[0], (lam[1] / s[1]) * zx + le[1] - lam[1],
                  -(lam[2] / s[2]) * zu + le[2] - lam[2], (lam[3] / s[3]) * zu + le[3] - lam[3]]
            return ddx, ddu, ds, dl

        def step(ds, dl):
            return (TAU * _ftb(s + lam, ds + dl)).clamp(max=1.0)

        _, _, dsa, dla = newton()
        a_aff = step(dsa, dla)
        a3 = a_aff[:, None, None]
        mu_aff = sum(((s_ + a3 * d1) * (l_ + a3 * d2)).flatten(1).sum(1)
                     for s_, l_, d1, d2 in zip(s, lam, dsa, dla)) / n_con
        sigma = ((mu_aff / mu.clamp(min=1e-16)) ** 3).clamp(0.0, 1.0)
        ddx, ddu, ds, dl = newton(sigma * mu, [a3 * d1 * d2 for d1, d2 in zip(dsa, dla)])
        al = step(ds, dl)[:, None, None]
        new = [dxs + al * ddx, dus + al * ddu] + [
            (v + al * d).clamp(min=s_floor) for v, d in zip(s + lam, ds + dl)]
        finite = torch.stack([torch.isfinite(t).flatten(1).all(1) for t in new]).all(0)
        keep = (mu < mu_min) | ~finite
        old = [dxs, dus] + s + lam
        new = [torch.where(keep.reshape(-1, *[1] * (o.dim() - 1)), o, n_)
               for o, n_ in zip(old, new)]
        dxs, dus, s, lam = new[0], new[1], new[2:6], new[6:10]
    mu = sum((a * b).flatten(1).sum(1) for a, b in zip(s, lam)) / n_con
    return dxs, dus, mu


def controller_tick(robot: Robot, prec: Prec, xs, us, carry, pose, vel, steer, traj, n_valid):
    """One tick for M samples from the solver memory (xs [M, N+1, nx],
    us [M, N, nu], carry [M, nx]) and the measurements; returns a dict with
    the command (v, vn, w) [M, 3], the new memory and ``ok``."""
    t = lambda x: x.to(prec.dtype)  # noqa: E731
    xs, us, carry, pose, vel, steer, traj = map(t, (xs, us, carry, pose, vel, steer, traj))
    N, nx, nu, ibx = robot.N, robot.nx, robot.nu, robot.ibx
    M, dev = xs.shape[0], xs.device
    const = lambda v: torch.tensor(v, dtype=prec.dtype, device=dev)  # noqa: E731
    x0 = torch.cat([pose, wheels_of_body(robot, vel, steer), carry[:, 3 + nu:]], -1)
    yref = pose_reference(N, x0[:, 2], traj, n_valid)
    q, r = const(robot.q).expand(M, nx), const(robot.r)
    qe = q
    if robot.geometry == "diff":
        same = (yref[:, N] == yref[:, N - 1]).all(-1)
        scale = torch.where(same, TERMINAL_SCALE, 1.0).to(prec.dtype)
        qe = torch.cat([scale[:, None] * q[:, :3], q[:, 3:]], -1)
    xl = torch.cat([x0[:, None], xs[:, 1:]], 1)
    Qd = torch.cat([q[:, None].expand(M, N, nx), qe[:, None]], 1)
    Rd = r.expand(M, N, nu)
    res = torch.cat([xl[..., :3] - yref, xl[..., 3:]], -1)
    A, Bm, xn = linearize(robot, xl, us)
    bounds = (const(robot.lbx) - xl[:, 1:, ibx], const(robot.ubx) - xl[:, 1:, ibx],
              const(robot.lbu) - us, const(robot.ubu) - us)
    dxs, dus, mu = solve_qp(prec, A, Bm, xn - xl[:, 1:], Qd, Qd * res, Rd, Rd * us,
                            x0 - xl[:, 0], bounds, ibx)
    xs_new, us_new = xl + dxs, us + dus
    u0 = us_new[:, 0]
    refs = x0[:, ibx] + u0 * robot.dt
    carry_new = xs_new[:, 1].clone()
    carry_new[:, ibx] = refs
    ok = torch.isfinite(u0).all(-1) & torch.isfinite(mu)
    return dict(cmd=command_of_refs(robot, refs), xs=xs_new, us=us_new, carry=carry_new, ok=ok)
