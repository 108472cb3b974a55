"""Box-constrained stagewise QP: Mehrotra primal-dual interior point.

Port of ``nmpc_nav_control_tpu/qp/ipm.py``.  QP in delta form around a
reference trajectory:

  min  sum_k 1/2 dx'diag(Qd_k)dx + qx_k'dx + 1/2 du'diag(Rd_k)du + qu_k'du
  s.t. dx_0 = dx0
       dx_{k+1} = A_k dx_k + B_k du_k + c_k
       lbx_k <= sel_x(dx_k) <= ubx_k   (k = 1..N)
       lbu_k <= sel_u(du_k) <= ubu_k   (k = 0..N-1)

Two solves of the same iteration, as in the JAX package, each taking a
batch (every leaf with a leading batch axis):

  - ``qp/ipm_batched.py``: the fused-sweep iteration (the JAX package's
    tiled IPM), which exploits the A/B sparsity pattern;
  - ``solve_box_qp_serial`` below: the JAX package's per-problem solve
    (``_solve_box_qp_serial``), written for a batch: each iteration is one
    dense Riccati factorization and two Riccati solves
    (``ops/riccati_fused.py``), with the iterate update, the step lengths
    and the per-lane freeze in plain torch.

``solve_box_qp`` is the one place that chooses between them.  Like the JAX
package's, it reads ``NMPC_TPU_TILED_IPM`` at call time (``tiled_ipm_ok``:
"1", the default, takes the fused sweeps) unless its caller passes the
route it has already read, as ``rti_step`` does so that its linearization
pattern and its solve follow one reading.  The JAX package's other
conditions (a TPU, whole 1024-lane tiles reached by edge padding) have no
counterpart: either solve takes any batch size, B=1 included, with no
padding.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch

from nmpc_nav_control_tpu_torch.ops import riccati_fused as rf

__all__ = ["BoxQP", "IPMSolution", "solve_box_qp", "solve_box_qp_serial", "tiled_ipm_ok"]


class BoxQP(NamedTuple):
    """Stagewise box-QP data; shapes per problem, leading batch axis [B, ...]."""

    A: torch.Tensor     # [N, nx, nx]
    B: torch.Tensor     # [N, nx, nu]
    c: torch.Tensor     # [N, nx]
    Qd: torch.Tensor    # [N+1, nx]
    qx: torch.Tensor    # [N+1, nx]
    Rd: torch.Tensor    # [N, nu]
    qu: torch.Tensor    # [N, nu]
    dx0: torch.Tensor   # [nx]
    lbx: torch.Tensor   # [N, nbx]  bounds on dx_k[idxbx], k = 1..N
    ubx: torch.Tensor   # [N, nbx]
    lbu: torch.Tensor   # [N, nbu]  bounds on du_k[idxbu], k = 0..N-1
    ubu: torch.Tensor   # [N, nbu]


class IPMSolution(NamedTuple):
    dxs: torch.Tensor       # [N+1, nx]
    dus: torch.Tensor       # [N, nu]
    lam_xl: torch.Tensor    # [N, nbx]
    lam_xu: torch.Tensor    # [N, nbx]
    lam_ul: torch.Tensor    # [N, nbu]
    lam_uu: torch.Tensor    # [N, nbu]
    mu: torch.Tensor        # [] final complementarity measure
    kkt_res: torch.Tensor   # [] inf-norm of the stationarity residual


class _Iterate(NamedTuple):
    """Primal-dual iterate in the sweeps' batch-minor layout [rows, e, B]."""

    dxs: torch.Tensor
    dus: torch.Tensor
    s_xl: torch.Tensor
    s_xu: torch.Tensor
    s_ul: torch.Tensor
    s_uu: torch.Tensor
    l_xl: torch.Tensor
    l_xu: torch.Tensor
    l_ul: torch.Tensor
    l_uu: torch.Tensor


def _guards(dtype):
    """(mu_min, slack floor, barrier cap) for the dtype: a converged lane
    stops stepping below mu_min, before its slacks underflow; the floor and
    the cap keep every lam/s finite near active bounds."""
    if dtype == torch.float64:
        return 1e-14, 1e-11, 1e14
    return 1e-7, 1e-9, 1e10


def tiled_ipm_ok() -> bool:
    """True (the fused sweeps) unless ``NMPC_TPU_TILED_IPM`` is set to
    something other than "1"; read per call.  Unlike the JAX package's rule
    there is no platform test and no 1024-lane tile: both solves take any
    batch size, B=1 included, without padding."""
    return os.environ.get("NMPC_TPU_TILED_IPM", "1") == "1"


def solve_box_qp(qp: BoxQP, idxbx, idxbu, iters: int = 12, tau: float = 0.995,
                 mu0: float = 1.0, s_min: float = 0.3, reg: float = 1e-8,
                 mu_min: float | None = None, spars=None, packed_abc=None,
                 tiled: bool | None = None) -> IPMSolution:
    """Solve a batch of stagewise box QPs (leaves [B, ...]).

    ``tiled``: the route, True for the fused sweeps and False for the
    Riccati solve; None reads it from ``tiled_ipm_ok()``.  ``spars``:
    optional (A_pattern, B_pattern) structural-nonzero masks that
    over-approximate the nonzeros of qp.A / qp.B, used by the fused sweeps;
    None means dense.  The Riccati solve ignores it.  ``packed_abc``:
    optional batch-minor (A, Bm, c) already packed for the route (to
    ``spars`` for the fused sweeps, dense for the Riccati solve); ``qp.A/B/c``
    are then ignored.  Returns an ``IPMSolution`` with leading batch axes.
    """
    if tiled is None:
        tiled = tiled_ipm_ok()
    if tiled:
        from nmpc_nav_control_tpu_torch.qp.ipm_batched import solve_box_qp_batched

        return solve_box_qp_batched(qp, idxbx, idxbu, iters=iters, tau=tau, mu0=mu0,
                                    s_min=s_min, reg=reg, mu_min=mu_min, spars=spars,
                                    packed_abc=packed_abc)
    return solve_box_qp_serial(qp, idxbx, idxbu, iters=iters, tau=tau, mu0=mu0,
                               s_min=s_min, reg=reg, mu_min=mu_min, packed_abc=packed_abc)


def _per_lane_finite(x):
    """[..., B] -> [B] bool: every entry of the lane finite."""
    return torch.isfinite(x).reshape(-1, x.shape[-1]).all(0)


def solve_box_qp_serial(qp: BoxQP, idxbx, idxbu, iters: int = 12, tau: float = 0.995,
                        mu0: float = 1.0, s_min: float = 0.3, reg: float = 1e-8,
                        mu_min: float | None = None, packed_abc=None) -> IPMSolution:
    """The Riccati-based solve of the JAX package's serial path, batched.

    ``qp`` leaves carry a leading batch axis [B, ...].  ``packed_abc``:
    optional dense (A [N, nx*nx, B], Bm [N, nx*nu, B], c [N, nx, B]) in the
    batch-minor layout (``ops.linearize_packed`` with the dense pattern
    writes exactly this); ``qp.A/B/c`` are then ignored.  Every per-stage
    tensor stays batch-minor [rows, e, B] for the whole solve, so A and B
    are transposed at most once.
    """
    ibx, ibu = [int(i) for i in idxbx], [int(i) for i in idxbu]
    B, Np1, nx = qp.Qd.shape
    N, nu = Np1 - 1, qp.Rd.shape[-1]
    dtype = qp.Qd.dtype
    mu_min_d, eps_floor, d_cap = _guards(dtype)
    if mu_min is None:
        mu_min = mu_min_d
    if packed_abc is None:
        packed_abc = (rf.to_bm(qp.A), rf.to_bm(qp.B), rf.to_bm(qp.c))
    A, Bm, c = packed_abc
    A4, B4 = A.view(N, nx, nx, B), Bm.view(N, nx, nu, B)
    Qd, qx, Rd, qu = map(rf.to_bm, (qp.Qd, qp.qx, qp.Rd, qp.qu))
    lbx, ubx, lbu, ubu = map(rf.to_bm, (qp.lbx, qp.ubx, qp.lbu, qp.ubu))
    dx0 = qp.dx0.mT.contiguous()                                  # [nx, B]
    n_con = 2 * N * (len(ibx) + len(ibu))

    def gaps(dxs, dus):
        zx, zu = dxs[1:, ibx], dus[:, ibu]
        return zx - lbx, ubx - zx, zu - lbu, ubu - zu

    def mu_of(s, lam):
        return sum((s_ * l_).sum((0, 1)) for s_, l_ in zip(s, lam)) / n_con

    def step_len(s, lam, ds, dl):
        """Fraction-to-boundary step over all eight groups (inf sentinel)."""
        m = None
        for v, dv in zip(s + lam, ds + dl):
            neg = dv < 0
            r = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.inf).amin((0, 1))
            m = r if m is None else torch.minimum(m, r)
        return torch.clamp(tau * m, max=1.0)

    dxs = torch.zeros((N + 1, nx, B), dtype=dtype, device=Qd.device)
    dus = torch.zeros((N, nu, B), dtype=dtype, device=Qd.device)
    s = tuple(torch.clamp(g, min=s_min) for g in gaps(dxs, dus))
    it = _Iterate(dxs, dus, *s, *(torch.clamp(mu0 / s_, min=s_min) for s_ in s))

    for _ in range(iters):
        s, lam = tuple(it[2:6]), tuple(it[6:10])
        rp = tuple(g - s_ for g, s_ in zip(gaps(it.dxs, it.dus), s))
        mu = mu_of(s, lam)

        # Barrier-modified diagonals, capped; reg is folded into R once and
        # the factorization adds nothing more.
        Qbar = Qd.clone()
        Qbar[1:, ibx] += torch.clamp(lam[0] / s[0] + lam[1] / s[1], max=d_cap)
        Rbar = Rd + reg
        Rbar[:, ibu] += torch.clamp(lam[2] / s[2] + lam[3] / s[3], max=d_cap)
        fac = rf.riccati_factor_fused(A, Bm, Qbar, Rbar)

        r_dyn = (torch.einsum("kijb,kjb->kib", A4, it.dxs[:-1])
                 + torch.einsum("kijb,kjb->kib", B4, it.dus) + c - it.dxs[1:]).contiguous()
        r_init = dx0 - it.dxs[0]

        def newton(sigma_mu, corr):
            """One Newton solve -> (ddxs, ddus, ds, dl); the affine pass has
            sigma_mu = 0 and no corrector (None)."""
            if corr is None:
                le = tuple(-(l_ / s_) * r_ for l_, s_, r_ in zip(lam, s, rp))
            else:
                le = tuple((sigma_mu - c_) / s_ - (l_ / s_) * r_
                           for l_, s_, r_, c_ in zip(lam, s, rp, corr))
            gx = Qd * it.dxs + qx
            gx[1:, ibx] += le[1] - le[0]
            gu = Rd * it.dus + qu
            gu[:, ibu] += le[3] - le[2]
            kff = rf.riccati_solve_bwd_fused(A, Bm, fac.Ks, fac.Ls, fac.Ps, gx, gu, r_dyn)
            ddxs, ddus = rf.riccati_solve_fwd_fused(A, Bm, fac.Ks, kff, r_dyn, r_init)
            dzx, dzu = ddxs[1:, ibx], ddus[:, ibu]
            ds = (rp[0] + dzx, rp[1] - dzx, rp[2] + dzu, rp[3] - dzu)
            dl = (-(lam[0] / s[0]) * dzx + le[0] - lam[0],
                  (lam[1] / s[1]) * dzx + le[1] - lam[1],
                  -(lam[2] / s[2]) * dzu + le[2] - lam[2],
                  (lam[3] / s[3]) * dzu + le[3] - lam[3])
            return ddxs, ddus, ds, dl

        # Predictor (affine) pass.
        _, _, dsa, dla = newton(None, None)
        a_aff = step_len(s, lam, dsa, dla)
        mu_aff = sum(((s_ + a_aff * ds_) * (l_ + a_aff * dl_)).sum((0, 1))
                     for s_, l_, ds_, dl_ in zip(s, lam, dsa, dla)) / n_con
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-16)) ** 3, 0.0, 1.0)

        # Corrector pass; its products are scaled by a_aff (the JAX package's
        # qp/ipm.py documents the cycling on bound-touching warm starts that
        # the unscaled products cause).
        corr = tuple(a_aff * ds_ * dl_ for ds_, dl_ in zip(dsa, dla))
        ddxs, ddus, ds, dl = newton(sigma * mu, corr)
        alpha = step_len(s, lam, ds, dl)
        new = _Iterate(it.dxs + alpha * ddxs, it.dus + alpha * ddus,
                       *(torch.clamp(v + alpha * d, min=eps_floor)
                         for v, d in zip(s + lam, ds + dl)))

        # Converged lanes stop stepping; a lane whose new iterate has a
        # non-finite entry in any leaf keeps its last iterate.
        step_bad = ~torch.stack([_per_lane_finite(x) for x in new]).all(0)
        frozen = (mu < mu_min) | step_bad
        it = _Iterate(*(torch.where(frozen, old, upd) for old, upd in zip(it, new)))

    s, lam = tuple(it[2:6]), tuple(it[6:10])
    return IPMSolution(
        dxs=it.dxs.permute(2, 0, 1), dus=it.dus.permute(2, 0, 1),
        lam_xl=lam[0].permute(2, 0, 1), lam_xu=lam[1].permute(2, 0, 1),
        lam_ul=lam[2].permute(2, 0, 1), lam_uu=lam[3].permute(2, 0, 1),
        mu=mu_of(s, lam),
        kkt_res=_stationarity_inf_norm(A4, B4, Qd, qx, Rd, qu, ibx, ibu, it),
    )


def _stationarity_inf_norm(A4, B4, Qd, qx, Rd, qu, ibx, ibu, it: _Iterate):
    """Per-lane inf-norm of the u-stationarity residual (the ``inf_norm_res``
    analog), costates from the x-stationarity recursion; batch-minor
    operands, A4 [N, nx, nx, B], B4 [N, nx, nu, B]."""
    gx = Qd * it.dxs + qx
    gx[1:, ibx] += it.l_xu - it.l_xl
    gu = Rd * it.dus + qu
    gu[:, ibu] += it.l_uu - it.l_ul
    nu_k = gx[-1]
    rus = []
    for k in reversed(range(gu.shape[0])):
        rus.append(gu[k] + torch.einsum("ijb,ib->jb", B4[k], nu_k))
        nu_k = gx[k] + torch.einsum("ijb,ib->jb", A4[k], nu_k)
    return torch.stack(rus).abs().amax((0, 1))
