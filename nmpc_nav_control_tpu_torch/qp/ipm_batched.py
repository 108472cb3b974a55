"""Batched Mehrotra box-IPM over the fused sweeps, batch-minor layout.

Port of ``nmpc_nav_control_tpu/qp/ipm_tiled.py``: the same predictor-
corrector iteration, fraction-to-boundary step, per-lane freeze and
non-finite-step rejection as ``qp/ipm.py`` of the JAX package.  Each
iteration is four sweeps of ``ops/ipm_fused.py`` (CUDA kernels for CUDA
tensors, their plain versions for CPU tensors); between sweeps only per-lane
[B] scalars are combined, and the iterate update is elementwise torch.  A
solve ends with one KKT sweep.

Every per-stage tensor lives in the batch-minor layout [N(+1), e, B] for the
whole solve: inputs are transposed once, outputs once.  Any batch size
works, B=1 included; the JAX path's edge padding to a 1024-lane tile has no
counterpart here (the kernels mask their ragged last block).

The numeric guards follow the dtype as in the JAX package's serial path:
f32 freezes a lane below mu 1e-7 and floors slacks/multipliers at 1e-9 with
the barrier diagonal capped at 1e10 (identical to the tiled TPU path); f64
uses 1e-14, 1e-11 and 1e14.
"""
from __future__ import annotations

import torch

from nmpc_nav_control_tpu_torch.ops.ipm_fused import (
    SweepConfig,
    dense_sparsity,
    ipm_bwd_corr,
    ipm_bwd_fused,
    ipm_fwd_affine,
    ipm_fwd_corr,
    ipm_kkt_fused,
    pack_sparse,
)
from nmpc_nav_control_tpu_torch.qp.ipm import BoxQP, IPMSolution, _guards, _Iterate

__all__ = ["solve_box_qp_batched"]


def _bm(x):
    """[B, rows, e] -> contiguous batch-minor [rows, e, B]."""
    return x.permute(1, 2, 0).contiguous()


def _from_bm(x):
    """[rows, e, B] -> [B, rows, e]."""
    return x.permute(2, 0, 1)


def solve_box_qp_batched(qp: BoxQP, idxbx, idxbu, iters: int = 12,
                         tau: float = 0.995, mu0: float = 1.0,
                         s_min: float = 0.3, reg: float = 1e-8,
                         mu_min: float | None = None, spars=None,
                         packed_abc=None) -> IPMSolution:
    """Batched solve; ``qp`` leaves carry a leading batch axis [B, ...].

    ``packed_abc``: optional (A [N, nnzA, B], Bm [N, nnzB, B], c [N, nx, B])
    already packed to ``spars`` in the batch-minor layout, e.g. from
    ``ops.linearize_packed.linearize_packed``; ``qp.A/B/c`` are then ignored
    (may be None) and the dense Jacobians never exist.
    """
    idxbx, idxbu = tuple(int(i) for i in idxbx), tuple(int(i) for i in idxbu)
    B, Np1, nx = qp.Qd.shape
    N, nu = Np1 - 1, qp.Rd.shape[-1]
    nbx, nbu = len(idxbx), len(idxbu)
    dtype = qp.Qd.dtype
    mu_min_d, eps_floor, d_cap = _guards(dtype)
    if mu_min is None:
        mu_min = mu_min_d
    asp, bsp = spars if spars is not None else dense_sparsity(nx, nu)
    cfg = SweepConfig(nx, nu, idxbx, idxbu, asp, bsp)
    if packed_abc is None:
        packed_abc = (_bm(pack_sparse(qp.A, asp)), _bm(pack_sparse(qp.B, bsp)), _bm(qp.c))
    A, Bm, c = packed_abc

    # ---- One-time transposition to the batch-minor layout. ----
    Qd, qx, Rd, qu = _bm(qp.Qd), _bm(qp.qx), _bm(qp.Rd), _bm(qp.qu)
    dx0 = qp.dx0.transpose(0, 1).contiguous()            # [nx, B]
    bnd = (_bm(qp.lbx), _bm(qp.ubx), _bm(qp.lbu), _bm(qp.ubu))
    n_con = 2 * N * (nbx + nbu)

    # ---- Initial iterate: zero deltas, slacks at the gaps (>= s_min). ----
    dxs = torch.zeros((N + 1, nx, B), dtype=dtype, device=Qd.device)
    dus = torch.zeros((N, nu, B), dtype=dtype, device=Qd.device)
    zx, zu = dxs[1:, list(idxbx)], dus[:, list(idxbu)]
    gaps = (zx - bnd[0], bnd[1] - zx, zu - bnd[2], bnd[3] - zu)
    s = tuple(torch.clamp(g, min=s_min) for g in gaps)
    lam = tuple(torch.clamp(mu0 / s_, min=s_min) for s_ in s)
    it = _Iterate(dxs, dus, *s, *lam)

    for _ in range(iters):
        it = _ipm_iter(cfg, it, A, Bm, c, Qd, qx, Rd, qu, dx0, bnd, n_con,
                       tau, reg, d_cap, eps_floor, mu_min)

    # ---- KKT + complementarity on the final iterate, then untranspose. ----
    lam = (it.l_xl, it.l_xu, it.l_ul, it.l_uu)
    kkt = ipm_kkt_fused(cfg, A, Bm, Qd, qx, it.dxs, Rd, qu, it.dus, lam,
                        (it.s_xl, it.s_xu, it.s_ul, it.s_uu))
    return IPMSolution(
        dxs=_from_bm(it.dxs), dus=_from_bm(it.dus),
        lam_xl=_from_bm(it.l_xl), lam_xu=_from_bm(it.l_xu),
        lam_ul=_from_bm(it.l_ul), lam_uu=_from_bm(it.l_uu),
        mu=kkt.musum / n_con, kkt_res=kkt.kkt,
    )


def _ipm_iter(cfg, it, A, Bm, c, Qd, qx, Rd, qu, dx0, bnd, n_con, tau, reg,
              d_cap, eps_floor, mu_min):
    s = (it.s_xl, it.s_xu, it.s_ul, it.s_uu)
    lam = (it.l_xl, it.l_xu, it.l_ul, it.l_uu)

    # --- Sweep 1: factor + residuals + affine backward + mu. ---
    bwd = ipm_bwd_fused(cfg, A, Bm, Qd, Rd, qx, qu, c, it.dxs, it.dus, s, lam,
                        bnd, reg=reg, d_cap=d_cap)
    mu = bwd.musum / n_con
    r_init = dx0 - it.dxs[0]

    # --- Sweep 2: affine forward (corrector products + mu_aff coeffs). ---
    aff = ipm_fwd_affine(cfg, A, Bm, bwd.K, bwd.kff, bwd.rdyn, r_init, s, lam,
                         bwd.rp, tau=tau)
    a_aff = aff.alpha
    mu_aff = (bwd.musum + a_aff * aff.c12[0] + a_aff * a_aff * aff.c12[1]) / n_con
    sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-16)) ** 3, 0.0, 1.0)
    sigma_mu = sigma * mu
    # The Mehrotra corrector is scaled by a_aff (damped toward the step
    # actually achievable); the JAX package's qp/ipm.py documents the
    # cycling on bound-touching warm starts that this prevents.
    corr = tuple(a_aff * p for p in aff.corr)

    # --- Sweep 3: corrector backward. ---
    kff_c = ipm_bwd_corr(cfg, A, Bm, bwd.K, bwd.L, bwd.Pc, Qd, qx, it.dxs, Rd,
                         qu, it.dus, s, lam, bwd.rp, corr, sigma_mu)

    # --- Sweep 4: corrector forward (deltas + alpha + finiteness). ---
    fc = ipm_fwd_corr(cfg, A, Bm, bwd.K, kff_c, bwd.rdyn, r_init, s, lam,
                      bwd.rp, corr, sigma_mu, tau=tau)
    alpha = fc.alpha
    ddxs = torch.cat([fc.ddx, fc.ddx_N[None]], 0)
    new = _Iterate(
        it.dxs + alpha * ddxs, it.dus + alpha * fc.ddu,
        *(torch.clamp(v + alpha * d, min=eps_floor) for v, d in zip(s + lam, fc.ds + fc.dl)),
    )
    # Per-lane freeze of converged lanes + rejection of non-finite steps.
    # The flag covers the full corrector delta set, and alpha is finite when
    # the deltas are, so delta finiteness implies iterate finiteness.
    frozen = (mu < mu_min) | (fc.finite < 0.5)
    return _Iterate(*(torch.where(frozen, old, upd) for old, upd in zip(it, new)))
