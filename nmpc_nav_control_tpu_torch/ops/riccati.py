"""Riccati factorization and solve for the stagewise LQR subproblem, batched.

Port of ``nmpc_nav_control_tpu/qp/riccati.py``; it lives in ``ops/``
beside the kernels it is the reference of, so that ``ops`` (and a loaded
tick artifact, ``runtime/aot.py``) imports nothing of ``qp/``.  The matrix
recursion (P, K, chol(Quu)) is separate from the vector recursion (p, kff)
and the forward rollout, so one factorization serves the two Newton solves
of a Mehrotra iteration.  The functions below are plain torch with a leading batch axis
on every tensor ([B, N, ...]), in the JAX package's layout: the reference
the kernels of ``ops/riccati_fused.py`` are held against and, through those
wrappers' plain versions, the CPU route.  The batched entry points of the
JAX package (``riccati_factor_v``, ``riccati_solve_v``) are those wrappers
(``riccati_factor_fused``, ``riccati_solve_bwd_fused``,
``riccati_solve_fwd_fused``): they take the kernels' batch-minor layout, so
the IPM lays A and B out once per solve, and go to the CUDA kernels for
CUDA tensors and to the plain versions for CPU tensors.

Problem solved (delta form; dx0 given):
  min  sum_{k<N} 1/2 dx'diag(Qd_k)dx + qx_k'dx + 1/2 du'diag(Rd_k)du + qu_k'du
       + 1/2 dx_N'diag(Qd_N)dx_N + qx_N'dx_N
  s.t. dx_{k+1} = A_k dx_k + B_k du_k + c_k,   dx_0 = dx0.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from nmpc_nav_control_tpu_torch.ops.linalg_small import cho_solve_small, cholesky_small

__all__ = ["RiccatiFactors", "riccati_factor", "riccati_solve", "riccati_solve_bwd",
           "riccati_solve_fwd", "lqr_solve"]


class RiccatiFactors(NamedTuple):
    """Backward-sweep factorization, leading batch axis.

    Ps: [B, N+1, nx, nx] cost-to-go Hessians, Ps[:, k] = P_k (row 0 too).
    Ks: [B, N, nu, nx]   feedback gains.
    Ls: [B, N, nu, nu]   lower Cholesky factors of Quu_k.
    """

    Ps: torch.Tensor
    Ks: torch.Tensor
    Ls: torch.Tensor


def _mv(M, v):
    """Batched matrix-vector product [..., n, m] x [..., m] -> [..., n]."""
    return (M @ v[..., None])[..., 0]


def riccati_factor(A, B, Qd, Rd, reg: float = 0.0) -> RiccatiFactors:
    """Backward matrix recursion.

    A [B, N, nx, nx], B [B, N, nx, nu], Qd [B, N+1, nx] (row N terminal),
    Rd [B, N, nu]; ``reg`` is added to the diagonal of every Quu.
    """
    N = B.shape[1]
    P = torch.diag_embed(Qd[:, N])
    Ps, Ks, Ls = [None] * (N + 1), [None] * N, [None] * N
    Ps[N] = P
    for k in reversed(range(N)):
        A_k, B_k = A[:, k], B[:, k]
        PA = P @ A_k
        PB = P @ B_k
        Quu = B_k.mT @ PB + torch.diag_embed(Rd[:, k] + reg)
        Qux = B_k.mT @ PA
        L = cholesky_small(Quu)
        K = -cho_solve_small(L, Qux)
        P = A_k.mT @ PA + Qux.mT @ K + torch.diag_embed(Qd[:, k])
        P = 0.5 * (P + P.mT)
        Ps[k], Ks[k], Ls[k] = P, K, L
    return RiccatiFactors(Ps=torch.stack(Ps, 1), Ks=torch.stack(Ks, 1), Ls=torch.stack(Ls, 1))


def riccati_solve_bwd(factors: RiccatiFactors, A, B, qx, qu, c):
    """Backward vector recursion -> kff [B, N, nu].

    tmp = p + P_{k+1} c_k, qu_bar = qu_k + B_k'tmp, kff_k = -Quu_k^{-1} qu_bar,
    p <- qx_k + A_k'tmp + K_k'qu_bar, from p = qx_N.
    """
    Ps, Ks, Ls = factors
    N = B.shape[1]
    p = qx[:, N]
    kffs = [None] * N
    for k in reversed(range(N)):
        tmp = p + _mv(Ps[:, k + 1], c[:, k])
        qu_bar = qu[:, k] + _mv(B[:, k].mT, tmp)
        kffs[k] = -cho_solve_small(Ls[:, k], qu_bar)
        p = qx[:, k] + _mv(A[:, k].mT, tmp) + _mv(Ks[:, k].mT, qu_bar)
    return torch.stack(kffs, 1)


def riccati_solve_fwd(A, B, Ks, kffs, c, dx0):
    """Forward rollout du = K dx + kff, dx' = A dx + B du + c from dx0 ->
    (dxs [B, N+1, nx], dus [B, N, nu])."""
    dx, dxs, dus = dx0, [dx0], []
    for k in range(B.shape[1]):
        du = _mv(Ks[:, k], dx) + kffs[:, k]
        dx = _mv(A[:, k], dx) + _mv(B[:, k], du) + c[:, k]
        dxs.append(dx)
        dus.append(du)
    return torch.stack(dxs, 1), torch.stack(dus, 1)


def riccati_solve(factors: RiccatiFactors, A, B, qx, qu, c, dx0):
    """Vector backward recursion + forward rollout with cached factors.

    qx [B, N+1, nx], qu [B, N, nu], c [B, N, nx], dx0 [B, nx] ->
    (dxs [B, N+1, nx], dus [B, N, nu]).
    """
    kffs = riccati_solve_bwd(factors, A, B, qx, qu, c)
    return riccati_solve_fwd(A, B, factors.Ks, kffs, c, dx0)


def lqr_solve(A, B, Qd, Rd, qx, qu, c, dx0, reg: float = 0.0):
    """Factor + solve in one call."""
    return riccati_solve(riccati_factor(A, B, Qd, Rd, reg=reg), A, B, qx, qu, c, dx0)
