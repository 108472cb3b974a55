"""Batched Riccati factorization and solve: CUDA kernels + plain torch.

Port of ``nmpc_nav_control_tpu/ops/pallas_riccati.py``.  Three kernels
mirror the factor/solve split of ``qp/riccati.py``, so one factorization
serves both Newton solves of a Mehrotra iteration:

  ``riccati_factor_fused``     A, B, Qd, Rd              -> Ps, Ks, Ls
  ``riccati_solve_bwd_fused``  factors + gradients + c   -> kff     (carry p)
  ``riccati_solve_fwd_fused``  A, B, Ks, kff, c, dx0     -> dxs, dus (carry dx)

Layout: every per-stage tensor is batch-minor ``[rows, entries, B]``,
contiguous; matrices are dense, entries row-major (A ``[N, nx*nx, B]``,
B ``[N, nx*nu, B]``, Ps ``[N+1, nx*nx, B]``, Ks ``[N, nu*nx, B]``), and the
Cholesky factors are packed lower triangles ``[N, nu(nu+1)/2, B]``.  Ps
holds P_k at every row k = 0..N, and the forward half writes dx_N itself.
The IPM transposes A and B to this layout once per solve.

Each wrapper routes by device: CPU tensors go to the plain version beside
it (the functions of ``qp/riccati.py`` moved to this layout), CUDA tensors
to the hand-written kernel in ``csrc/riccati_fused.cu``, compiled for
(nx, nu) = (7, 2) (diff, tric) and (11, 4) (omni4); another shape on the
card raises.  There is no fallback between the two.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from nmpc_nav_control_tpu_torch.ops import _build
from nmpc_nav_control_tpu_torch.qp import riccati as ref

__all__ = [
    "KERNELS",
    "RiccatiFactorsBM",
    "pack_L",
    "unpack_L",
    "to_bm",
    "from_bm",
    "riccati_factor_fused",
    "riccati_solve_bwd_fused",
    "riccati_solve_fwd_fused",
    "factor_plain",
    "solve_bwd_plain",
    "solve_fwd_plain",
]

# Kernel name -> the TPU kernel it replaces (file:line of its pl.pallas_call
# or of the function that reaches it).
KERNELS = {
    "riccati_factor": "nmpc_nav_control_tpu/ops/pallas_riccati.py:231",
    "riccati_solve_bwd": "nmpc_nav_control_tpu/ops/pallas_riccati.py:408",
    "riccati_solve_fwd": "nmpc_nav_control_tpu/ops/pallas_riccati.py:438",
}

# (nx, nu) instantiated in csrc/riccati_fused.cu (RICCATI_EXPORT).
_CUDA_SHAPES = {(7, 2), (11, 4)}


class RiccatiFactorsBM(NamedTuple):
    Ps: torch.Tensor   # [N+1, nx*nx, B], row k = P_k
    Ks: torch.Tensor   # [N, nu*nx, B]
    Ls: torch.Tensor   # [N, nu(nu+1)/2, B], lower row-major


def _tril(nu):
    r, c = torch.tril_indices(nu, nu)
    return (r * nu + c).tolist()


def pack_L(L, nu):
    """Dense [N, nu*nu, B] -> packed lower triangles [N, nu(nu+1)/2, B]."""
    return L[:, _tril(nu)].contiguous()


def unpack_L(L, nu):
    """Packed [N, nu(nu+1)/2, B] -> dense [N, nu*nu, B], zeros above."""
    out = L.new_zeros((L.shape[0], nu * nu, L.shape[2]))
    out[:, _tril(nu)] = L
    return out


def from_bm(x, *entry):
    """Batch-minor [rows, e, B] -> [B, rows, *entry] (the layout of
    qp/riccati.py)."""
    return x.permute(2, 0, 1).reshape(x.shape[2], x.shape[0], *entry)


def to_bm(x):
    """[B, rows, *entry] -> contiguous batch-minor [rows, prod(entry), B]."""
    return x.reshape(x.shape[0], x.shape[1], -1).permute(1, 2, 0).contiguous()


def _dims(A, Bm):
    nx = round(A.shape[1] ** 0.5)
    return nx, Bm.shape[1] // nx


def _config(nx, nu):
    if (nx, nu) not in _CUDA_SHAPES:
        raise NotImplementedError(
            f"no CUDA Riccati kernel for nx={nx}, nu={nu}: csrc/riccati_fused.cu "
            f"instantiates {sorted(_CUDA_SHAPES)}")
    return f"{nx}x{nu}"


# --------------------------------------------------------------------------- #
# Plain versions (same arguments and outputs as the kernels)
# --------------------------------------------------------------------------- #


def factor_plain(A, Bm, Qd, Rd, *, reg=0.0) -> RiccatiFactorsBM:
    """Plain version of ``riccati_factor_fused``."""
    nx, nu = _dims(A, Bm)
    f = ref.riccati_factor(from_bm(A, nx, nx), from_bm(Bm, nx, nu), from_bm(Qd, nx),
                           from_bm(Rd, nu), reg=reg)
    return RiccatiFactorsBM(Ps=to_bm(f.Ps), Ks=to_bm(f.Ks), Ls=pack_L(to_bm(f.Ls), nu))


def solve_bwd_plain(A, Bm, Ks, Ls, Ps, qx, qu, c):
    """Plain version of ``riccati_solve_bwd_fused``; kff [N, nu, B]."""
    nx, nu = _dims(A, Bm)
    factors = ref.RiccatiFactors(Ps=from_bm(Ps, nx, nx), Ks=from_bm(Ks, nu, nx),
                                 Ls=from_bm(unpack_L(Ls, nu), nu, nu))
    kff = ref.riccati_solve_bwd(factors, from_bm(A, nx, nx), from_bm(Bm, nx, nu),
                                from_bm(qx, nx), from_bm(qu, nu), from_bm(c, nx))
    return to_bm(kff)


def solve_fwd_plain(A, Bm, Ks, kff, c, dx0):
    """Plain version of ``riccati_solve_fwd_fused``; (dxs [N+1, nx, B],
    dus [N, nu, B])."""
    nx, nu = _dims(A, Bm)
    dxs, dus = ref.riccati_solve_fwd(from_bm(A, nx, nx), from_bm(Bm, nx, nu),
                                     from_bm(Ks, nu, nx), from_bm(kff, nu), from_bm(c, nx),
                                     dx0.mT)
    return to_bm(dxs), to_bm(dus)


# --------------------------------------------------------------------------- #
# Wrappers: CPU -> plain version, CUDA -> kernel
# --------------------------------------------------------------------------- #


def riccati_factor_fused(A, Bm, Qd, Rd, *, reg: float = 0.0) -> RiccatiFactorsBM:
    """Backward Riccati factorization (replaces
    ``pallas_riccati.riccati_factor_batched``).

    A [N, nx*nx, B], Bm [N, nx*nu, B], Qd [N+1, nx, B], Rd [N, nu, B].
    """
    ins = (A, Bm, Qd, Rd)
    if not _build.on_cuda(ins):
        return factor_plain(A, Bm, Qd, Rd, reg=reg)
    nx, nu = _dims(A, Bm)
    N, _, B = A.shape
    config = _config(nx, nu)
    _build.check([("A", A, (N, nx * nx, B)), ("Bm", Bm, (N, nx * nu, B)),
                  ("Qd", Qd, (N + 1, nx, B)), ("Rd", Rd, (N, nu, B))])
    out = RiccatiFactorsBM(Ps=A.new_empty((N + 1, nx * nx, B)), Ks=A.new_empty((N, nu * nx, B)),
                           Ls=A.new_empty((N, nu * (nu + 1) // 2, B)))
    _build.launch("riccati_factor", config, [*ins, *out], N, B, reg)
    return out


def riccati_solve_bwd_fused(A, Bm, Ks, Ls, Ps, qx, qu, c):
    """Backward half of the Riccati solve (replaces the backward kernel of
    ``pallas_riccati.riccati_solve_batched``).

    Ks/Ls/Ps from ``riccati_factor_fused``; qx [N+1, nx, B], qu [N, nu, B],
    c [N, nx, B].  Returns kff [N, nu, B].
    """
    ins = (A, Bm, Ks, Ls, Ps, qx, qu, c)
    if not _build.on_cuda(ins):
        return solve_bwd_plain(*ins)
    nx, nu = _dims(A, Bm)
    N, _, B = A.shape
    config = _config(nx, nu)
    _build.check([("A", A, (N, nx * nx, B)), ("Bm", Bm, (N, nx * nu, B)),
                  ("Ks", Ks, (N, nu * nx, B)), ("Ls", Ls, (N, nu * (nu + 1) // 2, B)),
                  ("Ps", Ps, (N + 1, nx * nx, B)), ("qx", qx, (N + 1, nx, B)),
                  ("qu", qu, (N, nu, B)), ("c", c, (N, nx, B))])
    kff = A.new_empty((N, nu, B))
    _build.launch("riccati_solve_bwd", config, [*ins, kff], N, B)
    return kff


def riccati_solve_fwd_fused(A, Bm, Ks, kff, c, dx0):
    """Forward half of the Riccati solve (replaces the forward kernel of
    ``pallas_riccati.riccati_solve_batched``).

    kff [N, nu, B], c [N, nx, B], dx0 [nx, B].  Returns (dxs [N+1, nx, B],
    dus [N, nu, B]).
    """
    ins = (A, Bm, Ks, kff, c, dx0)
    if not _build.on_cuda(ins):
        return solve_fwd_plain(*ins)
    nx, nu = _dims(A, Bm)
    N, _, B = A.shape
    config = _config(nx, nu)
    _build.check([("A", A, (N, nx * nx, B)), ("Bm", Bm, (N, nx * nu, B)),
                  ("Ks", Ks, (N, nu * nx, B)), ("kff", kff, (N, nu, B)),
                  ("c", c, (N, nx, B)), ("dx0", dx0, (nx, B))])
    dxs, dus = A.new_empty((N + 1, nx, B)), A.new_empty((N, nu, B))
    _build.launch("riccati_solve_fwd", config, [*ins, dxs, dus], N, B)
    return dxs, dus
