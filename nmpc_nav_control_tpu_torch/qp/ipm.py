"""Box-constrained stagewise QP: Mehrotra primal-dual interior point.

Port of ``nmpc_nav_control_tpu/qp/ipm.py`` (the data types and the batched
entry point).  QP in delta form around a reference trajectory:

  min  sum_k 1/2 dx'diag(Qd_k)dx + qx_k'dx + 1/2 du'diag(Rd_k)du + qu_k'du
  s.t. dx_0 = dx0
       dx_{k+1} = A_k dx_k + B_k du_k + c_k
       lbx_k <= sel_x(dx_k) <= ubx_k   (k = 1..N)
       lbu_k <= sel_u(du_k) <= ubu_k   (k = 0..N-1)

``solve_box_qp`` takes a batch (every leaf with a leading batch axis) and
runs the fused-sweep iteration of ``qp/ipm_batched.py``.  The JAX package's
serial single-problem path and its Riccati module (``qp/riccati.py``) are
not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["BoxQP", "IPMSolution", "solve_box_qp"]


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


def solve_box_qp(qp: BoxQP, idxbx, idxbu, iters: int = 12, tau: float = 0.995,
                 mu0: float = 1.0, s_min: float = 0.3, reg: float = 1e-8,
                 mu_min: float | None = None, spars=None) -> IPMSolution:
    """Solve a batch of stagewise box QPs (leaves [B, ...]).

    ``spars``: optional (A_pattern, B_pattern) structural-nonzero masks that
    over-approximate the nonzeros of qp.A / qp.B; None means dense.  Returns
    an ``IPMSolution`` with leading batch axes.
    """
    from nmpc_nav_control_tpu_torch.qp.ipm_batched import solve_box_qp_batched

    return solve_box_qp_batched(qp, idxbx, idxbu, iters=iters, tau=tau, mu0=mu0,
                                s_min=s_min, reg=reg, mu_min=mu_min, spars=spars)
