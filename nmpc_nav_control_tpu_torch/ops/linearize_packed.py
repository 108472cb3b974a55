"""Batched RK4 linearization written straight into packed A/B nonzeros.

Port of ``nmpc_nav_control_tpu/ops/tiled_linearize.py``.  The model ``f``
indexes entries on the first axis and is elementwise over the rest, so one
RK4 evaluation covers every stage and scenario of the batch-minor
``[nx, N, B]`` block.  The Jacobian columns are forward derivatives taken
by complex step (as the repo's NumPy oracle takes them), all of them from
one complex RK4 evaluation over a trailing column axis; torch's forward-mode
AD gives the same columns at some thirty times the host time per call.  Only
the structural nonzeros of A/B are kept, in the IPM's batch-minor
``[N, nnz, B]`` layout.
Plain torch: the JAX package leaves this step to XLA too.  The JAX path's stage chunking
(``NMPC_TPU_LIN_CHUNK``) worked around an XLA fusion-size limit and has no
counterpart here.
"""
from __future__ import annotations

import torch

from nmpc_nav_control_tpu_torch.ocp.integrator import make_discrete_dynamics
from nmpc_nav_control_tpu_torch.utils.index import index_tensor, nz_positions

__all__ = ["linearize_packed", "nz_positions"]


def linearize_packed(f, dt, xs, us, p, asp, bsp):
    """Linearize a batch of trajectories into packed, batch-minor operands.

    Args:
      f:   continuous dynamics (the model function).
      dt:  shooting interval.
      xs:  [B, N+1, nx] linearization states (rows 0..N-1 used).
      us:  [B, N, nu] inputs.
      p:   [npar] or [B, npar] model parameters.
      asp/bsp: structural-nonzero patterns of the discrete A/B Jacobians.

    Returns (A [N, nnzA, B], Bm [N, nnzB, B], x_next [N, nx, B]).
    """
    F = make_discrete_dynamics(f, dt)
    nx, nu = xs.shape[-1], us.shape[-1]
    xT = xs[:, :-1].permute(2, 1, 0)                   # [nx, N, B]
    uT = us.permute(2, 1, 0)                           # [nu, N, B]
    pT = p.T[:, None, :] if p.ndim == 2 else p         # [npar, 1, B] or [npar]
    x_next = F(xT, uT, pT)

    # Complex step, one column per entry of a trailing axis:
    # Im F(z + i h e_j) = h dF/dz_j up to O(h^3), with no subtraction, so
    # Im / h is the Jacobian column to rounding for analytic dynamics (the
    # wheeled models are: arithmetic, sin, cos).  h is a power of two, so the
    # division is exact.  One complex RK4 evaluation yields every column.
    h = 2.0 ** -64
    cplx = torch.complex128 if xs.dtype == torch.float64 else torch.complex64
    seed = (1j * h) * torch.eye(nx + nu, dtype=cplx, device=xs.device)[:, None, None, :]
    pC = pT[..., None] if p.ndim == 2 else pT
    cols = F(xT[..., None] + seed[:nx], uT[..., None] + seed[nx:], pC).imag / h
    # cols[i, k, b, j] = d x_next_i / d z_j at stage k of lane b.

    # The nonzeros are gathered by index tensors made once on the device,
    # which a CUDA graph can replay (a list index copies from the host).
    dev = xs.device
    nzA, nzB = nz_positions(asp), nz_positions(bsp)
    A = cols[index_tensor(tuple(i for i, _ in nzA), dev), :, :,
             index_tensor(tuple(j for _, j in nzA), dev)]
    Bm = cols[index_tensor(tuple(i for i, _ in nzB), dev), :, :,
              index_tensor(tuple(nx + j for _, j in nzB), dev)]
    return (A.permute(1, 0, 2).contiguous(), Bm.permute(1, 0, 2).contiguous(),
            x_next.permute(1, 0, 2).contiguous())
