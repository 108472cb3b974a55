"""Tiny-matrix linear algebra, unrolled over the matrix entries.

Port of ``nmpc_nav_control_tpu/qp/linalg_small.py``, in ``ops/`` beside
``ops/riccati.py``, its user there.  The stage blocks are
minuscule (nu in {2, 4}, nx in {7, 11}), so every function keeps the matrix
dimensions unrolled as index arithmetic and is elementwise over any leading
batch axes [..., n, n].  A non-positive pivot gives NaN through the square
root, as in the JAX package.
"""
from __future__ import annotations

import torch

__all__ = ["cholesky_small", "cho_solve_small", "solve_spd_small"]


def cholesky_small(M):
    """Unrolled lower Cholesky of an SPD matrix. M: [..., n, n] -> L: [..., n, n]."""
    n = M.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    zero = torch.zeros_like(M[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero for j in range(n)], -1)
                        for i in range(n)], -2)


def cho_solve_small(L, rhs):
    """Solve (L L^T) X = rhs given lower Cholesky L.

    L: [..., n, n]; rhs: [..., n] or [..., n, m].
    """
    vec = rhs.ndim == L.ndim - 1
    if vec:
        rhs = rhs[..., None]
    n = L.shape[-1]
    y = [None] * n
    for i in range(n):
        s = rhs[..., i, :]
        for k in range(i):
            s = s - L[..., i, k, None] * y[k]
        y[i] = s / L[..., i, i, None]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i, None] * x[k]
        x[i] = s / L[..., i, i, None]
    out = torch.stack(x, -2)
    return out[..., 0] if vec else out


def solve_spd_small(M, rhs, reg: float = 0.0):
    """Solve M X = rhs for SPD M (optionally Tikhonov-regularized)."""
    if reg:
        M = M + reg * torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return cho_solve_small(cholesky_small(M), rhs)
