"""Stage-parallel LQR by associative scans: O(log N) depth, batched.

Port of ``nmpc_nav_control_tpu/qp/parallel_riccati.py``.  The backward
Riccati sweep is a suffix reduction over "conditional value function"
elements (Sarkka & Garcia-Fernandez, "Temporal Parallelization of Dynamic
Programming and Linear Quadratic Control"); each stage k gives

    a = (A, b, C, eta, J)
      A = A_k,  b = c_k - B_k R^{-1} qu_k,  C = B_k R^{-1} B_k',
      eta = -qx_k,  J = diag(Qd_k),

with the terminal element (0, 0, 0, -qx_N, diag(Qd_N)), and the composition
``_combine`` (S = (I + C1 J2)^{-1}) is associative.  The suffix reduction at
k gives J = P_k and eta = -p_k.  Gains are then stage-local, and the forward
rollout is a prefix scan of affine maps.

Each scan is a log-depth loop (Hillis-Steele): ceil(log2(L)) levels over L
elements, each level one batched ``_combine`` of every pair at distance
1, 2, 4, ...  The JAX package hands the same elements to
``jax.lax.associative_scan``, whose tree differs, so the two agree to
rounding, not bit for bit.

``plqr_solve_blocks`` takes the horizon as contiguous stage blocks, each
on a device of its own (the last block may be shorter and holds the
terminal element), and gives the step back in the same blocks.  Each scan
then runs in two levels, as XLA partitions a sharded ``associative_scan``:
a local scan inside every block on its device, the block totals carried
across the devices, and a fix-up of each block by the carry; the gains read
one row of the next block, and the rollout carries one state row and
``dx0``.  Nothing else crosses a device, and every crossing goes through
``move``.  ``plqr_solve`` splits whole tensors into blocks of ceil(N/s)
stages on ``stage_devices`` (``stage_blocks``) and concatenates the result
on the inputs' device; one block (the default) is the plain scan.

The small products are torch batched matmuls and the non-symmetric solves
``torch.linalg.solve_ex`` with ``check_errors=False``: ``torch.linalg.solve``
reads its ``info`` on the host, a sync per call that a CUDA graph cannot
capture.
"""
from __future__ import annotations

import math

import torch

from nmpc_nav_control_tpu_torch.ops.linalg_small import cho_solve_small, cholesky_small

__all__ = ["move", "plqr_solve", "plqr_solve_blocks", "stage_blocks", "state_blocks"]


def move(x, device):
    """``x`` on ``device``: the one place where the stage-parallel solves
    carry a tensor from one device to another."""
    return x.to(device)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _combine(e1, e2):
    """Associative composition: e1 spans [i, k), e2 spans [k, j) -> [i, j).
    Leaves [B, L, ...], the stage axis second; e2 may be expanded from one
    row."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    nx = A1.shape[-1]
    eye = torch.eye(nx, dtype=A1.dtype, device=A1.device)
    # S = (I + C1 J2)^{-1}; T = (I + J2 C1)^{-1} = S' with these symmetric C, J.
    M = eye + C1 @ J2
    rhs = torch.cat([A1, (b1 + _mv(C1, eta2))[..., None], C1], -1)
    S = torch.linalg.solve_ex(M, rhs, check_errors=False)[0]
    S_A1, S_b, S_C1 = S[..., :nx], S[..., nx], S[..., nx + 1:]
    A = A2 @ S_A1
    b = _mv(A2, S_b) + b2
    C = A2 @ S_C1 @ A2.mT + C2
    Mt = eye + J2 @ C1
    rhs = torch.cat([(eta2 - _mv(J2, b1))[..., None], J2.expand_as(C1)], -1)
    T = torch.linalg.solve_ex(Mt, rhs, check_errors=False)[0]
    eta = _mv(A1.mT, T[..., 0]) + eta1
    J = A1.mT @ T[..., 1:] @ A1 + J1
    return A, b, C, eta, 0.5 * (J + J.mT)


def _compose(f1, f2):
    """Affine maps x -> M x + v; f1 earlier, f2 later: (M2 M1, M2 v1 + v2)."""
    M1, v1 = f1
    M2, v2 = f2
    return M2 @ M1, _mv(M2, v1) + v2


def _local_scan(op, elems, reverse):
    """Inclusive scan along axis 1 in ceil(log2(L)) levels: prefix
    (``reverse=False``: row k = op(row 0, ..., row k)) or suffix
    (row k = op(row k, ..., row L-1)); ``op(earlier, later)``."""
    L = elems[0].shape[1]
    d = 1
    while d < L:
        new = op(tuple(e[:, :L - d] for e in elems), tuple(e[:, d:] for e in elems))
        if reverse:
            elems = tuple(torch.cat([n, e[:, L - d:]], 1) for n, e in zip(new, elems))
        else:
            elems = tuple(torch.cat([e[:, :d], n], 1) for n, e in zip(new, elems))
        d *= 2
    return elems


def _scan(op, blocks, reverse):
    """Two-level scan over per-device blocks (lists of element tuples in
    stage order): local scans, then the block totals carried across the
    devices (from the last block for a suffix, the first for a prefix), each
    block fixed up by the carry that reaches it."""
    blocks = [_local_scan(op, b, reverse) for b in blocks]
    order = range(len(blocks) - 1, -1, -1) if reverse else range(len(blocks))
    carry = None
    for j in order:
        blk = blocks[j]
        if carry is not None:
            c = tuple(move(t, blk[0].device).expand_as(e) for t, e in zip(carry, blk))
            blk = blocks[j] = op(blk, c) if reverse else op(c, blk)
        carry = tuple(e[:, :1] if reverse else e[:, -1:] for e in blk)
    return blocks


def stage_blocks(N: int, n_blocks: int) -> list[tuple[int, int]]:
    """[start, stop) of each non-empty block of ceil(N / n_blocks) stages."""
    size = math.ceil(N / n_blocks)
    return [(k, min(k + size, N)) for k in range(0, N, size)]


def state_blocks(spans: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The state rows of each stage block: a block's stages' own rows, and
    the last block also row N."""
    N = spans[-1][1]
    return [(k0, k1 + (k1 == N)) for k0, k1 in spans]


def plqr_solve_blocks(blocks, dx0):
    """``plqr_solve`` on a horizon held in stage blocks.

    ``blocks``: per block in stage order, (A, B, Qd, Rd, qx, qu, c) on the
    block's device, batch-leading: A [B, n, nx, nx], B [B, n, nx, nu], Rd,
    qu, c over the block's n stages, Qd and qx over its state rows
    (``state_blocks``: the last block's hold row N too); dx0 [B, nx] on any
    device.  Returns (dxs, dus): per block, the step's state rows [B, rows,
    nx] and inputs [B, n, nu] on the block's device.
    """
    last = len(blocks) - 1
    elems = []
    for j, (A, B, Qd, Rd, qx, qu, c) in enumerate(blocks):
        C = (B / Rd[..., None, :]) @ B.mT                    # B R^{-1} B'
        b = c - _mv(B, qu / Rd)
        if j == last:                                        # the terminal element
            zeroA = torch.zeros_like(A[:, :1])
            A, b, C = (torch.cat([A, zeroA], 1), torch.cat([b, torch.zeros_like(b[:, :1])], 1),
                       torch.cat([C, zeroA], 1))
        elems.append((A, b, C, -qx, torch.diag_embed(Qd)))
    suffix = _scan(_combine, elems, reverse=True)

    # Stage-parallel gains from P_{k+1}, p_{k+1}: a block's rows shifted by
    # one, the last row from the next block.
    gains = []
    for j, ((A_j, B_j, _, Rd_j, _, qu_j, c_j), (_, _, _, eta, Js)) in enumerate(
            zip(blocks, suffix)):
        if j < last:
            nxt = suffix[j + 1]
            eta = torch.cat([eta[:, 1:], move(nxt[3][:, :1], eta.device)], 1)
            Js = torch.cat([Js[:, 1:], move(nxt[4][:, :1], Js.device)], 1)
        else:
            eta, Js = eta[:, 1:], Js[:, 1:]
        P1, p1 = Js, -eta
        PB = P1 @ B_j
        L = cholesky_small(B_j.mT @ PB + torch.diag_embed(Rd_j))
        qu_bar = qu_j + _mv(B_j.mT, p1 + _mv(P1, c_j))
        kff = -cho_solve_small(L, qu_bar)
        K = -cho_solve_small(L, PB.mT @ A_j)
        gains.append((K, kff, A_j + B_j @ K, _mv(B_j, kff) + c_j))

    # Forward rollout as an affine-map prefix scan: dx_{k+1} = Mc[k] dx0 +
    # vc[k]; a block's first state row is the previous block's last.
    prefix = _scan(_compose, [g[2:] for g in gains], reverse=False)
    dxs, dus, prev_row = [], [], dx0[:, None]
    for j, ((K, kff, _, _), (Mc, vc)) in enumerate(zip(gains, prefix)):
        x0 = move(dx0, Mc.device)
        tail = _mv(Mc, x0[:, None].expand(-1, Mc.shape[1], -1)) + vc
        xs = torch.cat([move(prev_row, Mc.device), tail[:, :-1]], 1)
        dus.append(_mv(K, xs) + kff)
        dxs.append(xs if j < last else torch.cat([xs, tail[:, -1:]], 1))
        prev_row = tail[:, -1:]
    return dxs, dus


def plqr_solve(A, B, Qd, Rd, qx, qu, c, dx0, stage_devices=None):
    """Solve the affine LQR of ``ops.riccati.lqr_solve`` with log-depth
    associative scans, for a batch.

    A [B, N, nx, nx], B [B, N, nx, nu], Qd [B, N+1, nx], Rd [B, N, nu],
    qx [B, N+1, nx], qu [B, N, nu], c [B, N, nx], dx0 [B, nx] ->
    (dxs [B, N+1, nx], dus [B, N, nu]) on the inputs' device.
    ``stage_devices``: the devices of the stage blocks (module docstring);
    None runs one block on the inputs' device.
    """
    home = A.device
    devices = [home] if stage_devices is None else list(stage_devices)
    spans = stage_blocks(B.shape[1], len(devices))
    blocks = [tuple(move(x[:, k0:k1], d) for x, (k0, k1) in
                    zip((A, B, Qd, Rd, qx, qu, c), (st, st, sx, st, sx, st, st)))
              for st, sx, d in zip(spans, state_blocks(spans), devices)]
    dxs, dus = plqr_solve_blocks(blocks, dx0)
    return (torch.cat([move(x, home) for x in dxs], 1),
            torch.cat([move(u, home) for u in dus], 1))
