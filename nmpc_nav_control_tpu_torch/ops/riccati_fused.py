"""Batched Riccati factorization and solve: CUDA kernels + plain torch.

Port of ``nmpc_nav_control_tpu/ops/pallas_riccati.py``.  Three kernels
mirror the factor/solve split of ``ops/riccati.py``, so one factorization
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

Each kernel is a ``torch.library`` custom op, ``nmpc_tpu::<kernel>``
(``OPS``, the schema of ``ops._build.OP_SCHEMA``; the key is empty, the
shape is read from A and Bm): on CUDA tensors it launches the hand-written
kernel in ``csrc/riccati_fused.cu``, compiled for f32 at (nx, nu) = (7, 2)
(diff, tric) and (11, 4) (omni4), where another shape or dtype raises; on
CPU tensors it runs the plain version beside it (the functions of
``ops/riccati.py`` moved to this layout); under a tracer its fake gives the
outputs' shapes.  Each wrapper routes by its ``impl`` argument and the
device (``ops._build.use_op``): "kernel" (the default) sends CUDA tensors
to the op and so to the kernel, and CPU tensors to the plain version
(through the op where a tracer made them); "plain" runs the plain version
on the tensors' own device, which is how the solve runs f64 on the card
(``qp.ipm.kernel_impl``).  There is no fallback between the two.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from nmpc_nav_control_tpu_torch.ops import _build
from nmpc_nav_control_tpu_torch.ops import riccati as ref
from nmpc_nav_control_tpu_torch.utils.index import index_tensor

__all__ = [
    "KERNELS",
    "OPS",
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


def _tril(nu, device):
    """Row-major positions of the lower triangle in a dense nu x nu row."""
    return index_tensor(tuple(i * nu + j for i in range(nu) for j in range(i + 1)), device)


def pack_L(L, nu):
    """Dense [N, nu*nu, B] -> packed lower triangles [N, nu(nu+1)/2, B]."""
    return L.index_select(1, _tril(nu, L.device))


def unpack_L(L, nu):
    """Packed [N, nu(nu+1)/2, B] -> dense [N, nu*nu, B], zeros above."""
    out = L.new_zeros((L.shape[0], nu * nu, L.shape[2]))
    return out.index_copy_(1, _tril(nu, L.device), L)


def from_bm(x, *entry):
    """Batch-minor [rows, e, B] -> [B, rows, *entry] (the layout of
    ops/riccati.py)."""
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
# The ops: nmpc_tpu::<kernel>, the kernel on CUDA tensors, the plain version
# on CPU tensors, output shapes for a tracer
# --------------------------------------------------------------------------- #


# Each kernel's operands, in the order of its argument struct in
# csrc/riccati_fused.cu: io(key, ins) -> (N, B, [(name, shape)] of the
# inputs, [shape] of the outputs, the compiled specialisation's name).
def _factor_io(key, ins):
    (nx, nu), (N, _, B) = _dims(*ins[:2]), ins[0].shape
    inputs = [("A", (N, nx * nx, B)), ("Bm", (N, nx * nu, B)), ("Qd", (N + 1, nx, B)),
              ("Rd", (N, nu, B))]
    outputs = [(N + 1, nx * nx, B), (N, nu * nx, B), (N, nu * (nu + 1) // 2, B)]
    return N, B, inputs, outputs, lambda: _config(nx, nu)


def _solve_bwd_io(key, ins):
    (nx, nu), (N, _, B) = _dims(*ins[:2]), ins[0].shape
    inputs = [("A", (N, nx * nx, B)), ("Bm", (N, nx * nu, B)), ("Ks", (N, nu * nx, B)),
              ("Ls", (N, nu * (nu + 1) // 2, B)), ("Ps", (N + 1, nx * nx, B)),
              ("qx", (N + 1, nx, B)), ("qu", (N, nu, B)), ("c", (N, nx, B))]
    return N, B, inputs, [(N, nu, B)], lambda: _config(nx, nu)


def _solve_fwd_io(key, ins):
    (nx, nu), (N, _, B) = _dims(*ins[:2]), ins[0].shape
    inputs = [("A", (N, nx * nx, B)), ("Bm", (N, nx * nu, B)), ("Ks", (N, nu * nx, B)),
              ("kff", (N, nu, B)), ("c", (N, nx, B)), ("dx0", (nx, B))]
    return N, B, inputs, [(N + 1, nx, B), (N, nu, B)], lambda: _config(nx, nu)


OPS = {
    "riccati_factor": _build.define_op("riccati_factor", _factor_io, lambda key, ins, reg, _:
                                       list(factor_plain(*ins, reg=reg))),
    "riccati_solve_bwd": _build.define_op("riccati_solve_bwd", _solve_bwd_io,
                                          lambda key, ins, *_: [solve_bwd_plain(*ins)]),
    "riccati_solve_fwd": _build.define_op("riccati_solve_fwd", _solve_fwd_io,
                                          lambda key, ins, *_: list(solve_fwd_plain(*ins))),
}


# --------------------------------------------------------------------------- #
# Wrappers: the op (kernel on CUDA, plain version on the CPU), or the plain
# version itself
# --------------------------------------------------------------------------- #


def riccati_factor_fused(A, Bm, Qd, Rd, *, reg: float = 0.0,
                         impl: str = "kernel") -> RiccatiFactorsBM:
    """Backward Riccati factorization (replaces
    ``pallas_riccati.riccati_factor_batched``).

    A [N, nx*nx, B], Bm [N, nx*nu, B], Qd [N+1, nx, B], Rd [N, nu, B].
    """
    ins = (A, Bm, Qd, Rd)
    if not _build.use_op(ins, impl):
        return factor_plain(A, Bm, Qd, Rd, reg=reg)
    return RiccatiFactorsBM(*OPS["riccati_factor"]("", ins, reg, 0.0))


def riccati_solve_bwd_fused(A, Bm, Ks, Ls, Ps, qx, qu, c, *, impl: str = "kernel"):
    """Backward half of the Riccati solve (replaces the backward kernel of
    ``pallas_riccati.riccati_solve_batched``).

    Ks/Ls/Ps from ``riccati_factor_fused``; qx [N+1, nx, B], qu [N, nu, B],
    c [N, nx, B].  Returns kff [N, nu, B].
    """
    ins = (A, Bm, Ks, Ls, Ps, qx, qu, c)
    if not _build.use_op(ins, impl):
        return solve_bwd_plain(*ins)
    return OPS["riccati_solve_bwd"]("", ins, 0.0, 0.0)[0]


def riccati_solve_fwd_fused(A, Bm, Ks, kff, c, dx0, *, impl: str = "kernel"):
    """Forward half of the Riccati solve (replaces the forward kernel of
    ``pallas_riccati.riccati_solve_batched``).

    kff [N, nu, B], c [N, nx, B], dx0 [nx, B].  Returns (dxs [N+1, nx, B],
    dus [N, nu, B]).
    """
    ins = (A, Bm, Ks, kff, c, dx0)
    if not _build.use_op(ins, impl):
        return solve_fwd_plain(*ins)
    return tuple(OPS["riccati_solve_fwd"]("", ins, 0.0, 0.0))
