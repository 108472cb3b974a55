"""The five sweeps of the batched Mehrotra box-IPM: CUDA kernels + plain torch.

Port of ``nmpc_nav_control_tpu/ops/pallas_ipm.py``.  One IPM iteration is
four sweeps over the horizon, and a solve ends with one KKT sweep:

  1. ``ipm_bwd_fused``  — backward: bound gaps / primal residuals, sum of
     s*lam, barrier diagonals, dynamics residual, Riccati factorization and
     the affine vector recursion;
  2. ``ipm_fwd_affine`` — forward: affine rollout, slack/multiplier deltas,
     fraction-to-boundary step, Mehrotra corrector products and the mu_aff
     coefficients;
  3. ``ipm_bwd_corr``   — backward: corrector vector recursion;
  4. ``ipm_fwd_corr``   — forward: corrector rollout, full deltas, step and
     a per-lane finiteness flag;
  5. ``ipm_kkt_fused``  — backward: costate recursion, inf-norm of the
     u-stationarity and the final sum of s*lam.

Layout: every per-stage tensor is batch-minor ``[rows, entries, B]``,
contiguous (``rows`` = N or N+1); per-lane results are ``[B]``.  A/B arrive
packed to their structural nonzeros (``pack_sparse``).  The four bound
groups travel as 4-tuples ordered (x lower, x upper, u lower, u upper); x
bounds at row k apply to stage k+1.

Each sweep is a ``torch.library`` custom op, ``nmpc_tpu::<kernel>``
(``OPS``): on CUDA tensors it checks its operands and launches the
hand-written kernel in ``csrc/ipm_fused.cu`` (its header says how each
kernel splits a lane's stages over threads; f32 only), on CPU tensors it
runs the plain torch version beside it, and under a tracer its fake gives
the outputs' shapes, so an exported tick holds one node per sweep
(``runtime/aot.py``).  An op takes the ``SweepConfig`` as its key string
and its operands as one flat list, in the order of the kernel's argument
struct, and returns a flat list that the wrapper nests again.  Each wrapper
routes by its ``impl`` argument and the device (``ops._build.use_op``):
with "kernel" (the default) tensors on a CUDA device go to the op and so
to the kernel, or the wrapper raises, and tensors on the CPU to the plain
version (through the op where a tracer made them); "plain" runs the plain
version on the tensors' own device, which is how the solve runs f64 on the
card (``qp.ipm.kernel_impl``).  There is no fallback between the
two.  The plain versions follow the TPU kernels' conventions so that
every output is comparable: the cost-to-go carry excludes the stage
diagonal, which is added when consumed; backward sweeps read Qd/qx/dx at
row k+1; the forward rollout starts from ``r_init = dx0 - dx[0]``; the
fraction-to-boundary sentinel is ``_BIG``; a product with a structural zero
of A or B is left out of its sum, and the Cholesky factor and its solves
go entry by entry, so NaN and Inf reach the same outputs as in the kernels.
They also run in f64.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from typing import NamedTuple

import torch

from nmpc_nav_control_tpu_torch.ops import _build
from nmpc_nav_control_tpu_torch.utils.index import index_tensor, mask_tensor, nz_positions, sel

__all__ = [
    "SweepConfig",
    "dense_sparsity",
    "pack_sparse",
    "ipm_bwd_fused",
    "ipm_fwd_affine",
    "ipm_bwd_corr",
    "ipm_fwd_corr",
    "ipm_kkt_fused",
    "bwd_fused_plain",
    "fwd_affine_plain",
    "bwd_corr_plain",
    "fwd_corr_plain",
    "kkt_fused_plain",
    "KERNELS",
    "OPS",
]

_BIG = 3.4e38

# Kernel name -> the TPU kernel it replaces (file:line of the function that
# reaches pl.pallas_call).
KERNELS = {
    "ipm_bwd_fused": "nmpc_nav_control_tpu/ops/pallas_ipm.py:387",
    "ipm_fwd_affine": "nmpc_nav_control_tpu/ops/pallas_ipm.py:738",
    "ipm_bwd_corr": "nmpc_nav_control_tpu/ops/pallas_ipm.py:512",
    "ipm_fwd_corr": "nmpc_nav_control_tpu/ops/pallas_ipm.py:783",
    "ipm_kkt_fused": "nmpc_nav_control_tpu/ops/pallas_ipm.py:909",
}

# Compiled specialisations: config name -> its header in csrc/.  The tric
# model's shape and patterns equal diff's, so "diff" serves both.
_CUDA_HEADERS = {"diff": "config_diff.cuh", "dense72": "config_dense72.cuh",
                 "omni4": "config_omni4.cuh"}


def dense_sparsity(nx: int, nu: int):
    """All-nonzero pattern (the safe default for arbitrary QP data)."""
    return (tuple(tuple(True for _ in range(nx)) for _ in range(nx)),
            tuple(tuple(True for _ in range(nu)) for _ in range(nx)))


def pack_sparse(x, sp):
    """[..., n, m] -> [..., nnz] keeping only the structural nonzeros."""
    m = len(sp[0])
    idx = [i * m + j for i, j in nz_positions(sp)]
    return x.reshape(x.shape[:-2] + (-1,))[..., idx]


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Static shape of the sweeps: dims, bounded indices, A/B patterns."""

    nx: int
    nu: int
    idxbx: tuple
    idxbu: tuple
    asp: tuple
    bsp: tuple

    @property
    def nbx(self) -> int:
        return len(self.idxbx)

    @property
    def nbu(self) -> int:
        return len(self.idxbu)

    @property
    def nnzA(self) -> int:
        return len(nz_positions(self.asp))

    @property
    def nnzB(self) -> int:
        return len(nz_positions(self.bsp))

    @functools.cached_property
    def cuda_config(self) -> str:
        """Name of the compiled specialisation for this shape; raises if none."""
        key = (self.nx, self.nu, self.idxbx, self.idxbu, self.asp, self.bsp)
        for name, header in _CUDA_HEADERS.items():
            if _build.header_config(header) == key:
                return name
        raise NotImplementedError(
            f"no CUDA specialisation for nx={self.nx} nu={self.nu} "
            f"idxbx={self.idxbx} idxbu={self.idxbu} with this A/B pattern; "
            "add a csrc/config_*.cuh header and instantiate it")

    @functools.cached_property
    def key(self) -> str:
        """This config as the string an op takes; ``from_key`` reads it."""
        return json.dumps([self.nx, self.nu, list(self.idxbx), list(self.idxbu),
                           [[int(v) for v in row] for row in self.asp],
                           [[int(v) for v in row] for row in self.bsp]], separators=(",", ":"))

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def from_key(key: str) -> "SweepConfig":
        nx, nu, idxbx, idxbu, asp, bsp = json.loads(key)
        return SweepConfig(nx, nu, tuple(idxbx), tuple(idxbu),
                           *(tuple(tuple(bool(v) for v in row) for row in sp) for sp in (asp, bsp)))


class BwdFusedOut(NamedTuple):
    K: torch.Tensor        # [N, nu*nx, B] row-major gain
    L: torch.Tensor        # [N, nu(nu+1)/2, B] Cholesky of Quu, lower row-major
    Pc: torch.Tensor       # [N, nx, B] P_{k+1} r_dyn_k
    rdyn: torch.Tensor     # [N, nx, B] A dx + B du + c - dx_next
    kff: torch.Tensor      # [N, nu, B] affine feed-forward
    rp: tuple              # 4 x [N, nb, B] primal residuals gap - s
    musum: torch.Tensor    # [B] sum of s*lam over all constraints


class FwdAffineOut(NamedTuple):
    corr: tuple            # 4 x [N, nb, B] products ds_aff * dl_aff
    alpha: torch.Tensor    # [B] fraction-to-boundary step
    c12: torch.Tensor      # [2, B]: mu_aff = (musum + a c1 + a^2 c2) / n_con


class FwdCorrOut(NamedTuple):
    ddx: torch.Tensor      # [N, nx, B] state deltas, rows 0..N-1
    ddu: torch.Tensor      # [N, nu, B]
    ddx_N: torch.Tensor    # [nx, B] terminal state delta
    ds: tuple              # 4 x [N, nb, B]
    dl: tuple              # 4 x [N, nb, B]
    alpha: torch.Tensor    # [B]
    finite: torch.Tensor   # [B] 1.0 where every delta is finite


class KKTOut(NamedTuple):
    kkt: torch.Tensor      # [B] inf-norm of the u-stationarity residual
    musum: torch.Tensor    # [B]


# --------------------------------------------------------------------------- #
# Plain torch algebra (batch-first per stage: [rows, B, e])
# --------------------------------------------------------------------------- #


def _bf(x):
    """[rows, e, B] -> [rows, B, e] view."""
    return x.mT


class _Sparse(NamedTuple):
    """A stage matrix, dense [..., n, m] with zeros off the pattern, and its
    structural-nonzero mask [n, m]."""
    M: torch.Tensor
    nz: torch.Tensor

    @property
    def mT(self):
        return _Sparse(self.M.mT, self.nz.mT)

    def __getitem__(self, k):
        return _Sparse(self.M[k], self.nz)


def _dense(packed, sp):
    """Packed [N, nnz, B] -> _Sparse of [N, B, n, m]."""
    n, m = len(sp), len(sp[0])
    N, _, B = packed.shape
    dev = packed.device
    out = packed.new_zeros((N, n * m, B))
    out.index_copy_(1, index_tensor(tuple(i * m + j for i, j in nz_positions(sp)), dev), packed)
    return _Sparse(_bf(out).reshape(N, B, n, m), mask_tensor(sp, dev))


def _mm(a, b):
    """a @ b, either factor dense or a _Sparse: a structural zero's term is
    left out of the sum, not added as 0 * x, so a NaN or Inf multiplied by a
    structural zero stays out of the result, as in the kernels (the Pallas
    kernels' ``_dot`` and the CUDA kernels skip these terms)."""
    if not isinstance(a, _Sparse) and not isinstance(b, _Sparse):
        return a @ b
    am, bm = (x.M if isinstance(x, _Sparse) else x for x in (a, b))
    t = am.unsqueeze(-1) * bm.unsqueeze(-3)                   # [..., i, m, j]
    if isinstance(a, _Sparse):
        t = torch.where(a.nz[:, :, None], t, 0.0)
    if isinstance(b, _Sparse):
        t = torch.where(b.nz[None], t, 0.0)
    return t.sum(-2)


def _chol(Q):
    """Cholesky factor of [..., n, n] (lower triangle read), entry by entry
    as the kernels compute it: IEEE sqrt of a non-positive or NaN pivot
    gives NaN there, and the NaN reaches exactly the entries that use it."""
    n = Q.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            t = Q[..., i, j]
            for m in range(j):
                t = t - L[i][m] * L[j][m]
            L[i][j] = torch.sqrt(t) if i == j else t / L[j][j]
    zero = torch.zeros_like(Q[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero for j in range(n)], -1)
                        for i in range(n)], -2)


def _chol_solve(rhs, L):
    """(L L')^{-1} rhs for rhs [..., n, c], by the kernels' two substitutions
    (LAPACK's skips terms whose right-hand side is zero, which would hide a
    NaN in L)."""
    n = L.shape[-1]
    y = [None] * n
    for i in range(n):
        t = rhs[..., i, :]
        for m in range(i):
            t = t - L[..., i, m, None] * y[m]
        y[i] = t / L[..., i, i, None]
    x = [None] * n
    for i in reversed(range(n)):
        t = y[i]
        for m in range(i + 1, n):
            t = t - L[..., m, i, None] * x[m]
        x[i] = t / L[..., i, i, None]
    return torch.stack(x, -2)


def _lower_to_sym(M):
    """Symmetric matrix from the lower triangle of M (the carry stores only
    the lower triangle)."""
    return torch.tril(M) + torch.tril(M, -1).mT


def _grads(cfg, Qd, qx, dx, Rd, qu, du, le):
    """Stationarity gradients at consumption rows (batch-first):
    gx_{k+1} = Qd dx + qx + sel'(le_xu - le_xl), gu_k = Rd du + qu +
    sel'(le_uu - le_ul)."""
    ibx, ibu = sel(cfg.idxbx, dx.device), sel(cfg.idxbu, dx.device)
    gx = Qd[1:] * dx[1:] + qx[1:]
    gx[..., ibx] = gx[..., ibx] + (le[1] - le[0])
    gu = Rd * du + qu
    gu[..., ibu] = gu[..., ibu] + (le[3] - le[2])
    return gx, gu


def _col(x):
    return x.unsqueeze(-1)


def _vector_bwd(Ad, Bd, K, L, Pc, gx, gu):
    """Backward vector recursion with the diagonal-free carry:
    tmp = p + gx + Pc, qu_bar = gu + B' tmp, kff = -(L L')^-1 qu_bar,
    p <- A' tmp + K' qu_bar.  Operands [N, B, ...]; returns kff [N, B, nu]."""
    AT, BT, KT = Ad.mT, Bd.mT, K.mT
    gx, gu, Pc = _col(gx), _col(gu), _col(Pc)
    p = torch.zeros_like(gx[0])
    sol = [None] * gu.shape[0]
    for k in reversed(range(gu.shape[0])):
        tmp = p + gx[k] + Pc[k]
        qub = gu[k] + _mm(BT[k], tmp)
        sol[k] = _chol_solve(qub, L[k])
        p = _mm(AT[k], tmp) + KT[k] @ qub
    return -torch.stack(sol).squeeze(-1)


def _tril(nu, device):
    """(rows, columns) of the lower triangle, row-major, on ``device``."""
    rc = [(i, j) for i in range(nu) for j in range(i + 1)]
    return (index_tensor(tuple(i for i, _ in rc), device),
            index_tensor(tuple(j for _, j in rc), device))


def _unpack_L(L, nu):
    """[N, ntri, B] lower row-major -> [N, B, nu, nu]."""
    N, _, B = L.shape
    out = L.new_zeros((N, B, nu, nu))
    r, c = _tril(nu, L.device)
    out[:, :, r, c] = _bf(L)
    return out


def _pack_L(L):
    """[N, B, nu, nu] -> [N, ntri, B] lower row-major."""
    r, c = _tril(L.shape[-1], L.device)
    return L[:, :, r, c].transpose(1, 2).contiguous()


def _sum_sl(s, lam):
    """Per-lane sum of s*lam over the four [N, B, nb] groups -> [B]."""
    return sum((si * li).sum((0, 2)) for si, li in zip(s, lam))


def _to_bm(x):
    """[rows, B, e] -> contiguous [rows, e, B]."""
    return x.mT.contiguous()


def bwd_fused_plain(cfg, A, Bm, Qd, Rd, qx, qu, c, dx, du, s, lam, bnd, *,
                    reg, d_cap) -> BwdFusedOut:
    """Plain version of ``ipm_bwd_fused`` (same arguments and outputs)."""
    ibx, ibu = sel(cfg.idxbx, A.device), sel(cfg.idxbu, A.device)
    Ad, Bd = _dense(A, cfg.asp), _dense(Bm, cfg.bsp)
    Qd, Rd, qx, qu, c, dx, du = map(_bf, (Qd, Rd, qx, qu, c, dx, du))
    s, lam, bnd = [tuple(map(_bf, g)) for g in (s, lam, bnd)]
    lbx, ubx, lbu, ubu = bnd
    zx, zu = dx[1:][..., ibx], du[..., ibu]
    rp = (zx - lbx - s[0], ubx - zx - s[1], zu - lbu - s[2], ubu - zu - s[3])
    musum = _sum_sl(s, lam)

    # Barrier diagonals on the consumed rows: state cost of stage k+1,
    # input cost of stage k.
    Dx = torch.clamp(lam[0] / s[0] + lam[1] / s[1], max=d_cap)
    Du = torch.clamp(lam[2] / s[2] + lam[3] / s[3], max=d_cap)
    qbar = Qd[1:].clone()
    qbar[..., ibx] = qbar[..., ibx] + Dx
    rbar = Rd + reg
    rbar[..., ibu] = rbar[..., ibu] + Du

    rdyn = c - dx[1:] + _mm(Ad, _col(dx[:-1])).squeeze(-1) + _mm(Bd, _col(du)).squeeze(-1)
    le = tuple(-(l_ / s_) * r_ for l_, s_, r_ in zip(lam, s, rp))
    gx, gu = _grads(cfg, Qd, qx, dx, Rd, qu, du, le)

    # Riccati factorization; P_core excludes the stage diagonal, which is
    # added where it is consumed.
    N = c.shape[0]
    AT, BT = Ad.mT, Bd.mT
    Qdiag, Rdiag, r_col = torch.diag_embed(qbar), torch.diag_embed(rbar), _col(rdyn)
    P_core = torch.zeros_like(Ad.M[0])
    Ks, Ls, Pcs = [None] * N, [None] * N, [None] * N
    for k in reversed(range(N)):
        P = P_core + Qdiag[k]
        Pcs[k] = P @ r_col[k]
        PA = _mm(P, Ad[k])
        Qux = _mm(BT[k], PA)
        Ls[k] = _chol(_mm(BT[k], _mm(P, Bd[k])) + Rdiag[k])
        Ks[k] = -_chol_solve(Qux, Ls[k])
        P_core = _lower_to_sym(_mm(AT[k], PA) + Qux.mT @ Ks[k])
    K, L, Pc = torch.stack(Ks), torch.stack(Ls), torch.stack(Pcs).squeeze(-1)
    kff = _vector_bwd(Ad, Bd, K, L, Pc, gx, gu)
    return BwdFusedOut(
        K=K.reshape(N, -1, cfg.nu * cfg.nx).transpose(1, 2).contiguous(),
        L=_pack_L(L), Pc=_to_bm(Pc), rdyn=_to_bm(rdyn), kff=_to_bm(kff),
        rp=tuple(map(_to_bm, rp)), musum=musum)


def _rollout(Ad, Bd, K, kff, rdyn, r_init):
    """du_k = K dx_k + kff_k, dx_{k+1} = A dx + B du + r_dyn from r_init.
    Returns dxs [N+1, B, nx], dus [N, B, nu]."""
    kff, rdyn = _col(kff), _col(rdyn)
    dx = _col(r_init)
    dxs, dus = [dx], []
    for k in range(kff.shape[0]):
        du = kff[k] + K[k] @ dx
        dx = rdyn[k] + _mm(Ad[k], dx) + _mm(Bd[k], du)
        dxs.append(dx)
        dus.append(du)
    return torch.stack(dxs).squeeze(-1), torch.stack(dus).squeeze(-1)


def _fwd_plain(cfg, A, Bm, K, kff, rdyn, r_init, s, lam, rp, corr, sigma_mu,
               tau, mode):
    ibx, ibu = sel(cfg.idxbx, A.device), sel(cfg.idxbu, A.device)
    N = kff.shape[0]
    Ad, Bd = _dense(A, cfg.asp), _dense(Bm, cfg.bsp)
    Kd = _bf(K).reshape(N, -1, cfg.nu, cfg.nx)
    dxs, dus = _rollout(Ad, Bd, Kd, _bf(kff), _bf(rdyn), r_init.transpose(0, 1))
    s, lam, rp = [tuple(map(_bf, g)) for g in (s, lam, rp)]
    dz = (dxs[1:][..., ibx], dxs[1:][..., ibx], dus[..., ibu], dus[..., ibu])
    if mode == "corr":
        sm = sigma_mu[:, None]
        le = [(sm - _bf(c_)) / s_ - (l_ / s_) * r_
              for s_, l_, r_, c_ in zip(s, lam, rp, corr)]
    else:
        le = [-(l_ / s_) * r_ for s_, l_, r_ in zip(s, lam, rp)]
    ds, dl = [], []
    for sign, s_, l_, r_, le_, dz_ in zip((1, -1, 1, -1), s, lam, rp, le, dz):
        ds.append(r_ + sign * dz_)
        dl.append(-sign * (l_ / s_) * dz_ + le_ - l_)

    def ratio_min(v, dv):
        neg = dv < 0
        r = torch.where(neg, -v / torch.where(neg, dv, -1.0), _BIG)
        return r.amin((0, 2))

    m = torch.full_like(r_init[0], _BIG)
    for v, dv in zip(s + lam, ds + dl):
        m = torch.minimum(m, ratio_min(v, dv))
    alpha = torch.clamp(tau * m, max=1.0)
    if mode == "affine":
        c1 = sum((s_ * dl_ + l_ * ds_).sum((0, 2)) for s_, l_, ds_, dl_ in zip(s, lam, ds, dl))
        c2 = sum((ds_ * dl_).sum((0, 2)) for ds_, dl_ in zip(ds, dl))
        return FwdAffineOut(corr=tuple(_to_bm(a * b) for a, b in zip(ds, dl)),
                            alpha=alpha, c12=torch.stack([c1, c2]))
    finite = torch.isfinite(dus).all(-1).all(0) & torch.isfinite(dxs[1:]).all(-1).all(0)
    for t in ds + dl:
        finite = finite & torch.isfinite(t).all(-1).all(0)
    return FwdCorrOut(ddx=_to_bm(dxs[:-1]), ddu=_to_bm(dus),
                      ddx_N=dxs[-1].transpose(0, 1).contiguous(),
                      ds=tuple(map(_to_bm, ds)), dl=tuple(map(_to_bm, dl)),
                      alpha=alpha, finite=finite.to(alpha.dtype))


def fwd_affine_plain(cfg, A, Bm, K, kff, rdyn, r_init, s, lam, rp, *,
                     tau) -> FwdAffineOut:
    """Plain version of ``ipm_fwd_affine``."""
    return _fwd_plain(cfg, A, Bm, K, kff, rdyn, r_init, s, lam, rp, None, None,
                      tau, "affine")


def fwd_corr_plain(cfg, A, Bm, K, kff, rdyn, r_init, s, lam, rp, corr,
                   sigma_mu, *, tau) -> FwdCorrOut:
    """Plain version of ``ipm_fwd_corr``."""
    return _fwd_plain(cfg, A, Bm, K, kff, rdyn, r_init, s, lam, rp, corr,
                      sigma_mu, tau, "corr")


def bwd_corr_plain(cfg, A, Bm, K, L, Pc, Qd, qx, dx, Rd, qu, du, s, lam, rp,
                   corr, sigma_mu):
    """Plain version of ``ipm_bwd_corr``; returns kff_c [N, nu, B]."""
    N = K.shape[0]
    Ad, Bd = _dense(A, cfg.asp), _dense(Bm, cfg.bsp)
    Kd = _bf(K).reshape(N, -1, cfg.nu, cfg.nx)
    sm = sigma_mu[:, None]
    le = tuple((sm - _bf(c_)) / _bf(s_) - (_bf(l_) / _bf(s_)) * _bf(r_)
               for s_, l_, r_, c_ in zip(s, lam, rp, corr))
    gx, gu = _grads(cfg, *map(_bf, (Qd, qx, dx, Rd, qu, du)), le)
    kff = _vector_bwd(Ad, Bd, Kd, _unpack_L(L, cfg.nu), _bf(Pc), gx, gu)
    return _to_bm(kff)


def kkt_fused_plain(cfg, A, Bm, Qd, qx, dx, Rd, qu, du, lam, s) -> KKTOut:
    """Plain version of ``ipm_kkt_fused``: costate recursion
    nu_{k+1} = gx_{k+1} + A_{k+1}' nu_{k+2}, ru_k = gu_k + B_k' nu_{k+1}."""
    Ad, Bd = _dense(A, cfg.asp), _dense(Bm, cfg.bsp)
    lam_b = tuple(map(_bf, lam))
    gx, gu = _grads(cfg, *map(_bf, (Qd, qx, dx, Rd, qu, du)), lam_b)
    N = gu.shape[0]
    AT, gx = Ad.mT, _col(gx)
    c = torch.zeros_like(gx[0])
    nus = [None] * N
    for k in reversed(range(N)):
        nus[k] = gx[k] + c
        c = _mm(AT[k], nus[k])
    ru = gu + _mm(Bd.mT, torch.stack(nus)).squeeze(-1)
    return KKTOut(kkt=ru.abs().amax((0, 2)),
                  musum=_sum_sl(tuple(map(_bf, s)), lam_b))




# --------------------------------------------------------------------------- #
# The ops: nmpc_tpu::<kernel>, the kernel on CUDA tensors, the plain version
# on CPU tensors, output shapes for a tracer
# --------------------------------------------------------------------------- #

_GROUPED = frozenset({"rp", "corr", "ds", "dl"})   # fields that are 4 bound groups


def _group_shapes(cfg, N, B, prefix):
    return [(f"{prefix}_{g}", (N, n, B))
            for g, n in zip(("xl", "xu", "ul", "uu"), (cfg.nbx, cfg.nbx, cfg.nbu, cfg.nbu))]


def _fwd_inputs(cfg, N, B):
    nx, nu = cfg.nx, cfg.nu
    return ([("A", (N, cfg.nnzA, B)), ("Bm", (N, cfg.nnzB, B)), ("K", (N, nu * nx, B)),
             ("kff", (N, nu, B)), ("rdyn", (N, nx, B)), ("r_init", (nx, B))]
            + _group_shapes(cfg, N, B, "s") + _group_shapes(cfg, N, B, "lam")
            + _group_shapes(cfg, N, B, "rp"))


def _shapes(named):
    return [shape for _, shape in named]


# Each kernel's operands, in the order of its argument struct in
# csrc/ipm_fused.cu: io(cfg, ins) -> (N, B, [(name, shape)] of the inputs,
# [shape] of the outputs).
def _bwd_fused_io(cfg, ins):
    N, nx, B = ins[6].shape                                    # c
    nu = cfg.nu
    inputs = ([("A", (N, cfg.nnzA, B)), ("Bm", (N, cfg.nnzB, B)), ("Qd", (N + 1, nx, B)),
               ("Rd", (N, nu, B)), ("qx", (N + 1, nx, B)), ("qu", (N, nu, B)),
               ("c", (N, nx, B)), ("dx", (N + 1, nx, B)), ("du", (N, nu, B))]
              + _group_shapes(cfg, N, B, "s") + _group_shapes(cfg, N, B, "lam")
              + _group_shapes(cfg, N, B, "bnd"))
    outputs = [(N, nu * nx, B), (N, nu * (nu + 1) // 2, B), (N, nx, B), (N, nx, B),
               (N, nu, B), *_shapes(_group_shapes(cfg, N, B, "rp")), (B,)]
    return N, B, inputs, outputs


def _fwd_affine_io(cfg, ins):
    N, _, B = ins[4].shape                                     # rdyn
    return N, B, _fwd_inputs(cfg, N, B), [*_shapes(_group_shapes(cfg, N, B, "corr")), (B,),
                                          (2, B)]


def _bwd_corr_io(cfg, ins):
    N, _, B = ins[2].shape                                     # K
    nx, nu = cfg.nx, cfg.nu
    inputs = ([("A", (N, cfg.nnzA, B)), ("Bm", (N, cfg.nnzB, B)), ("K", (N, nu * nx, B)),
               ("L", (N, nu * (nu + 1) // 2, B)), ("Pc", (N, nx, B)), ("Qd", (N + 1, nx, B)),
               ("qx", (N + 1, nx, B)), ("dx", (N + 1, nx, B)), ("Rd", (N, nu, B)),
               ("qu", (N, nu, B)), ("du", (N, nu, B))]
              + _group_shapes(cfg, N, B, "s") + _group_shapes(cfg, N, B, "lam")
              + _group_shapes(cfg, N, B, "rp") + _group_shapes(cfg, N, B, "corr")
              + [("sigma_mu", (B,))])
    return N, B, inputs, [(N, nu, B)]


def _fwd_corr_io(cfg, ins):
    N, nx, B = ins[4].shape                                    # rdyn
    inputs = (_fwd_inputs(cfg, N, B) + _group_shapes(cfg, N, B, "corr")
              + [("sigma_mu", (B,))])
    groups = _shapes(_group_shapes(cfg, N, B, "d"))
    return N, B, inputs, [(N, nx, B), (N, cfg.nu, B), (nx, B), *groups, *groups, (B,), (B,)]


def _kkt_io(cfg, ins):
    N, nu, B = ins[7].shape                                    # du
    nx = cfg.nx
    inputs = ([("A", (N, cfg.nnzA, B)), ("Bm", (N, cfg.nnzB, B)), ("Qd", (N + 1, nx, B)),
               ("qx", (N + 1, nx, B)), ("dx", (N + 1, nx, B)), ("Rd", (N, nu, B)),
               ("qu", (N, nu, B)), ("du", (N, nu, B))]
              + _group_shapes(cfg, N, B, "lam") + _group_shapes(cfg, N, B, "s"))
    return N, B, inputs, [(B,), (B,)]


def _args(ins, head, n_groups):
    """A flat operand list back to a plain version's arguments: ``head``
    tensors, ``n_groups`` 4-tuples, then the rest."""
    end = head + 4 * n_groups
    return [*ins[:head], *(tuple(ins[i:i + 4]) for i in range(head, end, 4)), *ins[end:]]


def _flat(out):
    """A sweep's result (a tensor or an output NamedTuple) as a flat list."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for f in out for t in (f if isinstance(f, tuple) else (f,))]


def _nest(cls, flat):
    """``_flat``'s inverse for an output NamedTuple."""
    it = iter(flat)
    return cls(*(tuple(next(it) for _ in range(4)) if f in _GROUPED else next(it)
                 for f in cls._fields))


def _define(name, io, plain):
    """``ops._build.define_op`` for a sweep, whose key is its
    ``SweepConfig``; ``plain(cfg, ins, f0, f1)`` runs the plain version on a
    flat operand list."""
    def op_io(key, ins):
        cfg = SweepConfig.from_key(key)
        return (*io(cfg, ins), lambda: cfg.cuda_config)

    return _build.define_op(name, op_io, lambda key, ins, f0, f1:
                            _flat(plain(SweepConfig.from_key(key), ins, f0, f1)))


OPS = {
    "ipm_bwd_fused": _define("ipm_bwd_fused", _bwd_fused_io, lambda cfg, ins, f0, f1:
                             bwd_fused_plain(cfg, *_args(ins, 9, 3), reg=f0, d_cap=f1)),
    "ipm_fwd_affine": _define("ipm_fwd_affine", _fwd_affine_io, lambda cfg, ins, f0, f1:
                              fwd_affine_plain(cfg, *_args(ins, 6, 3), tau=f0)),
    "ipm_bwd_corr": _define("ipm_bwd_corr", _bwd_corr_io, lambda cfg, ins, f0, f1:
                            bwd_corr_plain(cfg, *_args(ins, 11, 4))),
    "ipm_fwd_corr": _define("ipm_fwd_corr", _fwd_corr_io, lambda cfg, ins, f0, f1:
                            fwd_corr_plain(cfg, *_args(ins, 6, 4), tau=f0)),
    "ipm_kkt_fused": _define("ipm_kkt_fused", _kkt_io, lambda cfg, ins, f0, f1:
                             kkt_fused_plain(cfg, *_args(ins, 8, 2))),
}


# --------------------------------------------------------------------------- #
# Wrappers: the op (kernel on CUDA, plain version on the CPU), or the plain
# version itself
# --------------------------------------------------------------------------- #


def ipm_bwd_fused(cfg: SweepConfig, A, Bm, Qd, Rd, qx, qu, c, dx, du, s, lam,
                  bnd, *, reg: float, d_cap: float, impl: str = "kernel") -> BwdFusedOut:
    """Fused backward sweep (replaces ``pallas_ipm.ipm_bwd_fused``).

    A [N,nnzA,B], Bm [N,nnzB,B], Qd/qx [N+1,nx,B], Rd/qu [N,nu,B],
    c [N,nx,B], dx [N+1,nx,B], du [N,nu,B]; s, lam: 4-tuples of slacks and
    multipliers; bnd: (lbx, ubx, lbu, ubu), each [N, nb, B].
    """
    ins = (A, Bm, Qd, Rd, qx, qu, c, dx, du, *s, *lam, *bnd)
    if not _build.use_op(ins, impl):
        return bwd_fused_plain(cfg, A, Bm, Qd, Rd, qx, qu, c, dx, du, s, lam,
                               bnd, reg=reg, d_cap=d_cap)
    return _nest(BwdFusedOut, OPS["ipm_bwd_fused"](cfg.key, ins, reg, d_cap))


def ipm_fwd_affine(cfg: SweepConfig, A, Bm, K, kff, rdyn, r_init, s, lam, rp,
                   *, tau: float, impl: str = "kernel") -> FwdAffineOut:
    """Affine forward sweep (replaces ``pallas_ipm.ipm_fwd_affine``).

    K [N,nu*nx,B], kff [N,nu,B], rdyn [N,nx,B], r_init [nx,B] = dx0 - dx[0].
    """
    ins = (A, Bm, K, kff, rdyn, r_init, *s, *lam, *rp)
    if not _build.use_op(ins, impl):
        return fwd_affine_plain(cfg, A, Bm, K, kff, rdyn, r_init, s, lam, rp, tau=tau)
    return _nest(FwdAffineOut, OPS["ipm_fwd_affine"](cfg.key, ins, tau, 0.0))


def ipm_bwd_corr(cfg: SweepConfig, A, Bm, K, L, Pc, Qd, qx, dx, Rd, qu, du,
                 s, lam, rp, corr, sigma_mu, *, impl: str = "kernel"):
    """Corrector backward sweep (replaces ``pallas_ipm.ipm_bwd_corr``);
    sigma_mu [B].  Returns kff_c [N, nu, B]."""
    ins = (A, Bm, K, L, Pc, Qd, qx, dx, Rd, qu, du, *s, *lam, *rp, *corr, sigma_mu)
    if not _build.use_op(ins, impl):
        return bwd_corr_plain(cfg, A, Bm, K, L, Pc, Qd, qx, dx, Rd, qu, du,
                              s, lam, rp, corr, sigma_mu)
    return OPS["ipm_bwd_corr"](cfg.key, ins, 0.0, 0.0)[0]


def ipm_fwd_corr(cfg: SweepConfig, A, Bm, K, kff, rdyn, r_init, s, lam, rp,
                 corr, sigma_mu, *, tau: float, impl: str = "kernel") -> FwdCorrOut:
    """Corrector forward sweep (replaces ``pallas_ipm.ipm_fwd_corr``)."""
    ins = (A, Bm, K, kff, rdyn, r_init, *s, *lam, *rp, *corr, sigma_mu)
    if not _build.use_op(ins, impl):
        return fwd_corr_plain(cfg, A, Bm, K, kff, rdyn, r_init, s, lam, rp,
                              corr, sigma_mu, tau=tau)
    return _nest(FwdCorrOut, OPS["ipm_fwd_corr"](cfg.key, ins, tau, 0.0))


def ipm_kkt_fused(cfg: SweepConfig, A, Bm, Qd, qx, dx, Rd, qu, du, lam,
                  s, *, impl: str = "kernel") -> KKTOut:
    """Post-solve KKT sweep (replaces ``pallas_ipm.ipm_kkt_fused``)."""
    ins = (A, Bm, Qd, qx, dx, Rd, qu, du, *lam, *s)
    if not _build.use_op(ins, impl):
        return kkt_fused_plain(cfg, A, Bm, Qd, qx, dx, Rd, qu, du, lam, s)
    return _nest(KKTOut, OPS["ipm_kkt_fused"](cfg.key, ins, 0.0, 0.0))
