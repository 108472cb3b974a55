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
pattern and its solve follow one reading.  ``stage_parallel=True`` takes
the Riccati solve's iteration whatever the route says, as the JAX
package's does, with each Newton solve through the log-depth
associative-scan LQR (``qp/parallel_riccati.py::plqr_solve_blocks``) in
place of the factorization and the two Riccati sweeps: it launches no
kernel.  That solve (``solve_box_qp_blocks``) holds the horizon in stage
blocks, each on a device of its own; ``stage_parallel=True`` is its
one-block case, and ``parallel/mesh2d.py`` gives it a mesh row's stage
devices.  The JAX package's other conditions (a TPU, whole 1024-lane
tiles reached by edge padding) have no counterpart: every solve takes any
batch size, B=1 included, with no padding.  It also chooses, once per solve, between the CUDA kernels and
their plain versions (``kernel_impl``): f32 on the card takes the kernels,
f64 anywhere and every CPU solve the plain versions.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch

from nmpc_nav_control_tpu_torch.ops import riccati_fused as rf
from nmpc_nav_control_tpu_torch.qp.parallel_riccati import (move, plqr_solve_blocks,
                                                            stage_blocks, state_blocks)
from nmpc_nav_control_tpu_torch.utils.index import sel

__all__ = ["BoxQP", "IPMSolution", "kernel_impl", "solve_box_qp", "solve_box_qp_blocks",
           "solve_box_qp_serial", "tiled_ipm_ok"]


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


def kernel_impl(dtype, device) -> str:
    """The kernels or their plain versions for a solve, on either route:
    "kernel" for f32 on a CUDA device, "plain" otherwise, on the tensors'
    own device.  The rule mirrors the JAX package's, which admits only f32
    to its Pallas kernels (``ops/pallas_riccati.py::supported``) and sends
    f64 to XLA on any device; no kernel takes f64.  Chosen once per solve."""
    if dtype == torch.float32 and torch.device(device).type == "cuda":
        return "kernel"
    return "plain"


def solve_box_qp(qp: BoxQP, idxbx, idxbu, iters: int = 12, tau: float = 0.995,
                 mu0: float = 1.0, s_min: float = 0.3, reg: float = 1e-8,
                 mu_min: float | None = None, spars=None, packed_abc=None,
                 tiled: bool | None = None, stage_parallel: bool = False) -> IPMSolution:
    """Solve a batch of stagewise box QPs (leaves [B, ...]).

    ``tiled``: the route, True for the fused sweeps and False for the
    Riccati solve; None reads it from ``tiled_ipm_ok()``.  ``spars``:
    optional (A_pattern, B_pattern) structural-nonzero masks that
    over-approximate the nonzeros of qp.A / qp.B, used by the fused sweeps;
    None means dense.  The Riccati solve ignores it.  ``packed_abc``:
    optional batch-minor (A, Bm, c) already packed for the route (to
    ``spars`` for the fused sweeps, dense for the Riccati solve); ``qp.A/B/c``
    are then ignored.  The kernels run where ``kernel_impl`` says (f32 on
    the card), the plain versions elsewhere.  ``stage_parallel``: the
    Riccati solve's iteration with every Newton solve through the log-depth
    scans, whatever ``tiled`` says (``solve_box_qp_blocks`` on one device;
    no ``packed_abc``).  Returns an ``IPMSolution`` with leading batch axes.
    """
    if stage_parallel:
        if packed_abc is not None:
            raise ValueError("stage_parallel solves the QP's own A, B, c: no packed_abc")
        return solve_box_qp_blocks(qp, idxbx, idxbu, [qp.Qd.device], iters=iters, tau=tau,
                                   mu0=mu0, s_min=s_min, reg=reg, mu_min=mu_min)
    if tiled is None:
        tiled = tiled_ipm_ok()
    impl = kernel_impl(qp.Qd.dtype, qp.Qd.device)
    if tiled:
        from nmpc_nav_control_tpu_torch.qp.ipm_batched import solve_box_qp_batched

        return solve_box_qp_batched(qp, idxbx, idxbu, iters=iters, tau=tau, mu0=mu0,
                                    s_min=s_min, reg=reg, mu_min=mu_min, spars=spars,
                                    packed_abc=packed_abc, impl=impl)
    return solve_box_qp_serial(qp, idxbx, idxbu, iters=iters, tau=tau, mu0=mu0,
                               s_min=s_min, reg=reg, mu_min=mu_min, packed_abc=packed_abc,
                               impl=impl)


def _per_lane_finite(x):
    """[..., B] -> [B] bool: every entry of the lane finite."""
    return torch.isfinite(x).reshape(-1, x.shape[-1]).all(0)


# The stagewise algebra of one Riccati-solve iteration, on batch-minor
# [rows, e, B] tensors and [B] per-lane values.  ``xoff``: the state rows
# ahead of the first bounded one (1 where the rows start at dx_0, which has
# no bound; 0 for a stage block further on).  The stage-blocked solve
# (``solve_box_qp_blocks``) runs the same helpers on each block's rows.

def _gaps(dxs, dus, lbx, ubx, lbu, ubu, ibx, ibu, xoff=1):
    """The four bound gaps (x lower, x upper, u lower, u upper)."""
    zx, zu = dxs[xoff:, ibx], dus[:, ibu]
    return zx - lbx, ubx - zx, zu - lbu, ubu - zu


def _barrier(Qd, Rd, s, lam, ibx, ibu, reg, d_cap, xoff=1):
    """Barrier-modified diagonals (Qbar, Rbar), capped; reg is folded into
    R once and the factorization adds nothing more."""
    Qbar = Qd.clone()
    Qbar[xoff:, ibx] += torch.clamp(lam[0] / s[0] + lam[1] / s[1], max=d_cap)
    Rbar = Rd + reg
    Rbar[:, ibu] += torch.clamp(lam[2] / s[2] + lam[3] / s[3], max=d_cap)
    return Qbar, Rbar


def _grads(Qd, qx, Rd, qu, dxs, dus, ibx, ibu, w, xoff=1):
    """Cost gradients (gx, gu) plus the bound terms ``w`` = (x lower, x
    upper, u lower, u upper) of the four groups."""
    gx = Qd * dxs + qx
    gx[xoff:, ibx] += w[1] - w[0]
    gu = Rd * dus + qu
    gu[:, ibu] += w[3] - w[2]
    return gx, gu


def _newton_terms(s, lam, rp, sigma_mu=None, corr=None):
    """The bound groups' right-hand terms of a Newton solve; the affine pass
    has no corrector (None)."""
    if corr is None:
        return tuple(-(l_ / s_) * r_ for l_, s_, r_ in zip(lam, s, rp))
    return tuple((sigma_mu - c_) / s_ - (l_ / s_) * r_ for l_, s_, r_, c_ in zip(lam, s, rp, corr))


def _deltas(s, lam, rp, le, ddxs, ddus, ibx, ibu, xoff=1):
    """Slack and multiplier deltas (ds, dl) from a Newton step."""
    dzx, dzu = ddxs[xoff:, ibx], ddus[:, ibu]
    ds = (rp[0] + dzx, rp[1] - dzx, rp[2] + dzu, rp[3] - dzu)
    dl = (-(lam[0] / s[0]) * dzx + le[0] - lam[0],
          (lam[1] / s[1]) * dzx + le[1] - lam[1],
          -(lam[2] / s[2]) * dzu + le[2] - lam[2],
          (lam[3] / s[3]) * dzu + le[3] - lam[3])
    return ds, dl


def _complementarity(s, lam):
    """Per lane, the sum of s * lam over every entry of the groups: [B]."""
    return sum((s_ * l_).sum((0, 1)) for s_, l_ in zip(s, lam))


def _fraction_to_boundary(vs, dvs):
    """Per lane, the largest a keeping every v + a dv >= 0 over the groups
    (inf where no dv < 0); groups with no rows are skipped, and None comes
    back when no group has rows."""
    m = None
    for v, dv in zip(vs, dvs):
        if not v.shape[0]:
            continue
        neg = dv < 0
        r = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.inf).amin((0, 1))
        m = r if m is None else torch.minimum(m, r)
    return m


def _sigma(mu_aff, mu):
    """Mehrotra's centering parameter."""
    return torch.clamp((mu_aff / torch.clamp(mu, min=1e-16)) ** 3, 0.0, 1.0)


def solve_box_qp_serial(qp: BoxQP, idxbx, idxbu, iters: int = 12, tau: float = 0.995,
                        mu0: float = 1.0, s_min: float = 0.3, reg: float = 1e-8,
                        mu_min: float | None = None, packed_abc=None,
                        impl: str = "kernel") -> IPMSolution:
    """The Riccati-based solve of the JAX package's serial path, batched.

    ``qp`` leaves carry a leading batch axis [B, ...].  ``packed_abc``:
    optional dense (A [N, nx*nx, B], Bm [N, nx*nu, B], c [N, nx, B]) in the
    batch-minor layout (``ops.linearize_packed`` with the dense pattern
    writes exactly this); ``qp.A/B/c`` are then ignored.  Every per-stage
    tensor stays batch-minor [rows, e, B] for the whole solve, so A and B
    are transposed at most once.  ``impl`` goes to the Riccati wrappers
    (``ops.riccati_fused``).
    """
    B, Np1, nx = qp.Qd.shape
    ibx, ibu = sel(idxbx, qp.Qd.device), sel(idxbu, qp.Qd.device)
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
    n_con = 2 * N * (len(idxbx) + len(idxbu))

    def gaps(dxs, dus):
        return _gaps(dxs, dus, lbx, ubx, lbu, ubu, ibx, ibu)

    def step_len(s, lam, ds, dl):
        """Fraction-to-boundary step over all eight groups."""
        return torch.clamp(tau * _fraction_to_boundary(s + lam, ds + dl), max=1.0)

    dxs = torch.zeros((N + 1, nx, B), dtype=dtype, device=Qd.device)
    dus = torch.zeros((N, nu, B), dtype=dtype, device=Qd.device)
    s = tuple(torch.clamp(g, min=s_min) for g in gaps(dxs, dus))
    it = _Iterate(dxs, dus, *s, *(torch.clamp(mu0 / s_, min=s_min) for s_ in s))

    for _ in range(iters):
        s, lam = tuple(it[2:6]), tuple(it[6:10])
        rp = tuple(g - s_ for g, s_ in zip(gaps(it.dxs, it.dus), s))
        mu = _complementarity(s, lam) / n_con
        fac = rf.riccati_factor_fused(A, Bm, *_barrier(Qd, Rd, s, lam, ibx, ibu, reg, d_cap),
                                      impl=impl)

        r_dyn = (torch.einsum("kijb,kjb->kib", A4, it.dxs[:-1])
                 + torch.einsum("kijb,kjb->kib", B4, it.dus) + c - it.dxs[1:]).contiguous()
        r_init = dx0 - it.dxs[0]

        def newton(sigma_mu, corr):
            """One Newton solve -> (ddxs, ddus, ds, dl); the affine pass has
            sigma_mu = 0 and no corrector (None)."""
            le = _newton_terms(s, lam, rp, sigma_mu, corr)
            gx, gu = _grads(Qd, qx, Rd, qu, it.dxs, it.dus, ibx, ibu, le)
            kff = rf.riccati_solve_bwd_fused(A, Bm, fac.Ks, fac.Ls, fac.Ps, gx, gu, r_dyn,
                                             impl=impl)
            ddxs, ddus = rf.riccati_solve_fwd_fused(A, Bm, fac.Ks, kff, r_dyn, r_init,
                                                    impl=impl)
            return (ddxs, ddus) + _deltas(s, lam, rp, le, ddxs, ddus, ibx, ibu)

        # Predictor (affine) pass.
        _, _, dsa, dla = newton(None, None)
        a_aff = step_len(s, lam, dsa, dla)
        mu_aff = _complementarity(tuple(s_ + a_aff * ds_ for s_, ds_ in zip(s, dsa)),
                                  tuple(l_ + a_aff * dl_ for l_, dl_ in zip(lam, dla))) / n_con
        sigma = _sigma(mu_aff, mu)

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
        mu=_complementarity(s, lam) / n_con,
        kkt_res=_stationarity(A4, B4, Qd, qx, Rd, qu, ibx, ibu, it)[0],
    )


def _stationarity(A4, B4, Qd, qx, Rd, qu, ibx, ibu, it: _Iterate, nu_k=None, xoff=1):
    """Per-lane inf-norm of the u-stationarity residual (the ``inf_norm_res``
    analog) over these stages, costates from the x-stationarity recursion
    run backward from ``nu_k`` (None: the last state row's gradient, the
    terminal costate); batch-minor operands, A4 [N, nx, nx, B], B4 [N, nx,
    nu, B].  Returns the norm and the costate of the first stage, which
    carries the recursion into the stages before these."""
    gx, gu = _grads(Qd, qx, Rd, qu, it.dxs, it.dus, ibx, ibu, it[6:10], xoff)
    if nu_k is None:
        nu_k = gx[-1]
    rus = []
    for k in reversed(range(gu.shape[0])):
        rus.append(gu[k] + torch.einsum("ijb,ib->jb", B4[k], nu_k))
        nu_k = gx[k] + torch.einsum("ijb,ib->jb", A4[k], nu_k)
    return torch.stack(rus).abs().amax((0, 1)), nu_k


class _Block(NamedTuple):
    """A stage block's QP data on its device, batch-minor [rows, e, B]."""

    A4: torch.Tensor     # [n, nx, nx, B]
    B4: torch.Tensor     # [n, nx, nu, B]
    c: torch.Tensor      # [n, nx, B]
    Qd: torch.Tensor     # [rows, nx, B], the block's state rows
    qx: torch.Tensor
    Rd: torch.Tensor     # [n, nu, B]
    qu: torch.Tensor
    lbx: torch.Tensor    # [rows - xoff, nbx, B], the bounds on its state rows
    ubx: torch.Tensor
    lbu: torch.Tensor    # [n, nbu, B]
    ubu: torch.Tensor
    ibx: object          # the bounded entries, as subscripts on this device
    ibu: object
    xoff: int            # 1 for the first block (dx_0 has no bound), else 0


def _split(qp: BoxQP, idxbx, idxbu, devices) -> list[_Block]:
    """The QP's stage blocks, each moved once to its device."""
    B, N, nx, nu = qp.B.shape
    spans = stage_blocks(N, len(devices))
    blocks = []
    for (k0, k1), (r0, r1), dev in zip(spans, state_blocks(spans), devices):
        xoff, n = (1 if r0 == 0 else 0), k1 - k0

        def take(x, a, b, dev=dev):
            return move(x[:, a:b], dev).flatten(2).permute(1, 2, 0).contiguous()

        blocks.append(_Block(
            take(qp.A, k0, k1).view(n, nx, nx, B), take(qp.B, k0, k1).view(n, nx, nu, B),
            take(qp.c, k0, k1), take(qp.Qd, r0, r1), take(qp.qx, r0, r1), take(qp.Rd, k0, k1),
            take(qp.qu, k0, k1), take(qp.lbx, r0 + xoff - 1, r1 - 1),
            take(qp.ubx, r0 + xoff - 1, r1 - 1), take(qp.lbu, k0, k1), take(qp.ubu, k0, k1),
            sel(idxbx, dev), sel(idxbu, dev), xoff))
    return blocks


def solve_box_qp_blocks(qp: BoxQP, idxbx, idxbu, devices, iters: int = 12,
                        tau: float = 0.995, mu0: float = 1.0, s_min: float = 0.3,
                        reg: float = 1e-8, mu_min: float | None = None) -> IPMSolution:
    """The stage-parallel solve with the horizon in stage blocks, block j on
    ``devices[j]`` (the JAX package's ``stage_parallel`` serial solve).

    ``qp`` (leaves [B, ...], on any device) splits once into blocks of ceil(N / len(devices)) stages
    (``stage_blocks``; devices past the last non-empty block get none).  A
    block's rows of the QP (A, B, c, Rd, qu and the input bounds by stage;
    Qd, qx and the state bounds by state, ``state_blocks``: the bound on
    dx_k goes with dx_k), its rows of the iterate and the stagewise algebra
    on them stay on its device for the whole solve.  Each Newton step is
    ``plqr_solve_blocks`` on the blocks as they lie.  Per iteration only
    single rows and per-lane values cross devices, all through ``move``:
    r_dyn's halo (the next block's first state row), the scans' carries,
    r_init; each block's partial sums of s*lam (mu, mu_aff), step-length
    minima and finiteness flags go to ``devices[0]`` (the data device),
    which reduces them, and the [B] results (a_aff, sigma*mu, alpha, the
    frozen mask: one decision a lane) go back to every block.  ``kkt_res``
    runs its costate recursion block by block, one [B, nx] costate across
    each boundary.  Returns the ``IPMSolution`` on ``devices[0]``.  One
    device is ``solve_box_qp(..., stage_parallel=True)``.
    """
    home = devices[0]
    blocks = _split(qp, idxbx, idxbu, devices)
    mu_min_d, eps_floor, d_cap = _guards(qp.Qd.dtype)
    consts = dict(tau=tau, reg=reg, mu_min=mu_min_d if mu_min is None else mu_min,
                  eps_floor=eps_floor, d_cap=d_cap,
                  n_con=2 * qp.Rd.shape[1] * (len(idxbx) + len(idxbu)))
    dx0 = move(qp.dx0, home).mT.contiguous()                          # [nx, B]

    its = []
    for b in blocks:
        dxs = torch.zeros_like(b.Qd)
        dus = torch.zeros_like(b.Rd)
        s = tuple(torch.clamp(g, min=s_min)
                  for g in _gaps(dxs, dus, b.lbx, b.ubx, b.lbu, b.ubu, b.ibx, b.ibu, b.xoff))
        its.append(_Iterate(dxs, dus, *s, *(torch.clamp(mu0 / s_, min=s_min) for s_ in s)))
    for _ in range(iters):
        its = _iteration(blocks, its, dx0, home, **consts)

    mu = _on_home([_complementarity(it[2:6], it[6:10]) for it in its], home).sum(0)
    kkt, nu_k = [], None
    for b, it in zip(reversed(blocks), reversed(its)):
        res, nu_k = _stationarity(b.A4, b.B4, b.Qd, b.qx, b.Rd, b.qu, b.ibx, b.ibu, it,
                                  None if nu_k is None else move(nu_k, b.Qd.device), b.xoff)
        kkt.append(res)
    sol = [torch.cat([move(x, home) for x in leaf]).permute(2, 0, 1) for leaf in zip(*its)]
    return IPMSolution(sol[0], sol[1], *sol[6:10], mu=mu / consts["n_con"],
                       kkt_res=_on_home(kkt, home).amax(0))


def _on_home(parts, home):
    """Per-block [B] partials stacked on the data device: [blocks, B]."""
    return torch.stack([move(p, home) for p in parts])


def _iteration(blocks, its, dx0, home, tau, reg, mu_min, eps_floor, d_cap, n_con):
    """One Mehrotra iteration of ``solve_box_qp_blocks``, block by block:
    ``solve_box_qp_serial``'s iteration with its reductions over stages
    taken from the blocks' partials on the data device ``home``."""
    devs = [b.Qd.device for b in blocks]

    def to_blocks(v):
        return [move(v, d) for d in devs]

    def step_len(ds, dl):
        parts = [_fraction_to_boundary(it[2:10], ds_ + dl_) for it, ds_, dl_ in zip(its, ds, dl)]
        m = _on_home([p for p in parts if p is not None], home).amin(0)
        return torch.clamp(tau * m, max=1.0)

    S = [tuple(it[2:6]) for it in its]
    L = [tuple(it[6:10]) for it in its]
    rp, bars, r_dyn = [], [], []
    for j, (b, it) in enumerate(zip(blocks, its)):
        rp.append(tuple(g - s_ for g, s_ in zip(
            _gaps(it.dxs, it.dus, b.lbx, b.ubx, b.lbu, b.ubu, b.ibx, b.ibu, b.xoff), S[j])))
        bars.append(_barrier(b.Qd, b.Rd, S[j], L[j], b.ibx, b.ibu, reg, d_cap, b.xoff))
        n = b.Rd.shape[0]
        nxt = (torch.cat([it.dxs[1:], move(its[j + 1].dxs[:1], devs[j])])   # the halo row
               if j + 1 < len(blocks) else it.dxs[1:])
        r_dyn.append((torch.einsum("kijb,kjb->kib", b.A4, it.dxs[:n])
                      + torch.einsum("kijb,kjb->kib", b.B4, it.dus) + b.c - nxt).contiguous())
    mu = _on_home([_complementarity(s, l_) for s, l_ in zip(S, L)], home).sum(0) / n_con
    r_init = (dx0 - its[0].dxs[0]).mT                                # [B, nx], on home

    def newton(sigma_mu=None, corr=None):
        """One Newton solve over the blocks -> per block (ddxs, ddus, ds,
        dl); the affine pass has no corrector (None), the corrector per-block
        lists."""
        nb = len(blocks)
        sigma_mu, corr = sigma_mu or [None] * nb, corr or [None] * nb
        le = [_newton_terms(S[j], L[j], rp[j], sigma_mu[j], corr[j]) for j in range(nb)]
        elems = []
        for j, (b, it) in enumerate(zip(blocks, its)):
            gx, gu = _grads(b.Qd, b.qx, b.Rd, b.qu, it.dxs, it.dus, b.ibx, b.ibu, le[j], b.xoff)
            elems.append((b.A4.permute(3, 0, 1, 2), b.B4.permute(3, 0, 1, 2),
                          *(x.permute(2, 0, 1) for x in (*bars[j], gx, gu, r_dyn[j]))))
        out = []
        for j, (b, dx, du) in enumerate(zip(blocks, *plqr_solve_blocks(elems, r_init))):
            dx, du = dx.permute(1, 2, 0), du.permute(1, 2, 0)
            out.append((dx, du) + _deltas(S[j], L[j], rp[j], le[j], dx, du, b.ibx, b.ibu, b.xoff))
        return out

    # Predictor (affine) pass.
    aff = newton()
    a_aff = step_len([a[2] for a in aff], [a[3] for a in aff])
    a_b = to_blocks(a_aff)
    mu_aff = _on_home([_complementarity(tuple(s_ + a * ds_ for s_, ds_ in zip(S[j], aff[j][2])),
                                        tuple(l_ + a * dl_ for l_, dl_ in zip(L[j], aff[j][3])))
                       for j, a in enumerate(a_b)], home).sum(0) / n_con

    # Corrector pass, its products scaled by a_aff (as in solve_box_qp_serial).
    corr = [tuple(a * ds_ * dl_ for ds_, dl_ in zip(aff[j][2], aff[j][3]))
            for j, a in enumerate(a_b)]
    full = newton(to_blocks(_sigma(mu_aff, mu) * mu), corr)
    alpha = step_len([f[2] for f in full], [f[3] for f in full])
    new = []
    for (ddxs, ddus, ds, dl), it, a in zip(full, its, to_blocks(alpha)):
        new.append(_Iterate(it.dxs + a * ddxs, it.dus + a * ddus,
                            *(torch.clamp(v + a * d, min=eps_floor)
                              for v, d in zip(it[2:10], ds + dl))))

    # Converged lanes stop stepping; a lane whose new iterate has a
    # non-finite entry on any block keeps its last iterate on every block.
    finite = _on_home([torch.stack([_per_lane_finite(x) for x in nw]).all(0) for nw in new],
                      home).all(0)
    frozen = to_blocks((mu < mu_min) | ~finite)
    return [_Iterate(*(torch.where(f, old, upd) for old, upd in zip(it, nw)))
            for f, it, nw in zip(frozen, its, new)]
