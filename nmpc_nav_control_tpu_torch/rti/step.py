"""Real-Time Iteration (RTI) SQP step, batched.

Port of ``nmpc_nav_control_tpu/rti/step.py``.  One call runs, for every
scenario lane of a batch:

  1. pin x0 at stage 0;
  2. build yref with the theta-unwrap chain seeded at the robot heading and
     the tail padded with the last valid pose;
  3. the diff-only adaptive terminal weight: where the last two pose refs
     are identical, the pose entries of W_e are scaled by 100 (per lane);
  4. one Gauss-Newton linearize -> box-QP -> expand iteration, warm-started
     from the previous solution (``RTIState``);
  5. u0, the integrated reference entries, and the stage-1 carry.

Every tensor has a leading batch axis [B, ...] in the JAX package's layout.
The linearization writes the IPM's batch-minor operands directly, so the
[B, N, nx, nx] Jacobians never exist.  Which IPM runs follows
``NMPC_TPU_TILED_IPM``, read once per call (``qp.ipm.tiled_ipm_ok``), as in
the JAX package: "1", the default, packs A/B to their structural nonzeros
for the fused sweeps (``qp/ipm_batched.py``); otherwise the dense branch
packs them with the dense pattern, row-major, which is the layout of the
Riccati-based solve (``qp/ipm.py::solve_box_qp_serial``).  That one
reading goes to ``solve_box_qp``, so the pattern and the solve cannot
disagree.  The JAX package's dense branch linearizes with ``jacfwd``; the
complex step here gives the same Jacobians to rounding for these analytic
models.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from nmpc_nav_control_tpu_torch.ocp.spec import OCPData, OCPDims
from nmpc_nav_control_tpu_torch.ops.ipm_fused import dense_sparsity
from nmpc_nav_control_tpu_torch.ops.linearize_packed import linearize_packed
from nmpc_nav_control_tpu_torch.qp.ipm import BoxQP, solve_box_qp, tiled_ipm_ok
from nmpc_nav_control_tpu_torch.tick_types import RTIState
from nmpc_nav_control_tpu_torch.utils import telemetry
from nmpc_nav_control_tpu_torch.utils.angles import unwrap_angle
from nmpc_nav_control_tpu_torch.utils.index import sel

__all__ = ["RTIConfig", "RTIState", "RTIStats", "build_yref", "rti_init",
           "rti_reset", "rti_step"]


@dataclasses.dataclass(frozen=True)
class RTIConfig:
    """Static RTI solver configuration.

    ``spars``: (A_pattern, B_pattern) structural-nonzero masks of the stage
    Jacobians (``ocp.sparsity.detect_jacobian_sparsity``); None = dense.
    """

    dims: OCPDims
    ipm_iters: int = 8
    adaptive_terminal_weight: bool = False  # the diff-only x100 pose-weight hack
    adaptive_terminal_scale: float = 100.0
    ipm_reg: float = 1e-8
    spars: tuple | None = None


class RTIStats(NamedTuple):
    kkt_res: torch.Tensor   # [B] inf-norm stationarity residual
    mu: torch.Tensor        # [B] final IPM complementarity
    ok: torch.Tensor        # [B] bool: solution finite


def rti_init(dims: OCPDims, batch: int, dtype=torch.float32, device="cuda") -> RTIState:
    """Fresh solver state for ``batch`` lanes (zeros), on the card unless
    ``device`` says otherwise."""
    m = dims.model

    def zeros(*shape):
        return torch.zeros((batch,) + shape, dtype=dtype, device=device)

    return RTIState(xs=zeros(dims.N + 1, m.nx), us=zeros(dims.N, m.nu), x0_carry=zeros(m.nx))


def rti_reset(state: RTIState) -> RTIState:
    """Zero the primal trajectory, keep the carried initial state."""
    return RTIState(xs=torch.zeros_like(state.xs), us=torch.zeros_like(state.us),
                    x0_carry=state.x0_carry)


def build_yref(N: int, robot_theta, traj_xy_theta, n_valid):
    """Unwrap-and-pad reference build.

    robot_theta [B] seeds the unwrap chain; traj_xy_theta [B, N+1, 3] holds
    candidate poses of which the first n_valid [B] rows are valid.  Returns
    [B, N+1, 3] with the theta chain unwrapped and the tail padded with the
    last valid (unwrapped) pose.
    """
    prev = robot_theta
    last = torch.zeros_like(traj_xy_theta[:, 0])
    rows = []
    for i in range(N + 1):
        pose_i = traj_xy_theta[:, i]
        theta_u = unwrap_angle(pose_i[:, 2], prev)
        pose = torch.where((i < n_valid)[:, None],
                           torch.stack([pose_i[:, 0], pose_i[:, 1], theta_u], -1), last)
        prev, last = pose[:, 2], pose
        rows.append(pose)
    return torch.stack(rows, 1)


def _batched(data: OCPData, B: int) -> OCPData:
    """Broadcast unbatched [..] leaves to [B, ..]."""
    return OCPData(*(x if x.ndim == 2 else x.expand(B, -1) for x in data))


def rti_step(config: RTIConfig, data: OCPData, state: RTIState, x0, traj_xy_theta,
             n_valid):
    """One warm-started RTI solve for a batch of lanes.

    x0 [B, nx] is the pinned initial state (composed by the control layer);
    traj_xy_theta [B, N+1, 3] the reference poses, n_valid [B] the number of
    valid rows.  Returns (new_state, u0 [B, nu], stats).  With tracing on
    the QP solve is marked ``qp.start`` and ``qp.end``
    (``utils/telemetry.py``).
    """
    dims = config.dims
    model = dims.model
    N, dt = dims.N, dims.dt
    nx, nu = model.nx, model.nu
    B = x0.shape[0]
    ibx, ibu = sel(model.idxbx, x0.device), sel(model.idxbu, x0.device)
    data = _batched(data, B)

    yref = build_yref(N, x0[:, 2], traj_xy_theta, n_valid)

    q, qe = data.q_diag, data.qe_diag
    if config.adaptive_terminal_weight:
        same = (yref[:, N] == yref[:, N - 1]).all(-1)
        scale = torch.where(same, config.adaptive_terminal_scale, 1.0).to(q.dtype)
        qe = torch.cat([scale[:, None] * q[:, :3], qe[:, 3:]], -1)

    # Linearization point: stage 0 is the pinned x0.
    xs_lin = torch.cat([x0[:, None], state.xs[:, 1:]], 1)

    # Gauss-Newton cost blocks (diagonal W; yref nonzero only in the pose).
    Qd = torch.cat([q[:, None].expand(B, N, nx), qe[:, None]], 1)
    Rd = data.r_diag[:, None].expand(B, N, nu)
    x_res = torch.cat([xs_lin[..., :3] - yref, xs_lin[..., 3:]], -1)
    qx = Qd * x_res
    qu = Rd * state.us

    # Box bounds in delta form.
    zx, zu = xs_lin[:, 1:, ibx], state.us[:, :, ibu]
    lbx_d, ubx_d = data.lbx[:, None] - zx, data.ubx[:, None] - zx
    lbu_d, ubu_d = data.lbu[:, None] - zu, data.ubu[:, None] - zu

    tiled = tiled_ipm_ok()
    spars = config.spars if tiled and config.spars is not None else dense_sparsity(nx, nu)
    A, Bm, x_next = linearize_packed(model.f, dt, xs_lin, state.us, data.p, *spars)
    c = x_next - xs_lin[:, 1:].permute(1, 2, 0)
    qp = BoxQP(A=None, B=None, c=None, Qd=Qd, qx=qx, Rd=Rd, qu=qu,
               dx0=x0 - xs_lin[:, 0], lbx=lbx_d, ubx=ubx_d, lbu=lbu_d, ubu=ubu_d)
    telemetry.mark("qp.start", x0)
    sol = solve_box_qp(qp, model.idxbx, model.idxbu, iters=config.ipm_iters,
                       reg=config.ipm_reg, spars=spars, packed_abc=(A, Bm, c), tiled=tiled)
    telemetry.mark("qp.end", x0)

    # Expand, integrate the references, carry stage 1.
    xs_new = xs_lin + sol.dxs
    us_new = state.us + sol.dus
    u0 = us_new[:, 0]
    x0_carry = xs_new[:, 1].clone()
    x0_carry[:, ibx] = x0[:, ibx] + u0 * dt

    ok = torch.isfinite(sol.kkt_res) & torch.isfinite(u0).all(-1)
    stats = RTIStats(kkt_res=sol.kkt_res, mu=sol.mu, ok=ok)
    return RTIState(xs=xs_new, us=us_new, x0_carry=x0_carry), u0, stats
