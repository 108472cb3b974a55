"""Per-geometry NMPC controllers, batched.

Port of ``nmpc_nav_control_tpu/control/controllers.py`` for the diff-drive
geometry: a static ``ControllerSpec`` + an ``OCPData`` of tensors + the
shared ``rti_step``.  A tick composes the solver's initial state from the
measurements and the carried reference entries, runs one RTI solve, and maps
the integrated references to a robot command, for every lane of a batch.
The omni4 and tric geometries are not ported yet (ROADMAP.md, queue 1,
item 7).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from nmpc_nav_control_tpu_torch.models import diff
from nmpc_nav_control_tpu_torch.ocp.sparsity import detect_jacobian_sparsity
from nmpc_nav_control_tpu_torch.ocp.spec import OCPData, OCPDims
from nmpc_nav_control_tpu_torch.rti.step import (
    RTIConfig,
    RTIState,
    rti_init,
    rti_reset,
    rti_step,
)

__all__ = [
    "CmdVel",
    "ControllerSpec",
    "make_controller",
    "controller_init",
    "controller_reset",
    "controller_step",
]


class CmdVel(NamedTuple):
    """Command triple per lane; diff: (v, 0, w) from the integrated wheel refs."""

    v: torch.Tensor
    vn: torch.Tensor
    w: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ControllerSpec:
    """Static controller description (hashable)."""

    geometry: str
    rti: RTIConfig

    @property
    def dims(self) -> OCPDims:
        return self.rti.dims


def make_controller(
    geometry: str,
    dt: float,
    N: int,
    *,
    dist_b: float | None = None,
    tau_v: float = 0.1,
    v_max: float = 1.0,
    a_max: float = 1.0,
    q_diag: Sequence[float] = (),
    r_diag: Sequence[float] = (),
    qn_diag: Sequence[float] | None = None,
    ipm_iters: int = 8,
    dtype=torch.float32,
    device="cpu",
) -> tuple[ControllerSpec, OCPData]:
    """Build a (static spec, numeric data) controller pair on ``device``.

    Arguments as in the JAX package (angles in radians); W_e defaults to the
    runtime Q diagonal, as the reference's runtime override does.
    """
    if geometry in ("omni4", "tric"):
        raise NotImplementedError(
            f"the {geometry!r} geometry is not ported yet: ROADMAP.md, queue 1, "
            "item 7 (omni4 and tric)")
    if geometry != "diff":
        raise ValueError(f"unknown steering geometry: {geometry!r}")
    if dist_b is None:
        raise ValueError("the diff geometry needs dist_b")

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    model = diff.SPEC
    nx, nu = model.nx, model.nu
    q, r = t(list(q_diag)), t(list(r_diag))
    qe = q if qn_diag is None else t(list(qn_diag))
    for name, v, n in (("q_diag", q, nx), ("r_diag", r, nu), ("qn_diag", qe, nx)):
        if v.shape != (n,):
            raise ValueError(f"{name} must have {n} entries")
    p = t([dist_b, tau_v])
    spec = ControllerSpec(
        geometry=geometry,
        rti=RTIConfig(
            dims=OCPDims(model=model, N=N, dt=dt),
            ipm_iters=ipm_iters,
            adaptive_terminal_weight=True,   # the x100 terminal hack: diff only
            spars=detect_jacobian_sparsity(model.f, dt, nx, nu, p),
        ),
    )
    data = OCPData(
        p=p, lbx=t([-v_max, -v_max]), ubx=t([v_max, v_max]),
        lbu=t([-a_max, -a_max]), ubu=t([a_max, a_max]),
        q_diag=q, r_diag=r, qe_diag=qe,
    )
    return spec, data


def controller_init(spec: ControllerSpec, batch: int, dtype=torch.float32,
                    device="cpu") -> RTIState:
    return rti_init(spec.dims, batch, dtype, device)


def controller_reset(state: RTIState) -> RTIState:
    """New goal/path received: reset solver memory, keep integrated refs."""
    return rti_reset(state)


def _compose_x0(spec: ControllerSpec, data: OCPData, state: RTIState, pose, vel):
    """Solver initial state [B, nx]: measured (x, y, theta, vl, vr) + the
    carried (vl_ref, vr_ref)."""
    carry = state.x0_carry
    vl, vr = diff.direct_kinematics(vel[:, 0], vel[:, 2], data.p[..., diff.P_DIST_B])
    meas = torch.stack([pose[:, 0], pose[:, 1], pose[:, 2], vl, vr], -1)
    return torch.cat([meas.to(carry.dtype), carry[:, 5:]], -1)


def _cmd_of(spec: ControllerSpec, data: OCPData, refs) -> CmdVel:
    v, w = diff.inverse_kinematics(refs[:, 0], refs[:, 1], data.p[..., diff.P_DIST_B])
    return CmdVel(v=v, vn=torch.zeros_like(v), w=w)


def controller_step(spec: ControllerSpec, data: OCPData, state: RTIState, pose, vel,
                    traj_xy_theta, n_valid):
    """One controller tick for every lane.

    pose [B, 3] (x, y, theta), vel [B, 3] (v, vn, w), traj_xy_theta
    [B, N+1, 3] with n_valid [B] valid rows.  Returns (new_state, CmdVel,
    RTIStats).
    """
    x0 = _compose_x0(spec, data, state, pose, vel)
    new_state, u0, stats = rti_step(spec.rti, data, state, x0, traj_xy_theta, n_valid)
    refs = x0[:, list(spec.dims.model.idxbx)] + u0 * spec.dims.dt
    return new_state, _cmd_of(spec, data, refs), stats
