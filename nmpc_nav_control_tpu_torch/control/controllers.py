"""Per-geometry NMPC controllers, batched.

Port of ``nmpc_nav_control_tpu/control/controllers.py`` for the diff,
omni4 and tric geometries: a static ``ControllerSpec`` + an ``OCPData`` of
tensors + the shared ``rti_step``.  A tick composes the solver's initial
state from the measurements and the carried reference entries, runs one RTI
solve, and maps the integrated references to a robot command, for every
lane of a batch.  Tensors are made on the card unless ``device`` says
otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from nmpc_nav_control_tpu_torch.models import diff, omni4, tric
from nmpc_nav_control_tpu_torch.ocp.sparsity import detect_jacobian_sparsity
from nmpc_nav_control_tpu_torch.ocp.spec import OCPData, OCPDims
from nmpc_nav_control_tpu_torch.rti.step import (
    RTIConfig,
    RTIState,
    rti_init,
    rti_reset,
    rti_step,
)
from nmpc_nav_control_tpu_torch.tick_types import CmdVel
from nmpc_nav_control_tpu_torch.utils import telemetry
from nmpc_nav_control_tpu_torch.utils.index import sel

__all__ = [
    "CmdVel",
    "ControllerSpec",
    "make_controller",
    "controller_init",
    "controller_reset",
    "controller_step",
]


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
    l1_plus_l2: float | None = None,
    dist_d: float | None = None,
    tau_v: float = 0.1,
    tau_a: float = 0.5,
    v_max: float = 1.0,
    a_max: float = 1.0,
    alpha_min: float | None = None,
    alpha_max: float | None = None,
    dalpha_max: float | None = None,
    q_diag: Sequence[float] = (),
    r_diag: Sequence[float] = (),
    qn_diag: Sequence[float] | None = None,
    ipm_iters: int = 8,
    tric_bug_compat: bool = False,
    dtype=torch.float32,
    device="cuda",
) -> tuple[ControllerSpec, OCPData]:
    """Build a (static spec, numeric data) controller pair on ``device``.

    Arguments as in the JAX package (angles in radians): diff needs
    ``dist_b``, omni4 ``l1_plus_l2``, tric ``dist_d``, ``alpha_min``,
    ``alpha_max`` and ``dalpha_max``; ``tric_bug_compat`` selects the
    reference's as-generated tricycle model.  W_e defaults to the runtime Q
    diagonal, as the reference's runtime override does.
    """
    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    def need(**kw):
        for name, v in kw.items():
            if v is None:
                raise ValueError(f"the {geometry} geometry needs {name}")

    if geometry == "diff":
        need(dist_b=dist_b)
        model, p = diff.SPEC, [dist_b, tau_v]
        lbx, ubx = [-v_max] * 2, [v_max] * 2
        lbu, ubu = [-a_max] * 2, [a_max] * 2
    elif geometry == "omni4":
        need(l1_plus_l2=l1_plus_l2)
        model, p = omni4.SPEC, [l1_plus_l2, tau_v]
        lbx, ubx = [-v_max] * 4, [v_max] * 4
        lbu, ubu = [-a_max] * 4, [a_max] * 4
    elif geometry == "tric":
        need(dist_d=dist_d, alpha_min=alpha_min, alpha_max=alpha_max, dalpha_max=dalpha_max)
        model = tric.SPEC_BUG_COMPAT if tric_bug_compat else tric.SPEC
        p = [dist_d, tau_v, tau_a]
        lbx, ubx = [-v_max, alpha_min], [v_max, alpha_max]
        lbu, ubu = [-a_max, -dalpha_max], [a_max, dalpha_max]
    else:
        raise ValueError(f"unknown steering geometry: {geometry!r}")

    nx, nu = model.nx, model.nu
    q, r = t(list(q_diag)), t(list(r_diag))
    qe = q if qn_diag is None else t(list(qn_diag))
    for name, v, n in (("q_diag", q, nx), ("r_diag", r, nu), ("qn_diag", qe, nx)):
        if v.shape != (n,):
            raise ValueError(f"{name} must have {n} entries")
    p = t(p)
    spec = ControllerSpec(
        geometry=geometry,
        rti=RTIConfig(
            dims=OCPDims(model=model, N=N, dt=dt),
            ipm_iters=ipm_iters,
            adaptive_terminal_weight=geometry == "diff",   # the x100 terminal hack
            spars=detect_jacobian_sparsity(model.f, dt, nx, nu, p),
        ),
    )
    data = OCPData(p=p, lbx=t(lbx), ubx=t(ubx), lbu=t(lbu), ubu=t(ubu),
                   q_diag=q, r_diag=r, qe_diag=qe)
    return spec, data


def controller_init(spec: ControllerSpec, batch: int, dtype=torch.float32,
                    device="cuda") -> RTIState:
    return rti_init(spec.dims, batch, dtype, device)


def controller_reset(state: RTIState) -> RTIState:
    """New goal/path received: reset solver memory, keep integrated refs."""
    return rti_reset(state)


def _compose_x0(spec: ControllerSpec, data: OCPData, state: RTIState, pose, vel,
                steer_angle):
    """Solver initial state [B, nx]: the measured entries + the carried
    reference entries.  diff measures (x, y, theta, vl, vr), omni4 (x, y,
    theta, v1..v4), tric (x, y, theta, v, alpha) with alpha the steering
    angle."""
    g = spec.geometry
    carry = state.x0_carry
    if g == "diff":
        wheels = diff.direct_kinematics(vel[:, 0], vel[:, 2], data.p[..., diff.P_DIST_B])
    elif g == "omni4":
        wheels = omni4.direct_kinematics(vel[:, 0], vel[:, 1], vel[:, 2],
                                         data.p[..., omni4.P_L1_PLUS_L2])
    else:
        wheels = (vel[:, 0], steer_angle)
    meas = [v.to(carry.dtype) for v in (pose[:, 0], pose[:, 1], pose[:, 2], *wheels)]
    return torch.cat([torch.stack(meas, -1), carry[:, len(meas):]], -1)


def _cmd_of(spec: ControllerSpec, data: OCPData, refs) -> CmdVel:
    g = spec.geometry
    zero = torch.zeros_like(refs[:, 0])
    if g == "diff":
        v, w = diff.inverse_kinematics(refs[:, 0], refs[:, 1], data.p[..., diff.P_DIST_B])
        return CmdVel(v=v, vn=zero, w=w)
    if g == "omni4":
        v, vn, w = omni4.inverse_kinematics(*refs.unbind(-1), data.p[..., omni4.P_L1_PLUS_L2])
        return CmdVel(v=v, vn=vn, w=w)
    return CmdVel(v=refs[:, 0], vn=zero, w=refs[:, 1])


def controller_step(spec: ControllerSpec, data: OCPData, state: RTIState, pose, vel,
                    traj_xy_theta, n_valid, steer_angle=None):
    """One controller tick for every lane.

    pose [B, 3] (x, y, theta), vel [B, 3] (v, vn, w), traj_xy_theta
    [B, N+1, 3] with n_valid [B] valid rows; steer_angle [B] is the measured
    steering angle (tric only; zeros when None).  Returns (new_state,
    CmdVel, RTIStats).  With tracing on it marks ``ctl.start`` and
    ``ctl.end`` (``utils/telemetry.py``).
    """
    telemetry.mark("ctl.start", pose)
    if steer_angle is None:
        steer_angle = torch.zeros_like(state.x0_carry[:, 0])
    x0 = _compose_x0(spec, data, state, pose, vel, steer_angle)
    new_state, u0, stats = rti_step(spec.rti, data, state, x0, traj_xy_theta, n_valid)
    refs = x0[:, sel(spec.dims.model.idxbx, x0.device)] + u0 * spec.dims.dt
    cmd = _cmd_of(spec, data, refs)
    telemetry.mark("ctl.end", pose)
    return new_state, cmd, stats
