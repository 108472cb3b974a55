"""The box-IPM on a (data, stage) mesh: lanes on one axis, the horizon on the other.

Port of ``nmpc_nav_control_tpu/parallel/mesh2d.py``.  The scenario batch
splits over the ``data`` axis in contiguous blocks of lanes
(``sharding.lane_blocks``); the horizon splits over the ``stage`` axis in
contiguous blocks of ceil(N/s) stages (the last may be shorter;
``qp.parallel_riccati.stage_blocks``).  Each Newton step runs through the
associative-scan LQR (``qp/parallel_riccati.py::plqr_solve``) with its
stage blocks on the row's stage devices: a local scan inside each block, the
block totals carried across the devices, then a fix-up of each block, which
is what XLA inserts for a sharded ``associative_scan``.

The data device of a row is its first device (stage index 0).  The N+1
cost rows (``Qd``, ``qx``) and ``dx0`` stay there, as the JAX package keeps
them data-only; so do the iterate and the IPM's stagewise algebra, which is
elementwise over stages, and with them its reductions over stages (mu, the
step lengths, per-lane finiteness).  Only the scans, the log-depth part
whose depth the stage axis exists to cut, go to the stage devices, with the
per-stage leaves' blocks (A, B, c, Rd, qu and the barrier-modified costs)
as their elements.

Use when a horizon is too long for one serial sweep, e.g. N=512 look-ahead
studies; for N <= 80 control the 1-D data split and the fused kernels are
faster per solve.  The result equals ``solve_box_qp(...,
stage_parallel=True)`` on the same lanes to rounding (the scans' trees
differ).
"""
from __future__ import annotations

from nmpc_nav_control_tpu_torch.parallel.sharding import Mesh, Sharded, lane_blocks
from nmpc_nav_control_tpu_torch.qp.ipm import BoxQP, solve_box_qp_serial

__all__ = ["solve_box_qp_2d", "qp_2d_shardings"]


def qp_2d_shardings(mesh: Mesh, data_axis: str = "data", stage_axis: str = "stage") -> BoxQP:
    """The axes each leaf of a batched BoxQP splits over: [B, N, ...]
    leaves (data, stage); the [B, N+1, ...] cost leaves and ``dx0`` data
    only."""
    for axis in (data_axis, stage_axis):
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} lack {axis!r}")
    ds, d_only = (data_axis, stage_axis), (data_axis,)
    return BoxQP(A=ds, B=ds, c=ds, Qd=d_only, qx=d_only, Rd=ds, qu=ds, dx0=d_only,
                 lbx=ds, ubx=ds, lbu=ds, ubu=ds)


def solve_box_qp_2d(qp: BoxQP, idxbx, idxbu, mesh: Mesh, iters: int = 8,
                    data_axis: str = "data", stage_axis: str = "stage", **kw) -> Sharded:
    """Solve a batched BoxQP (leaves [B, ...]) with the lanes split over
    ``data_axis`` and the horizon over ``stage_axis`` of ``mesh``.

    Equal to ``solve_box_qp(qp, ..., stage_parallel=True)`` to rounding.
    Returns the ``IPMSolution`` as a ``Sharded`` over the data devices
    (``.gather()`` for one tensor a leaf).
    """
    qp_2d_shardings(mesh, data_axis, stage_axis)
    grid = mesh.devices.transpose(mesh.axis_names.index(data_axis),
                                  mesh.axis_names.index(stage_axis))
    rows, blocks, start = [], [], 0
    for row, n in zip(grid, lane_blocks(qp.Qd.shape[0], grid.shape[0])):
        if not n:
            continue
        home = row[0]
        lanes = BoxQP(*(x[start:start + n].to(home) for x in qp))
        blocks.append(solve_box_qp_serial(lanes, idxbx, idxbu, iters=iters, stage_parallel=True,
                                          stage_devices=list(row), **kw))
        rows.append(home)
        start += n
    return Sharded(mesh, data_axis, rows, blocks)
