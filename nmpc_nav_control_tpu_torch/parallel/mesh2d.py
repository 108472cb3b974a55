"""The box-IPM on a (data, stage) mesh: lanes on one axis, the horizon on the other.

Port of ``nmpc_nav_control_tpu/parallel/mesh2d.py``.  The scenario batch
splits over the ``data`` axis in contiguous blocks of lanes
(``sharding.lane_blocks``).  Each data row's lanes are solved by
``qp.ipm.solve_box_qp_blocks`` over the row's stage devices: the horizon
in contiguous blocks of ceil(N/s) stages (the last may be shorter, and
stage devices past the last non-empty block get none), each block's rows
of the QP and of the iterate, and the stagewise algebra on them, on its
stage device for the whole solve, as the JAX package's [data, stage]
shardings place them.  The scans run in two levels, as XLA partitions a
sharded ``associative_scan``; per iteration only single stage rows and
per-lane values cross devices, all through ``qp.parallel_riccati.move``.
A row's data device is its first device (stage index 0): it holds the
first stage block, reduces the blocks' partials (mu, the step lengths,
per-lane finiteness) and receives the row's solution.

Use when a horizon is too long for one device (the QP's memory a device
falls with the stage axis), e.g. N=512 look-ahead studies; for N <= 80
control the 1-D data split and the fused kernels are faster per solve.
The result equals ``solve_box_qp(..., stage_parallel=True)`` (the one-block
case) on the same lanes to rounding: the scans' trees and the reductions'
order differ.
"""
from __future__ import annotations

from nmpc_nav_control_tpu_torch.parallel.sharding import Mesh, Sharded, lane_blocks
from nmpc_nav_control_tpu_torch.qp.ipm import BoxQP, solve_box_qp_blocks

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
    ``kw``: tau, mu0, s_min, reg, mu_min, as there.  Returns the
    ``IPMSolution`` as a ``Sharded`` over the data devices (``.gather()``
    for one tensor a leaf).
    """
    qp_2d_shardings(mesh, data_axis, stage_axis)
    grid = mesh.devices.transpose(mesh.axis_names.index(data_axis),
                                  mesh.axis_names.index(stage_axis))
    rows, sols, start = [], [], 0
    for row, n in zip(grid, lane_blocks(qp.Qd.shape[0], grid.shape[0])):
        if not n:
            continue
        lanes = BoxQP(*(x[start:start + n] for x in qp))                 # views
        sols.append(solve_box_qp_blocks(lanes, idxbx, idxbu, list(row), iters=iters, **kw))
        rows.append(row[0])
        start += n
    return Sharded(mesh, data_axis, rows, sols)
