"""Per-layer metrics: one reader module each, found by the metric's name up
to its first dot.  ``read(ctx, suffix)`` returns the value, or None where
the traced ticks give it nothing to read (the harness then leaves the metric
out).  ``ctx`` is a ``Context``; ``suffix`` is the part after the dot
(``ticks`` for the batched cells, ``cycle`` for the robot).

Every reader of the trace takes its numbers from the one traced stretch:
device time from the profiler's device ops, host time from the harness's
``traced_window`` range on the same clock.  A reader of ``window`` takes the
run's measured window, which the profiler does not see.
"""
from __future__ import annotations

import dataclasses

import torch

from benchmark import kernels as K


@dataclasses.dataclass
class Context:
    trace: object        # benchmark.trace.Trace of the traced ticks
    ticks: int           # ticks (or cycles) traced
    groups: dict         # {"tick.<group>": (robot, lanes)}: the program's calls
    kernels: dict        # {name: kernel module}
    dims: dict           # {"tick.<group>": Dims}
    window: dict = dataclasses.field(default_factory=dict)  # the run's window numbers
    dtype: torch.dtype = torch.float32     # the cell's precision: its launches' entries and rate

    def program_ops(self):
        """Device ops launched from inside a call into the program."""
        return [op for op in self.trace.ops if op.label in self.groups]

    def kernel_of(self, op):
        return K.which(self.kernels, op.name)


def roofline(ctx: Context, only=None):
    """Percent: the least time of the port's kernel launches, in the cell's
    precision, over their device time (``only``: one kernel's launches);
    None without a launch."""
    least = spent = 0.0
    for op in ctx.program_ops():
        name = ctx.kernel_of(op)
        if name is None or (only is not None and name != only):
            continue
        robot, lanes = ctx.groups[op.label]
        least += K.least_seconds(ctx.kernels[name], ctx.dims[op.label], robot.N, lanes,
                                 ctx.dtype)
        spent += op.end - op.start
    return 100.0 * least / spent if spent > 0 else None
