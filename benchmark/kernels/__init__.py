"""The port's kernels: one module each, found by the harness by file name.

A module gives ``PATTERN`` (a regular expression on the kernel's name in the
profiler's trace) and ``entries(d, N, B)`` / ``flops(d, N, B)``: what one
launch at horizon N over B lanes must read and write (each input entry it
reads once, each output once) and compute, from the shapes of its operands
(``d``: ``Dims``), whatever kernel implements it.  The launch's precision,
the cell's, sets the rest: an entry is 4 bytes in float32 and 8 in float64,
and the least time a launch needs is the larger of its bytes over the card's
bandwidth and its flops over the card's rate in that precision (NVIDIA H100
SXM data sheet, at its 700 W limit: 67 TFLOP/s float32 and 34 TFLOP/s
float64, both outside the tensor cores).
"""
from __future__ import annotations

import dataclasses
import importlib
import pkgutil
import re

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}


@dataclasses.dataclass(frozen=True)
class Dims:
    nx: int
    nu: int
    nbx: int
    nbu: int
    nnzA: int     # structural nonzeros of a stage's A = dF/dx and B = dF/du
    nnzB: int

    @property
    def groups(self) -> int:
        """Entries of one stage's four bound groups (lower and upper, x and u)."""
        return 2 * (self.nbx + self.nbu)


def dims(robot) -> Dims:
    """A robot's kernel shapes; the nonzeros from the reference model's
    Jacobians at a few random points."""
    from benchmark.reference.controller import linearize

    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 5, robot.nx, generator=g, dtype=torch.float64)
    u = torch.randn(1, 4, robot.nu, generator=g, dtype=torch.float64)
    A, Bm, _ = linearize(robot, x, u)
    return Dims(robot.nx, robot.nu, robot.nu, robot.nu,
                int((A[0] != 0).any(0).sum()), int((Bm[0] != 0).any(0).sum()))


def load_all() -> dict:
    """{name: module} of every kernel module here."""
    return {m.name: importlib.import_module(f"{__name__}.{m.name}")
            for m in pkgutil.iter_modules(__path__) if not m.name.startswith("_")}


def which(kernels: dict, op_name: str):
    """The name of the kernel module whose pattern matches, or None."""
    return next((n for n, k in kernels.items() if re.search(k.PATTERN, op_name)), None)


def moved_bytes(kernel, d: Dims, N: int, B: int, dtype=torch.float32) -> int:
    """The bytes one launch reads and writes in ``dtype``."""
    return dtype.itemsize * kernel.entries(d, N, B)


def least_seconds(kernel, d: Dims, N: int, B: int, dtype=torch.float32) -> float:
    return max(moved_bytes(kernel, d, N, B, dtype) / PEAK_BYTES_PER_S,
               kernel.flops(d, N, B) / PEAK_FLOPS_PER_S[dtype])


def vec_bwd(d: Dims) -> int:
    """Flops of a stage's vector backward recursion (shared by two sweeps)."""
    a, b = d.nnzA, d.nnzB
    return 2 * (a + b) + 4 * d.nu * d.nx + 2 * d.nu * d.nu + 3 * d.nx
