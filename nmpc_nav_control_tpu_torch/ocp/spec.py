"""OCP specification: static dimensions + numeric data.

Port of ``nmpc_nav_control_tpu/ocp/spec.py``.  ``OCPDims`` is static and
hashable; ``OCPData`` holds tensors, each either unbatched or with a leading
batch axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from nmpc_nav_control_tpu_torch.models.base import ModelSpec

__all__ = ["OCPDims", "OCPData"]


@dataclasses.dataclass(frozen=True)
class OCPDims:
    """Static OCP dimensions: model, horizon length, sample time."""

    model: ModelSpec
    N: int
    dt: float

    @staticmethod
    def from_freq(model: ModelSpec, tf_ini: float = 2.0, freq: int = 40) -> "OCPDims":
        """N = ceil(tf_ini / dt) as in the reference (``scripts/*/common.py:5-10``)."""
        dt = 1.0 / float(freq)
        return OCPDims(model=model, N=int(math.ceil(tf_ini / dt)), dt=dt)


class OCPData(NamedTuple):
    """Per-problem numeric OCP data ([..] or [B, ..] per leaf).

    p [npar], lbx/ubx [nbx] (stages 1..N), lbu/ubu [nbu] (stages 0..N-1),
    q_diag [nx], r_diag [nu], qe_diag [nx] (terminal).
    """

    p: torch.Tensor
    lbx: torch.Tensor
    ubx: torch.Tensor
    lbu: torch.Tensor
    ubu: torch.Tensor
    q_diag: torch.Tensor
    r_diag: torch.Tensor
    qe_diag: torch.Tensor
