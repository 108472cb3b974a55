"""Model abstraction: a torch dynamics function plus static metadata.

Port of ``nmpc_nav_control_tpu/models/base.py``.  ``f(x, u, p)`` indexes the
state, input and parameter entries along the FIRST axis and is elementwise
over any trailing axes, so one call evaluates a whole ``[nx, N, B]`` block of
stages and scenarios.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

__all__ = ["ModelSpec"]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static description of a robot dynamics model.

    Attributes:
      name:   model identifier ('diff').
      nx, nu, npar: numbers of states, inputs and parameters.
      idxbx:  state indices with box bounds at stages 1..N.
      idxbu:  input indices with box bounds at stages 0..N-1.
      f:      continuous-time dynamics ``f(x[nx, ...], u[nu, ...],
              p[npar, ...]) -> xdot[nx, ...]``.
    """

    name: str
    nx: int
    nu: int
    npar: int
    idxbx: Tuple[int, ...]
    idxbu: Tuple[int, ...]
    f: Callable = dataclasses.field(compare=False)
