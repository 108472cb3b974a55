"""The phase mark's kernel, as the op ``nmpc_tpu::trace_mark``.

``csrc/trace_mark.cu::trace_mark_kernel`` reads the card's ``%globaltimer``
and writes ``(code, ns)`` into a ring of int64 pairs on the card at its
cursor, which it advances.  ``utils/telemetry.py`` launches it at each
phase mark of a tick captured in a CUDA graph while tracing is on, and
eagerly to calibrate the card's clock against the host's; nothing else
does.  The op mutates the ring and the cursor and returns nothing; it has a
CUDA implementation only (a CPU mark takes the host clock in
``telemetry.mark``, and a traced program holds no mark).
"""
from __future__ import annotations

import torch

from nmpc_nav_control_tpu_torch.ops import _build

__all__ = ["mark"]


def _cuda(ring, cursor, code):
    entries = ring.shape[0]
    if (ring.dtype != torch.int64 or cursor.dtype != torch.int64 or ring.dim() != 2
            or ring.shape[1] != 2 or cursor.numel() != 1 or entries & (entries - 1)
            or not ring.is_contiguous()):
        raise ValueError("trace_mark: ring [2**k, 2] and cursor [1], int64 and contiguous")
    _build.launch("trace_mark", "ring", [ring, cursor], code, entries)


_build._ops.define("trace_mark(Tensor(a!) ring, Tensor(b!) cursor, int code) -> ()")
_build._ops.impl("trace_mark", _cuda, "CUDA")
torch.library.register_fake(f"{_build.NAMESPACE}::trace_mark", lambda ring, cursor, code: None,
                            lib=_build._ops)


def mark(ring, cursor, code: int) -> None:
    """Launch one mark on the current stream of the ring's card: entry
    ``(code, the card's ns)`` at the cursor."""
    torch.ops.nmpc_tpu.trace_mark(ring, cursor, code)
