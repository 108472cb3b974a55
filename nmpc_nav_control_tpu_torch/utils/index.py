"""Index selections that a captured tick can replay.

Indexing a tensor with a Python list builds an index tensor on the host and
copies it to the device on every call: a hidden host step in an eager tick,
and a copy that a CUDA graph cannot capture (``control/graph.py``).
``sel`` gives a slice where the indices are one contiguous run (every
bounded index set of the diff, omni4 and tric models is one) and otherwise
an index tensor; ``index_tensor`` makes each index tensor once per
(indices, device) and keeps it, so only a tick's first, uncaptured call
(a graph's warm-up) makes it.

``kept`` is that cache.  It keeps only real tensors: under a tracer
(``torch.export``'s fake mode, functionalization) a factory call returns a
tensor of the tracer's, which would poison every later eager tick if it
were kept; the tracer gets a fresh one each time, and export lifts it into
the program as a constant.
"""
from __future__ import annotations

import torch

__all__ = ["index_tensor", "kept", "mask_tensor", "nz_positions", "sel", "static_index"]

_kept: dict = {}


def kept(key, make) -> torch.Tensor:
    """The tensor kept under ``key``, made by ``make()`` at first use; a
    tensor made under a tracing mode (any subclass of ``torch.Tensor``) is
    returned and not kept.  Callers must not write to it."""
    t = _kept.get(key)
    if t is None:
        t = make()
        if type(t) is torch.Tensor:
            _kept[key] = t
    return t


def static_index(idx) -> tuple:
    """A model's index set (``idxbx``, ``idxbu``) as a tuple of Python ints."""
    return tuple(int(i) for i in idx)


def nz_positions(sp):
    """Row-major list of (i, j) structural nonzeros of a pattern."""
    return [(i, j) for i, row in enumerate(sp) for j, nz in enumerate(row) if nz]


def sel(idx, device):
    """Subscript for the entries ``idx`` of an axis: a slice for a
    contiguous ascending run, else the cached index tensor on ``device``."""
    idx = static_index(idx)
    if idx and idx == tuple(range(idx[0], idx[0] + len(idx))):
        return slice(idx[0], idx[0] + len(idx))
    return index_tensor(idx, device)


def index_tensor(idx: tuple, device) -> torch.Tensor:
    """``idx`` as an int64 tensor on ``device``, made once."""
    return kept(("index", idx, device),
                lambda: torch.tensor(idx, dtype=torch.long, device=device))


def mask_tensor(mask: tuple, device) -> torch.Tensor:
    """A nested tuple of bools as a bool tensor on ``device``, made once."""
    return kept(("mask", mask, device),
                lambda: torch.tensor(mask, dtype=torch.bool, device=device))
