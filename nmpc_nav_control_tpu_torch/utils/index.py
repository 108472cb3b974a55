"""Index selections that a captured tick can replay.

Indexing a tensor with a Python list builds an index tensor on the host and
copies it to the device on every call: a hidden host step in an eager tick,
and a copy that a CUDA graph cannot capture (``control/graph.py``).
``sel`` gives a slice where the indices are one contiguous run (every
bounded index set of the diff, omni4 and tric models is one) and otherwise
an index tensor; ``index_tensor`` makes each index tensor once per
(indices, device) and keeps it, so only a tick's first, uncaptured call
(a graph's warm-up) makes it.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["index_tensor", "mask_tensor", "sel", "static_index"]


def static_index(idx) -> tuple:
    """A model's index set (``idxbx``, ``idxbu``) as a tuple of Python ints."""
    return tuple(int(i) for i in idx)


def sel(idx, device):
    """Subscript for the entries ``idx`` of an axis: a slice for a
    contiguous ascending run, else the cached index tensor on ``device``."""
    idx = static_index(idx)
    if idx and idx == tuple(range(idx[0], idx[0] + len(idx))):
        return slice(idx[0], idx[0] + len(idx))
    return index_tensor(idx, device)


@functools.lru_cache(maxsize=None)
def index_tensor(idx: tuple, device) -> torch.Tensor:
    """``idx`` as an int64 tensor on ``device``, made once."""
    return torch.tensor(idx, dtype=torch.long, device=device)


@functools.lru_cache(maxsize=None)
def mask_tensor(mask: tuple, device) -> torch.Tensor:
    """A nested tuple of bools as a bool tensor on ``device``, made once."""
    return torch.tensor(mask, dtype=torch.bool, device=device)
