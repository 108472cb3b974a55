"""Device meshes and scenario-batch sharding.

Port of ``nmpc_nav_control_tpu/parallel/sharding.py``.  Scale comes from two
axes, as there:

  - **data**: the scenario batch (robot x path x initial pose), split over
    devices; each lane is one robot;
  - **stage**: the horizon, split over devices by the two-level scans of
    ``qp/parallel_riccati.py`` (``parallel/mesh2d.py``).

Torch has no ``jax.sharding``, so the port keeps a small ``Mesh``: an array
of ``torch.device`` with axis names, plus the process that owns each
device.  ``make_mesh`` takes an explicit device list, as JAX's ``devices=``
does, and by default every visible card.  A list may name one device
several times: torch has one CPU device where JAX's tests have eight
virtual ones (``tests/conftest.py``), so the CPU tests' mesh names ``cpu``
eight times, and on a machine with one card the same goes for ``cuda:0``.

A sharded tree (``Sharded``) holds, for each of this process's devices
along the sharded axis, in mesh order, a contiguous block of lanes on that
device (``lane_blocks``: any lane count, the first blocks one lane longer
where it does not divide).  ``gather`` concatenates the blocks back into
one tree for reading.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "Sharded", "gather", "lane_blocks", "make_mesh", "replicate",
           "leaves", "shard_leading_axis", "tree_map"]


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of nested NamedTuples / tuples / dicts."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple):
        out = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t)(*out) if hasattr(t, "_fields") else type(t)(out)
    return fn(*trees)


def leaves(tree) -> list:
    """The tensor leaves of a tree, in ``tree_map`` order."""
    out = []
    tree_map(out.append, tree)
    return out


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """Devices laid out on named axes (the port's ``jax.sharding.Mesh``).

    ``devices``: a nested sequence (or object array) of devices or device
    names whose shape is the mesh's; ``process_index``: the process owning
    each device, same shape (default: all this process's).
    """

    def __init__(self, devices, axis_names: Sequence[str], process_index=None):
        arr = np.asarray(devices, dtype=object)
        self.devices = np.vectorize(torch.device, otypes=[object])(arr)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices for axes {self.axis_names}")
        self.process_index = (np.full(arr.shape, _rank()) if process_index is None
                              else np.asarray(process_index).reshape(arr.shape))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_devices(self, axis: str) -> list:
        """Along ``axis``, the devices at index 0 of every other axis, with
        the processes that own them: [(process, device), ...]."""
        i = self.axis_names.index(axis)
        devs = np.moveaxis(self.devices, i, 0).reshape(self.devices.shape[i], -1)[:, 0]
        procs = np.moveaxis(self.process_index, i, 0).reshape(self.devices.shape[i], -1)[:, 0]
        return list(zip(procs.tolist(), devs.tolist()))

    def local_devices(self, axis: str = "data") -> list:
        """This process's devices along ``axis``, in mesh order."""
        rank = _rank()
        return [d for p, d in self.axis_devices(axis) if p == rank]

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.ravel()]})"


def make_mesh(axis_sizes: Sequence[int] | None = None, axis_names: Sequence[str] = ("data",),
              devices=None) -> Mesh:
    """A mesh over ``devices`` (default: every visible card).

    ``make_mesh()``: a 1-D ("data",) mesh over all of them;
    ``make_mesh((4, 2), ("data", "stage"))``: a 2-D mesh over the first 8.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh found no CUDA device: pass the devices explicitly")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if axis_sizes is None:
        axis_sizes = (len(devices),)
    n = int(np.prod(axis_sizes))
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(tuple(axis_sizes)), axis_names)


def lane_blocks(lanes: int, n: int) -> list[int]:
    """Lanes of each of ``n`` contiguous blocks: the first ``lanes % n``
    blocks one longer (a block may be empty when lanes < n)."""
    return [lanes // n + (i < lanes % n) for i in range(n)]


@dataclasses.dataclass
class Sharded:
    """A tree split along its leading (lane) axis: ``blocks[i]`` lies on
    ``devices[i]``, this process's devices along ``axis`` of ``mesh``."""

    mesh: Mesh
    axis: str
    devices: list
    blocks: list

    def gather(self, device=None) -> Any:
        """The blocks concatenated, on ``device`` (default the first
        block's)."""
        device = self.devices[0] if device is None else device
        return tree_map(lambda *xs: torch.cat([x.to(device) for x in xs]), *self.blocks)


def gather(x, device=None):
    """``x.gather(device)`` for a ``Sharded``; any other tree as it is."""
    return x.gather(device) if isinstance(x, Sharded) else x


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def shard_leading_axis(tree, mesh: Mesh, axis: str = "data") -> Sharded:
    """Split every leaf's leading axis over this process's devices along
    ``axis`` (numpy leaves become tensors)."""
    tree = tree_map(_as_tensor, tree)
    devices = mesh.local_devices(axis)
    blocks, start = [], 0
    for dev, n in zip(devices, lane_blocks(leaves(tree)[0].shape[0], len(devices))):
        blocks.append(tree_map(lambda x, a=start, b=start + n, d=dev: x[a:b].to(d), tree))
        start += n
    return Sharded(mesh, axis, devices, blocks)


def replicate(tree, mesh: Mesh) -> list:
    """A copy of the tree on every device of the mesh, in mesh order."""
    tree = tree_map(_as_tensor, tree)
    return [tree_map(lambda x, d=d: x.to(d), tree) for d in mesh.devices.ravel()]
