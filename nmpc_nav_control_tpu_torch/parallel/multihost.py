"""Multi-process fleet scaling: process launch, global meshes, host-local I/O.

Port of ``nmpc_nav_control_tpu/parallel/multihost.py`` onto
``torch.distributed``:

  - every process runs the same program and calls ``init_distributed``
    (arguments, or torch's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
    ``RANK`` as ``torchrun`` sets them, where the JAX package reads its
    ``JAX_*`` variables); with nothing configured it does nothing;
  - ``global_data_mesh`` builds a ``data`` mesh over every process's
    devices, process-major, so each process's lanes live on its own
    devices;
  - ``local_to_global`` / ``global_to_local`` move this process's robots
    onto and off its own devices.  The data-parallel tick needs no
    collective, so per-tick ingest and egress stay local to the process.

The backend is NCCL for processes whose devices are cards (``device``
"cuda", the default) and gloo for CPU processes (``device="cpu"``).  If
NCCL fails to start, ``init_distributed`` raises: it never falls back to
gloo.  Typical loop, the same script in every process::

    init_distributed()
    mesh = global_data_mesh()
    fleet = Fleet(groups, mesh=mesh)       # group.batch: this process's lanes
    while running:
        meas = ingest_local_robots(local_batch(global_batch))
        outs = fleet.tick({"diff": local_to_global(mesh, meas)})
        publish(global_to_local(outs["diff"]))
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from nmpc_nav_control_tpu_torch.parallel.sharding import (
    Mesh,
    Sharded,
    shard_leading_axis,
    tree_map,
)

__all__ = [
    "init_distributed",
    "global_data_mesh",
    "local_batch",
    "local_to_global",
    "global_to_local",
]


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _local_card(rank: int) -> int:
    """This process's card: ``LOCAL_RANK`` (``torchrun``), else the rank
    modulo the visible cards."""
    local = os.environ.get("LOCAL_RANK")
    return int(local) if local is not None else rank % torch.cuda.device_count()


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device="cuda") -> None:
    """Join the process group (idempotent).

    ``coordinator_address`` "host:port" (default ``MASTER_ADDR``:
    ``MASTER_PORT``), ``num_processes`` (``WORLD_SIZE``), ``process_id``
    (``RANK``).  Nothing configured: a single-process run, nothing to do.
    ``device`` "cuda": NCCL, this process on its card (``LOCAL_RANK``, else
    the rank modulo the cards), raising without a card; "cpu": gloo.
    """
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("init_distributed needs the coordinator address, the number of "
                         "processes and this process's id, as arguments or MASTER_ADDR, "
                         "WORLD_SIZE and RANK")
    kw = dict(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
              rank=int(process_id))
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device for the NCCL backend")
        card = torch.device("cuda", _local_card(int(process_id)))
        torch.cuda.set_device(card)
        dist.init_process_group("nccl", device_id=card, **kw)
    else:
        dist.init_process_group("gloo", **kw)


def global_data_mesh(axis_name: str = "data", devices=None) -> Mesh:
    """1-D mesh over every process's devices, process-major.

    ``devices``: this process's devices (default: its card in a
    multi-process run, every visible card in a single process).  The
    processes' device lists are exchanged once (``all_gather_object``).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("global_data_mesh found no CUDA device: pass the devices")
        devices = ([torch.device("cuda", _local_card(dist.get_rank()))] if _world() > 1 else
                   [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    local = [str(torch.device(d)) for d in devices]
    every = [local]
    if _world() > 1:
        every = [None] * _world()
        dist.all_gather_object(every, local)
    flat = [d for names in every for d in names]
    procs = [p for p, names in enumerate(every) for _ in names]
    arr = np.empty(len(flat), dtype=object)
    arr[:] = flat
    return Mesh(arr, (axis_name,), np.asarray(procs))


def local_batch(global_batch: int) -> int:
    """This process's share of a scenario batch split over ``data``."""
    n = _world()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def local_to_global(mesh: Mesh, tree, axis_name: str = "data") -> Sharded:
    """This process's lanes (numpy or tensors, leading axis the lanes) onto
    its own devices along ``axis_name``: host to local device only."""
    return shard_leading_axis(tree, mesh, axis_name)


def global_to_local(tree):
    """This process's lanes of a ``Sharded`` (or a dict of them) as
    numpy, blocks in mesh order."""
    if isinstance(tree, Sharded):
        return tree_map(lambda x: x.detach().cpu().numpy(), tree.gather("cpu"))
    if isinstance(tree, dict):
        return {k: global_to_local(v) for k, v in tree.items()}
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)
