"""Fleet runner: batched mixed-geometry scenario sweeps, optionally on a mesh.

Port of ``nmpc_nav_control_tpu/parallel/fleet.py``.  The reference controls
one robot per process; the fleet drives thousands of (robot, path, initial
pose) scenarios at once, BASELINE.json's fifth configuration (a batched
4096-scenario mixed-geometry sweep).  Geometries differ in state and input
sizes, so a mixed fleet runs one batched ``node_tick`` per geometry, the
groups one after another in a tick.

A group is one geometry's batch of lanes:
  - without a mesh, on the card, one ``control.GraphedNavigator`` (the
    tick captured in a CUDA graph, the port's ``jax.jit``); on the CPU an
    eager batched ``node_tick``;
  - with a mesh, one navigator for each of this process's devices along
    the ``data`` axis, over its contiguous block of lanes
    (``sharding.lane_blocks``: any lane count, ragged splits too).  A tick
    replays them one device after another, each on its device's current
    stream, and returns the outputs as a ``sharding.Sharded``.

States live in the navigators' static buffers: ``set_states`` copies into
them (``load_state``), never rebinds them.  Outputs on the card are the
navigators' static buffers too, overwritten by the next tick: clone what
you keep.  In a multi-process run (``torch.distributed``) a group's
``batch`` is this process's lanes, and host inputs enter through
``multihost.local_to_global``, as the JAX package's ``_shard_in`` does.

With tracing on (``utils/telemetry.py``) a tick is a ``fleet.tick`` span
holding one ``fleet.group`` span a group.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict

import torch

from nmpc_nav_control_tpu_torch.control.controllers import ControllerSpec
from nmpc_nav_control_tpu_torch.control.graph import GraphedNavigator, _copy_into
from nmpc_nav_control_tpu_torch.control.state_machine import (
    Measurements,
    NavConfig,
    NodeState,
    node_init,
    node_tick,
)
from nmpc_nav_control_tpu_torch.ocp.spec import OCPData
from nmpc_nav_control_tpu_torch.parallel.sharding import Sharded, lane_blocks, leaves, tree_map
from nmpc_nav_control_tpu_torch.utils import telemetry

__all__ = ["Fleet", "FleetGroup"]


@dataclasses.dataclass
class FleetGroup:
    """One geometry's scenario batch; ``data`` on the device it runs on
    (the card unless made elsewhere)."""

    spec: ControllerSpec
    data: OCPData
    cfg: NavConfig
    batch: int

    def init_states(self, dtype=torch.float32, device=None) -> NodeState:
        """``batch`` idle nodes on ``device`` (default ``data``'s)."""
        device = self.data.p.device if device is None else device
        return node_init(self.spec, self.cfg, self.batch, dtype, device)


class _EagerNavigator:
    """``GraphedNavigator``'s interface over an eager ``node_tick``, for a
    group on the CPU."""

    def __init__(self, spec, data, cfg, batch):
        self.spec, self.data, self.cfg = spec, data, cfg
        self.state = node_init(spec, cfg, batch, data.p.dtype, data.p.device)

    def load_state(self, state: NodeState) -> None:
        with telemetry.span("nav.load_state"):
            _copy_into(self.state, state)

    def step(self, meas: Measurements):
        self.state, out = node_tick(self.spec, self.data, self.cfg, self.state,
                                    tree_map(lambda x: x.to(self.data.p.device), meas))
        return self.state, out


def _navigator(spec, data, cfg, batch):
    cls = GraphedNavigator if data.p.device.type == "cuda" else _EagerNavigator
    return cls(spec, data, cfg, batch)


class Fleet:
    """Mixed-geometry fleet of batched navigation nodes on an optional mesh."""

    def __init__(self, groups: Dict[str, FleetGroup], mesh=None, dtype=torch.float32):
        self.groups = groups
        self.mesh = mesh
        self.dtype = dtype
        self.navigators: Dict[str, list] = {}
        for name, g in groups.items():
            devices = [g.data.p.device] if mesh is None else mesh.local_devices("data")
            self.navigators[name] = [
                _navigator(g.spec, OCPData(*(t.to(dev, dtype) for t in g.data)), g.cfg, n)
                for dev, n in zip(devices, lane_blocks(g.batch, len(devices))) if n]

    def _shard_in(self, tree) -> list:
        """A tree of this process's lanes as one block per navigator."""
        if self.mesh is None:
            return [tree]
        if not isinstance(tree, Sharded):
            from nmpc_nav_control_tpu_torch.parallel.multihost import local_to_global

            tree = local_to_global(self.mesh, tree)
        return [b for b in tree.blocks if leaves(b)[0].shape[0]]

    def _shard_out(self, navs, blocks):
        if self.mesh is None:
            return blocks[0]
        return Sharded(self.mesh, "data", [n.data.p.device for n in navs], blocks)

    @property
    def states(self) -> Dict[str, NodeState]:
        """Each group's state (a ``Sharded`` on a mesh), static buffers."""
        return {name: self._shard_out(navs, [n.state for n in navs])
                for name, navs in self.navigators.items()}

    def set_states(self, name: str, states: NodeState) -> None:
        """Copy a group's state batch into its navigators (e.g. after
        batched goal or path events, ``on_goal_pose`` / ``on_path_set``)."""
        for nav, block in zip(self.navigators[name], self._shard_in(states)):
            nav.load_state(block)

    def tick(self, measurements: Dict[str, Measurements]) -> dict:
        """Advance every group one control cycle: {name: TickOutput}."""
        outs = {}
        with telemetry.span("fleet.tick"):
            for name, meas in measurements.items():
                with telemetry.span("fleet.group", group=name):
                    navs, blocks = self.navigators[name], []
                    for nav, block in zip(navs, self._shard_in(meas)):
                        device = nav.data.p.device
                        on_card = device.type == "cuda"
                        with torch.cuda.device(device) if on_card else contextlib.nullcontext():
                            blocks.append(nav.step(block)[1])
                    outs[name] = self._shard_out(navs, blocks)
        return outs

    @property
    def total_scenarios(self) -> int:
        return sum(g.batch for g in self.groups.values())

