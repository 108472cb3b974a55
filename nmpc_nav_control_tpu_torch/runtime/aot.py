"""Ahead-of-time tick artifacts (the generated-capsule analog).

Port of ``nmpc_nav_control_tpu/runtime/aot.py``.  The reference prepares its
solvers offline and its runtime only loads the built ``.so`` capsules; the
JAX package serializes its whole jitted node tick with ``jax.export``.
Here ``torch.export`` (non-strict) traces ``control.state_machine.node_tick``
(state machine, path window, discretizer, RTI linearization and the IPM on
the route ``NMPC_TPU_TILED_IPM`` selects) into an ATen program, one per
platform, that a serving host loads and calls without the model code.  The
port's kernels are ``torch.library`` ops (``ops._build.define_op``), so the
program holds one node per kernel launch: on the card the op launches the
kernel, on the CPU it runs the plain version.

The program's signature is flat: it takes the leaves of ``NodeState`` and
``Measurements`` and returns those of the new ``NodeState`` and of the
``TickOutput``, in the order the header records (``tick_types``' field
order, depth first).  ``AotTick`` flattens and nests them, as the JAX
``AotTick`` does with pytrees; the flat signature needs no registration of
the NamedTuples with torch's serializer.

Blob: ``_MAGIC`` | u32 little-endian header length | JSON header | one
``torch.export.save`` archive per platform, in the header's order, of the
byte lengths it records.  The header names the geometry, horizon, dt,
batch, dtype, platforms, the IPM route, the torch version the program was
traced with and the hash of the kernel sources (``ops._build.source_hash``).

``batch=None`` is the single-robot tick (leaves without a lane axis, as in
the JAX package); the batched tick runs inside at B=1.  An int ``batch`` is
the fleet tick over that many lanes.  On the card the loaded tick runs as
the node's does: its first call captures the program in a CUDA graph over
static input buffers (the counterpart of XLA compiling the loaded blob at
its first call), and every call copies the inputs in and replays it.  On
the CPU the program runs as it is.

Loading imports torch, the port's ops (their registration and the kernel
build) and ``tick_types``, and nothing of ``models/``, ``rti/``, ``qp/``,
``paths/`` or ``control/``: the export side imports them inside
``export_tick``.
"""
from __future__ import annotations

import dataclasses
import io
import json
import struct
from typing import Optional

import torch

from nmpc_nav_control_tpu_torch.ops import _build
from nmpc_nav_control_tpu_torch.ops import ipm_fused, riccati_fused  # noqa: F401  (op registration)
from nmpc_nav_control_tpu_torch.tick_types import (
    CmdVel,
    Measurements,
    NodeState,
    PathSegment,
    PathWindow,
    RTIState,
    TickOutput,
)

__all__ = ["export_tick", "save_tick", "load_tick", "AotTick"]

_MAGIC = b"NMPCTAOT"
_JAX_MAGIC = b"NMPCAOT1"        # nmpc_nav_control_tpu.runtime.aot's artifacts
_FORMAT = 1
_PLATFORMS = ("cuda", "cpu")

# NamedTuple fields that nest another NamedTuple.
_NESTED = {(NodeState, "window"): PathWindow, (PathWindow, "segs"): PathSegment,
           (NodeState, "rti"): RTIState, (TickOutput, "cmd"): CmdVel}

# Eager calls of the loaded program before its capture (as control/graph.py).
_WARMUP = 2


def _leaves(tree) -> list:
    """The tensors of a NamedTuple tree, depth first in field order."""
    if isinstance(tree, tuple):
        return [t for sub in tree for t in _leaves(sub)]
    return [tree]


def _paths(cls, prefix="") -> list:
    """Leaf names of a NamedTuple class, in ``_leaves`` order."""
    out = []
    for f in cls._fields:
        sub = _NESTED.get((cls, f))
        out += _paths(sub, f"{prefix}{f}.") if sub else [prefix + f]
    return out


def _nest(cls, leaves, start=0):
    """(``cls`` built from ``leaves[start:]``, index after its last leaf)."""
    fields = []
    for f in cls._fields:
        sub = _NESTED.get((cls, f))
        if sub:
            value, start = _nest(sub, leaves, start)
        else:
            value, start = leaves[start], start + 1
        fields.append(value)
    return cls(*fields), start


class _FlatTick(torch.nn.Module):
    """``node_tick`` on flat leaves, with the lane axis added and removed
    inside for the single-robot tick."""

    def __init__(self, tick, single: bool):
        super().__init__()
        self.tick, self.single = tick, single

    def forward(self, *leaves):
        state, n = _nest(NodeState, leaves)
        meas, _ = _nest(Measurements, leaves, n)
        if self.single:
            state, meas = (_nest(type(t), [x[None] for x in _leaves(t)])[0] for t in (state, meas))
        new_state, out = self.tick(state, meas)
        flat = _leaves(new_state) + _leaves(out)
        return tuple(x[0] for x in flat) if self.single else tuple(flat)


def _trace(config, batch, dtype, device) -> bytes:
    """One platform's ``torch.export.save`` archive."""
    from nmpc_nav_control_tpu_torch.control import make_controller
    from nmpc_nav_control_tpu_torch.control.state_machine import node_init, node_tick

    spec, data = make_controller(config.steering_geometry, config.dt, config.horizon,
                                 dtype=dtype, device=device, **config.controller_kwargs())
    cfg = config.nav
    lanes = 1 if batch is None else batch
    state = node_init(spec, cfg, lanes, dtype, device)
    flag = torch.ones(lanes, dtype=torch.bool, device=device)
    zeros = torch.zeros((lanes, 3), dtype=dtype, device=device)
    meas = Measurements(pose=zeros, vel=zeros.clone(), steer_angle=zeros[:, 0].clone(),
                        pose_valid=flag, vel_valid=flag.clone(), steer_valid=flag.clone())
    example = _leaves(state) + _leaves(meas)
    if batch is None:
        example = [x[0] for x in example]
    module = _FlatTick(lambda s, m: node_tick(spec, data, cfg, s, m), batch is None)
    program = torch.export.export(module, tuple(example), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_tick(config, batch: Optional[int] = None, platforms=_PLATFORMS,
                dtype=torch.float32) -> bytes:
    """Serialize the navigation tick for ``config`` (a ``RobotConfig``).

    ``batch``: None exports the single-robot tick; an int the fleet tick
    over that many lanes.  ``platforms``: "cuda" (traced on the card, which
    it needs: without one it raises) and/or "cpu".  The IPM route is the
    one ``NMPC_TPU_TILED_IPM`` selects now.

    Returns bytes: magic | u32 header length | JSON header | archives.
    """
    from nmpc_nav_control_tpu_torch.qp.ipm import tiled_ipm_ok

    platforms = list(platforms)
    for p in platforms:
        if p not in _PLATFORMS:
            raise ValueError(f"unknown platform {p!r}: choose from {_PLATFORMS}")
    if "cuda" in platforms and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the 'cuda' platform is traced on the card; "
                           "export platforms=('cpu',) without one")
    archives = [_trace(config, batch, dtype, p) for p in platforms]
    header = json.dumps({
        "format": _FORMAT,
        "geometry": config.steering_geometry,
        "horizon": config.horizon,
        "dt": config.dt,
        "batch": batch,
        "dtype": str(dtype).removeprefix("torch."),
        "platforms": platforms,
        "sizes": [len(a) for a in archives],
        "route": "fused" if tiled_ipm_ok() else "riccati",
        "torch": torch.__version__,
        "kernels": _build.source_hash(),
        "inputs": _paths(NodeState) + _paths(Measurements),
        "outputs": _paths(NodeState) + _paths(TickOutput),
    }).encode()
    return b"".join([_MAGIC, struct.pack("<I", len(header)), header, *archives])


@dataclasses.dataclass
class AotTick:
    """A loaded tick: ``meta`` (the JSON header) and ``__call__(state,
    meas) -> (NodeState, TickOutput)``, as ``node_tick`` gives them for the
    exported batch.

    On the card the results are the captured graph's static buffers: the
    new state is the static state input, so passing it back copies nothing,
    and the next call overwrites both; clone what you keep.  The launches
    made while capturing, one tick's, are in ``capture_launches``.
    """

    meta: dict
    program: torch.nn.Module
    device: torch.device
    capture_launches: Optional[dict] = None
    _graph: Optional[tuple] = None       # (graph, static inputs, static outputs)

    def __call__(self, state, meas):
        leaves = _leaves(state) + _leaves(meas)
        if self.device.type == "cuda":
            outs = self._replay(leaves)
        else:
            outs = self.program(*leaves)
        new_state, n = _nest(NodeState, outs)
        return new_state, _nest(TickOutput, outs, n)[0]

    def _replay(self, leaves):
        if self._graph is None:
            self._capture(leaves)
        graph, inputs, outputs = self._graph
        _copy_into(inputs, leaves)
        graph.replay()
        return outputs

    def _capture(self, leaves):
        inputs = [x.to(self.device, copy=True) for x in leaves]
        n_state = len(_paths(NodeState))
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for _ in range(_WARMUP):
                self.program(*inputs)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        before = _build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = list(self.program(*inputs))
            # The new state goes back into the static state inputs, which
            # then stand for it among the outputs.
            _copy_into(inputs[:n_state], outs[:n_state])
        outs[:n_state] = inputs[:n_state]
        self._graph = (graph, inputs, outs)
        self.capture_launches = {k: n - before.get(k, 0) for k, n in _build.launch_counts().items()
                                 if n != before.get(k, 0)}


def _copy_into(dsts, srcs) -> None:
    """Copy each source into its static buffer (a source that is its buffer,
    or a view of all of it, is skipped)."""
    for dst, src in zip(dsts, srcs):
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(src.shape)}, expected {tuple(dst.shape)}")
        if src is dst or (src.device == dst.device and src.data_ptr() == dst.data_ptr()
                          and src.stride() == dst.stride()):
            continue
        dst.copy_(src)


def _header(data: bytes):
    if data[:len(_JAX_MAGIC)] == _JAX_MAGIC:
        raise ValueError("a JAX artifact (nmpc_nav_control_tpu.runtime.aot): load it with "
                         "that package")
    if data[:len(_MAGIC)] != _MAGIC:
        raise ValueError("not an nmpc_nav_control_tpu_torch AOT artifact")
    off = len(_MAGIC)
    (hlen,) = struct.unpack_from("<I", data, off)
    off += 4
    meta = json.loads(data[off:off + hlen].decode())
    if meta.get("format") != _FORMAT:
        raise ValueError(f"artifact format {meta.get('format')}, this loader reads {_FORMAT}")
    if (meta["inputs"] != _paths(NodeState) + _paths(Measurements)
            or meta["outputs"] != _paths(NodeState) + _paths(TickOutput)):
        raise ValueError("the artifact's leaves differ from this package's NodeState, "
                         "Measurements and TickOutput")
    return meta, off + hlen


def load_tick(data: bytes, device=None) -> AotTick:
    """Deserialize an :func:`export_tick` artifact for ``device``: the card
    unless the caller asks for the CPU (``device="cpu"``), as the port's
    other entry points; without a card and without ``device="cpu"`` it
    raises.  Refuses a JAX artifact, anything without this format's magic
    and a platform the artifact lacks."""
    meta, off = _header(data)
    device = torch.device("cuda" if device is None else device)
    if device.type not in meta["platforms"]:
        raise ValueError(f"the artifact holds no {device.type!r} platform "
                         f"(it holds {meta['platforms']})")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the artifact on the CPU")
    i = meta["platforms"].index(device.type)
    start = off + sum(meta["sizes"][:i])
    program = torch.export.load(io.BytesIO(data[start:start + meta["sizes"][i]]))
    return AotTick(meta=meta, program=program.module(), device=device)


def save_tick(config, path: str, batch: Optional[int] = None,
              platforms=_PLATFORMS, dtype=torch.float32) -> dict:
    """Export and write the artifact; returns the header dict."""
    data = export_tick(config, batch=batch, platforms=platforms, dtype=dtype)
    with open(path, "wb") as f:
        f.write(data)
    return _header(data)[0]
