"""The controller tick captured in a CUDA graph: the port's ``jax.jit``.

The JAX package runs a tick as one compiled program (``jax.jit`` at
``nmpc_nav_control_tpu/runtime/node.py:96`` and ``bench.py:168``).
``controller_step`` runs eagerly, one torch op and one kernel launch at a
time, so at small batch the host sets the tick's time.
``GraphedController`` captures one ``controller_step`` tick with
``torch.cuda.CUDAGraph`` and replays it: the same kernels and ops in the
same order, launched by the card from one graph.

It owns static buffers for the tick's inputs (``pose``, ``vel``,
``traj_xy_theta``, ``n_valid``, ``steer_angle``) and for its ``RTIState``.
The captured tick ends by copying the new state into the state buffers, so
chained replays carry the state with no host work.  Spec, batch, dtype and
device are fixed per object (dtype and device are those of ``data``); a
graph also freezes its route, so the object holds one capture and the
``NMPC_TPU_TILED_IPM`` reading it was taken under, and captures again when
a step reads another.  ``data`` is read by address: change it in place
(``copy_``) or build a new object.

``GraphedNavigator`` does the same for the navigation tick
(``control/state_machine.py::node_tick``), the counterpart of the jitted
``node_tick`` of ``nmpc_nav_control_tpu/runtime/node.py:96`` and
``bench.py:254-262``: static ``Measurements`` and ``NodeState`` buffers,
the new state copied back inside the graph, and the event functions
(``on_goal_pose``, ``on_path_set``, ``on_command``, ``reset``) run eagerly
between replays and copied into the static state.  Both classes share one
capture routine (``_GraphedTick``).

Launch counts (``ops._build.launch_counts``) grow at the warm-up ticks and
at the capture, one tick's launches, and not at replays.  Without a CUDA
device the classes raise; they never run eagerly in their place.

Telemetry (``utils/telemetry.py``): a capture is a ``graph.capture`` span
(``graph.warmup``, ``graph.record``) and counts ``graph.captures``, and
``graph.recaptures`` where the object held a capture; the captured graph's
node count is ``capture_nodes`` and the ``graph.nodes`` gauge.  Each replay
is a ``graph.replay`` span and counts ``graph.replays``.  A tick captured
while tracing is on holds its phase marks, which each replay writes on the
card, between ``graph.start`` and ``graph.end`` around the whole captured
body (the tick and the copy into the state buffers); captured with tracing
off, the graph holds none.
"""
from __future__ import annotations

import torch

from nmpc_nav_control_tpu_torch.control import state_machine as sm
from nmpc_nav_control_tpu_torch.control.controllers import (
    ControllerSpec,
    controller_init,
    controller_reset,
    controller_step,
)
from nmpc_nav_control_tpu_torch.ocp.spec import OCPData
from nmpc_nav_control_tpu_torch.ops import _build
from nmpc_nav_control_tpu_torch.qp.ipm import tiled_ipm_ok
from nmpc_nav_control_tpu_torch.utils import telemetry

__all__ = ["GraphedController", "GraphedNavigator"]

# Eager ticks before a capture: they build the kernels, set each launcher's
# shared-memory opt-in and fill the index caches outside the capture.
WARMUP_TICKS = 2


class _GraphedTick:
    """One tick captured in a CUDA graph over static buffers.

    A subclass sets ``self.state`` (a NamedTuple of static tensors, nested
    ones too) and ``_tick()``, which reads the static buffers and returns
    ``(new_state, outputs)``.  ``capture`` takes the tick on the current
    route; ``_replay`` replays it, capturing first where there is no capture
    for the route ``NMPC_TPU_TILED_IPM`` now reads, and returns the static
    outputs.
    """

    _capture = None           # (route, graph, outputs, GraphMarks or None)
    capture_launches = None   # the last capture's launches, one tick's
    capture_nodes = None      # the last captured graph's node count

    @staticmethod
    def _check_device(data: OCPData, what: str):
        device = data.p.device
        if device.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError(f"{what} needs data on a CUDA device, got {device}")
        return data.p.dtype, device

    def _tick(self):
        raise NotImplementedError

    def capture(self) -> dict:
        """Capture the tick on the loaded inputs for the current route,
        replacing the capture held.  ``WARMUP_TICKS`` eager ticks on a side
        stream come first, their results dropped (the state buffers are not
        written).  Returns the kernel launches made while capturing: one
        tick's."""
        route = tiled_ipm_ok()
        device = self.data.p.device
        with telemetry.span("graph.capture"):
            with telemetry.span("graph.warmup"):
                stream = torch.cuda.Stream(device)
                stream.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(stream):
                    for _ in range(WARMUP_TICKS):
                        self._tick()
                torch.cuda.current_stream(device).wait_stream(stream)
            with telemetry.span("graph.record"), telemetry.recording(device) as marks:
                before = _build.launch_counts()
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                with torch.cuda.graph(graph):
                    telemetry.mark("graph.start", self.data.p)
                    new_state, outputs = self._tick()
                    _copy_into(self.state, new_state)
                    telemetry.mark("graph.end", self.data.p)
                graph.instantiate()
        m = telemetry.metrics()
        m.counter("graph.captures").inc()
        if self._capture is not None:
            m.counter("graph.recaptures").inc()
        self.capture_nodes = _build.graph_nodes(graph.raw_cuda_graph())
        m.gauge("graph.nodes").set(self.capture_nodes)
        self._capture = (route, graph, outputs, marks)
        self.capture_launches = {k: n - before.get(k, 0)
                                 for k, n in _build.launch_counts().items()
                                 if n != before.get(k, 0)}
        return self.capture_launches

    def _replay(self):
        if self._capture is None or self._capture[0] != tiled_ipm_ok():
            self.capture()
        _, graph, outputs, marks = self._capture
        with telemetry.replay(marks):
            graph.replay()
        telemetry.metrics().counter("graph.replays").inc()
        return outputs


class GraphedController(_GraphedTick):
    """A batch of controllers whose tick replays a captured CUDA graph.

    ``step`` copies the inputs into the static buffers, replays the tick
    (capturing it first if there is none for the current route) and returns
    ``(state, cmd, stats)`` as ``controller_step`` does; all three are
    static buffers that the next replay overwrites, so a caller clones what
    it keeps past it.
    """

    def __init__(self, spec: ControllerSpec, data: OCPData, batch: int):
        dtype, device = self._check_device(data, "GraphedController")
        self.spec, self.data = spec, data
        self.state = controller_init(spec, batch, dtype, device)
        N = spec.dims.N

        def zeros(*shape, dtype=dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        self._inputs = (zeros(batch, 3), zeros(batch, 3), zeros(batch, N + 1, 3),
                        zeros(batch, dtype=torch.long), zeros(batch))

    def load_inputs(self, pose, vel, traj_xy_theta, n_valid, steer_angle=None) -> None:
        """Copy one tick's inputs into the static buffers (shapes as for
        ``controller_step``; steer_angle None means zeros)."""
        pose_b, vel_b, traj_b, n_b, steer_b = self._inputs
        _copy_into((pose_b, vel_b, traj_b, n_b), (pose, vel, traj_xy_theta, n_valid))
        if steer_angle is None:
            steer_b.zero_()
        else:
            _copy_into((steer_b,), (steer_angle,))

    def _tick(self):
        new_state, cmd, stats = controller_step(self.spec, self.data, self.state, *self._inputs)
        return new_state, (cmd, stats)

    def step(self, pose, vel, traj_xy_theta, n_valid, steer_angle=None):
        """One tick for every lane: (state, CmdVel, RTIStats), static."""
        self.load_inputs(pose, vel, traj_xy_theta, n_valid, steer_angle)
        cmd, stats = self._replay()
        return self.state, cmd, stats

    def reset(self) -> None:
        """``controller_reset`` applied to the static state, in place."""
        _copy_into(self.state, controller_reset(self.state))


class GraphedNavigator(_GraphedTick):
    """A batch of navigation nodes whose ``node_tick`` replays a captured
    CUDA graph (the fleet tick of ``bench.py::_measure_fleet`` and the
    single-robot node's tick).

    ``step(meas)`` copies the measurements into the static buffers, replays
    the tick and returns ``(state, TickOutput)``, both static buffers that
    the next replay overwrites.  The event methods act on every lane, as
    ``control.state_machine``'s event functions do, eagerly between replays.
    """

    def __init__(self, spec: ControllerSpec, data: OCPData, cfg: sm.NavConfig, batch: int):
        dtype, device = self._check_device(data, "GraphedNavigator")
        self.spec, self.data, self.cfg = spec, data, cfg
        self.state = sm.node_init(spec, cfg, batch, dtype, device)

        def zeros(*shape, dtype=dtype):
            return torch.zeros((batch,) + shape, dtype=dtype, device=device)

        true = torch.ones(batch, dtype=torch.bool, device=device)
        self.meas = sm.Measurements(pose=zeros(3), vel=zeros(3), steer_angle=zeros(),
                                    pose_valid=true, vel_valid=true.clone(),
                                    steer_valid=true.clone())

    def load_measurements(self, meas: sm.Measurements) -> None:
        """Copy measurements (any device) into the static buffers."""
        _copy_into(self.meas, meas)

    def load_state(self, state: sm.NodeState) -> None:
        """Copy a NodeState (any device) into the static state."""
        with telemetry.span("nav.load_state"):
            _copy_into(self.state, state)

    def _tick(self):
        return sm.node_tick(self.spec, self.data, self.cfg, self.state, self.meas)

    def step(self, meas: sm.Measurements | None = None):
        """One tick for every lane on ``meas`` (None: the loaded ones):
        (NodeState, TickOutput), static."""
        if meas is not None:
            self.load_measurements(meas)
        return self.state, self._replay()

    def on_goal_pose(self, goal_pose) -> None:
        self.load_state(sm.on_goal_pose(self.state, goal_pose))

    def on_path_set(self, new_segs, n_new, request_id=0) -> None:
        self.load_state(sm.on_path_set(self.state, self.cfg, new_segs, n_new, request_id))

    def on_command(self, command: str) -> None:
        self.load_state(sm.on_command(self.state, command))

    def reset(self) -> None:
        """Every lane back to an idle node with an empty window."""
        self.load_state(sm.node_init(self.spec, self.cfg, self.state.status.shape[0],
                                     self.state.goal_pose.dtype, self.state.goal_pose.device))


def _copy_into(dsts, srcs) -> None:
    """Copy each source tensor into its static buffer, over nested tuples."""
    for dst, src in zip(dsts, srcs):
        if isinstance(dst, tuple):
            _copy_into(dst, src)
            continue
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(src.shape)}, expected {tuple(dst.shape)}")
        if src is not dst:
            dst.copy_(src)
