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

Launch counts (``ops._build.launch_counts``) grow at the warm-up ticks and
at the capture, one tick's launches, and not at replays.  Without a CUDA
device the class raises; it never runs eagerly in its place.
"""
from __future__ import annotations

import torch

from nmpc_nav_control_tpu_torch.control.controllers import (
    ControllerSpec,
    controller_init,
    controller_reset,
    controller_step,
)
from nmpc_nav_control_tpu_torch.ocp.spec import OCPData
from nmpc_nav_control_tpu_torch.ops import _build
from nmpc_nav_control_tpu_torch.qp.ipm import tiled_ipm_ok

__all__ = ["GraphedController"]

# Eager ticks before a capture: they build the kernels, set each launcher's
# shared-memory opt-in and fill the index caches outside the capture.
WARMUP_TICKS = 2


class GraphedController:
    """A batch of controllers whose tick replays a captured CUDA graph.

    ``step`` copies the inputs into the static buffers, replays the tick
    (capturing it first if there is none for the current route) and returns
    ``(state, cmd, stats)`` as ``controller_step`` does; all three are
    static buffers that the next replay overwrites, so a caller clones what
    it keeps past it.
    """

    def __init__(self, spec: ControllerSpec, data: OCPData, batch: int):
        dtype, device = data.p.dtype, data.p.device
        if device.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError(f"GraphedController needs data on a CUDA device, got {device}")
        self.spec, self.data = spec, data
        self.state = controller_init(spec, batch, dtype, device)
        N = spec.dims.N

        def zeros(*shape, dtype=dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        self._inputs = (zeros(batch, 3), zeros(batch, 3), zeros(batch, N + 1, 3),
                        zeros(batch, dtype=torch.long), zeros(batch))
        self._capture = None      # (route, graph, cmd, stats)

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
        return controller_step(self.spec, self.data, self.state, *self._inputs)

    def capture(self) -> dict:
        """Capture the tick on the loaded inputs for the current route,
        replacing the capture held.  ``WARMUP_TICKS`` eager ticks on a side
        stream come first, their results dropped (the state buffers are not
        written).  Returns the kernel launches made while capturing: one
        tick's."""
        route = tiled_ipm_ok()
        device = self.state.xs.device
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_TICKS):
                self._tick()
        torch.cuda.current_stream(device).wait_stream(stream)
        before = _build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            new_state, cmd, stats = self._tick()
            _copy_into(self.state, new_state)
        self._capture = (route, graph, cmd, stats)
        return {k: n - before.get(k, 0) for k, n in _build.launch_counts().items()
                if n != before.get(k, 0)}

    def step(self, pose, vel, traj_xy_theta, n_valid, steer_angle=None):
        """One tick for every lane: (state, CmdVel, RTIStats), static."""
        self.load_inputs(pose, vel, traj_xy_theta, n_valid, steer_angle)
        if self._capture is None or self._capture[0] != tiled_ipm_ok():
            self.capture()
        _, graph, cmd, stats = self._capture
        graph.replay()
        return self.state, cmd, stats

    def reset(self) -> None:
        """``controller_reset`` applied to the static state, in place."""
        _copy_into(self.state, controller_reset(self.state))


def _copy_into(dsts, srcs) -> None:
    for dst, src in zip(dsts, srcs):
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(src.shape)}, expected {tuple(dst.shape)}")
        if src is not dst:
            dst.copy_(src)
