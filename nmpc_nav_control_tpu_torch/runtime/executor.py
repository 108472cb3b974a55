"""Real-time executor: the 40 Hz timer loop.

The ``ros::Timer`` equivalent (``NMPCNavControlROS.cpp:36-41,508-514``): runs
the node's control cycle at ``control_freq`` Hz against a pluggable state
provider and command sink, with per-cycle wall-time accounting against the
period budget.  Port of ``nmpc_nav_control_tpu/runtime/executor.py``.

On the card the node's first tick captures its CUDA graph (the JAX node's
first tick compiles), so the first cycle overruns the period, as it does in
the JAX package; ``latency_stats`` counts it like any other cycle, and
``first_cycle_s`` and ``steady_latency_stats`` report it apart from the
cycles after it.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Protocol

from nmpc_nav_control_tpu_torch.runtime.messages import ControlStatus, Twist
from nmpc_nav_control_tpu_torch.runtime.node import NmpcNavControlNode
from nmpc_nav_control_tpu_torch.utils.profiling import LatencyStats
from nmpc_nav_control_tpu_torch.utils.telemetry import channel, metrics

__all__ = ["StateProvider", "CommandSink", "RealTimeExecutor"]

_log = channel("executor")


class StateProvider(Protocol):
    """Supplies robot state each cycle (the tf2 boundary).

    ``get_state`` returns (pose (x,y,theta), vel (v,vn,w), valid: bool) or a
    4-tuple that appends the pose's frame_id (the node re-expresses it into
    the required frame via its ``frame_transformer`` hook)."""

    def get_state(self) -> tuple:
        """Returns (pose, vel, valid[, frame_id])."""
        ...


class CommandSink(Protocol):
    def publish_cmd_vel(self, twist: Twist) -> None: ...

    def publish_status(self, status: ControlStatus) -> None: ...


class RealTimeExecutor:
    """Fixed-rate loop with overrun accounting.

    A cycle that exceeds the period is logged as an overrun and the next
    cycle starts immediately (no catch-up bursts — matches ros::Timer's
    default behavior for slow callbacks).
    """

    def __init__(self, node: NmpcNavControlNode, provider: StateProvider,
                 sink: CommandSink,
                 on_overrun: Optional[Callable[[float], None]] = None,
                 use_native_timer: bool = True):
        self.node = node
        self.provider = provider
        self.sink = sink
        self.period = node.config.dt
        self.on_overrun = on_overrun
        self.overruns = 0
        # Whole-cycle latency vs the tick budget (the ros::WallTime analog,
        # NMPCNavControlROS.cpp:510-513, with p50/p99 instead of raw logs).
        self.latency = LatencyStats(budget_s=self.period, max_samples=1 << 20)
        # The first cycle (on the card: the graph capture), also in ``latency``.
        self.first_cycle_s: Optional[float] = None
        self._native_timer = None
        if use_native_timer:
            from nmpc_nav_control_tpu_torch.runtime import native

            if native.available():
                self._native_timer = native.RtTimer(self.period)
            else:
                _log.warning("native_timer_unavailable",
                             reason="libnmpc_rt could not be built or loaded",
                             fallback="python timer")

    def _cycle(self):
        t0 = time.perf_counter()
        state = self.provider.get_state()
        pose, vel, valid = state[:3]
        frame = state[3] if len(state) > 3 else None
        twist, status = self.node.tick(
            pose, vel, pose_valid=valid, vel_valid=valid,
            pose_frame=frame,
        )
        if twist is not None:
            self.sink.publish_cmd_vel(twist)
        self.sink.publish_status(status)
        if self.node.last_actual_path is not None:
            pub = getattr(self.sink, "publish_actual_path", None)
            if pub is not None:
                pub(self.node.last_actual_path)
        cycle_s = time.perf_counter() - t0
        self.latency.record(cycle_s)
        if self.first_cycle_s is None:
            self.first_cycle_s = cycle_s

    def run(self, cycles: int) -> None:
        if self._native_timer is not None:
            self._run_native(cycles)
        else:
            self._run_python(cycles)

    def _run_native(self, cycles: int) -> None:
        """Native absolute-deadline pacing (clock_nanosleep in libnmpc_rt)."""
        t = self._native_timer
        overruns0 = t.overruns
        for _ in range(cycles):
            self._cycle()
            late_ns = t.wait()
            if t.overruns > overruns0:
                overruns0 = t.overruns
                self._note_overrun(late_ns * 1e-9)

    def _note_overrun(self, late_s: float) -> None:
        """Overrun accounting: counter + structured warning + user hook
        (ros::Timer logs nothing on slow callbacks; a production controller
        must)."""
        self.overruns += 1
        metrics().counter("executor.overruns").inc()
        _log.warning("cycle_overrun", late_ms=round(late_s * 1e3, 3),
                     period_ms=round(self.period * 1e3, 3),
                     total_overruns=self.overruns)
        if self.on_overrun is not None:
            self.on_overrun(late_s)

    def timer_stats(self) -> dict:
        if self._native_timer is None:
            return {}
        return self._native_timer.jitter_stats()

    def latency_stats(self) -> dict:
        """p50/p99/max cycle latency (ms) vs the tick budget."""
        return self.latency.summary()

    def steady_latency_stats(self) -> dict:
        """``latency_stats`` of the cycles after the first."""
        lat = self.latency
        if lat.count < 2:
            return {"count": 0}
        steady = LatencyStats(budget_s=self.period)
        # Until the ring wraps, its first sample is the first cycle.
        steady._samples = lat._samples[1:] if lat.count <= len(lat._samples) else lat._samples
        steady.count = lat.count - 1
        steady.violations = lat.violations - (self.first_cycle_s > self.period)
        return steady.summary()

    def _run_python(self, cycles: int) -> None:
        next_deadline = time.perf_counter() + self.period
        for _ in range(cycles):
            self._cycle()
            now = time.perf_counter()
            if now > next_deadline:
                self._note_overrun(now - next_deadline)
                next_deadline = now + self.period
            else:
                time.sleep(next_deadline - now)
                next_deadline += self.period
