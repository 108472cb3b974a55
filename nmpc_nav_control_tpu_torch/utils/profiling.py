"""Profiling and latency-accounting utilities.

Port of ``nmpc_nav_control_tpu/utils/profiling.py``.  The reference exposes
two timing hooks: the solver-internal ``time_tot`` (surfaced at
``NMPCNavControlDiff.cpp:148-149``) and the whole-cycle wall time
(``ros::WallTime`` around ``mainCycle``, ``NMPCNavControlROS.cpp:510-513``).
This module is the port's observability equivalent:

  - :class:`LatencyStats` — streaming per-cycle latency accounting with
    p50/p99/max and budget-violation counts (the 25 ms tick budget of the
    40 Hz loop); a copy of the JAX class;
  - :func:`steady_state_seconds_per_step` — the chained-slope throughput
    measurement: the marginal cost of one more dependent step, which
    removes the fixed cost of starting and ending a chain.  The JAX version
    chains the steps under ``lax.scan`` in one jit; here ``step`` is called
    ``k`` times in a row (eagerly, or as replays of a captured graph) and
    the chain is timed with CUDA events on the card, ``time.perf_counter``
    on the CPU;
  - :func:`device_trace` — a ``torch.profiler`` context that writes a Chrome
    trace (the counterpart of ``jax.profiler.trace``).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch

__all__ = [
    "LatencyStats",
    "steady_state_seconds_per_step",
    "device_trace",
]


class LatencyStats:
    """Streaming latency recorder with percentile summaries.

    Keeps every sample (8 bytes each; a week at 40 Hz is ~200 MB — callers
    running unbounded loops should ``reset()`` periodically or set
    ``max_samples`` to use a fixed-size ring).
    """

    def __init__(self, budget_s: float | None = None,
                 max_samples: int | None = None):
        self.budget_s = budget_s
        self.max_samples = max_samples
        self._samples: list[float] = []
        self._pos = 0
        self.count = 0
        self.violations = 0

    def record(self, seconds: float) -> None:
        self.count += 1
        if self.budget_s is not None and seconds > self.budget_s:
            self.violations += 1
        if self.max_samples is not None and len(self._samples) >= self.max_samples:
            self._samples[self._pos] = seconds
            self._pos = (self._pos + 1) % self.max_samples
        else:
            self._samples.append(seconds)

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(time.perf_counter() - t0)

    def reset(self) -> None:
        self._samples.clear()
        self._pos = 0
        self.count = 0
        self.violations = 0

    def summary(self) -> dict:
        """p50/p90/p99/max in milliseconds plus budget accounting."""
        if not self._samples:
            return {"count": 0}
        arr = np.asarray(self._samples)
        out = {
            "count": self.count,
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
            "max_ms": float(arr.max() * 1e3),
            "mean_ms": float(arr.mean() * 1e3),
        }
        if self.budget_s is not None:
            out["budget_ms"] = self.budget_s * 1e3
            out["violations"] = self.violations
        return out


def steady_state_seconds_per_step(
    step: Callable,
    carry,
    *,
    k_lo: int = 1,
    k_hi: int = 9,
    reps: int = 5,
    device="cuda",
) -> float:
    """Marginal wall time of one dependent ``step``.

    ``step(carry) -> carry`` is chained ``k`` times; the returned figure is
    ``(t[k_hi] - t[k_lo]) / (k_hi - k_lo)`` over the best of ``reps`` timed
    chains each, after one untimed chain of each length.  On a CUDA device
    a chain is timed with CUDA events recorded on the current stream
    (device time, not the host's enqueue); with ``device="cpu"`` with
    ``time.perf_counter``.  ``step`` may be an eager tick or a graph replay.
    Without a card and without ``device="cpu"`` it raises.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("steady_state_seconds_per_step: no CUDA device (pass "
                           "device='cpu' to time on the CPU)")

    def chain(k):
        c = carry
        for _ in range(k):
            c = step(c)
        return c

    def timed(k):
        if device.type != "cuda":
            t0 = time.perf_counter()
            chain(k)
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        chain(k)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3

    timings = {}
    for k in (k_lo, k_hi):
        timed(k)                      # first chain: set-up, capture
        timings[k] = min(timed(k) for _ in range(reps))
    return (timings[k_hi] - timings[k_lo]) / (k_hi - k_lo)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (CPU and, where there is a
    card, CUDA activity) and write ``trace.json`` (Chrome / Perfetto
    format) into ``log_dir``.  Usage::

        with device_trace("build/nmpc_trace"):
            node.tick(pose, vel)

    Yields the profiler, whose ``key_averages()`` sums the time by op and
    kernel.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
