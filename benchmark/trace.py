"""The traced run: ``torch.profiler`` over a few ticks, read back from its
Chrome trace.

Device work is every kernel, copy and fill the profiler saw on the card.
Each is tied to the host range (``record_function``) in which the runtime
call that launched it ran, by the profiler's correlation ids: a CUDA graph's
kernels to the range of its replay.  The harness's ranges are ``tick.<group>``
around each call into the program, ``plant`` and ``events`` around its own
work, and ``traced_window`` around the whole traced stretch.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Op:
    name: str
    start: float      # seconds, the trace's clock
    end: float
    label: str | None  # the innermost harness range around its launch


@dataclasses.dataclass
class Trace:
    ops: list          # [Op] on the device, by start
    ranges: list       # [(label, start, end)] of the harness's host ranges
    window: tuple      # (start, end) of ``traced_window``

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self, lo=None, hi=None, ops=None) -> float:
        """Seconds in [lo, hi] in which some device op ran (intervals merged)."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        total, end = 0.0, lo
        for op in sorted(self.ops if ops is None else ops, key=lambda o: o.start):
            a, b = max(op.start, end), min(op.end, hi)
            if b > a:
                total += b - a
                end = b
        return total

    def gaps(self) -> list:
        """Idle stretches of the window: [(start, end)] between device ops."""
        out, end = [], self.window[0]
        for op in self.ops:
            if op.start > end:
                out.append((end, min(op.start, self.window[1])))
            end = max(end, op.end)
        if end < self.window[1]:
            out.append((end, self.window[1]))
        return [(a, b) for a, b in out if b > a]

    def label_at(self, t: float) -> str:
        """The innermost harness range holding host time t ("other" if none)."""
        return _innermost(self.ranges, t) or "other"


def _innermost(ranges, t):
    """The name of the latest-starting range (by start) that holds t, but
    ``traced_window``; None if none does."""
    i = bisect.bisect_right(ranges, t, key=lambda r: r[1])
    for name, a, b in reversed(ranges[:i]):
        if a <= t < b and name != "traced_window":
            return name
    return None


def read_chrome_trace(path: Path) -> Trace:
    """The device ops, harness ranges and window of an exported trace."""
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    ranges, launches, device = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, a = e.get("cat", ""), e.get("ts", 0.0) * 1e-6
        b = a + e.get("dur", 0.0) * 1e-6
        corr = e.get("args", {}).get("correlation")
        if cat == "user_annotation":
            ranges.append((e["name"], a, b))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches[corr] = a
        elif cat in DEVICE_CATS:
            device.append((e["name"], a, b, corr))
    ranges.sort(key=lambda r: r[1])
    window = next(((a, b) for n, a, b in ranges if n == "traced_window"), None)
    if window is None:
        raise RuntimeError("the trace holds no traced_window range")
    ops = [Op(n, a, b, None if c not in launches else _innermost(ranges, launches[c]))
           for n, a, b, c in device
           if b > window[0] and a < window[1]]
    ops.sort(key=lambda o: o.start)
    return Trace(ops, ranges, window)


def profile(run, path: Path, settle=None):
    """Run ``run()`` under the profiler inside a ``traced_window`` range
    (it synchronizes at both ends), after ``settle()`` under the profiler
    but outside the window; export the trace to ``path``, read it back and
    delete the file: (``Trace``, what ``run`` returned)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if settle is not None:
            settle()
            torch.cuda.synchronize()
        with record_function("traced_window"):
            info = run()
            torch.cuda.synchronize()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        return read_chrome_trace(path), info
    finally:
        os.remove(path)
