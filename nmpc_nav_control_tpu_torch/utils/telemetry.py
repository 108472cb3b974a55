"""Structured logging and metrics: the observability layer.

The reference's observability is ROS logging macros on named channels —
``ROS_DEBUG_NAMED("main_cycle", ...)`` for the per-cycle wall time
(reference ``src/nmpc_nav_control/NMPCNavControlROS.cpp:513``),
``ROS_DEBUG_NAMED("nmpc_solver", ...)`` for the solver time (``:715``), and
``ROS_WARN/ERROR`` at every failure site (``:431-434,552,620-627,656-664``)
— plus the ``control_status`` topic published every tick (``:364-388``).

This module is the port's copy of ``nmpc_nav_control_tpu/utils/telemetry.py``
(JAX-free itself, but importing it would run the JAX package's ``__init__``),
built for fleet-scale production use rather than a human watching a
terminal:

  - :func:`channel` — named structured loggers (same channel names as the
    reference).  Events are key-value records; with :func:`configure`'s
    default JSON-lines sink they are machine-parseable one-per-line, ready
    for any log shipper.  Logging is stdlib ``logging`` underneath, so hosts
    that already configure handlers keep full control (we never touch the
    root logger).
  - :class:`MetricsRegistry` — process-local counters and gauges with a
    cheap lock-free-enough (GIL-atomic) hot path; the node/executor publish
    tick counts, solver failures, safety aborts, overruns, and latency
    gauges here.  ``snapshot()`` is the scrape surface.

Both are deliberately host-side only: nothing in this module may appear
inside a captured tick (device code reports through returned tensors, the
host decides what to log — the one-transfer-per-tick rule of
``runtime/node.py``).
"""
from __future__ import annotations

import json
import logging
import threading
import time
from typing import Optional, TextIO

__all__ = [
    "channel",
    "configure",
    "Channel",
    "MetricsRegistry",
    "metrics",
]

_ROOT = "nmpc_nav_control_tpu_torch"
_configured = False
_lock = threading.Lock()


class _JsonLinesFormatter(logging.Formatter):
    """One JSON object per record: ts, level, channel, event, fields."""

    def format(self, record: logging.LogRecord) -> str:
        rec = {
            "ts": round(record.created, 6),
            "level": record.levelname.lower(),
            "channel": record.name.removeprefix(_ROOT + "."),
            "event": record.getMessage(),
        }
        rec.update(getattr(record, "fields", {}))
        return json.dumps(rec, default=str)


def configure(level: int = logging.INFO, stream: Optional[TextIO] = None,
              json_lines: bool = True, force: bool = False) -> None:
    """Install a handler on the package logger (idempotent).

    Library rule: importing the package never configures logging; hosts opt
    in by calling this (the CLI does) or by attaching their own handlers to
    the ``nmpc_nav_control_tpu_torch`` logger hierarchy.
    """
    global _configured
    with _lock:
        if _configured and not force:
            return
        root = logging.getLogger(_ROOT)
        if force:
            for h in list(root.handlers):
                root.removeHandler(h)
        handler = logging.StreamHandler(stream)
        if json_lines:
            handler.setFormatter(_JsonLinesFormatter())
        else:
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        root.addHandler(handler)
        root.setLevel(level)
        _configured = True


class Channel:
    """A named structured logger.

    ``ch.info("event_name", key=value, ...)`` emits one structured record;
    field values must be JSON-serializable scalars (anything else is
    stringified by the formatter).
    """

    __slots__ = ("_log",)

    def __init__(self, name: str):
        self._log = logging.getLogger(f"{_ROOT}.{name}")

    def _emit(self, level: int, event: str, fields: dict) -> None:
        if self._log.isEnabledFor(level):
            self._log.log(level, event, extra={"fields": fields})

    def debug(self, event: str, **fields) -> None:
        self._emit(logging.DEBUG, event, fields)

    def info(self, event: str, **fields) -> None:
        self._emit(logging.INFO, event, fields)

    def warning(self, event: str, **fields) -> None:
        self._emit(logging.WARNING, event, fields)

    def error(self, event: str, **fields) -> None:
        self._emit(logging.ERROR, event, fields)

    def isEnabledFor(self, level: int) -> bool:
        return self._log.isEnabledFor(level)


_channels: dict = {}


def channel(name: str) -> Channel:
    """Get (and cache) the structured logger for a named channel."""
    ch = _channels.get(name)
    if ch is None:
        ch = _channels.setdefault(name, Channel(name))
    return ch


class _Counter:
    # ``value += n`` is a multi-bytecode read-modify-write, NOT GIL-atomic:
    # concurrent increments (executor timer thread vs a host callback
    # thread) can lose counts.  A per-counter lock keeps inc() correct from
    # any thread; uncontended acquisition is tens of ns — negligible next
    # to the tick it instruments.
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class _Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class MetricsRegistry:
    """Process-local named counters and gauges.

    The hot path (``inc``/``set``) is attribute assignment only; creation is
    locked.  ``snapshot()`` returns a flat ``{name: value}`` dict — the
    scrape/export surface (Prometheus text format, JSON dump, test
    assertions).
    """

    def __init__(self):
        self._counters: dict = {}
        self._gauges: dict = {}
        self._lock = threading.Lock()
        self._t0 = time.time()

    def counter(self, name: str) -> _Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, _Counter())
        return c

    def gauge(self, name: str) -> _Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, _Gauge())
        return g

    def snapshot(self) -> dict:
        out = {"uptime_s": round(time.time() - self._t0, 3)}
        out.update({k: v.value for k, v in self._counters.items()})
        out.update({k: v.value for k, v in self._gauges.items()})
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._t0 = time.time()


_default_registry = MetricsRegistry()


def metrics() -> MetricsRegistry:
    """The process-default registry (node/executor publish here)."""
    return _default_registry
