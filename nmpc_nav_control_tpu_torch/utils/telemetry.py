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

  - Tracing, off unless :func:`enable_tracing` turns it on: :func:`span`
    records a named host span (``time.perf_counter_ns`` at both ends, its
    parent span and the tick it belongs to) in a preallocated ring;
    :func:`mark` records a phase of the tick ("tick.start", "ctl.end", ...).
    In a CUDA graph being captured a mark is one launch of the
    ``nmpc_tpu::trace_mark`` kernel (``ops/trace_mark.py``), which writes
    the card's ``%globaltimer`` into a ring on the card at every replay;
    elsewhere (CPU tensors, eager ticks) it takes the host clock.  The
    card's clock is calibrated against the host's, and :func:`records`
    returns spans and marks on the host clock, tying each card mark to the
    ``graph.replay`` span that launched it.  With tracing off, ``span``
    returns one shared no-op context and ``mark`` returns at once: one
    test of a module-level bool each, and a graph captured then holds no
    mark.

Channels and metrics are host-side only; nothing of this module but a mark
appears inside a captured tick, and the card's ring is read back by
:func:`records` alone, after a synchronize, never per tick (device code
reports through returned tensors, the host decides what to log — the
one-transfer-per-tick rule of ``runtime/node.py``).
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import logging
import threading
import time
from typing import NamedTuple, Optional, TextIO

__all__ = [
    "channel",
    "configure",
    "Channel",
    "MetricsRegistry",
    "metrics",
    "Records",
    "SpanIndex",
    "begin",
    "disable_tracing",
    "enable_tracing",
    "end",
    "mark",
    "outside_graphs_by_span",
    "records",
    "reset_records",
    "span",
    "write_chrome_trace",
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


# --------------------------------------------------------------------------- #
# Tracing: host spans and the tick's phase marks
# --------------------------------------------------------------------------- #

# A span of these names opened outside any tick starts one: it gets a new
# tick id, which the spans and marks inside it share.
TICK_SPANS = frozenset({"node.tick", "fleet.tick", "graph.replay"})
SPAN_CAPACITY = 65536          # host spans kept (and host-clock marks), the newest
RING = 65536                   # card marks kept a card, the newest: 16 bytes each
# Phase ids of the card's ring entries (0: the clock's calibration marks).
# ``graph.*`` bound the whole captured body of a graph (``control/graph.py``).
PHASES = ("clock", "tick.start", "tick.end", "ctl.start", "ctl.end", "qp.start", "qp.end",
          "graph.start", "graph.end")
CALIBRATION_PAIRS = 20

_on = False                    # the switch every span and mark tests first
_tracer = None                 # the process's _Tracer, from the first enable_tracing()


class Span(NamedTuple):
    """A closed host span, ``perf_counter_ns`` at both ends."""
    id: int                    # spans are numbered in the order they opened
    name: str
    start: int
    end: int
    parent: int                # the enclosing span's id; -1 for none
    tick: int                  # the tick it belongs to; 0 for none
    fields: Optional[dict]


class Mark(NamedTuple):
    """A phase mark on the host clock (ns)."""
    phase: str
    t: int
    tick: int
    device: str                # the card ("cuda:0"); "host" for a host-clock mark
    replay: int                # the id of the graph.replay span that launched it; -1 for none


class Clock(NamedTuple):
    """One calibration of a card's ``%globaltimer`` against the host clock:
    the tightest of ``CALIBRATION_PAIRS`` round trips (host clock, mark,
    synchronize, host clock)."""
    device_ns: int             # the mark's reading on the card
    host_ns: int               # the midpoint of its round trip on the host
    uncertainty_ns: int        # half the round trip


class Records(NamedTuple):
    """What :func:`records` returns, on the host clock."""
    spans: list                # [Span] by start
    marks: list                # [Mark] by time
    clocks: dict               # {card: [Clock]}: first capture, enable_tracing, each read


class GraphMarks:
    """The card marks a graph captured with tracing on writes at each
    replay: the graph's id and card, and how many."""

    __slots__ = ("graph", "device", "count")

    def __init__(self, graph: int, device):
        self.graph, self.device, self.count = graph, device, 0


class _NoSpan:
    """The one context ``span`` returns with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("tracer", "name", "fields", "id")

    def __init__(self, tracer, name: str, fields: Optional[dict]):
        self.tracer, self.name, self.fields = tracer, name, fields

    def __enter__(self):
        self.id = self.tracer.open(self.name, self.fields)
        return self

    def __exit__(self, *exc):
        self.tracer.close(self.id)
        return False


class _Ring:
    """A card's marks: ``entries`` [RING, 2] int64 (code, ns) written by the
    kernel at ``cursor``; ``written`` counts the marks the host enqueued,
    so mark n of the card is entry n % RING."""

    def __init__(self, device):
        import torch

        self.device = device
        self.entries = torch.zeros((RING, 2), dtype=torch.int64, device=device)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=device)
        self.written = 0
        self.floor = 0             # marks before it were reset
        self.clocks = []

    def _sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def calibrate(self) -> None:
        import torch

        from nmpc_nav_control_tpu_torch.ops import trace_mark

        pairs = []
        on_card = self.device.type == "cuda"
        with torch.cuda.device(self.device) if on_card else contextlib.nullcontext():
            for _ in range(CALIBRATION_PAIRS):
                self._sync()
                h0 = time.perf_counter_ns()
                trace_mark.mark(self.entries, self.cursor, 0)
                self._sync()
                h1 = time.perf_counter_ns()
                pairs.append((h1 - h0, h0, self.written))
                self.written += 1
        trip, h0, n = min(pairs)
        device_ns = int(self.entries[n % RING, 1])
        self.clocks.append(Clock(device_ns, h0 + trip // 2, (trip + 1) // 2))

    def to_host(self, device_ns: int) -> int:
        """A card reading on the host clock: the first and the last
        calibration's line (one calibration: its offset)."""
        a, b = self.clocks[0], self.clocks[-1]
        if b.device_ns == a.device_ns:
            return device_ns - a.device_ns + a.host_ns
        slope = (b.host_ns - a.host_ns) / (b.device_ns - a.device_ns)
        return a.host_ns + round((device_ns - a.device_ns) * slope)

    def read(self) -> tuple:
        """(entries as a list, the first mark still held) after a
        synchronize and a calibration."""
        self.calibrate()
        cursor = int(self.cursor.cpu()[0])
        if cursor != self.written:
            raise RuntimeError(f"{self.device} wrote {cursor} marks, the host enqueued "
                               f"{self.written}: a replay ran outside telemetry.replay")
        return self.entries.cpu().tolist(), max(self.floor, cursor - RING)


class _Tracer:
    """The spans' ring, the host-clock marks, the cards' rings, the tick
    and graph ids, and each thread's stack of open spans."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.capacity = capacity
        self.ids = [-1] * capacity
        self.names = [None] * capacity
        self.starts = [0] * capacity
        self.ends = [0] * capacity
        self.parents = [-1] * capacity
        self.ticks = [0] * capacity
        self.fields = [None] * capacity
        self._span_ids = itertools.count()
        self._tick_ids = itertools.count(1)
        self._graph_ids = itertools.count(1)
        self._local = threading.local()
        self.host_marks = collections.deque(maxlen=capacity)   # (phase, ns, tick)
        self.rings = {}
        self.recording = None          # GraphMarks of the capture under way
        self.floor = 0                 # spans before it were reset

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str, fields: Optional[dict], start_ns: Optional[int] = None) -> int:
        stack = self._stack()
        parent, tick = stack[-1] if stack else (-1, 0)
        if not tick and name in TICK_SPANS:
            tick = next(self._tick_ids)
        i = next(self._span_ids)
        at = i % self.capacity
        self.ids[at], self.names[at], self.parents[at] = i, name, parent
        self.ticks[at], self.fields[at], self.ends[at] = tick, fields, 0
        self.starts[at] = time.perf_counter_ns() if start_ns is None else start_ns
        stack.append((i, tick))
        return i

    def close(self, i: int, end_ns: Optional[int] = None) -> None:
        t = time.perf_counter_ns() if end_ns is None else end_ns
        stack = self._stack()
        while stack and stack.pop()[0] != i:      # spans left open inside it close with it
            pass
        at = i % self.capacity
        if self.ids[at] == i:
            self.ends[at] = t

    def mark(self, phase: str, like) -> None:
        import torch

        if type(like) is not torch.Tensor:       # a tracer's tensor: no mark in its program
            return
        rec = self.recording
        if rec is not None and like.device == rec.device:
            from nmpc_nav_control_tpu_torch.ops import trace_mark

            ring = self.rings[rec.device]
            trace_mark.mark(ring.entries, ring.cursor, rec.graph << 8 | PHASES.index(phase))
            rec.count += 1
        else:
            stack = self._stack()
            self.host_marks.append((phase, time.perf_counter_ns(), stack[-1][1] if stack else 0))

    def start_recording(self, device) -> GraphMarks:
        import torch

        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self.rings:
            self.rings[device] = ring = _Ring(device)
            ring.calibrate()
        self.recording = GraphMarks(next(self._graph_ids), device)
        return self.recording

    def replay(self, marks: GraphMarks):
        ring = self.rings[marks.device]
        pos = ring.written
        ring.written += marks.count
        if not _on:
            return _NO_SPAN
        return _Span(self, "graph.replay", {"graph": marks.graph, "device": str(marks.device),
                                            "pos": pos, "marks": marks.count})

    def reset(self) -> None:
        self.floor = next(self._span_ids)
        self.host_marks.clear()
        for ring in self.rings.values():
            ring.floor = ring.written

    def records(self) -> Records:
        spans = [Span(i, self.names[at], self.starts[at], self.ends[at], self.parents[at],
                      self.ticks[at], self.fields[at])
                 for at, i in enumerate(self.ids) if i >= self.floor and self.ends[at]]
        spans.sort(key=lambda s: (s.start, s.id))
        marks = [Mark(p, t, tick, "host", -1) for p, t, tick in list(self.host_marks)]
        clocks = {}
        for device, ring in self.rings.items():
            entries, first = ring.read()
            card = str(device)
            clocks[card] = list(ring.clocks)
            for s in spans:
                f = s.fields
                if s.name != "graph.replay" or not f or f.get("device") != card:
                    continue
                for n in range(max(f["pos"], first), f["pos"] + f["marks"]):
                    code, ns = entries[n % RING]
                    marks.append(Mark(PHASES[code & 255], ring.to_host(ns), s.tick, card, s.id))
        marks.sort(key=lambda m: m.t)
        return Records(spans, marks, clocks)


def enable_tracing() -> None:
    """Turn tracing on: spans and marks are recorded from now on, and
    graphs captured from now on hold the card marks.  A card is calibrated
    at its first capture with tracing on, again here if it already was, and
    at each :func:`records`."""
    global _on, _tracer
    if _tracer is None:
        _tracer = _Tracer()
    for ring in _tracer.rings.values():
        ring.calibrate()
    _on = True


def disable_tracing() -> None:
    """Turn tracing off; what was recorded stays readable."""
    global _on
    _on = False


def span(name: str, **fields):
    """A context that records the host span ``name`` (``fields`` kept with
    it); with tracing off, one shared no-op context."""
    if not _on:
        return _NO_SPAN
    return _Span(_tracer, name, fields or None)


def begin(name: str, start_ns: Optional[int] = None) -> Optional[int]:
    """Open the span ``name`` at ``start_ns``, a ``perf_counter_ns``
    reading the caller took (now where None): the token for :func:`end`;
    None with tracing off."""
    if not _on:
        return None
    return _tracer.open(name, None, start_ns)


def end(token: Optional[int], end_ns: Optional[int] = None) -> None:
    """Close the span :func:`begin` opened at ``end_ns`` (now where None)."""
    if token is not None:
        _tracer.close(token, end_ns)


def mark(phase: str, like) -> None:
    """Mark ``phase`` of the tick that tensor ``like`` belongs to: in a CUDA
    graph being captured on its card, the card's clock at every replay;
    otherwise the host clock now.  Nothing under a tracer (``torch.export``)
    or with tracing off."""
    if _on:
        _tracer.mark(phase, like)


@contextlib.contextmanager
def recording(device):
    """A context around a CUDA graph's capture on ``device``: marks go into
    the graph.  It gives the capture's :class:`GraphMarks` (None with
    tracing off: the graph then holds no mark)."""
    if not _on:
        yield None
        return
    try:
        yield _tracer.start_recording(device)
    finally:
        _tracer.recording = None


def replay(marks: Optional[GraphMarks]):
    """A context around one replay of a graph whose capture gave ``marks``:
    the ``graph.replay`` span, which the card marks of the replay are tied
    to.  The host counts those marks whether tracing is on or not."""
    if marks is not None and marks.count:
        return _tracer.replay(marks)
    return span("graph.replay")


def reset_records() -> None:
    """Forget what was recorded (graph captures keep their marks)."""
    if _tracer is not None:
        _tracer.reset()


def records() -> Records:
    """Everything recorded and still held, on the host clock: the closed
    spans, the host-clock marks and each card's marks.  Synchronizes and
    calibrates each card that marks; the cards' rings are read back here
    alone."""
    if _tracer is None:
        return Records([], [], {})
    return _tracer.records()


class SpanIndex:
    """The innermost span open at a time (host ns), through the tree of
    ``spans``."""

    def __init__(self, spans):
        held = {s.id for s in spans}
        self.kids = collections.defaultdict(list)
        for s in spans:
            self.kids[s.parent if s.parent in held else -1].append(s)
        self.starts = {k: [s.start for s in v] for k, v in self.kids.items()}

    def innermost(self, t: int) -> Optional[Span]:
        found, level = None, -1
        while level in self.kids:
            i = bisect.bisect_right(self.starts[level], t) - 1
            if i < 0 or self.kids[level][i].end <= t:
                break
            found = self.kids[level][i]
            level = found.id
        return found


def outside_graphs_by_span(recs: Optional[Records] = None) -> dict:
    """Seconds of each card's timeline between its graph replays (from one
    replay's last mark, ``graph.end``, to the next one's first,
    ``graph.start``), by the innermost host span open where each stretch
    starts ("other" where none is)."""
    recs = records() if recs is None else recs
    replays = {}                   # (card, replay span id): (first mark, last mark)
    for m in recs.marks:
        if m.replay >= 0:
            a, b = replays.get((m.device, m.replay), (m.t, m.t))
            replays[m.device, m.replay] = (min(a, m.t), max(b, m.t))
    by_card = collections.defaultdict(list)
    for (card, _), ab in replays.items():
        by_card[card].append(ab)
    index, out = SpanIndex(recs.spans), {}
    for spans in by_card.values():
        spans.sort()
        for (_, b), (a, _) in zip(spans, spans[1:]):
            if a > b:
                s = index.innermost(b)
                label = "other" if s is None else s.name
                out[label] = out.get(label, 0.0) + (a - b) * 1e-9
    return out


def write_chrome_trace(path: str, recs: Optional[Records] = None) -> None:
    """Write the records as one Chrome-trace JSON (``chrome://tracing``,
    Perfetto): host spans on one track, the tick's phases (``tick``,
    ``ctl``, ``qp``, from their start and end marks) on one track a card
    and one for host-clock marks, all on the host clock (microseconds)."""
    recs = records() if recs is None else recs
    events = [{"name": "process_name", "ph": "M", "pid": 0, "args": {"name": "host spans"}},
              {"name": "process_name", "ph": "M", "pid": 1, "args": {"name": "host phases"}}]
    pids = {"host": 1} | {card: 2 + i for i, card in enumerate(recs.clocks)}
    events += [{"name": "process_name", "ph": "M", "pid": pids[card],
                "args": {"name": f"{card} phases"}} for card in recs.clocks]
    for s in recs.spans:
        events.append({"name": s.name, "ph": "X", "pid": 0, "tid": 0, "ts": s.start * 1e-3,
                       "dur": (s.end - s.start) * 1e-3,
                       "args": dict(s.fields or {}, id=s.id, parent=s.parent, tick=s.tick)})
    started = {}
    for m in recs.marks:
        what, _, edge = m.phase.rpartition(".")
        key = (m.device, m.replay, m.tick, what)
        if edge == "start":
            started[key] = m.t
        elif edge == "end" and key in started:
            t0 = started.pop(key)
            events.append({"name": what, "ph": "X", "pid": pids[m.device],
                           "tid": 0, "ts": t0 * 1e-3, "dur": (m.t - t0) * 1e-3,
                           "args": {"tick": m.tick, "replay": m.replay}})
    clocks = {k: [c._asdict() for c in v] for k, v in recs.clocks.items()}
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms", "clocks": clocks}, f)
