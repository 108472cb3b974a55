"""ctypes bindings for the native real-time runtime (``native/rt_runtime.cpp``).

Port of ``nmpc_nav_control_tpu/runtime/native.py``: the same C functions,
``RtTimer`` and ``SpscRing``.  The source is compiled on first use with g++
into ``build/native/<hash of source and flags>/libnmpc_rt.so`` at the root
of the checkout (beside the CUDA kernels of ``ops/_build.py``, and like
them git-ignored), so an edit to the source rebuilds it.  Nothing is
written under ``native/``.  Without a compiler ``available()`` is False and
the executor takes the Python timing path, with a warning on its
telemetry channel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

__all__ = ["available", "build", "RtTimer", "SpscRing", "now_ns"]

_ROOT = Path(__file__).resolve().parents[2]
SRC = _ROOT / "native" / "rt_runtime.cpp"
BUILD_ROOT = _ROOT / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")
LIB_NAME = "libnmpc_rt.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def build() -> Path:
    """Compile the runtime if this source hash has no library under
    ``BUILD_ROOT`` yet; returns the library's path.  Raises
    ``subprocess.CalledProcessError`` (or ``OSError`` without g++)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp_lib), str(SRC), "-lpthread"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp_lib, lib)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.rt_timer_create.restype = ctypes.c_void_p
    lib.rt_timer_create.argtypes = [ctypes.c_double]
    lib.rt_timer_destroy.argtypes = [ctypes.c_void_p]
    lib.rt_timer_wait.restype = ctypes.c_int64
    lib.rt_timer_wait.argtypes = [ctypes.c_void_p]
    lib.rt_timer_overruns.restype = ctypes.c_int64
    lib.rt_timer_overruns.argtypes = [ctypes.c_void_p]
    lib.rt_timer_jitter_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    for name in ("ring_push", "ring_push_overwrite"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.ring_pop.restype = ctypes.c_int
    lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                             ctypes.POINTER(ctypes.c_uint8)]
    lib.ring_pop_latest.restype = ctypes.c_int64
    lib.ring_pop_latest.argtypes = lib.ring_pop.argtypes
    lib.ring_size.restype = ctypes.c_int64
    lib.ring_size.argtypes = [ctypes.c_void_p]
    lib.rt_now_ns.restype = ctypes.c_int64
    lib.rt_now_ns.argtypes = []
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _need_lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable (no g++ to build it)")
    return lib


def now_ns() -> int:
    return int(_need_lib().rt_now_ns())


class RtTimer:
    """Absolute-deadline periodic timer (native clock_nanosleep)."""

    def __init__(self, period_s: float):
        self._lib = _need_lib()
        self._h = self._lib.rt_timer_create(period_s)

    def wait(self) -> int:
        """Block until the next deadline; returns wakeup lateness in ns."""
        return int(self._lib.rt_timer_wait(self._h))

    @property
    def overruns(self) -> int:
        return int(self._lib.rt_timer_overruns(self._h))

    def jitter_stats(self):
        out = (ctypes.c_int64 * 3)()
        self._lib.rt_timer_jitter_stats(self._h, out)
        return {"p50_ns": out[0], "p99_ns": out[1], "max_ns": out[2]}

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rt_timer_destroy(self._h)
            self._h = None


class SpscRing:
    """Wait-free SPSC ring of fixed-size byte records with timestamps.

    ``capacity`` is the requested number of usable records.  The native ring
    keeps one slot of headroom in bounded (``overwrite=False``) mode — the
    consumer's lap-validated read treats a record at distance >= slots from
    head as potentially mid-rewrite, so a bounded producer must stop one
    short — hence ring_create is given ``2 * capacity_pow2`` slots so the
    advertised capacity is fully usable in both modes.
    """

    def __init__(self, record_size: int, capacity_pow2: int = 64):
        self._lib = _need_lib()
        self.record_size = record_size
        self.capacity = capacity_pow2
        self._h = self._lib.ring_create(record_size, 2 * capacity_pow2)
        if not self._h:
            raise ValueError("capacity must be a power of two")

    def push(self, payload: bytes, overwrite: bool = True) -> bool:
        if len(payload) != self.record_size:
            raise ValueError(f"payload of {len(payload)} bytes, records are "
                             f"{self.record_size}")
        buf = (ctypes.c_uint8 * self.record_size).from_buffer_copy(payload)
        fn = self._lib.ring_push_overwrite if overwrite else self._lib.ring_push
        return bool(fn(self._h, buf))

    def pop(self):
        """Oldest record -> (timestamp_ns, payload) or None."""
        ts = ctypes.c_int64()
        buf = (ctypes.c_uint8 * self.record_size)()
        if not self._lib.ring_pop(self._h, ctypes.byref(ts), buf):
            return None
        return int(ts.value), bytes(buf)

    def pop_latest(self):
        """Freshest record, dropping stale ones -> (ts, payload, n_dropped) or None."""
        ts = ctypes.c_int64()
        buf = (ctypes.c_uint8 * self.record_size)()
        dropped = self._lib.ring_pop_latest(self._h, ctypes.byref(ts), buf)
        if dropped < 0:
            return None
        return int(ts.value), bytes(buf), int(dropped)

    def __len__(self):
        return int(self._lib.ring_size(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ring_destroy(self._h)
            self._h = None
