"""Build, load and count the port's CUDA kernels.

The sources in ``csrc/`` are compiled at first use with ``nvcc`` into a
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds), loaded with ctypes: one ``nvcc`` per ``.cu`` file, all
started together, then one link.  The library lands in
``build/kernels/<hash of sources and flags>/`` at the root of the checkout,
so an edit to any source rebuilds it.  Every exported launcher has one
signature::

    int <kernel>_<config>(void* const* ptrs, int n_ptrs, int N, int B,
                          float f0, float f1, cudaStream_t stream)

and returns ``cudaGetLastError()`` after the launch.

Each wrapper that launches a kernel adds one to that kernel's count in
``launch_counts()``, and nothing else touches the counts, so a run can show
which kernels its main path went through.  ``on_cuda`` and ``check`` are the
wrappers' shared routing and argument checks.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

__all__ = [
    "CSRC",
    "build",
    "check",
    "header_config",
    "launch",
    "launch_counts",
    "on_cuda",
    "reset_launch_counts",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
# No --use_fast_math: the finiteness flag must see NaN/Inf, lambda/s runs up
# to the 1e10 barrier cap at the 1e-9 slack floor, and the 2x2 Cholesky
# needs IEEE sqrt and division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libnmpc_kernels.so"

_counts: collections.Counter = collections.Counter()
_lib: ctypes.CDLL | None = None
_bound: set = set()


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def build() -> tuple[Path, float]:
    """Compile the kernels if this source hash has no library yet.

    Returns (library path, seconds spent compiling; 0.0 when it was built).
    The nvcc log, with ptxas' register and spill counts, is kept beside the
    library as ``build.log``.
    """
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = Path(tmp) / f"{src.stem}.o"
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in jobs:
            log.append(f"== nvcc {src.name}\n{proc.communicate()[0]}")
            if proc.returncode != 0:
                failed.append(src.name)
        if not failed:
            tmp_lib = Path(tmp) / LIB_NAME
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib),
                                   *[str(obj) for _, obj, _ in jobs]],
                                  capture_output=True, text=True)
            log.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append("link")
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        os.replace(tmp_lib, lib)
    return lib, time.perf_counter() - t0


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()[0]))
    return _lib


def launch(kernel: str, config: str, tensors, N: int, B: int,
           f0: float = 0.0, f1: float = 0.0) -> None:
    """Launch ``<kernel>_<config>`` on the current stream; raise on error.

    ``tensors``: inputs then outputs, in the order of the kernel's argument
    struct in its ``csrc/*.cu`` source; the caller has checked them.
    """
    lib = _load()
    name = f"{kernel}_{config}"
    fn = getattr(lib, name)
    if name not in _bound:
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound.add(name)
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    rc = fn(ptrs, len(tensors), N, B, f0, f1, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    _counts[kernel] += 1


def on_cuda(tensors) -> bool:
    """True for all-CUDA tensors, False for all-CPU; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel operands on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel implementation for device {dev}")


def check(named_shapes) -> None:
    """Raise unless every (name, tensor, shape) is float32, of that shape and
    contiguous: what the CUDA kernels take."""
    for name, t, shape in named_shapes:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: CUDA kernels take float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")


def launch_counts() -> dict:
    """Kernel launches per kernel name since the last reset."""
    return dict(_counts)


def reset_launch_counts() -> None:
    _counts.clear()


@functools.lru_cache(maxsize=None)
def header_config(header: str):
    """Parse a ``csrc/config_*.cuh`` header into
    (nx, nu, idxbx, idxbu, A_pattern, B_pattern), patterns as nested bool
    tuples — what the compiled kernels were specialised for."""
    text = (CSRC / header).read_text()

    def ints(s):
        return [int(v) for v in re.findall(r"-?\d+", s)]

    nx = int(re.search(r"\bNX\s*=\s*(\d+)", text).group(1))
    nu = int(re.search(r"\bNU\s*=\s*(\d+)", text).group(1))
    idxbx = tuple(ints(re.search(r"IDXBX\s*=\s*IndexList<([^>]*)>", text).group(1)))
    idxbu = tuple(ints(re.search(r"IDXBU\s*=\s*IndexList<([^>]*)>", text).group(1)))

    def pattern(name):
        m = re.search(rf"\b{name}\s*=\s*(Dense)?Pattern<([^>]*)>", text)
        vals = ints(m.group(2))
        rows, cols = vals[0], vals[1]
        bits = [1] * (rows * cols) if m.group(1) else vals[2:]
        if len(bits) != rows * cols:
            raise ValueError(f"{header}: {name} has {len(bits)} entries, "
                             f"expected {rows}x{cols}")
        return tuple(tuple(bool(bits[i * cols + j]) for j in range(cols))
                     for i in range(rows))

    return nx, nu, idxbx, idxbu, pattern("A"), pattern("B")
