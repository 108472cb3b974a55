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
which kernels its main path went through; a CUDA graph that captures a
wrapper's launch counts it once, at capture, and not at each replay.

``define_op`` registers a kernel as a ``torch.library`` custom op,
``nmpc_tpu::<kernel>`` (through ``torch.library.Library``, whose
dispatch, which every eager call of a wrapper pays, is lighter than
``torch.library.custom_op``'s), with one schema for all of them: the CUDA
implementation launches the kernel (and counts it, once per launch), the
CPU one runs its plain version and the fake one gives the outputs' shapes,
so that ``torch.export`` traces a kernel as one node and a loaded program
runs it on either device (``runtime/aot.py``).  ``use_op``, ``use_kernel``
and ``check`` are the wrappers' shared routing and argument checks.
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
    "define_op",
    "header_config",
    "launch",
    "launch_counts",
    "on_cuda",
    "reset_launch_counts",
    "source_hash",
    "traced",
    "use_kernel",
    "use_op",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
# No --use_fast_math: the finiteness flag must see NaN/Inf, lambda/s runs up
# to the 1e10 barrier cap at the 1e-9 slack floor, and the 2x2 Cholesky
# needs IEEE sqrt and division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libnmpc_kernels.so"
# The ops' namespace and their one schema: a config key (the compiled
# specialisation's parameters), the operands in the order of the kernel's
# argument struct, and its two float arguments; the outputs as a list.
NAMESPACE = "nmpc_tpu"
OP_SCHEMA = "(str key, Tensor[] ins, float f0, float f1) -> Tensor[]"

_counts: collections.Counter = collections.Counter()
_lib: ctypes.CDLL | None = None
_bound: set = set()
_ops = torch.library.Library(NAMESPACE, "DEF")


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


def source_hash() -> str:
    """Hash of the kernel sources and the nvcc flags: the build's directory
    name, and what a tick artifact records of the kernels it was traced
    against."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile the kernels if this source hash has no library yet.

    Returns (library path, seconds spent compiling; 0.0 when it was built).
    The nvcc log, with ptxas' register and spill counts, is kept beside the
    library as ``build.log``.
    """
    out_dir = BUILD_ROOT / source_hash()
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


def use_kernel(tensors, impl: str) -> bool:
    """True where a wrapper launches its kernel.  ``impl`` is the solve's
    choice (``qp.ipm.kernel_impl``): "plain" takes the plain version on the
    tensors' own device; "kernel" launches the kernel on CUDA tensors and
    takes the plain version on CPU tensors, for which no kernel exists.
    Mixed or other devices raise either way."""
    cuda = on_cuda(tensors)
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    return cuda and impl == "kernel"


def traced(tensors) -> bool:
    """True where a tracer made the tensors: ``torch.export``'s fake tensors
    and every other subclass of ``torch.Tensor``."""
    return any(type(t) is not torch.Tensor for t in tensors)


def use_op(tensors, impl: str) -> bool:
    """True where a wrapper calls its op: to launch its kernel
    (``use_kernel``), and for a tracer's CPU tensors, so that the traced
    program holds the op, which runs the plain version on the CPU."""
    return use_kernel(tensors, impl) or (traced(tensors) and not on_cuda(tensors))


def define_op(name: str, io, plain):
    """Register kernel ``name`` as the op ``nmpc_tpu::<name>``
    (``OP_SCHEMA``) and return it.

    ``io(key, ins)`` -> (N, B, [(name, shape)] of the inputs, [shape] of the
    outputs, ``config``), ``config()`` the compiled specialisation's name
    (it raises where there is none); ``plain(key, ins, f0, f1)`` -> the
    plain version's outputs as a list.  On CUDA tensors the op checks its
    operands and launches the kernel on new outputs; on CPU tensors it runs
    the plain version, copying out an output that shares memory with an
    input or another output (a plain version's layout change that moved no
    data, at B=1), which an op may not return; its fake gives the outputs'
    shapes."""
    def cuda(key, ins, f0, f1):
        N, B, inputs, outputs, config = io(key, ins)
        config = config()
        check([(n, t, shape) for (n, shape), t in zip(inputs, ins)])
        outs = [ins[0].new_empty(shape) for shape in outputs]
        launch(name, config, [*ins, *outs], N, B, f0, f1)
        return outs

    def cpu(key, ins, f0, f1):
        seen, outs = {t.untyped_storage().data_ptr() for t in ins}, []
        for t in plain(key, ins, f0, f1):
            if t.untyped_storage().data_ptr() in seen:
                t = t.clone(memory_format=torch.contiguous_format)
            seen.add(t.untyped_storage().data_ptr())
            outs.append(t)
        return outs

    def fake(key, ins, f0, f1):
        return [ins[0].new_empty(shape) for shape in io(key, ins)[3]]

    _ops.define(name + OP_SCHEMA)
    _ops.impl(name, cuda, "CUDA")
    _ops.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_ops)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


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
