#!/usr/bin/env python3
"""Smoke run of the torch port (``nmpc_nav_control_tpu_torch``) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

It imports nothing of JAX.  Phases, each printing one line per result:

  1. device and build: the card's name and power limit from nvidia-smi;
     the CUDA kernels built from ``nmpc_nav_control_tpu_torch/csrc``; each
     kernel's registers and spill stores (ptxas) and, from one launch at
     B=17 under the profiler, its shared memory per block, static plus
     dynamic;
  2. each IPM sweep kernel against its plain torch version on the card, on
     random valid IPM inputs for the diff and the omni4 specialisations, at
     N=40 with B = 2048, 1 and 1000 (a ragged last block), at N=80 with
     B=17 (ragged, batch rows not 16-byte aligned) and B=1 (phase 12's node
     tick), and at N=13 with B=17 (no
     multiple of any sweep's chunk of stages), within rtol 1e-4 /
     atol 1e-5; kernel and plain times at B=2048 from CUDA events, device
     times from the profiler at B=2048 and B=1 (N=40 and N=80);
  3. the main path: 20 chained batched ``controller_step`` ticks, diff N=40,
     B=2048, 8 IPM iterations, f32, with the inputs of ``bench.py``, eager
     and then through ``GraphedController`` (the tick captured in a CUDA
     graph, 20 chained replays); every lane ``ok``, finite ``kkt_res``, the
     graphed chain's last state and command within 3.6e-6 of the eager
     chain's, the eager chain's launch counts exactly 20 x 8/8/8/8/1 and the
     capture's exactly 8/8/8/8/1 (one tick; replays count nothing); ms per
     tick eager and graphed at B=2048 and at
     B=1 (CUDA events), the graphed B=1 tick under the 25 ms budget, and
     the device time of a graphed tick and of the port's kernels in it
     (profiler);
  4. card against CPU: 5 ticks at B=256 through the port on the card and on
     the CPU (plain sweeps), ``us`` within the f32 bounds of the golden suite
     (max 5e-3, mean 2e-4), with an f64 CPU run as referee;
  5. golden closed loop: ``diff_pose_N40`` replayed through
     ``tests/oracle/numpy_rti.closed_loop`` with the port's step on the card,
     within the bounds of ``tests/test_rti_oracle.py``;
  6. each Riccati kernel against its plain version on the card, at
     (nx, nu) = (7, 2) and (11, 4), N=40 with B = 2048, 1 and 1000, N=80
     with B=1 (phase 12's node tick: five whole chunks of 16 stages, one
     lane), and N = 13 and 1 with B=17 (chunk edges, a ragged last block), with a
     non-positive Quu pivot, a NaN in c and an Inf in qx in three lanes
     where B holds them: NaN and Inf in the same places, the finite values
     within the f32 bounds of ``tests/test_pallas_riccati.py``; kernel and
     plain times at B=2048, device times at B=2048 and B=1 (N=40 and N=80);
  7. the Riccati route (``NMPC_TPU_TILED_IPM=0``): phase 3's runs for
     ``bench.py``'s omni4 configuration at B=2048 and B=1, launch counts
     exactly 8 / 16 / 16 Riccati kernels a tick (eager and at capture) and
     no IPM sweep; the same at B=2048 for diff and tric;
  8. omni4 and tric on the default route (the fused sweeps), phase 3's run
     at B=2048: launches 8/8/8/8/1 a tick (eager and at capture) and no
     Riccati kernel;
  9. goldens on the card, within the golden bounds: ``diff_pose_N40``,
     ``omni4_pose_N40``, ``tric_pose_N40`` and ``tric_bug_pose_N40``
     through the Riccati route and ``omni4_pose_N40`` and ``tric_pose_N40``
     through the default route, eager (``controller_step``); the three N=80
     goldens (``diff_pose_N80``, ``omni4_pose_N80``, ``tric_pose_N80``)
     through both routes, graphed;
 10. f64 on the card: 5 ticks of the diff controller in f64 at B=256 on
     each route take the plain versions on the card (no kernel launched)
     and agree with the f64 CPU run within 1e-8;
 11. the navigation tick (``control.state_machine.node_tick``: projection,
     windowing, the chord-table resampler, safety and termination lanes and
     the solve) at ``bench.py::_measure_fleet``'s configuration: diff, N=40,
     ``NavConfig()``, a 50 m line at 0.5 m/s, every robot at the origin,
     f32, default route; 20 chained eager ticks and 20 chained replays of
     ``GraphedNavigator`` at B=2048 and B=1, 5 of each for omni4 and tric
     at B=2048: every lane FOLLOW_PATH with ``solve_ok`` and a finite
     ``kkt_res`` at every tick, the graphed chain's last state and outputs
     equal to the eager chain's bit for bit, the capture's launches exactly
     one controller tick's (8/8/8/8/1) and the eager chain's 20 (5) times
     that; ms per tick graphed (eager), ticks per second, the device time
     and the kernels' share of a graphed tick, the graphed node tick minus
     phase 3's graphed controller tick (the path subsystem's cost), and the
     graphed B=1 tick under the 25 ms budget; then one robot through
     ``runtime.NmpcNavControlNode`` on the card (graphed) and on the CPU in
     lock step, fed one numpy plant driven by the card's commands, on the
     two-line path of ``tests/test_state_machine.py``: it reaches IDLE with
     no ERROR, the CPU node shows the same status at every tick, and the
     largest command gap between them is printed;
 12. the host runtime and the command line at the runtime YAMLs' N=80, run
     in this process (``nmpc_nav_control_tpu_torch.__main__.main``, stdout
     captured and parsed): (a) ``prepare config/models.yaml`` for the three
     sections, each tick captured with one tick's launches (8/8/8/8/1) and a
     finite smoke command; (b) ``run`` on ``config/runtime_{diff,omni4,tric}
     .yaml`` to the goal (1, 0, 0) with the native 40 Hz timer: IDLE within
     1.5x the ticks at which the JAX command line reports it on a CPU
     (``JAX_IDLE_TICKS``), no ERROR, the final error inside the YAML's
     ``final_position_error``, the capture's launches 8/8/8/8/1 and the
     run's (two warm-up ticks and the capture; replays count nothing)
     three times that, the native timer in use, and the cycles after the
     capture (host clock) under the 25 ms budget at p50; (c) ``run`` for
     diff on the path ``0 0 1 0 1 1`` to IDLE the same way; (d) one graphed
     N=80 node tick at B=1 per geometry on each route, profiled: device ms,
     the port's kernels' share, idle, and each kernel's device ms and
     launches inside it; (e) a diff node on that path for 40 ticks against
     the simulated plant, its state saved (``runtime/checkpoint.py``),
     loaded into a fresh graphed node with a copy of the plant, and 40 more
     ticks: the commands and plant poses equal the uninterrupted node's
     bit for bit; (f) a graphed diff node on the card and an eager one on
     the CPU in lock step for 12 ticks on that path, both fed the plant
     driven by the card's commands: the same status at every tick, and the
     largest command gap within the golden suite's f32 command bound
     (2.5e-2), printed;
 13. the parallel layers and the demos: (a) BASELINE.json's 4096-scenario
     mixed-geometry fleet (``parallel.fleet.Fleet``; diff 2048, omni4 1024,
     tric 1024 lanes, bench.py's controllers, N=40, ``NavConfig()``, the
     default route), half of each group GoToPose to distinct goals on a
     ring, half FollowPath on distinct 2 m lines, every robot moving on
     the pose-goal demo's RK4 plant: 40 ticks eager and 40 graphed, every
     lane ``solve_ok`` with a finite ``kkt_res``, no ERROR, the graphed
     chain equal to the eager one bit for bit, each group's capture one
     tick's launches (8/8/8/8/1) and the replays none; the fleet tick
     graphed and eager (20 chained ticks, CUDA events), scenario ticks/s,
     the groups' ticks alone, device time, kernels' share and idle; 8 lanes
     a group graphed on the card and eager on the CPU in lock step for 12
     ticks (statuses equal, command gap within 2.5e-2); where there are two
     cards or more, the fleet on a data mesh over them; (b) a diff QP at
     N=512, B=256 (the port's model linearized along a seeded trajectory,
     inputs at their bound on some lanes) solved by ``solve_box_qp(...,
     stage_parallel=True)`` (no kernel launched) and by the serial Riccati
     route (kernels 6-8, 8/16/16), both f32 within twice the JAX package's
     own f32 error of the f64 solve on the card; kernels 6-8 against their
     plain versions at N=512 (B=256 and 1) with device times; both solves
     timed at B=256 and 1 through a CUDA graph (eager where the capture
     fails, said so); ``solve_box_qp_2d`` on a (1, 4) mesh (its stage
     blocks on the visible cards in turn) within 1e-6 of the 1-D solve, the
     bytes each stage block holds, its ms a solve at B=256 and 1 beside the
     1-D solve's, and each card's peak memory during the 2-D solve beside
     the 1-D solve's (placement across cards is measured only with two
     cards or more); (c) ``init_distributed`` on NCCL at world size 1, then
     ``global_data_mesh``, ``local_to_global``, one fleet tick and
     ``global_to_local`` at 8 lanes a group, equal to the direct tick bit
     for bit; (d) the demos on the card: ``sim_pose_goal`` for the three
     geometries at ``--noise 0`` (the final error within 1 mm of the JAX
     script's) and ``--noise 0.05`` (printed; the median final error over
     32 noise streams inside the JAX script's range over 32 keys), and
     ``sim_follow_path`` to IDLE within 3 cm of the path end;
 14. the AOT tick artifacts (``runtime/aot.py``): (a) ``python -m
     nmpc_nav_control_tpu_torch export`` in parallel subprocesses for the
     three runtime YAMLs at N=80 (platforms cuda and cpu), diff on the
     Riccati route (``NMPC_TPU_TILED_IPM=0``) and diff at ``bench.py``'s
     fleet setting (N=40, ``--batch 2048``, cuda), each export's seconds and
     bytes; (b) each artifact loaded in a process of its own that imports
     ``runtime.aot`` and nothing else of the port (JAX blocked; no module of
     ``models``, ``rti``, ``qp``, ``paths`` or ``control.controllers``
     loaded), driven 40 ticks to the pose goal (1, 0, 0) on the measurements
     of a ``GraphedNavigator`` of the same config run here in closed loop on
     the demo plant (the fleet's robots start on y in [-0.25, 0.25]): every
     leaf of every tick equal to the navigator's bit for bit, or within
     3.6e-6 with the leaves that differ printed; (c) the loaded tick's
     capture launches exactly 8/8/8/8/1 (Riccati 8/16/16) and the 40 ticks
     two warm-up calls' and the capture's; (d) the loaded tick graphed and
     eager and the navigator graphed before and after it, CUDA events over
     20 chained calls, beside the card's name and power, the first call
     (warm-ups and capture) apart, and the diff N=80 artifact loaded in
     this process too and timed in turns with its navigator; (e) the cpu
     platform of the diff
     default-route and Riccati artifacts loaded on the CPU, 3 ticks equal
     to the port's CPU eager tick bit for bit.  The loading processes
     deserialize and run the CPU platform in parallel, then take the card
     one at a time with nothing else running;
 15. the measurement surface: the bench's headline path in this process
     (``nmpc_nav_control_tpu_torch/bench.py::_measure_config``, diff N=40
     B=2048) with the launch counts set to 0 just before, exactly two
     warm-up ticks' and the capture's launches; (a) ``python -m
     nmpc_nav_control_tpu_torch bench`` (the full sweep, ``BENCH_REPS`` 10)
     in a subprocess: exactly ``bench.py``'s twelve records in its order
     (the ten configurations, the B=1 latency and the fleet line, the
     headline last), each config naming this card, every value positive
     and finite, every ``hbm_roofline_frac`` and ``f32_peak_frac`` <= 1,
     the per-solve time not falling from N=40 to N=80 at a fixed geometry
     and B, ``BENCH_torch.json`` written with those records and
     ``BENCH.json``'s bytes unchanged; the headline's ms per batch tick,
     the B=1 latency and the fleet's ms per tick each within 15% of phase
     3's graphed B=2048 and B=1 ticks and phase 11's graphed B=2048 node
     tick, the pairs printed; (b) ``python -m nmpc_nav_control_tpu_torch.
     bench_scaling`` prints its ``skipped`` line on one card and exits 0;
     (c) ``tools.phase_probe diff 40 2048`` and ``tools.node_probe diff 40
     2048``, every line printed, ``full_tick`` and ``node_tick`` within 15%
     of (a)'s headline and fleet figures.

Any failure raises, and the script exits non-zero.  Before the last line it
prints the kernels as one JSON object (each with its bound: the bytes it
must read and write over 3.35 TB/s or its flops over the 67 TFLOP/s f32
peak, whichever is larger); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
A fuller record (with the nvcc/ptxas log) goes to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import ast
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N = 40
TICKS = 20
RTOL, ATOL = 1e-4, 1e-5          # kernel vs plain: f32 summation order only
REG, D_CAP, TAU = 1e-8, 1e10, 0.995
PER_TICK = {"ipm_bwd_fused": 8, "ipm_fwd_affine": 8, "ipm_bwd_corr": 8,
            "ipm_fwd_corr": 8, "ipm_kkt_fused": 1}
RICCATI_PER_TICK = {"riccati_factor": 8, "riccati_solve_bwd": 16, "riccati_solve_fwd": 16}
# Riccati kernel vs plain: the f32 bounds of tests/test_pallas_riccati.py.
RICCATI_TOL = {"Ps": (5e-4, 1e-4), "Ks": (5e-5, 1e-4), "Ls": (5e-5, 1e-4),
               "kff": (5e-5, 1e-4), "dxs": (5e-5, 0.0), "dus": (5e-5, 0.0)}
GRAPH_TOL = 3.6e-6               # graphed vs eager tick: the f32 batched-vs-serial bound
NAV_TICKS_SHORT = 5              # phase 11's omni4 and tric chains
F64_TOL = 1e-8                   # f64 card vs CPU (tests/test_torch_slice.py's f64 bound)
BUDGET_MS = 25.0                 # the reference's 40 Hz tick
# The report boundary (the tick of the first "status=0" line) at which the
# JAX command line, run with phase 12's arguments (the goal (1, 0, 0) and
# --ticks 200 per geometry; diff on the path 0 0 1 0 1 1 with --ticks 400;
# --no-rt, f32, on a CPU), prints IDLE (PERF.md section 4).
JAX_IDLE_TICKS = {"diff": 100, "omni4": 120, "tric": 100, "path": 240}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores


def _leaves(x):
    if isinstance(x, tuple):
        return [t for v in x for t in _leaves(v)]
    return [x]


def _errors(torch, got, ref, atol=ATOL, rtol=RTOL):
    """(max abs error, max relative error, worst |err| / (atol + rtol |ref|))."""
    worst = [0.0, 0.0, 0.0]
    for g, r in zip(_leaves(got), _leaves(ref)):
        d = (g - r).abs()
        rel = d / r.abs().clamp_min(torch.finfo(r.dtype).tiny)
        excess = d / (atol + rtol * r.abs())
        for i, v in enumerate((d, rel, excess)):
            v = float(torch.nan_to_num(v, nan=float("inf")).max())
            worst[i] = max(worst[i], v)
    return worst


def _placed_errors(torch, got, ref, atol, rtol):
    """(max abs error, worst |err| / (atol + rtol |ref|)) over the entries
    where ``ref`` is finite; the second is inf unless NaN, +Inf and -Inf sit
    in the same places of both."""
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
        if not bool((f(got) == f(ref)).all()):
            return float("inf"), float("inf")
    ok = torch.isfinite(ref)
    d = torch.where(ok, got - ref, 0.0).abs()
    excess = d / (atol + rtol * torch.where(ok, ref, 0.0).abs())
    return float(d.max()), float(excess.max())


def _time_ms(torch, fn, reps=20):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _profile(torch, fn, reps):
    """key_averages() of ``reps`` calls of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def _device_ms(torch, fn, reps=10, tries=3):
    """Device time per call from torch.profiler (CUPTI), for a call that
    launches one kernel and nothing else on the card.  A trace with no
    device time is taken again, up to ``tries`` times, then it raises."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        # The kernels' own rows: a wrapper's op (nmpc_tpu::<kernel>) is a row
        # of its own that repeats its kernel's device time.
        total = sum(e.self_device_time_total for e in _profile(torch, fn, reps)
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / reps / 1000.0
    raise RuntimeError(f"the profiler showed no device time in {tries} traces")


# The port's kernels as the profiler names them (csrc/*.cu, anonymous namespace).
PORT_KERNEL = re.compile(r"namespace\)::(bwd_fused_kernel|fwd_kernel|bwd_corr_kernel|kkt_kernel|"
                         r"factor_kernel|solve_bwd_kernel|solve_fwd_kernel)<")


# The port's kernels as the profiler names them -> their wrappers.
KERNEL_OF = ((r"::bwd_fused_kernel<", "ipm_bwd_fused"),
             (r"::fwd_kernel<[^>]*false>", "ipm_fwd_affine"),
             (r"::bwd_corr_kernel<", "ipm_bwd_corr"),
             (r"::fwd_kernel<[^>]*true>", "ipm_fwd_corr"),
             (r"::kkt_kernel<", "ipm_kkt_fused"),
             (r"::factor_kernel<", "riccati_factor"),
             (r"::solve_bwd_kernel<", "riccati_solve_bwd"),
             (r"::solve_fwd_kernel<", "riccati_solve_fwd"))


def _tick_breakdown(torch, fn, reps=5):
    """(device ms of all kernels, of the port's kernels, {wrapper: (ms,
    launches)} of the port's) per call of ``fn`` (one graphed tick) from
    torch.profiler; None where the trace shows no device time."""
    fn()
    torch.cuda.synchronize()
    total, split = 0.0, {}
    for e in _profile(torch, fn, reps):
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = e.self_device_time_total
        total += t
        if PORT_KERNEL.search(e.key):
            name = next((n for key, n in KERNEL_OF if re.search(key, e.key)), e.key)
            ms, count = split.get(name, (0.0, 0))
            split[name] = (ms + t / reps / 1000.0, count + e.count / reps)
    if total <= 0:
        return None
    return total / reps / 1000.0, sum(ms for ms, _ in split.values()), split


def _ptxas_kernels(log):
    """kernel<template args> -> (registers, spill store bytes, static shared
    memory bytes) from nvcc's -Xptxas -v log."""
    out = {}
    for fn, spill, used in re.findall(
            r"entry function '(\w+)' for \S+\n.*\n\s*\d+ bytes stack frame, "
            r"(\d+) bytes spill stores.*\n.*Used (\d+ registers.*)", log):
        m = re.search(r"([a-z]+(?:_[a-z]+)*_kernel)I(?:\d+(\w+?Config)(?:Lb([01])E)?|Li(\d+)ELi(\d+)E)E", fn)
        if m.group(2):
            targs = m.group(2) + ("" if m.group(3) is None else (", true" if m.group(3) == "1"
                                                                 else ", false"))
        else:
            targs = f"{m.group(4)}, {m.group(5)}"
        smem = re.search(r"(\d+) bytes smem", used)
        out[f"{m.group(1)}<{targs}>"] = (int(used.split()[0]), int(spill),
                                          int(smem.group(1)) if smem else 0)
    return out


def _launch_props(torch, fn):
    """(registers per thread, shared memory per block in bytes, grid, block)
    of the one kernel that ``fn`` launches, from the profiler's trace (CUPTI
    reports static plus dynamic shared memory); None where the trace has no
    kernel."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    for e in events:
        if e.get("cat") == "kernel":
            a = e.get("args", {})
            return (a.get("registers per thread"), a.get("shared memory"), a.get("grid"),
                    a.get("block"))
    return None


def _nbytes(x):
    return sum(t.numel() * t.element_size() for t in _leaves(x) if hasattr(t, "numel"))


def _moved_bytes(name, args, out, nx, lanes):
    """Bytes a kernel must move: each output written once and each input
    entry it reads read once.  Most kernels read the whole of every input;
    the IPM backward sweeps start at stage 1 of Qd and qx (``bwd_corr`` and
    ``kkt`` of dx too), and the Riccati solve's backward half reads only the
    lower triangle of P_1..P_N (``csrc/riccati_fused.cu``), so those entries
    are not counted.  Every call here is at N stages."""
    unread = {
        "ipm_bwd_fused": 2 * nx,
        "ipm_bwd_corr": 3 * nx,
        "ipm_kkt_fused": 3 * nx,
        "riccati_solve_bwd": nx * nx + N * nx * (nx - 1) // 2,
    }.get(name, 0)
    return _nbytes(args) + _nbytes(out) - 4 * unread * lanes


def _flops(name, nx, nu, a, b, nb):
    """Flops per stage and lane, counted from the kernel's loops (structural
    zeros skipped; a, b = A/B nonzeros, nb = bound entries of a stage)."""
    vec_bwd = 2 * (a + b) + 4 * nu * nx + 2 * nu * nu + 3 * nx
    return {
        "ipm_bwd_fused": (2 * nx * nx + 3 * a * nx + 4 * b * nx + b * nu + 2 * nu * nu * nx
                          + nu * nx * (nx + 1) + 2 * (a + b) + vec_bwd + 12 * nb),
        "ipm_fwd_affine": 2 * nu * nx + 2 * (a + b) + 12 * nb,
        "ipm_bwd_corr": vec_bwd + 2 * nx + 10 * nb,
        "ipm_fwd_corr": 2 * nu * nx + 2 * (a + b) + 14 * nb,
        "ipm_kkt_fused": 2 * (a + b) + 4 * nx + 6 * nb,
        "riccati_factor": (4 * nx ** 3 + 6 * nu * nx * nx + 4 * nu * nu * nx + nu ** 3
                           + 3 * nx * nx),
        "riccati_solve_bwd": 4 * nx * nx + 4 * nx * nu + 2 * nu * nu + 2 * nx,
        "riccati_solve_fwd": 2 * nx * nx + 4 * nx * nu + 2 * nx,
    }[name]


def _bound(nbytes, flops):
    """(least ms the card needs, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Kernel template of each wrapper, as ptxas names it (phase 1).
IPM_KERNEL = {"ipm_bwd_fused": "bwd_fused_kernel<{}>", "ipm_fwd_affine": "fwd_kernel<{}, false>",
              "ipm_bwd_corr": "bwd_corr_kernel<{}>", "ipm_fwd_corr": "fwd_kernel<{}, true>",
              "ipm_kkt_fused": "kkt_kernel<{}>"}
CONFIG = {"diff": "DiffConfig", "omni4": "Omni4Config"}
RICCATI_KERNEL = {"riccati_factor": "factor_kernel<{}, {}>",
                  "riccati_solve_bwd": "solve_bwd_kernel<{}, {}>",
                  "riccati_solve_fwd": "solve_fwd_kernel<{}, {}>"}


def _sweep_cfg(torch, tp, geometry):
    """The IPM sweeps' static shape for a geometry of bench.py."""
    spec = _controller(torch, "cpu", geometry=geometry)[0]
    m = spec.dims.model
    return tp.SweepConfig(m.nx, m.nu, m.idxbx, m.idxbu, *spec.rti.spars)


def _print_launch(torch, record, ptxas, name, kname, kern):
    """Phase 1: one launch of a kernel under the profiler; its registers and
    shared memory per block, static (ptxas) plus dynamic (the rest)."""
    props = _launch_props(torch, kern)
    static = ptxas.get(kname, (None, None, 0))[2]
    if props is None or props[1] is None:
        print(f"phase 1 launch {name} {kname}: not measured (no kernel in the trace)")
        return
    regs, total, grid, block = props
    print(f"phase 1 launch {name} {kname} at B=17: {regs} registers, shared memory "
          f"{total} bytes per block = {static} static + {total - static} dynamic, "
          f"grid {grid}, block {block}")
    record["launch"][kname] = dict(registers=regs, smem=total, static_smem=static,
                                   grid=grid, block=block)


def _sweep_calls(torch, tp, cfg, x, dev):
    """name -> (kernel call, plain call) on one input set; the inputs of
    each sweep downstream of the first come from the plain versions."""
    def d(v):
        if isinstance(v, tuple):
            return tuple(d(t) for t in v)
        return torch.from_numpy(np.ascontiguousarray(v)).to(dev)

    a = {k: d(v) for k, v in x.items()}
    bwd = (a["A"], a["Bm"], a["Qd"], a["Rd"], a["qx"], a["qu"], a["c"], a["dx"],
           a["du"], a["s"], a["lam"], a["bnd"])
    ref = tp.bwd_fused_plain(cfg, *bwd, reg=REG, d_cap=D_CAP)
    fwd = (a["A"], a["Bm"], ref.K, ref.kff, ref.rdyn, a["r_init"], a["s"], a["lam"], ref.rp)
    aff = tp.fwd_affine_plain(cfg, *fwd, tau=TAU)
    corr = tuple(aff.alpha * c for c in aff.corr)
    bc = (a["A"], a["Bm"], ref.K, ref.L, ref.Pc, a["Qd"], a["qx"], a["dx"], a["Rd"],
          a["qu"], a["du"], a["s"], a["lam"], ref.rp, corr, a["sigma_mu"])
    fc = fwd[:3] + (tp.bwd_corr_plain(cfg, *bc),) + fwd[4:] + (corr, a["sigma_mu"])
    kk = (a["A"], a["Bm"], a["Qd"], a["qx"], a["dx"], a["Rd"], a["qu"], a["du"],
          a["lam"], a["s"])
    return {
        "ipm_bwd_fused": (lambda: tp.ipm_bwd_fused(cfg, *bwd, reg=REG, d_cap=D_CAP),
                          lambda: tp.bwd_fused_plain(cfg, *bwd, reg=REG, d_cap=D_CAP), bwd),
        "ipm_fwd_affine": (lambda: tp.ipm_fwd_affine(cfg, *fwd, tau=TAU),
                           lambda: tp.fwd_affine_plain(cfg, *fwd, tau=TAU), fwd),
        "ipm_bwd_corr": (lambda: tp.ipm_bwd_corr(cfg, *bc),
                         lambda: tp.bwd_corr_plain(cfg, *bc), bc),
        "ipm_fwd_corr": (lambda: tp.ipm_fwd_corr(cfg, *fc, tau=TAU),
                         lambda: tp.fwd_corr_plain(cfg, *fc, tau=TAU), fc),
        "ipm_kkt_fused": (lambda: tp.ipm_kkt_fused(cfg, *kk),
                          lambda: tp.kkt_fused_plain(cfg, *kk), kk),
    }


def _riccati_calls(torch, rf, x, dev):
    """name -> (kernel call, plain call, inputs, tolerance per output); the
    solve halves take the plain factors and the plain kff."""
    a = {k: torch.from_numpy(v).to(dev) for k, v in x.items()}
    fac = (a["A"], a["Bm"], a["Qd"], a["Rd"])
    ref = rf.factor_plain(*fac)
    bwd = (a["A"], a["Bm"], ref.Ks, ref.Ls, ref.Ps, a["qx"], a["qu"], a["c"])
    fwd = (a["A"], a["Bm"], ref.Ks, rf.solve_bwd_plain(*bwd), a["c"], a["dx0"])
    return {
        "riccati_factor": (lambda: rf.riccati_factor_fused(*fac), lambda: rf.factor_plain(*fac),
                           fac, ("Ps", "Ks", "Ls")),
        "riccati_solve_bwd": (lambda: rf.riccati_solve_bwd_fused(*bwd),
                              lambda: rf.solve_bwd_plain(*bwd), bwd, ("kff",)),
        "riccati_solve_fwd": (lambda: rf.riccati_solve_fwd_fused(*fwd),
                              lambda: rf.solve_fwd_plain(*fwd), fwd, ("dxs", "dus")),
    }


def _bench_inputs(torch, B, dev):
    """bench.py's per-lane inputs (``_measure_config``), same generator."""
    rng = np.random.default_rng(0)
    poses = rng.normal(size=(B, 3)) * 0.1
    vels = rng.normal(size=(B, 3)) * 0.1
    trajs = np.zeros((B, N + 1, 3))
    trajs[:, 0, 0] = rng.uniform(0.3, 1.5, size=(B,))
    f32 = torch.float32
    return (torch.tensor(poses, dtype=f32, device=dev),
            torch.tensor(vels, dtype=f32, device=dev),
            torch.tensor(trajs, dtype=f32, device=dev),
            torch.ones(B, dtype=torch.int32, device=dev))


def _controller(torch, dev, dtype=None, geometry="diff"):
    """bench.py's controller for a geometry (``_build``), N=40, 8 IPM
    iterations."""
    import math

    from nmpc_nav_control_tpu_torch.control import make_controller

    kw = {
        "diff": dict(dist_b=0.27, tau_v=0.1, v_max=1.0, a_max=2.0,
                     q_diag=[10.0, 10.0, 5.0, 0, 0, 0, 0], r_diag=[1.0, 1.0]),
        "omni4": dict(l1_plus_l2=0.535, tau_v=0.1, v_max=1.0, a_max=1.0,
                      q_diag=[10.0, 10.0, 5.0] + [0.0] * 8, r_diag=[1.0] * 4),
        "tric": dict(dist_d=1.05, tau_v=0.1, tau_a=0.1, v_max=1.0, a_max=2.0,
                     alpha_min=-math.radians(60.0), alpha_max=math.radians(60.0),
                     dalpha_max=math.radians(90.0), q_diag=[10.0, 10.0, 5.0, 0, 0, 0, 0],
                     r_diag=[1.0, 1.0]),
    }[geometry]
    return make_controller(geometry, 1.0 / 40.0, N, ipm_iters=8,
                           dtype=dtype or torch.float32, device=dev, **kw)


def _set_route(route):
    """"1": the fused IPM sweeps (the default), "0": the Riccati solve."""
    os.environ["NMPC_TPU_TILED_IPM"] = route


def _time_pair(torch, kern, plain, device_time=True):
    """plain, kernel, kernel, plain on one card in one call: (kernel ms,
    plain ms, kernel device ms from the profiler or None)."""
    t = [_time_ms(torch, f) for f in (plain, kern, kern, plain)]
    dev_ms = _device_ms(torch, kern) if device_time else None
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, dev_ms


def _fleet_state(torch, sm, spec, cfg, lanes, dev):
    """``bench.py::_measure_fleet``'s lanes: one 50 m line at 0.5 m/s, set
    on every lane as a path set (request 1), and every robot at the origin,
    measurements valid."""
    from nmpc_nav_control_tpu_torch.paths import PathSegment, make_line_segment

    seg = make_line_segment((0.0, 0.0), (50.0, 0.0), velocity=0.5, device=dev)
    segs = PathSegment(*(
        torch.cat([x[None], torch.zeros((cfg.path_capacity - 1,) + x.shape, dtype=x.dtype,
                                        device=dev)])[None].expand(lanes, *((-1,) * (x.dim() + 1)))
        for x in seg))
    state = sm.on_path_set(sm.node_init(spec, cfg, lanes, torch.float32, dev), cfg, segs, 1, 1)
    flag = torch.ones(lanes, dtype=torch.bool, device=dev)
    zeros = torch.zeros(lanes, 3, device=dev)
    return state, sm.Measurements(zeros, zeros.clone(), zeros[:, 0].clone(), flag, flag, flag)


def _nav_ticks(torch, geometry, lanes, ticks, dev):
    """Eager chain, then the graphed chain, of ``node_tick`` at the fleet
    configuration; raises unless every lane stays FOLLOW_PATH with
    ``solve_ok`` and a finite ``kkt_res``, the graphed chain ends equal to
    the eager one bit for bit, the capture launched one controller tick's
    kernels and the eager chain ``ticks`` times that, and replays launch
    nothing."""
    from nmpc_nav_control_tpu_torch.control import GraphedNavigator
    from nmpc_nav_control_tpu_torch.control import state_machine as sm
    from nmpc_nav_control_tpu_torch.ops import _build

    what = f"phase 11 {geometry} B={lanes}"
    spec, data = _controller(torch, dev, geometry=geometry)
    cfg = sm.NavConfig()
    state0, meas = _fleet_state(torch, sm, spec, cfg, lanes, dev)
    sm.node_tick(spec, data, cfg, state0, meas)                 # first-call set-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def check(states, outs, how):
        status = torch.stack([s.status for s in states])
        ok = torch.stack([o.solve_ok for o in outs])
        kkt = torch.stack([o.kkt_res for o in outs])
        if not bool((status == sm.FOLLOW_PATH).all()):
            raise AssertionError(f"{what} {how}: lanes left FOLLOW_PATH: "
                                 f"{sorted(set(status.flatten().tolist()))}")
        if not bool(ok.all()) or not bool(torch.isfinite(kkt).all()):
            raise AssertionError(f"{what} {how}: {int((~ok).sum())} lane-ticks not solve_ok")
        return float(kkt.max())

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    state, states, outs = state0, [], []
    start.record()
    for _ in range(ticks):
        state, out = sm.node_tick(spec, data, cfg, state, meas)
        states.append(state)
        outs.append(out)
    end.record()
    end.synchronize()
    eager_ms = start.elapsed_time(end) / ticks
    eager_counts = _build.launch_counts()
    check(states, outs, "eager")

    nav = GraphedNavigator(spec, data, cfg, lanes)
    nav.load_state(state0)
    nav.load_measurements(meas)
    counts = nav.capture()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    g_states, g_outs = [], []
    start.record()
    for _ in range(ticks):
        g_state, g_out = nav.step()
        g_states.append(g_state._replace(status=g_state.status.clone()))
        g_outs.append(g_out._replace(solve_ok=g_out.solve_ok.clone(),
                                     kkt_res=g_out.kkt_res.clone()))
    end.record()
    end.synchronize()
    if _build.launch_counts():
        raise AssertionError(f"{what}: replays launched {_build.launch_counts()}")
    graphed_ms = start.elapsed_time(end) / ticks
    kkt_max = check(g_states, g_outs, "graphed")
    got, want = _leaves((nav.state, g_out)), _leaves((state, out))
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    gap = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    if not same:
        raise AssertionError(f"{what}: graphed chain departs from the eager one by {gap:.3e}")
    if counts != PER_TICK or eager_counts != {k: v * ticks for k, v in PER_TICK.items()}:
        raise AssertionError(f"{what}: launches at capture {counts}, eager {eager_counts}; "
                             f"expected {PER_TICK} a tick")
    split = _tick_breakdown(torch, nav.step)
    r = dict(eager_ms=eager_ms, graphed_ms=graphed_ms, launches=counts, kkt_max=kkt_max,
             device_ms=None if split is None else split[0],
             kernel_ms=None if split is None else split[1])
    share = ("device not measured" if split is None else
             f"device {split[0]:.3f} ms/tick (idle {100 * (1 - split[0] / graphed_ms):.1f}%), "
             f"port kernels {split[1]:.3f} ms ({100 * split[1] / graphed_ms:.1f}% of the tick)")
    print(f"{what}: {ticks} chained ticks, every lane FOLLOW_PATH and solve_ok, max kkt_res "
          f"{kkt_max:.3e}, launches at capture {counts}, eager {ticks} x one tick; "
          f"{graphed_ms:.3f} ms/tick graphed ({eager_ms:.3f} eager), "
          f"{lanes / graphed_ms * 1e3:.0f} ticks/s graphed, graphed = eager bit for bit; {share}")
    return r


def _nav_node_run(torch, dev):
    """One robot through ``runtime.NmpcNavControlNode`` on the card (its tick
    a ``GraphedNavigator`` replay at B=1) and on the CPU in lock step: one
    numpy plant (the diff RK4 plant of ``tests/test_state_machine.py``),
    driven by the card node's commands, feeds both the same measurements.
    Raises on an ERROR, on a status the two nodes disagree on, or if the
    card node never reaches IDLE."""
    import math

    from nmpc_nav_control_tpu_torch.runtime import (
        NmpcNavControlNode,
        ParametricPath,
        ParametricPathSet2,
        from_dict,
    )

    raw = dict(steering_geometry="diff", control_freq=40, tf_ini=1.0, rob_dist_between_wh=0.27,
               rob_wh_vel_time_const=0.1, rob_wh_max_vel=1.0, rob_wh_max_ace=2.0,
               cost_matrix_weights_state_diag=[10.0, 10.0, 5.0, 0, 0, 0, 0],
               cost_matrix_weights_input_diag=[1.0, 1.0], final_position_error=0.03,
               final_orientation_error=3.0)
    msg = ParametricPathSet2(paths=[ParametricPath("map", [0.0, 1.0], [0.0, 0.0], 0.5),
                                    ParametricPath("map", [1.0, 1.0], [0.0, 0.0], 0.5)],
                             request_id=1)
    nodes = {where: NmpcNavControlNode(from_dict(raw), device=d)
             for where, d in (("card", dev), ("cpu", "cpu"))}
    for node in nodes.values():
        node.on_path_no_stack_up_2(msg)

    def f(x, u):
        vb = 0.5 * (x[3] + x[4])
        return np.array([vb * math.cos(x[2]), vb * math.sin(x[2]), (x[4] - x[3]) / 0.27,
                         (u[0] - x[3]) / 0.1, (u[1] - x[4]) / 0.1])

    x, dt, gap, statuses = np.zeros(5), 1.0 / 40.0, 0.0, []
    for k in range(1200):
        meas = (tuple(x[:3]), ((x[3] + x[4]) / 2, 0.0, (x[4] - x[3]) / 0.27))
        (tw, st), (tw_cpu, st_cpu) = (n.tick(*meas) for n in nodes.values())
        if st.status != st_cpu.status or (tw is None) != (tw_cpu is None):
            raise AssertionError(f"phase 11 node tick {k}: card {st} {tw}, "
                                 f"CPU {st_cpu} {tw_cpu}")
        if st.status == 2:
            raise AssertionError(f"phase 11 node tick {k}: ERROR")
        statuses.append(st.status)
        if tw is not None:
            gap = max(gap, abs(tw.linear_x - tw_cpu.linear_x),
                      abs(tw.angular_z - tw_cpu.angular_z))
        if st.status == 0:
            break
        u = (tw.linear_x - 0.135 * tw.angular_z, tw.linear_x + 0.135 * tw.angular_z)
        k1 = f(x, u)
        k2 = f(x + dt / 2 * k1, u)
        k3 = f(x + dt / 2 * k2, u)
        x = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + f(x + dt * k3, u))
    if statuses[-1] != 0:
        raise AssertionError("phase 11 node: the robot never reached IDLE")
    stats, cpu = nodes["card"].timing_stats(), nodes["cpu"].timing_stats()
    print(f"phase 11 node, diff N=40, two-line path on the card (graphed) and the CPU in lock "
          f"step: IDLE after {len(statuses)} ticks, no ERROR, the same status at every tick, end "
          f"pose ({x[0]:.4f}, {x[1]:.4f}), max |cmd_card - cmd_cpu| {gap:.3e}; card node "
          f"tick p50 {stats['p50_ms']:.3f} ms, p99 {stats['p99_ms']:.3f} ms, max "
          f"{stats['max_ms']:.3f} ms (host clock, budget 25 ms; the first tick captures), CPU "
          f"node tick p50 {cpu['p50_ms']:.3f} ms")
    return dict(ticks=len(statuses), end_pose=x[:3].tolist(), max_cmd_gap=gap,
                card_tick_ms=stats, cpu_tick_ms=cpu)


def _phase_nav(torch, dev, controller_ms):
    """Phase 11; ``controller_ms`` holds phase 3's graphed controller ticks
    by B."""
    out = {}
    for geometry, lanes, ticks in (("diff", 2048, TICKS), ("diff", 1, TICKS),
                                   ("omni4", 2048, NAV_TICKS_SHORT),
                                   ("tric", 2048, NAV_TICKS_SHORT)):
        t0 = time.perf_counter()
        out[f"{geometry}/{lanes}"] = r = _nav_ticks(torch, geometry, lanes, ticks, dev)
        r["seconds"] = time.perf_counter() - t0
        if geometry == "diff":
            r["path_ms"] = r["graphed_ms"] - controller_ms[str(lanes)]
            print(f"phase 11 diff B={lanes}: graphed node tick {r['graphed_ms']:.3f} ms - graphed "
                  f"controller tick {controller_ms[str(lanes)]:.3f} ms (phase 3) = "
                  f"{r['path_ms']:.3f} ms of path subsystem")
    one = out["diff/1"]["graphed_ms"]
    if not one < BUDGET_MS:
        raise AssertionError(f"phase 11: the graphed B=1 node tick takes {one:.3f} ms, not under "
                             f"the {BUDGET_MS} ms budget")
    t0 = time.perf_counter()
    out["node"] = _nav_node_run(torch, dev)
    out["node"]["seconds"] = time.perf_counter() - t0
    print("phase 11 seconds: " + ", ".join(f"{k} {v['seconds']:.1f}" for k, v in out.items()))
    return out


# ---- Phase 12: the host runtime and the command line at N=80. ----

GOAL = ("1.0", "0.0", "0.0")
PATH = ("0", "0", "1", "0", "1", "1")
IDLE_FACTOR = 1.5
CHECKPOINT_TICKS = 40            # phase 12 (e): ticks before and after the checkpoint
LOCKSTEP_TICKS = 12              # phase 12 (f): card and CPU node ticks in lock step

def _cli(argv):
    """(rc, stdout lines) of the port's command line run in this process."""
    from nmpc_nav_control_tpu_torch.__main__ import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(list(argv))
    return rc, buf.getvalue().splitlines()


def _prepare(torch):
    """Phase 12 (a): ``prepare config/models.yaml``."""
    rc, lines = _cli(["prepare", os.path.join(ROOT, "config", "models.yaml")])
    for line in lines:
        print(f"phase 12 prepare | {line}")
    captured = {m.group(1): (float(m.group(2)), ast.literal_eval(m.group(3))) for m in (
        re.match(r"\[(\w+)\] captured one tick in a CUDA graph: ([\d.]+)s, launches (\{.*\})",
                 line) for line in lines) if m}
    smoke = {m.group(1): m.group(2) for m in (
        re.match(r"\[(\w+)\] smoke solve OK: (cmd=.*)", line) for line in lines) if m}
    if rc != 0 or set(captured) != set(smoke) or set(smoke) != {"diff", "omni4", "tric"}:
        raise AssertionError(f"phase 12 prepare: rc {rc}, captured {sorted(captured)}, "
                             f"smoke {sorted(smoke)}")
    for geom, (secs, launches) in captured.items():
        if launches != PER_TICK:
            raise AssertionError(f"phase 12 prepare {geom}: launches at capture {launches}")
        print(f"phase 12 prepare {geom}: capture {secs:.3f} s, launches {launches}, smoke "
              f"{smoke[geom]}")
    return {g: dict(capture_s=c[0], smoke=smoke[g]) for g, c in captured.items()}


def _run(torch, what, geometry, args, jax_ticks, ticks):
    """Phase 12 (b), (c): ``run`` on the card with the native timer, to IDLE."""
    from nmpc_nav_control_tpu_torch.ops import _build
    from nmpc_nav_control_tpu_torch.control.graph import WARMUP_TICKS
    from nmpc_nav_control_tpu_torch.runtime import load_config

    cfg_path = os.path.join(ROOT, "config", f"runtime_{geometry}.yaml")
    config = load_config(cfg_path)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rc, lines = _cli(["run", "--config", cfg_path, "--ticks", str(ticks), "--log-level",
                      "warning", *args])
    seconds = time.perf_counter() - t0
    counts = _build.launch_counts()
    for line in lines:
        print(f"phase 12 {what} | {line}")
    text = "\n".join(lines)
    boundaries = [(round(float(t) / config.dt), int(st)) for t, st in
                  re.findall(r"t=\s*([\d.]+)s pose=\(.*\) status=(\d)", text)]
    idle = next((k for k, st in boundaries if st == 0), None)
    capture = re.search(r"capture cycle: ([\d.]+)ms \(.*launches (\{.*\})\)", text)
    steady = re.search(r"cycles after the capture: count=(\d+) p50=([\d.]+)ms p99=([\d.]+)ms "
                       r"max=([\d.]+)ms violations=(\d+)", text)
    overruns = re.search(r"overruns=(\d+)", text)
    if rc != 0 or capture is None or steady is None or overruns is None:
        raise AssertionError(f"phase 12 {what}: rc {rc}, output {lines}")
    launches = ast.literal_eval(capture.group(2))
    r = dict(idle_tick_at_most=idle, capture_ms=float(capture.group(1)), launches=launches,
             run_launches=counts, p50_ms=float(steady.group(2)), p99_ms=float(steady.group(3)),
             max_ms=float(steady.group(4)), violations=int(steady.group(5)),
             overruns=int(overruns.group(1)), seconds=seconds, jax_ticks=jax_ticks)
    err = re.search(r"final position error: ([\d.]+) cm", text)
    if err is not None:
        r["final_error_cm"] = float(err.group(1))
    faults = []
    if any(st == 2 for _, st in boundaries):
        faults.append("ERROR status")
    if idle is None or "goal reached -> Idle" not in text:
        faults.append("no IDLE")
    elif jax_ticks is not None and idle > IDLE_FACTOR * jax_ticks:
        faults.append(f"IDLE seen at tick {idle}, over {IDLE_FACTOR} x {jax_ticks} (JAX)")
    if err is not None and not float(err.group(1)) <= 100 * config.nav.final_position_error:
        faults.append(f"final error {err.group(1)} cm")
    if launches != PER_TICK:
        faults.append(f"launches at capture {launches}")
    if counts != {k: v * (WARMUP_TICKS + 1) for k, v in PER_TICK.items()}:
        faults.append(f"the run launched {counts}, not {WARMUP_TICKS} warm-up ticks' and the "
                      f"capture's")
    if "native timer:" not in text:
        faults.append("not on the native timer")
    if not r["p50_ms"] < BUDGET_MS:
        faults.append(f"p50 cycle {r['p50_ms']} ms")
    if faults:
        raise AssertionError(f"phase 12 {what}: {'; '.join(faults)}")
    print(f"phase 12 {what}: IDLE by tick {idle} (JAX CLI on the CPU: {jax_ticks}), no ERROR, "
          f"capture {r['capture_ms']:.1f} ms with launches {launches}, cycles after it p50 "
          f"{r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms, max {r['max_ms']:.3f} ms (host "
          f"clock), {r['violations']} over 25 ms, {r['overruns']} overruns, native timer, "
          f"{seconds:.1f} s")
    return r


def _tick_profile(torch, geometry):
    """Phase 12 (d): one graphed N=80 node tick at B=1, each route."""
    from nmpc_nav_control_tpu_torch.runtime import NmpcNavControlNode, PoseStamped, load_config

    config = load_config(os.path.join(ROOT, "config", f"runtime_{geometry}.yaml"))
    node = NmpcNavControlNode(config)
    node.on_pose_goal(PoseStamped("map", 1.0, 0.0, 0.0))
    out = {}
    for route, per_tick in (("1", PER_TICK), ("0", RICCATI_PER_TICK)):
        _set_route(route)
        node.tick((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))             # captures for this route
        if node.capture_launches != per_tick:
            raise AssertionError(f"phase 12 tick {geometry} route {route}: launches at capture "
                                 f"{node.capture_launches}")
        nav = node._graphed
        graphed_ms = _time_ms(torch, nav.step)
        split = _tick_breakdown(torch, nav.step)
        label = "Riccati" if route == "0" else "default"
        what = f"phase 12 tick {geometry} N={config.horizon} B=1 {label} route"
        r = dict(graphed_ms=graphed_ms, launches=node.capture_launches)
        if split is None:
            print(f"{what}: {graphed_ms:.3f} ms/tick graphed; device not measured")
        else:
            device_ms, kernel_ms, per = split
            r.update(device_ms=device_ms, kernel_ms=kernel_ms,
                     kernels={k: dict(ms=v[0], launches=v[1]) for k, v in per.items()})
            each = ", ".join(f"{k} {v[0]:.4f} ms in {v[1]:g} launches" for k, v in per.items())
            print(f"{what}: {graphed_ms:.3f} ms/tick graphed (CUDA events, 20 replays), "
                  f"device {device_ms:.3f} ms (idle "
                  f"{100 * (1 - device_ms / graphed_ms):.1f}%), port kernels {kernel_ms:.3f} ms "
                  f"({100 * kernel_ms / graphed_ms:.1f}% of the tick): {each}")
        out[label] = r
    _set_route("1")
    return out


def _path_msg():
    """``PATH`` as the node's path message: one straight segment per leg."""
    from nmpc_nav_control_tpu_torch.runtime import ParametricPath, ParametricPathSet2

    pts = [float(v) for v in PATH]
    pts = list(zip(pts[0::2], pts[1::2]))
    return ParametricPathSet2(paths=[ParametricPath("map", [p0[0], p1[0] - p0[0]],
                                                    [p0[1], p1[1] - p0[1]], 0.5)
                                     for p0, p1 in zip(pts[:-1], pts[1:])], request_id=1)


def _checkpoint_resume(torch):
    """Phase 12 (e): save a graphed diff node mid-path, load it into a fresh
    one beside a copy of the plant, and hold the next ticks against the
    uninterrupted node bit for bit."""
    from nmpc_nav_control_tpu_torch.runtime import (
        NmpcNavControlNode,
        RealTimeExecutor,
        load_config,
    )
    from nmpc_nav_control_tpu_torch.runtime.checkpoint import load_state, save_state
    from nmpc_nav_control_tpu_torch.runtime.simulation import SimulatedRobot

    config = load_config(os.path.join(ROOT, "config", "runtime_diff.yaml"))
    msg = _path_msg()

    def loop(node, robot):
        return RealTimeExecutor(node, robot, robot, use_native_timer=False)

    def ticks(ex, n):
        seen = []
        for _ in range(n):
            ex.run(1)
            seen.append((ex.node.last_cmd, tuple(float(v) for v in ex.provider.pose),
                         ex.provider.last_status))
        return seen

    node = NmpcNavControlNode(config)
    node.on_path_no_stack_up_2(msg)
    robot = SimulatedRobot(node)
    ex = loop(node, robot)
    ticks(ex, CHECKPOINT_TICKS)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = os.path.join(d, "node.npz")
        save_state(path, node.state)
        plant = (robot.pose.copy(), robot.act.copy(), robot.sim_time, robot._last_refs.copy())
        want = ticks(ex, CHECKPOINT_TICKS)
        fresh = NmpcNavControlNode(config)
        fresh.set_state(load_state(path, fresh.state))
    copy = SimulatedRobot(fresh)
    copy.pose[:], copy.act[:], copy.sim_time, copy._last_refs = plant
    got = ticks(loop(fresh, copy), CHECKPOINT_TICKS)
    if got != want:
        k = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
        raise AssertionError(f"phase 12 checkpoint: resumed tick {k} {got[k]}, uninterrupted "
                             f"{want[k]}")
    if want[-1][2].status == 2:
        raise AssertionError("phase 12 checkpoint: ERROR on the path")
    print(f"phase 12 checkpoint: diff N={config.horizon} on the path, saved after "
          f"{CHECKPOINT_TICKS} ticks, loaded into a fresh graphed node: {CHECKPOINT_TICKS} more "
          f"ticks with commands and plant poses equal to the uninterrupted node's bit for "
          f"bit (last status {want[-1][2].status}, pose {want[-1][1]})")
    return dict(ticks=CHECKPOINT_TICKS, last_status=want[-1][2].status)


def _lockstep(torch):
    """Phase 12 (f): the graphed N=80 diff node on the card and an eager one
    on the CPU, fed the same plant (driven by the card's commands) on the
    path, tick by tick."""
    import torch_golden
    from nmpc_nav_control_tpu_torch.runtime import NmpcNavControlNode, load_config
    from nmpc_nav_control_tpu_torch.runtime.simulation import SimulatedRobot

    config = load_config(os.path.join(ROOT, "config", "runtime_diff.yaml"))
    card, cpu = NmpcNavControlNode(config), NmpcNavControlNode(config, device="cpu")
    for node in (card, cpu):
        node.on_path_no_stack_up_2(_path_msg())
    robot = SimulatedRobot(card)
    gap, bound = 0.0, 5 * torch_golden.U_TOL
    for k in range(LOCKSTEP_TICKS):
        pose, vel, _ = robot.get_state()
        (tw, st), (tw_cpu, st_cpu) = card.tick(pose, vel), cpu.tick(pose, vel)
        if st.status != st_cpu.status or (tw is None) != (tw_cpu is None):
            raise AssertionError(f"phase 12 lock step tick {k}: card {st} {tw}, "
                                 f"CPU {st_cpu} {tw_cpu}")
        if st.status == 2:
            raise AssertionError(f"phase 12 lock step tick {k}: ERROR")
        if tw is not None:
            gap = max(gap, abs(tw.linear_x - tw_cpu.linear_x),
                      abs(tw.angular_z - tw_cpu.angular_z))
            robot.publish_cmd_vel(tw)
        robot.publish_status(st)
    if not gap <= bound:
        raise AssertionError(f"phase 12 lock step: max |cmd_card - cmd_cpu| {gap:.3e} over "
                             f"{bound:.1e}")
    print(f"phase 12 lock step: diff N={config.horizon} on the path, the graphed card node and "
          f"the CPU node: {LOCKSTEP_TICKS} ticks with the same status (last {st.status}), max "
          f"|cmd_card - cmd_cpu| {gap:.3e} (bound {bound:.1e}), pose "
          f"({robot.pose[0]:.4f}, {robot.pose[1]:.4f}, {robot.pose[2]:.4f})")
    return dict(ticks=LOCKSTEP_TICKS, max_cmd_gap=gap, last_status=st.status)


def _phase_runtime(torch):
    """Phase 12."""
    out, t0 = {}, time.perf_counter()
    out["prepare"] = _prepare(torch)
    for geometry in ("diff", "omni4", "tric"):
        out[f"run/{geometry}"] = _run(torch, f"run {geometry}", geometry, ["--goal", *GOAL],
                                      JAX_IDLE_TICKS[geometry], 200)
    out["run/path"] = _run(torch, "run diff path", "diff", ["--path", *PATH],
                           JAX_IDLE_TICKS["path"], 400)
    for geometry in ("diff", "omni4", "tric"):
        out[f"tick/{geometry}"] = _tick_profile(torch, geometry)
    out["checkpoint"] = _checkpoint_resume(torch)
    out["lockstep"] = _lockstep(torch)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 12: {out['seconds']:.1f} s")
    return out


# ---- Phase 13: the parallel layers and the simulation demos. ----

FLEET_LANES = {"diff": 2048, "omni4": 1024, "tric": 1024}   # BASELINE.json's 4096 scenarios
FLEET_TICKS = 40
SMALL_LANES = 8                  # (a)'s lock step and (c)'s I/O, lanes a group
LOCKSTEP_CMD_TOL = 2.5e-2        # phase 12 (f)'s command bound
LONG_N, LONG_B = 512, 256        # (b): mesh2d's "N=512 look-ahead studies"
DU_MAX_TOL, DU_MEAN_TOL = 2.5e-3, 4e-5   # the golden command bound (ROADMAP section 3)
# (b)'s QP in f32 through the JAX package's vmapped solve_box_qp (8
# iterations, stage_parallel=True; on a CPU) against its f64 solve: max and
# mean |du - du_f64|.  The f32 IPM resolves du near active bounds only to
# this at N=512, in the JAX package as in the port, so the port is held to
# twice it (ROADMAP section 3).
JAX_F32_DU = (6.913029716491659e-03, 2.5286428405063385e-05)
MESH2D_TOL = 1e-6                # (b): the 2-D solve against the 1-D one, f32
# (d): the JAX script examples/sim_pose_goal.py on a CPU (f32, N=40, --ticks
# 600, the goal (1, 0.3, 0.5)): its final position error in m at --noise 0,
# and (min, median, max) over PRNG keys 0..31 at --noise 0.05 (key 0 is the
# script's own).
JAX_POSE_GOAL_NOISE0 = {"diff": 0.023703958306494823, "omni4": 0.013752213482529363,
                        "tric": 0.008871964685316992}
JAX_POSE_GOAL_BAND = {"diff": (0.009156, 0.022380, 0.035307),
                      "omni4": (0.007651, 0.014278, 0.021626),
                      "tric": (0.002821, 0.011880, 0.023983)}
NOISE0_TOL = 1e-3                # m: f32 rounding moves the settled point far less
BAND_LANES = 32                  # noise streams of the port's band
DEMO_TICKS = 600
PATH_END = (2.0, 0.3)            # sim_follow_path's path end
PATH_END_TOL = 0.03              # the demo node's final_position_error


def _fleet_lanes(torch, sm, group, dev):
    """(NodeState, plants [B, nxp]) of a group: the first half GoToPose to
    distinct goals on a ring of radius 0.5-1.95 m (under NavConfig's 2 m
    goal limit), each facing outward, robots at the origin; the second half
    FollowPath on distinct 2 m lines at 0.5 m/s from the origin, each robot
    at its line's start facing along it (omni4 holding that heading)."""
    import math

    from nmpc_nav_control_tpu_torch.examples import sim_pose_goal as demo
    from nmpc_nav_control_tpu_torch.parallel.sharding import tree_map
    from nmpc_nav_control_tpu_torch.paths import PathSegment, make_line_segment

    B, cap = group.batch, group.cfg.path_capacity
    half = B // 2
    k = torch.arange(half, dtype=torch.float64)
    phi = 2 * math.pi * k / half
    r = 0.5 + 1.45 * k / max(half - 1, 1)
    goals = torch.stack([r * torch.cos(phi), r * torch.sin(phi), phi], -1).float()
    psi = [2 * math.pi * j / (B - half) - math.pi for j in range(B - half)]
    lines = [make_line_segment((0.0, 0.0), (2 * math.cos(a), 2 * math.sin(a)), velocity=0.5,
                               theta_holonomic=a, device="cpu") for a in psi]
    segs = PathSegment(*(torch.cat([torch.stack(x)[:, None],
                                    torch.zeros((len(x), cap - 1) + x[0].shape, dtype=x[0].dtype)],
                                   1) for x in zip(*lines)))
    init = sm.node_init(group.spec, group.cfg, B, torch.float32, "cpu")
    gtp = sm.on_goal_pose(tree_map(lambda x: x[:half], init), goals)
    fp = sm.on_path_set(tree_map(lambda x: x[half:], init), group.cfg, segs, 1, 1)
    state = tree_map(lambda a, b: torch.cat([a, b]), gtp, fp)
    plants = torch.zeros(B, demo.plant_size(group.spec.geometry))
    plants[half:, 2] = torch.tensor(psi)
    return _to(state, dev), plants.to(dev)


def _to(x, dev):
    from nmpc_nav_control_tpu_torch.parallel.sharding import tree_map

    return tree_map(lambda t: t.to(dev), x)


def _clone(x):
    from nmpc_nav_control_tpu_torch.parallel.sharding import tree_map

    return tree_map(lambda t: t.clone(), x)


def _fleet_meas(torch, sm, geometry, plants, p):
    """The measurements a group's controllers read from its plants."""
    from nmpc_nav_control_tpu_torch.examples import sim_pose_goal as demo

    pose, vel, steer = demo.measure(geometry, plants, p)
    flag = torch.ones(plants.shape[0], dtype=torch.bool, device=plants.device)
    return sm.Measurements(pose, vel, steer, flag, flag, flag)


def _fleet_advance(torch, geometry, plants, out, p):
    """Plants one step on: each follows its published command (zero where
    none is published), noise-free."""
    from nmpc_nav_control_tpu_torch.examples import sim_pose_goal as demo

    refs = demo.references(geometry, out.cmd, p)
    refs = torch.where(out.publish_cmd[:, None], refs, 0.0)
    return demo.plant_step(geometry, plants, refs, p.to(plants.device))


def _fleet_check(torch, sm, what, states, outs):
    """Every lane solve_ok with a finite kkt_res at every tick, no ERROR."""
    for t, (st, out) in enumerate(zip(states, outs)):
        bad = int((~out.solve_ok).sum()) + int((~torch.isfinite(out.kkt_res)).sum())
        if bad or bool((st.status == sm.ERROR).any()):
            raise AssertionError(f"{what} tick {t}: {bad} lanes not solve_ok or non-finite, "
                                 f"statuses {sorted(set(st.status.tolist()))}")


def _fleet_run(torch, sm, groups, fleet, ticks, dev):
    """``ticks`` moving ticks of a fleet (graphed where ``fleet`` is given,
    else eager ``node_tick``): per group the (state, outputs) of every tick,
    cloned, and the last measurements."""
    runs = {g: [] for g in groups}
    lanes = {g: _fleet_lanes(torch, sm, grp, dev) for g, grp in groups.items()}
    states = {g: s for g, (s, _) in lanes.items()}
    plants = {g: pl for g, (_, pl) in lanes.items()}
    if fleet is not None:
        for g, s in states.items():
            fleet.set_states(g, s)
    for _ in range(ticks):
        meas = {g: _fleet_meas(torch, sm, g, plants[g], grp.data.p) for g, grp in groups.items()}
        if fleet is not None:
            outs = fleet.tick(meas)
            news = fleet.states
        else:
            outs, news = {}, {}
            for g, grp in groups.items():
                news[g], outs[g] = sm.node_tick(grp.spec, grp.data, grp.cfg, states[g], meas[g])
            states = news
        for g, grp in groups.items():
            runs[g].append((_clone(news[g]), _clone(outs[g])))
            plants[g] = _fleet_advance(torch, g, plants[g], outs[g], grp.data.p)
    return runs, meas, plants


def _fleet_groups(torch, lanes, dev):
    from nmpc_nav_control_tpu_torch.control import state_machine as sm
    from nmpc_nav_control_tpu_torch.parallel.fleet import FleetGroup

    return {g: FleetGroup(*_controller(torch, dev, geometry=g), cfg=sm.NavConfig(), batch=n)
            for g, n in lanes.items()}


def _phase_fleet(torch, dev):
    """Phase 13 (a): the 4096-lane mixed-geometry fleet, moving, graphed
    against eager, timed; 8 lanes a group on the card and the CPU in lock
    step; on a mesh of real cards where there are two or more."""
    from nmpc_nav_control_tpu_torch.control import state_machine as sm
    from nmpc_nav_control_tpu_torch.control.graph import WARMUP_TICKS
    from nmpc_nav_control_tpu_torch.ops import _build
    from nmpc_nav_control_tpu_torch.parallel import gather, make_mesh
    from nmpc_nav_control_tpu_torch.parallel.fleet import Fleet

    out, t0 = {}, time.perf_counter()
    groups = _fleet_groups(torch, FLEET_LANES, dev)
    fleet = Fleet(groups)
    # Eager chain first, counted: 40 ticks x three groups x one tick's launches.
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    eager, _, _ = _fleet_run(torch, sm, groups, None, FLEET_TICKS, dev)
    eager_counts = _build.launch_counts()
    want = {k: v * FLEET_TICKS * len(groups) for k, v in PER_TICK.items()}
    if eager_counts != want:
        raise AssertionError(f"phase 13 fleet eager: launches {eager_counts}, expected {want}")
    # Graphed chain: the first tick captures each group after its warm-up
    # ticks, each launching one tick's kernels; the replays launch nothing,
    # so the chain counts (warm-ups + 1) x three groups x one tick.
    _build.reset_launch_counts()
    graphed, meas, _ = _fleet_run(torch, sm, groups, fleet, FLEET_TICKS, dev)
    counts = _build.launch_counts()
    captures = {g: navs[0].capture_launches for g, navs in fleet.navigators.items()}
    want = {k: v * (WARMUP_TICKS + 1) * len(groups) for k, v in PER_TICK.items()}
    if any(c != PER_TICK for c in captures.values()) or counts != want:
        raise AssertionError(f"phase 13 fleet: launches at capture {captures}, in the chain "
                             f"{counts}; expected {PER_TICK} a capture, {want} in all")
    for g in groups:
        _fleet_check(torch, sm, f"phase 13 fleet {g} eager", *zip(*eager[g]))
        _fleet_check(torch, sm, f"phase 13 fleet {g} graphed", *zip(*graphed[g]))
        got, ref = _leaves(graphed[g][-1]), _leaves(eager[g][-1])
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            gap = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, ref))
            raise AssertionError(f"phase 13 fleet {g}: graphed chain departs from the eager "
                                 f"one by {gap:.3e}")
    moved = {g: float(gather(graphed[g][-1][1].cmd.v).abs().max()) for g in groups}
    statuses = {g: sorted(set(graphed[g][-1][0].status.tolist())) for g in groups}

    # Timing: 20 chained fleet ticks graphed and eager, each group alone.
    states = {g: graphed[g][-1][0] for g in groups}
    graphed_ms = _time_ms(torch, lambda: fleet.tick(meas))

    def eager_tick():
        for g, grp in groups.items():
            states[g], _ = sm.node_tick(grp.spec, grp.data, grp.cfg, states[g], meas[g])

    eager_ms = _time_ms(torch, eager_tick)
    alone = {g: _time_ms(torch, navs[0].step) for g, navs in fleet.navigators.items()}
    split = _tick_breakdown(torch, lambda: fleet.tick(meas))
    lanes = sum(FLEET_LANES.values())
    share = ("device not measured" if split is None else
             f"device {split[0]:.3f} ms/tick (idle {100 * (1 - split[0] / graphed_ms):.1f}%), "
             f"port kernels {split[1]:.3f} ms ({100 * split[1] / graphed_ms:.1f}% of the tick)")
    print(f"phase 13 fleet diff {FLEET_LANES['diff']} + omni4 {FLEET_LANES['omni4']} + tric "
          f"{FLEET_LANES['tric']}, N={N}, moving: {FLEET_TICKS} ticks graphed and eager, every "
          f"lane solve_ok and finite kkt_res, no ERROR, last statuses {statuses}, max |v| "
          f"{moved}; launches at capture {captures}, replays none, eager {FLEET_TICKS} x 3 "
          f"groups x one tick; graphed = eager bit for bit")
    print(f"phase 13 fleet tick: {graphed_ms:.3f} ms graphed ({eager_ms:.3f} eager), "
          f"{lanes / graphed_ms * 1e3:.0f} scenario ticks/s graphed; groups alone "
          + ", ".join(f"{g} {ms:.3f}" for g, ms in alone.items())
          + f" ms, sum {sum(alone.values()):.3f} ms; {share}")
    out.update(graphed_ms=graphed_ms, eager_ms=eager_ms, alone_ms=alone,
               scenario_ticks_per_s=lanes / graphed_ms * 1e3, launches=captures,
               device_ms=None if split is None else split[0],
               kernel_ms=None if split is None else split[1],
               kernels=None if split is None else {k: v[0] for k, v in split[2].items()})
    out["lockstep"] = _fleet_lockstep(torch, sm, dev)
    if torch.cuda.device_count() >= 2:
        out["mesh"] = _fleet_on_cards(torch, sm, dev, make_mesh)
    out["seconds"] = time.perf_counter() - t0
    return out


def _fleet_lockstep(torch, sm, dev):
    """8 lanes a group, graphed on the card and eager on the CPU, 12 ticks:
    one set of plants on the CPU, driven by the card's commands, feeds both."""
    from nmpc_nav_control_tpu_torch.parallel.fleet import Fleet

    small = {g: SMALL_LANES for g in FLEET_LANES}
    fleets = {where: Fleet(_fleet_groups(torch, small, d)) for where, d in
              (("card", dev), ("cpu", "cpu"))}
    plants = {}
    for g, grp in fleets["cpu"].groups.items():
        state, plants[g] = _fleet_lanes(torch, sm, grp, "cpu")
        for f in fleets.values():
            f.set_states(g, state)
    gap = 0.0
    for k in range(LOCKSTEP_TICKS):
        meas = {g: _fleet_meas(torch, sm, g, plants[g], grp.data.p)
                for g, grp in fleets["cpu"].groups.items()}
        card = fleets["card"].tick({g: _to(m, dev) for g, m in meas.items()})
        cpu = fleets["cpu"].tick(meas)
        for g in meas:
            oc, oh = _to(card[g], "cpu"), cpu[g]
            if not torch.equal(oc.status_code, oh.status_code) or not torch.equal(
                    oc.publish_cmd, oh.publish_cmd):
                raise AssertionError(f"phase 13 lock step {g} tick {k}: statuses "
                                     f"{oc.status_code.tolist()} (card), "
                                     f"{oh.status_code.tolist()} (CPU)")
            gap = max(gap, max(float((a - b).abs().max()) for a, b in zip(oc.cmd, oh.cmd)))
            plants[g] = _fleet_advance(torch, g, plants[g], oc, fleets["cpu"].groups[g].data.p)
    if not gap <= LOCKSTEP_CMD_TOL:
        raise AssertionError(f"phase 13 lock step: max |cmd_card - cmd_cpu| {gap:.3e}")
    print(f"phase 13 fleet lock step, {SMALL_LANES} lanes a group, card (graphed) and CPU "
          f"(eager): {LOCKSTEP_TICKS} ticks with the same statuses, max |cmd_card - cmd_cpu| "
          f"{gap:.3e} (bound {LOCKSTEP_CMD_TOL:.1e})")
    return dict(ticks=LOCKSTEP_TICKS, max_cmd_gap=gap)


def _fleet_on_cards(torch, sm, dev, make_mesh):
    """Where there are two cards or more: 8 lanes a group on a data mesh over
    every card against the same lanes on one card, 3 ticks."""
    from nmpc_nav_control_tpu_torch.parallel import gather
    from nmpc_nav_control_tpu_torch.parallel.fleet import Fleet

    small = {g: SMALL_LANES for g in FLEET_LANES}
    one = _fleet_run(torch, sm, _fleet_groups(torch, small, dev),
                     Fleet(_fleet_groups(torch, small, dev)), 3, dev)[0]
    groups = _fleet_groups(torch, small, dev)
    many = _fleet_run(torch, sm, groups, Fleet(groups, mesh=make_mesh()), 3, dev)[0]
    gap = 0.0
    for g in groups:
        for (s1, o1), (s2, o2) in zip(one[g], many[g]):
            o2 = gather(o2, dev)
            if not torch.equal(o1.status_code, o2.status_code):
                raise AssertionError(f"phase 13 fleet on {torch.cuda.device_count()} cards "
                                     f"{g}: statuses differ from one card")
            gap = max(gap, max(float((a - b).abs().max()) for a, b in zip(o1.cmd, o2.cmd)))
    if not gap <= LOCKSTEP_CMD_TOL:
        raise AssertionError(f"phase 13 fleet on cards: max |cmd gap| {gap:.3e}")
    print(f"phase 13 fleet on a data mesh over {torch.cuda.device_count()} cards: statuses "
          f"equal to one card's, max |cmd gap| {gap:.3e}")
    return dict(cards=torch.cuda.device_count(), max_cmd_gap=gap)


def _long_qp(torch, dev, dtype, B, N, seed=512):
    """A diff box QP at a long horizon: the port's diff model (bench.py's
    dist_b and tau_v) linearized by RK4 and forward sensitivities along a
    seeded trajectory (slow random wheel-acceleration references, the
    states perturbed by 1e-3 so the dynamics carry residuals), bench.py's Q
    and R diagonals, seeded gradients (large enough that inputs reach
    their bound on most lanes); the wheel-reference and input bounds of
    its controller in delta form."""
    from torch.func import jacfwd, vmap

    from nmpc_nav_control_tpu_torch.models import diff
    from nmpc_nav_control_tpu_torch.ocp.integrator import make_discrete_dynamics
    from nmpc_nav_control_tpu_torch.qp import BoxQP

    f64 = torch.float64
    rng = np.random.default_rng(seed)
    p = torch.tensor([0.27, 0.1], dtype=f64)
    F = make_discrete_dynamics(diff.f, 1.0 / 40.0)
    step = vmap(lambda x, u: F(x, u, p))
    t = np.arange(N) / 40.0
    us = torch.tensor(0.5 * np.sin(rng.uniform(2.0, 8.0, (B, 1, 2)) * t[None, :, None]
                                   + rng.uniform(0, 2 * np.pi, (B, 1, 2))), dtype=f64)
    xs = [torch.tensor(rng.normal(size=(B, 7)) * 0.1, dtype=f64)]
    for k in range(N):
        xs.append(step(xs[-1], us[:, k]))
    xs = torch.stack(xs, 1) + torch.tensor(rng.normal(size=(B, N + 1, 7)) * 1e-3, dtype=f64)
    X, U = xs[:, :-1].reshape(-1, 7), us.reshape(-1, 2)
    A, Bm = vmap(jacfwd(lambda x, u: F(x, u, p), argnums=(0, 1)))(X, U)
    c = step(X, U).reshape(B, N, 7) - xs[:, 1:]
    q = torch.tensor([10.0, 10.0, 5.0, 0, 0, 0, 0], dtype=f64)
    qu = torch.tensor(rng.normal(size=(B, N, 2)), dtype=f64)
    ref_x = xs[:, 1:, 5:7]
    qp = BoxQP(A=A.reshape(B, N, 7, 7), B=Bm.reshape(B, N, 7, 2), c=c,
               Qd=q.expand(B, N + 1, 7).clone(),
               qx=q * torch.tensor(rng.normal(size=(B, N + 1, 7)) * 0.1, dtype=f64),
               Rd=torch.ones(B, N, 2, dtype=f64), qu=qu,
               dx0=torch.tensor(rng.normal(size=(B, 7)) * 0.01, dtype=f64),
               lbx=-1.0 - ref_x, ubx=1.0 - ref_x, lbu=-2.0 - us, ubu=2.0 - us)
    return BoxQP(*(x.to(dev, dtype).contiguous() for x in qp)), (us.to(dev, dtype), (5, 6), (0, 1))


def _top_kernels(torch, fn, n=3):
    """(device ms per call of ``fn``, [(kernel, ms per call, share)] of the
    ``n`` costliest) from one traced call; None where the trace shows no
    device time."""
    rows = [(e.key, e.self_device_time_total / 1000.0) for e in _profile(torch, fn, 1)
            if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(ms for _, ms in rows)
    if total <= 0:
        return None
    top = sorted(rows, key=lambda r: -r[1])[:n]
    return total, [(k[:60], ms, ms / total) for k, ms in top]


def _solve_ms(torch, solve, what, reps=5):
    """(ms per solve from ``reps`` chained replays of a CUDA graph of
    ``solve``, "graphed", the replay), or, where the capture fails, as many
    eager calls, the reason and ``solve``."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            solve()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            solve()
    except RuntimeError as e:                    # timed eager instead, and said so
        torch.cuda.synchronize()
        reason = str(e).splitlines()[0][:160]
        print(f"phase 13 {what}: the capture failed ({reason}); timed eager")
        return _time_ms(torch, solve, reps), f"eager ({reason})", solve
    return _time_ms(torch, graph.replay, reps), "graphed", graph.replay


def _phase_long_horizon(torch, dev, kernels):
    """Phase 13 (b): the N=512 stage-parallel solve against the serial
    Riccati route (kernels 6-8) and the f64 referee; kernels 6-8 against
    their plain versions at N=512; the 2-D mesh solve."""
    from nmpc_nav_control_tpu_torch.ops import _build
    from nmpc_nav_control_tpu_torch.ops import riccati_fused as rf
    from nmpc_nav_control_tpu_torch.parallel import make_mesh, solve_box_qp_2d
    from nmpc_nav_control_tpu_torch.qp import solve_box_qp
    from torch_sweep_inputs import random_riccati_inputs

    out, t0 = {}, time.perf_counter()
    qp, (us, ibx, ibu) = _long_qp(torch, dev, torch.float32, LONG_B, LONG_N)
    qp64 = _long_qp(torch, dev, torch.float64, LONG_B, LONG_N)[0]
    du_max, du_mean = 2 * JAX_F32_DU[0], 2 * JAX_F32_DU[1]
    iters = 8

    def sp(q=qp):
        return solve_box_qp(q, ibx, ibu, iters=iters, stage_parallel=True)

    def serial(q=qp):
        return solve_box_qp(q, ibx, ibu, iters=iters, tiled=False)

    # Kernels 6-8 at N=512 against their plain versions (phase 6's bounds).
    out["kernels_N512"] = {}
    for lanes in (LONG_B, 1):
        x = random_riccati_inputs(7, 2, LONG_N, lanes, seed=LONG_N + lanes)
        for name, (kern, plain, args, outs) in _riccati_calls(torch, rf, x, dev).items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            abs_err, excess = 0.0, 0.0
            for o, g, r in zip(outs, _leaves(tuple(got)), _leaves(tuple(want))):
                e = _placed_errors(torch, g, r, *RICCATI_TOL[o])
                abs_err, excess = max(abs_err, e[0]), max(excess, e[1])
            if not excess <= 1.0:
                raise AssertionError(f"phase 13 {name} (7,2) N={LONG_N} B={lanes}: kernel "
                                     "disagrees with plain version")
            kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], abs_err)
            ms = _time_ms(torch, kern)
            try:
                dev_ms = _device_ms(torch, kern)
            except RuntimeError:                 # no device time in the traces
                dev_ms = None
            print(f"phase 13 {name} (7,2) N={LONG_N} B={lanes}: max abs err {abs_err:.3e}, "
                  f"worst err/(atol+rtol|ref|) {excess:.3f}, {ms:.4f} ms a call (CUDA events), "
                  f"device {'not measured' if dev_ms is None else f'{dev_ms} ms'}")
            out["kernels_N512"][f"{name}/{lanes}"] = dict(ms=ms, device_ms=dev_ms,
                                                          max_abs_err=abs_err)

    ref = solve_box_qp(qp64, ibx, ibu, iters=iters, tiled=False)
    active = int(((ref.dus + us.double()).abs() > 2.0 - 1e-3).any(-1).any(-1).sum())
    for name, fn, want in (("stage-parallel", sp, {}), ("serial Riccati", serial,
                                                       RICCATI_PER_TICK)):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        sol = fn()
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        du = (sol.dus.double() - ref.dus).abs()
        ok = bool(torch.isfinite(sol.dus).all()) and bool(torch.isfinite(sol.kkt_res).all())
        print(f"phase 13 N={LONG_N} B={LONG_B} diff QP, {name} f32: launches {counts}, "
              f"max |du - du_f64| {float(du.max()):.3e}, mean {float(du.mean()):.3e} (golden "
              f"{DU_MAX_TOL:.1e}, {DU_MEAN_TOL:.1e}; twice JAX's f32 {du_max:.3e}, "
              f"{du_mean:.3e}), max kkt_res {float(sol.kkt_res.max()):.3e},"
              f" max mu {float(sol.mu.max()):.3e}; {active} lanes hold an input at its bound")
        if counts != want or not ok:
            raise AssertionError(f"phase 13 {name}: launches {counts} (expected {want}), "
                                 f"finite {ok}")
        if not (float(du.max()) <= du_max and float(du.mean()) <= du_mean):
            raise AssertionError(f"phase 13 {name}: outside twice JAX's f32 error")
        out[name] = dict(max_du=float(du.max()), mean_du=float(du.mean()), launches=counts)
        if name == "stage-parallel":
            one_d = sol
    if active == 0:
        raise AssertionError("phase 13: no lane holds an input bound")

    # Both f32 solves timed at B=256 and B=1.
    out["ms"] = {}
    for lanes in (LONG_B, 1):
        q = type(qp)(*(x[:lanes].clone() for x in qp))
        for name, fn in (("stage-parallel", sp), ("serial Riccati", serial)):
            ms, how, run = _solve_ms(torch, lambda fn=fn, q=q: fn(q), f"{name} B={lanes}")
            top = _top_kernels(torch, run)
            where = ("device not measured" if top is None else
                     f"device {top[0]:.3f} ms, costliest kernels " + "; ".join(
                         f"{k} {ms_k:.3f} ms ({100 * share:.1f}%)" for k, ms_k, share in top[1]))
            print(f"phase 13 {name} N={LONG_N} B={lanes}: {ms:.3f} ms a solve ({how}, "
                  f"{iters} IPM iterations); {where}")
            out["ms"][f"{name}/{lanes}"] = dict(ms=ms, how=how, top=top)

    # The 2-D mesh: its four stage devices over the visible cards in turn
    # (one card named four times where there is one).
    cards = torch.cuda.device_count()
    devices = [torch.device("cuda", i % cards) for i in range(4)]
    mesh = make_mesh((1, 4), ("data", "stage"), devices=devices)
    two_d = solve_box_qp_2d(qp, ibx, ibu, mesh, iters=iters).gather(dev)
    gap = max(float((a - b).abs().max()) for a, b in ((two_d.dxs, one_d.dxs),
                                                      (two_d.dus, one_d.dus)))
    print(f"phase 13 solve_box_qp_2d on a (1, 4) mesh of {min(cards, 4)} card(s): "
          f"max |2-D - 1-D| {gap:.3e} over dxs and dus (bound {MESH2D_TOL:.0e})")
    if not gap <= MESH2D_TOL:
        raise AssertionError(f"phase 13: the 2-D solve departs from the 1-D one by {gap:.3e}")
    out.update(mesh2d_gap=gap, mesh2d=_mesh2d_measures(torch, qp, ibx, ibu, mesh, iters, sp,
                                                       out["ms"]))
    out["seconds"] = time.perf_counter() - t0
    return out


def _mesh2d_measures(torch, qp, ibx, ibu, mesh, iters, one_d, ms_1d):
    """Phase 13 (b)'s 2-D solve: the bytes each stage block holds for the
    whole solve (its QP rows and its iterate's), ms a solve beside the 1-D
    solve's at B=256 and 1, and each card's peak memory above what it held
    before, for the 2-D solve and for the 1-D solve on one card."""
    from nmpc_nav_control_tpu_torch.parallel import solve_box_qp_2d
    from nmpc_nav_control_tpu_torch.qp import ipm

    out = {"block_bytes": []}
    for j, b in enumerate(ipm._split(qp, ibx, ibu, list(mesh.devices[0]))):
        qp_bytes = sum(x.numel() * x.element_size() for x in b[:11])
        it_bytes = sum(x.numel() * x.element_size() * k
                       for x, k in ((b.Qd, 1), (b.Rd, 1), (b.lbx, 4), (b.lbu, 4)))
        print(f"phase 13 2-D stage block {j} on {b.Qd.device}: {b.Rd.shape[0]} stages, QP rows "
              f"{qp_bytes} bytes, iterate {it_bytes} bytes")
        out["block_bytes"].append(dict(device=str(b.Qd.device), stages=b.Rd.shape[0],
                                       qp=qp_bytes, iterate=it_bytes))
    whole = sum(x.numel() * x.element_size() for x in qp)
    print(f"phase 13 the whole N={LONG_N} B={LONG_B} QP: {whole} bytes")
    out["qp_bytes"] = whole

    out["ms"] = {}
    for lanes in (LONG_B, 1):
        q = type(qp)(*(x[:lanes].clone() for x in qp))
        ms, how, _ = _solve_ms(torch, lambda q=q: solve_box_qp_2d(q, ibx, ibu, mesh, iters=iters),
                               f"2-D B={lanes}")
        print(f"phase 13 solve_box_qp_2d N={LONG_N} B={lanes}: {ms:.3f} ms a solve ({how}, "
              f"{iters} IPM iterations, CUDA events); the 1-D stage-parallel solve "
              f"{ms_1d[f'stage-parallel/{lanes}']['ms']:.3f} ms")
        out["ms"][lanes] = dict(ms=ms, how=how)

    cards = sorted({d.index for d in mesh.devices.ravel()})

    def peaks(fn):
        torch.cuda.synchronize()
        before = {c: torch.cuda.memory_allocated(c) for c in cards}
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        fn()
        torch.cuda.synchronize()
        return {c: torch.cuda.max_memory_allocated(c) - before[c] for c in cards}

    out["peak_2d"] = peaks(lambda: solve_box_qp_2d(qp, ibx, ibu, mesh, iters=iters))
    out["peak_1d"] = peaks(one_d)
    print(f"phase 13 peak bytes above the held, by card: 2-D solve {out['peak_2d']}, 1-D solve "
          f"{out['peak_1d']}" + ("" if len(cards) > 1 else
                                 "; one card: placement across cards not measured"))
    return out


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _phase_multihost(torch, dev):
    """Phase 13 (c): ``init_distributed`` on NCCL at world size 1, then the
    fleet's multi-process I/O against the direct tick, bit for bit."""
    import torch.distributed as dist

    from nmpc_nav_control_tpu_torch.control import state_machine as sm
    from nmpc_nav_control_tpu_torch.parallel import (
        global_data_mesh,
        global_to_local,
        init_distributed,
        local_to_global,
    )
    from nmpc_nav_control_tpu_torch.parallel.fleet import Fleet

    t0 = time.perf_counter()
    init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        backend = dist.get_backend()
        if backend != "nccl":
            raise AssertionError(f"phase 13 multihost: backend {backend}")
        mesh = global_data_mesh()
        small = {g: SMALL_LANES for g in FLEET_LANES}
        direct = Fleet(_fleet_groups(torch, small, dev))
        io = Fleet(_fleet_groups(torch, small, dev), mesh=mesh)
        same = True
        for g, grp in direct.groups.items():
            state, plants = _fleet_lanes(torch, sm, grp, dev)
            direct.set_states(g, state)
            io.set_states(g, local_to_global(mesh, state))
            meas = _fleet_meas(torch, sm, g, plants, grp.data.p)
            want = direct.tick({g: meas})[g]
            host = sm.Measurements(*(x.cpu().numpy() for x in meas))
            got = global_to_local(io.tick({g: local_to_global(mesh, host)})[g])
            same &= all(np.array_equal(a, b.cpu().numpy())
                        for a, b in zip(_leaves(got), _leaves(want)))
    finally:
        dist.destroy_process_group()
    print(f"phase 13 multihost: init_distributed on {backend} at world size 1, "
          f"global_data_mesh {mesh}, local_to_global -> fleet tick -> global_to_local at "
          f"{SMALL_LANES} lanes a group: {'equal' if same else 'NOT equal'} to the direct tick "
          f"bit for bit; process group destroyed")
    if not same:
        raise AssertionError("phase 13 multihost: the I/O path departs from the direct tick")
    return dict(backend=backend, seconds=time.perf_counter() - t0)


def _pose_goal_band(torch, geometry, dev):
    """Final position errors [BAND_LANES] of the pose-goal demo's closed
    loop (its controller, plant and kinematics) at --noise 0.05 for
    DEMO_TICKS ticks, one noise stream a lane, graphed on the card."""
    from nmpc_nav_control_tpu_torch.control import GraphedController
    from nmpc_nav_control_tpu_torch.examples import sim_pose_goal as demo

    B = BAND_LANES
    spec, data = demo.build(geometry, torch.float32, demo.N, dev)
    ctrl = GraphedController(spec, data, B)
    traj = torch.zeros(B, demo.N + 1, 3, device=dev)
    traj[:, 0] = torch.tensor([1.0, 0.3, 0.5])
    n_valid = torch.ones(B, dtype=torch.long, device=dev)
    gen = torch.Generator().manual_seed(1)
    plant = torch.zeros(B, demo.plant_size(geometry), device=dev)
    for _ in range(DEMO_TICKS):
        pose, vel, steer = demo.measure(geometry, plant, data.p)
        cmd = ctrl.step(pose, vel, traj, n_valid, steer)[1]
        refs = demo.references(geometry, cmd, data.p)
        noise = torch.randn(refs.shape, generator=gen).to(dev)
        plant = demo.plant_step(geometry, plant, refs + 0.05 * noise, data.p)
    return torch.hypot(plant[:, 0] - 1.0, plant[:, 1] - 0.3).cpu()


def _phase_demos(torch, dev):
    """Phase 13 (d): the simulation demos on the card."""
    from nmpc_nav_control_tpu_torch.examples import sim_follow_path, sim_pose_goal

    out, t0 = {}, time.perf_counter()
    for g in ("diff", "omni4", "tric"):
        runs = {}
        for noise in ("0", "0.05"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                runs[noise] = sim_pose_goal.main([g, "--noise", noise, "--ticks",
                                                  str(DEMO_TICKS)])
        band = _pose_goal_band(torch, g, dev)
        lo, mid, hi = JAX_POSE_GOAL_BAND[g]
        gap0 = abs(runs["0"]["final_error"] - JAX_POSE_GOAL_NOISE0[g])
        median = float(band.median())
        print(f"phase 13 sim_pose_goal {g} --ticks {DEMO_TICKS} on the card: final position error "
              f"{runs['0']['final_error'] * 100:.4f} cm at --noise 0 (the JAX script's "
              f"{JAX_POSE_GOAL_NOISE0[g] * 100:.4f} cm), {runs['0.05']['final_error'] * 100:.2f} "
              f"cm at --noise 0.05 --seed 0; over {BAND_LANES} noise streams min / median / max "
              f"{float(band.min()) * 100:.2f} / {median * 100:.2f} / {float(band.max()) * 100:.2f}"
              f" cm (the JAX script over 32 keys {lo * 100:.2f} / {mid * 100:.2f} / "
              f"{hi * 100:.2f} cm)")
        if not (gap0 <= NOISE0_TOL and lo <= median <= hi):
            raise AssertionError(f"phase 13 sim_pose_goal {g}: outside the JAX script's outcome")
        out[g] = dict(noise0=runs["0"]["final_error"], noise=runs["0.05"]["final_error"],
                      band=band.tolist())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = sim_follow_path.main([])
    dist_end = float(np.hypot(r["plant"][0] - PATH_END[0], r["plant"][1] - PATH_END[1]))
    print(f"phase 13 sim_follow_path on the card: IDLE at tick {r['finished']}, final pos "
          f"({r['plant'][0]:.3f}, {r['plant'][1]:.3f}), {dist_end * 100:.2f} cm from the path "
          f"end; node tick p50 {r['stats']['p50_ms']:.3f} ms, p99 {r['stats']['p99_ms']:.3f} ms")
    if r["finished"] is None or not dist_end <= PATH_END_TOL:
        raise AssertionError("phase 13 sim_follow_path: the robot did not reach the path end")
    out.update(follow_path=dict(finished=r["finished"], dist_end=dist_end),
               seconds=time.perf_counter() - t0)
    return out


# ---- Phase 14: the AOT tick artifacts. ----

AOT_TICKS = 40                   # (b): ticks of the pose goal per artifact
AOT_CPU_TICKS = 3                # (e): ticks of the CPU platform against the CPU eager tick
AOT_GOAL = (1.0, 0.0, 0.0)
AOT_FLEET = 2048                 # bench.py's fleet lanes (diff, N=40)
AOT_FLEET_SPREAD = 0.25          # m: the fleet's robots start on y in [-this, this]
NAV_TOL = 3.6e-6                 # the f32 batched-vs-serial bound (ROADMAP section 3)

# The loading process: it imports torch and runtime.aot and nothing else of
# the port, loads one artifact for the card, runs the CPU platform where
# asked, says so in its ``ready`` file and waits for a line on its standard
# input: the card is its alone from then.  It drives the artifact on the
# card (capture, then the pose goal's measurements), times it graphed and
# eager, and writes what it computed.
AOT_CHILD = r"""
import json, sys, time
sys.modules["jax"] = None
import torch
from nmpc_nav_control_tpu_torch.ops import _build
from nmpc_nav_control_tpu_torch.runtime import aot
artifact, inputs, output, ready, cpu_ticks = sys.argv[1:6]
blob = open(artifact, "rb").read()
t0 = time.perf_counter()
tick = aot.load_tick(blob)
load_s = time.perf_counter() - t0
inp = torch.load(inputs, weights_only=False)
leaves = aot._leaves
n_state = len(leaves(inp["state"]))
cpu, cpu_load_s = [], None
if int(cpu_ticks):
    t0 = time.perf_counter()
    on_cpu = aot.load_tick(blob, device="cpu")
    cpu_load_s = time.perf_counter() - t0
    st = aot._nest(type(inp["state"]), [x.cpu() for x in leaves(inp["state"])])[0]
    for m in inp["meas"][:int(cpu_ticks)]:
        st, o = on_cpu(st, aot._nest(type(m), [x.cpu() for x in leaves(m)])[0])
        cpu.append(leaves(st) + leaves(o))
open(ready, "w").close()
sys.stdin.readline()


def timed(fn, reps=20):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


state, meas = inp["state"], inp["meas"]
torch.cuda.synchronize()
_build.reset_launch_counts()
t0 = time.perf_counter()
state, out = tick(state, meas[0])
torch.cuda.synchronize()
first_ms = (time.perf_counter() - t0) * 1e3
ticks = [[x.cpu() for x in leaves(state) + leaves(out)]]
for m in meas[1:]:
    state, out = tick(state, m)
    ticks.append([x.cpu() for x in leaves(state) + leaves(out)])
counts = _build.launch_counts()
graphed_ms = timed(lambda: tick(state, meas[-1]))
flat = [x.clone() for x in leaves(inp["state"]) + leaves(meas[-1])]


def eager():
    flat[:n_state] = tick.program(*flat)[:n_state]


eager_ms = timed(eager)
mods = sorted(m for m in sys.modules if m.split(".")[0] == "nmpc_nav_control_tpu_torch"
              and (m.split(".")[1:2] in (["models"], ["rti"], ["qp"], ["paths"])
                   or m == "nmpc_nav_control_tpu_torch.control.controllers"))
torch.save({"ticks": ticks, "cpu": cpu}, output)
print(json.dumps(dict(load_s=load_s, cpu_load_s=cpu_load_s, first_ms=first_ms,
                      capture=tick.capture_launches, counts=counts, graphed_ms=graphed_ms,
                      eager_ms=eager_ms, model_modules=mods, meta=tick.meta)))
"""


def _aot_cases(tmp):
    """The artifacts: the runtime YAMLs at N=80, B=1, on the default route;
    diff on the Riccati route; diff at bench.py's fleet setting (N=40, 2048
    lanes), whose YAML is runtime_diff.yaml at tf_ini 1.0 s."""
    cfg = os.path.join(ROOT, "config", "runtime_{}.yaml")
    fleet_yaml = os.path.join(tmp, "runtime_diff_N40.yaml")
    with open(cfg.format("diff")) as f, open(fleet_yaml, "w") as g:
        g.write(re.sub(r"(?m)^tf_ini:.*$", "tf_ini: 1.0", f.read()))
    cases = [dict(name=f"{g} N=80", yaml=cfg.format(g), geometry=g, batch=None, route="1",
                  per_tick=PER_TICK, cpu=g == "diff") for g in ("diff", "omni4", "tric")]
    cases.append(dict(name="diff N=80 Riccati", yaml=cfg.format("diff"), geometry="diff",
                      batch=None, route="0", per_tick=RICCATI_PER_TICK, cpu=True))
    cases.append(dict(name=f"diff N=40 B={AOT_FLEET}", yaml=fleet_yaml, geometry="diff",
                      batch=AOT_FLEET, route="1", per_tick=PER_TICK, cpu=False,
                      platforms=["cuda"]))
    for i, c in enumerate(cases):
        c.update(artifact=os.path.join(tmp, f"tick{i}.aot"), inputs=os.path.join(tmp, f"in{i}.pt"),
                 output=os.path.join(tmp, f"out{i}.pt"))
    return cases


def _aot_export(cases):
    """(a): start ``python -m nmpc_nav_control_tpu_torch export`` for every
    case, the processes in parallel (the default platforms, cuda and cpu,
    unless the case names its own)."""
    procs = []
    for c in cases:
        argv = [sys.executable, "-m", "nmpc_nav_control_tpu_torch", "export", "--config",
                c["yaml"], "-o", c["artifact"]]
        if c["batch"] is not None:
            argv += ["--batch", str(c["batch"])]
        for p in c.get("platforms", ()):
            argv += ["--platform", p]
        env = dict(os.environ, NMPC_TPU_TILED_IPM=c["route"], OMP_NUM_THREADS="1")
        procs.append((c, time.perf_counter(), subprocess.Popen(
            argv, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    return procs


def _aot_export_wait(procs):
    """Each case gets its export's seconds and bytes."""
    for c, t0, proc in procs:
        out, err = proc.communicate(timeout=900)
        c["export_s"] = time.perf_counter() - t0
        if proc.returncode != 0 or "exported" not in out:
            raise AssertionError(f"phase 14 export {c['name']}: rc {proc.returncode}\n{out}\n{err}")
        c["bytes"] = os.path.getsize(c["artifact"])
        print(f"phase 14 export {c['name']}: {out.strip()}; {c['export_s']:.1f} s ({len(procs)} "
              f"exports in parallel beside the references' runs), {c['bytes']} bytes")


def _aot_reference(torch, c, dev):
    """The pose goal through a GraphedNavigator of the same config: its
    state and measurements at the start, its outputs at every tick (on the
    CPU), the navigator (timed later) and the CPU eager ticks for (e)."""
    from nmpc_nav_control_tpu_torch.control import GraphedNavigator, make_controller
    from nmpc_nav_control_tpu_torch.control import state_machine as sm
    from nmpc_nav_control_tpu_torch.examples import sim_pose_goal as demo
    from nmpc_nav_control_tpu_torch.runtime import load_config

    _set_route(c["route"])
    config = load_config(c["yaml"])
    g, lanes = c["geometry"], c["batch"] or 1
    spec, data = make_controller(g, config.dt, config.horizon, device=dev,
                                 **config.controller_kwargs())
    nav = GraphedNavigator(spec, data, config.nav, lanes)
    state0 = sm.on_goal_pose(sm.node_init(spec, config.nav, lanes, torch.float32, dev),
                             torch.tensor(AOT_GOAL, device=dev))
    nav.load_state(state0)
    plants = torch.zeros(lanes, demo.plant_size(g), device=dev)
    if lanes > 1:
        plants[:, 1] = torch.linspace(-AOT_FLEET_SPREAD, AOT_FLEET_SPREAD, lanes)
    meas, ticks = [], []
    for _ in range(AOT_TICKS):
        meas.append(_clone(_fleet_meas(torch, sm, g, plants, data.p)))
        st, out = nav.step(meas[-1])
        ticks.append([x.cpu() for x in _leaves(st) + _leaves(out)])
        plants = _fleet_advance(torch, g, plants, out, data.p)
    single = c["batch"] is None

    def lane0(tree):
        return _squeeze(tree) if single else tree

    torch.save({"state": lane0(_clone(state0)), "meas": [lane0(m) for m in meas]}, c["inputs"])
    cpu = []
    if c["cpu"]:
        spec_c, data_c = make_controller(g, config.dt, config.horizon, device="cpu",
                                         **config.controller_kwargs())
        st = _to(state0, "cpu")
        for m in meas[:AOT_CPU_TICKS]:
            st, out = sm.node_tick(spec_c, data_c, config.nav, st, _to(m, "cpu"))
            cpu.append(_leaves(st) + _leaves(out))
    _set_route("1")
    return dict(ticks=ticks, cpu=cpu, nav=nav, route=c["route"], dt_ms=1e3 * config.dt)


def _squeeze(tree):
    """A B=1 NamedTuple tree without its lane axis."""
    if isinstance(tree, tuple):
        return type(tree)(*(_squeeze(x) for x in tree))
    return tree[0]


def _aot_gap(torch, got, want, single):
    """(leaves that differ, max |got - want| over them) of two ticks' leaves,
    ``got`` without the lane axis where ``single``."""
    differ, gap = 0, 0.0
    for g, w in zip(got, want):
        w = w[0] if single else w
        if g.shape != w.shape or g.dtype != w.dtype:
            return float("inf"), float("inf")
        if not torch.equal(g, w):
            differ += 1
            gap = max(gap, float((g.double() - w.double()).abs().max()))
    return differ, gap


def _aot_wait_ready(cases, procs, timeout=900):
    """Until every loading process has loaded its artifact and run its CPU
    platform; raises on one that ended instead."""
    t0 = time.perf_counter()
    while not all(os.path.exists(c["output"] + ".ready") for c in cases):
        for c, proc in zip(cases, procs):
            if proc.poll() is not None:
                raise AssertionError(f"phase 14 load {c['name']}: rc {proc.returncode}\n"
                                     f"{proc.communicate()[1]}")
        if time.perf_counter() - t0 > timeout:
            raise AssertionError("phase 14: the loading processes are not ready")
        time.sleep(0.5)


def _phase_aot(torch, dev, smi):
    """Phase 14."""
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        cases = _aot_cases(tmp)
        exports = _aot_export(cases)
        refs = [_aot_reference(torch, c, dev) for c in cases]
        _aot_export_wait(exports)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        procs = [subprocess.Popen(
            [sys.executable, "-c", AOT_CHILD, c["artifact"], c["inputs"], c["output"],
             c["output"] + ".ready", str(AOT_CPU_TICKS if c["cpu"] else 0)], cwd=ROOT, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for c in cases]
        _aot_wait_ready(cases, procs)
        # Each loaded tick takes the card alone, between two timings of its
        # navigator: nothing else runs on the card or the host meanwhile.
        done = []
        for c, ref, proc in zip(cases, refs, procs):
            _set_route(ref["route"])
            before = _time_ms(torch, ref["nav"].step)
            done.append(proc.communicate(input="go\n", timeout=900))
            ref["nav_ms"] = (before, _time_ms(torch, ref["nav"].step))
        _set_route("1")
        out = {}
        for c, ref, proc, (text, err) in zip(cases, refs, procs, done):
            if proc.returncode != 0:
                raise AssertionError(f"phase 14 load {c['name']}: rc {proc.returncode}\n{err}")
            r = json.loads(text.strip().splitlines()[-1])
            got = torch.load(c["output"], weights_only=False)
            single = c["batch"] is None
            per = [_aot_gap(torch, g, w, single) for g, w in zip(got["ticks"], ref["ticks"])]
            differ, gap = max(d for d, _ in per), max(x for _, x in per)
            cpu = [_aot_gap(torch, g, w, single) for g, w in zip(got["cpu"], ref["cpu"])]
            cpu_differ = max((d for d, _ in cpu), default=0)
            want = {k: v * (2 + 1) for k, v in c["per_tick"].items()}
            faults = []
            if r["model_modules"]:
                faults.append(f"the loading process imported {r['model_modules']}")
            if r["capture"] != c["per_tick"]:
                faults.append(f"launches at capture {r['capture']}")
            if r["counts"] != want:
                faults.append(f"the {AOT_TICKS} ticks launched {r['counts']}, not two warm-up "
                              f"calls' and the capture's {want}")
            if len(got["ticks"]) != AOT_TICKS or not gap <= NAV_TOL:
                faults.append(f"{differ} leaves differ from the GraphedNavigator, by up to "
                              f"{gap:.3e}")
            if c["cpu"] and (len(got["cpu"]) != AOT_CPU_TICKS or cpu_differ):
                faults.append(f"the CPU platform differs from the CPU eager tick in "
                              f"{cpu_differ} leaves")
            if faults:
                raise AssertionError(f"phase 14 {c['name']}: {'; '.join(faults)}")
            m = r["meta"]
            print(f"phase 14 load {c['name']} ({m['route']} route, torch {m['torch']} at export): "
                  f"deserialized in {r['load_s']:.1f} s in a process without the model code; "
                  f"first call (warm-up and capture) {r['first_ms']:.1f} ms, launches at capture "
                  f"{r['capture']}; {AOT_TICKS} ticks of the goal {AOT_GOAL} "
                  + ("equal to the GraphedNavigator's bit for bit" if differ == 0 else
                     f"within {gap:.3e} of the GraphedNavigator ({differ} leaves differ)")
                  + (f"; CPU platform ({r['cpu_load_s']:.1f} s to load) equal to the CPU eager "
                     f"tick bit for bit over {AOT_CPU_TICKS} ticks" if c["cpu"] else ""))
            nav = sum(ref["nav_ms"]) / 2
            print(f"phase 14 time {c['name']} [{smi}]: loaded tick {r['graphed_ms']:.3f} ms "
                  f"graphed, {r['eager_ms']:.3f} ms eager; GraphedNavigator "
                  f"{ref['nav_ms'][0]:.3f} ms before and {ref['nav_ms'][1]:.3f} ms after it, "
                  f"graphed (CUDA events, 20 chained calls each); loaded / navigator "
                  f"{r['graphed_ms'] / nav:.3f}; budget {ref['dt_ms']:.0f} ms")
            out[c["name"]] = dict(export_s=c["export_s"], bytes=c["bytes"], load_s=r["load_s"],
                                  cpu_load_s=r["cpu_load_s"], first_ms=r["first_ms"],
                                  capture=r["capture"], graphed_ms=r["graphed_ms"],
                                  eager_ms=r["eager_ms"], nav_ms=ref["nav_ms"],
                                  leaves_differ=differ, max_gap=gap)
        out["same process"] = _aot_pair(torch, cases[0], refs[0], smi)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 14: {out['seconds']:.1f} s")
    return out


def _aot_pair(torch, c, ref, smi):
    """(d) in one process: the first case's artifact loaded here and timed
    in turns with its GraphedNavigator (navigator, loaded, loaded,
    navigator), so that both replay under the same process and card state."""
    from nmpc_nav_control_tpu_torch.runtime import aot

    _set_route(ref["route"])
    with open(c["artifact"], "rb") as f:
        tick = aot.load_tick(f.read())
    inp = torch.load(c["inputs"], weights_only=False)
    state, _ = tick(inp["state"], inp["meas"][0])
    meas = inp["meas"][-1]

    def loaded():
        tick(state, meas)

    ms = [_time_ms(torch, f) for f in (ref["nav"].step, loaded, loaded, ref["nav"].step)]
    ratio = (ms[1] + ms[2]) / (ms[0] + ms[3])
    print(f"phase 14 time {c['name']} in one process [{smi}]: GraphedNavigator {ms[0]:.3f} / "
          f"{ms[3]:.3f} ms, loaded tick {ms[1]:.3f} / {ms[2]:.3f} ms graphed (navigator, loaded, "
          f"loaded, navigator; CUDA events, 20 chained calls each); loaded / navigator "
          f"{ratio:.3f}")
    _set_route("1")
    return dict(nav_ms=[ms[0], ms[3]], loaded_ms=[ms[1], ms[2]], ratio=ratio)


# ---- Phase 15: the measurement surface. ----

# bench.py's full sweep, in its order: the ten configurations of its
# ``configs`` list, then the latency and fleet lines, the headline last.
BENCH_RECORDS = [
    ("nmpc_solves_per_s_per_chip_N40", "diff", 40, 4096),
    ("nmpc_solves_per_s_per_chip_N80", "diff", 80, 2048),
    ("nmpc_solves_per_s_per_chip_N80", "diff", 80, 4096),
    ("nmpc_solves_per_s_per_chip_N40_omni4", "omni4", 40, 2048),
    ("nmpc_solves_per_s_per_chip_N40_omni4", "omni4", 40, 4096),
    ("nmpc_solves_per_s_per_chip_N80_omni4", "omni4", 80, 2048),
    ("nmpc_solves_per_s_per_chip_N40_tric", "tric", 40, 2048),
    ("nmpc_solves_per_s_per_chip_N40_tric", "tric", 40, 4096),
    ("nmpc_solves_per_s_per_chip_N80_tric", "tric", 80, 2048),
    ("single_robot_tick_latency_ms_N40", "diff", 40, 1),
    ("fleet_nav_ticks_per_s_per_chip_N40", "diff", 40, 2048),
    ("nmpc_solves_per_s_per_chip_N40", "diff", 40, 2048),
]
XCHECK_TOL = 0.15                # the bench and the probes against phases 3 and 11
BENCH_REPS_SMOKE = "10"          # bench.py's default


def _module(args, timeout, **env):
    """Run ``python -m <args>`` from the checkout with ``env`` set (every
    other ``BENCH_*`` variable cleared); raise unless it exits 0.  Returns
    its standard output's lines."""
    full = {k: v for k, v in os.environ.items()
            if k != "PYTHONPATH" and not k.startswith("BENCH_")}
    full.update(env)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=full,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"phase 15 {' '.join(args)}: rc {proc.returncode}\n"
                             f"{proc.stdout}\n{proc.stderr[-4000:]}")
    print(f"phase 15 {' '.join(args)}: {time.perf_counter() - t0:.1f} s")
    return proc.stdout.splitlines()


def _near(what, got, want):
    """Print the pair; raise unless ``got`` is within XCHECK_TOL of ``want``."""
    print(f"phase 15 cross-check {what}: {got:.4f} ms against {want:.4f} ms "
          f"(ratio {got / want:.4f})")
    if not abs(got / want - 1.0) <= XCHECK_TOL:
        raise AssertionError(f"phase 15 {what}: {got:.4f} ms is not within "
                             f"{100 * XCHECK_TOL:.0f}% of {want:.4f} ms")


def _bench_path_launches(torch, dev):
    """The bench's headline path in this process (``bench._measure_config``
    for diff, N=40, B=2048, chains of 1 and 3 replays): with the launch
    counts set to 0 just before, exactly two warm-up ticks' and the
    capture's launches (replays count nothing)."""
    from nmpc_nav_control_tpu_torch import bench as tbench
    from nmpc_nav_control_tpu_torch.ops import _build

    _build.reset_launch_counts()
    per_step = tbench._measure_config("diff", N, 2048, 2, 1, 3, dev)[0]
    counts = _build.launch_counts()
    want = {k: 3 * v for k, v in PER_TICK.items()}
    print(f"phase 15 bench path diff N={N} B=2048 in this process: launches {counts} "
          f"(two warm-up ticks and the capture), {per_step * 1e3:.4f} ms a tick")
    if counts != want:
        raise AssertionError(f"phase 15 bench path: launches {counts}, expected {want}")
    return counts


def _phase_measure(torch, dev, smi, controller_ms, nav_ms):
    """Phase 15; ``controller_ms`` holds phase 3's graphed controller ticks
    by B, ``nav_ms`` phase 11's graphed diff B=2048 node tick."""
    import hashlib

    t0 = time.perf_counter()
    out = {"launches": _bench_path_launches(torch, dev)}

    # (a) the bench's full sweep, as a user runs it.
    bench_json = os.path.join(ROOT, "BENCH.json")

    def digest():
        if not os.path.exists(bench_json):
            return None
        with open(bench_json, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    torch_json = os.path.join(ROOT, "BENCH_torch.json")
    if os.path.exists(torch_json):
        os.remove(torch_json)
    before = digest()
    lines = _module(["nmpc_nav_control_tpu_torch", "bench"], 900, BENCH_SWEEP="full",
                    BENCH_REPS=BENCH_REPS_SMOKE)
    recs = [json.loads(line) for line in lines]
    for r in recs:
        print(f"phase 15 bench (BENCH_REPS={BENCH_REPS_SMOKE}) | {json.dumps(r)}")
    faults = []
    if [r.get("metric") for r in recs] != [m for m, *_ in BENCH_RECORDS]:
        faults.append(f"metrics {[r.get('metric') for r in recs]}")
    else:
        for r, (_, geom, n, lanes) in zip(recs, BENCH_RECORDS):
            c = r.get("config", {})
            if (c.get("geometry"), c.get("N"), c.get("batch"), c.get("device")) != (
                    geom, n, lanes, smi):
                faults.append(f"{r['metric']} config {c}")
            if not (isinstance(r.get("value"), (int, float)) and math.isfinite(r["value"])
                    and r["value"] > 0):
                faults.append(f"{r['metric']} B={lanes} value {r.get('value')}")
            for key in ("hbm_roofline_frac", "f32_peak_frac"):
                if key in r and not r[key] <= 1.0:
                    faults.append(f"{r['metric']} B={lanes} {key} {r[key]}")
    if digest() != before:
        faults.append("BENCH.json changed")
    if not os.path.exists(torch_json):
        faults.append("no BENCH_torch.json")
    elif json.load(open(torch_json))["records"] != recs:
        faults.append("BENCH_torch.json holds other records than were printed")
    if faults:
        raise AssertionError(f"phase 15 bench: {'; '.join(faults)}")
    ms = {}                                       # (geometry, N, B) -> ms per solve
    for r, (_, geom, n, lanes) in zip(recs, BENCH_RECORDS):
        if "solves" in r["metric"]:
            ms[geom, n, lanes] = 1e3 / r["value"]
    for geom, lanes in (("diff", 2048), ("diff", 4096), ("omni4", 2048), ("tric", 2048)):
        a, b = ms[geom, 40, lanes], ms[geom, 80, lanes]
        print(f"phase 15 bench {geom} B={lanes}: {1e3 * a:.4f} us a solve at N=40, "
              f"{1e3 * b:.4f} at N=80 (ratio {b / a:.3f})")
        if not b >= a:
            raise AssertionError(f"phase 15 bench {geom} B={lanes}: the per-solve time falls "
                                 f"from N=40 to N=80")
    head, latency, fleet = recs[-1], recs[-3], recs[-2]
    head_ms, fleet_ms = 2048e3 / head["value"], 2048e3 / fleet["value"]
    _near("headline ms per batch tick vs phase 3 graphed B=2048 tick", head_ms,
          controller_ms["2048"])
    _near("B=1 latency vs phase 3 graphed B=1 tick", latency["value"], controller_ms["1"])
    _near("fleet ms per tick vs phase 11 graphed B=2048 node tick", fleet_ms, nav_ms)
    out["bench"] = recs

    # (b) the scaling sweep on one card: its skipped line.
    lines = _module(["nmpc_nav_control_tpu_torch.bench_scaling"], 120)
    skipped = json.loads(lines[-1])
    print(f"phase 15 bench_scaling | {lines[-1]}")
    if len(lines) != 1 or skipped.get("skipped") is not True or "TPU" in skipped["reason"]:
        raise AssertionError(f"phase 15 bench_scaling: {lines}")

    # (c) the probes at the headline and fleet configurations.
    out["probes"] = {}
    for probe, first, want in (("phase_probe", "full_tick", head_ms),
                               ("node_probe", "node_tick", fleet_ms)):
        lines = _module([f"nmpc_nav_control_tpu_torch.tools.{probe}", "diff", str(N), "2048"],
                        300, BENCH_REPS=BENCH_REPS_SMOKE)
        phases = [json.loads(line) for line in lines]
        for r in phases:
            print(f"phase 15 {probe} | {json.dumps(r)}")
        out["probes"][probe] = phases
        if phases[0]["phase"] != first or not all(math.isfinite(r["per_batch_ms"])
                                                   for r in phases):
            raise AssertionError(f"phase 15 {probe}: {phases}")
        _near(f"{probe} {first} vs (a)'s figure", phases[0]["per_batch_ms"], want)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 15: {out['seconds']:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from nmpc_nav_control_tpu_torch.control import (
        GraphedController,
        controller_init,
        controller_step,
    )
    from nmpc_nav_control_tpu_torch.ops import _build
    from nmpc_nav_control_tpu_torch.ops import ipm_fused as tp
    from nmpc_nav_control_tpu_torch.ops import riccati_fused as rf
    import torch_golden
    from torch_sweep_inputs import add_riccati_faults, random_riccati_inputs, random_sweep_inputs

    dev = torch.device("cuda", 0)
    record = {}
    _set_route("1")

    # ---- Phase 1: device and build. ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    lib, build_s = _build.build()
    log = (lib.parent / "build.log").read_text()
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores", log))
    print(f"phase 1 build: {build_s:.1f} s, {lib.name}, max {max(regs, default=0)} "
          f"registers/thread, {spills} bytes spill stores in all kernels")
    ptxas = _ptxas_kernels(log)
    for kname, (reg, spill, static) in ptxas.items():
        print(f"phase 1 ptxas {kname}: {reg} registers, {spill} bytes spill stores, "
              f"{static} bytes static shared memory")
    record.update(device=smi, kind=kind, build_s=build_s, ptxas=log)
    cfgs = {config: _sweep_cfg(torch, tp, config) for config in ("diff", "omni4")}
    record["launch"] = {}
    for config, cfg in cfgs.items():
        x = random_sweep_inputs(cfg.nx, cfg.nu, cfg.nbx, cfg.nbu, cfg.asp, cfg.bsp, N, 17, seed=17)
        for name, (kern, _, _) in _sweep_calls(torch, tp, cfg, x, dev).items():
            _print_launch(torch, record, ptxas, name, IPM_KERNEL[name].format(CONFIG[config]),
                          kern)
    for nx, nu in ((7, 2), (11, 4)):
        calls = _riccati_calls(torch, rf, random_riccati_inputs(nx, nu, N, 17, seed=17), dev)
        for name, (kern, _, _, _) in calls.items():
            _print_launch(torch, record, ptxas, name, RICCATI_KERNEL[name].format(nx, nu), kern)

    spec, data = _controller(torch, dev)
    kernels = {}
    for name in PER_TICK:
        kernels[name] = dict(name=name, route="cuda",
                             source="nmpc_nav_control_tpu_torch/csrc/ipm_fused.cu",
                             replaces=tp.KERNELS[name], launches=0, max_abs_err=0.0)
    for name in RICCATI_PER_TICK:
        kernels[name] = dict(name=name, route="cuda",
                             source="nmpc_nav_control_tpu_torch/csrc/riccati_fused.cu",
                             replaces=rf.KERNELS[name], launches=0, max_abs_err=0.0)

    # ---- Phase 2: each IPM sweep kernel against its plain version. ----
    # The JSON line carries the diff numbers (the main path of phase 3); the
    # omni4 specialisation is checked and timed too (phase 8's path).  N=80
    # at B=17 (ragged, rows not 16-byte aligned) and at B=1 (phase 12's
    # node tick) holds the kernels at the reference's horizon, N=13 a short
    # last chunk; B=1 gives each kernel's device time for one lane.
    record["ipm_omni4"], record["device_ms_B1"], record["device_ms_B1_N80"] = {}, {}, {}
    for config, cfg in cfgs.items():
        nx, nu, nbx, nbu = cfg.nx, cfg.nu, cfg.nbx, cfg.nbu
        for lanes, horizon in ((2048, N), (1, N), (1000, N), (17, 2 * N), (1, 2 * N),
                               (17, 13)):
            x = random_sweep_inputs(nx, nu, nbx, nbu, cfg.asp, cfg.bsp, horizon, lanes, seed=lanes)
            for name, (kern, plain, args) in _sweep_calls(torch, tp, cfg, x, dev).items():
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                abs_err, rel_err, excess = _errors(torch, got, ref)
                print(f"phase 2 {name} {config} N={horizon} B={lanes}: max abs err {abs_err:.3e}, "
                      f"max rel err {rel_err:.3e}, worst err/(atol+rtol|ref|) {excess:.3f}")
                if not excess <= 1.0:
                    raise AssertionError(f"{name} {config} N={horizon} B={lanes}: kernel "
                                         "disagrees with plain")
                k = kernels[name]
                k["max_abs_err"] = max(k["max_abs_err"], abs_err)
                if lanes == 1:
                    dev_ms = _device_ms(torch, kern)
                    print(f"phase 2 {name} {config} N={horizon} B=1: device {dev_ms} ms")
                    key = "device_ms_B1" if horizon == N else "device_ms_B1_N80"
                    record[key][f"{name}/{config}"] = dev_ms
                if lanes != 2048:
                    continue
                ms, plain_ms, dev_ms = _time_pair(torch, kern, plain)
                bound_ms, bound_by = _bound(
                    _moved_bytes(name, args, got, nx, lanes),
                    _flops(name, nx, nu, cfg.nnzA, cfg.nnzB, 2 * (nbx + nbu)) * N * lanes)
                print(f"phase 2 {name} {config} B=2048: kernel {ms:.4f} ms per call "
                      f"(device {dev_ms} ms), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                      f"({bound_by})")
                if config == "diff":
                    k.update(ms=ms, plain_ms=plain_ms, device_ms=dev_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None)
                else:
                    record["ipm_omni4"][name] = dict(ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                                                     bound_ms=bound_ms, bound_by=bound_by)

    # ---- Phase 3: the main path, bench inputs, 20 chained ticks. ----
    # Eager ticks first, counted (TICKS ticks' launches), then the same
    # chain through GraphedController: its capture is counted too (one
    # tick's launches; replays count nothing), and its last state and
    # command are held against the eager chain's.
    def run_ticks(spec, data, lanes, what):
        inputs = _bench_inputs(torch, lanes, dev)
        controller_step(spec, data, controller_init(spec, lanes, torch.float32, dev),
                        *inputs)                          # first-call set-up
        state = controller_init(spec, lanes, torch.float32, dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        start.record()
        oks, kkts = [], []
        for _ in range(TICKS):
            state, cmd, stats = controller_step(spec, data, state, *inputs)
            oks.append(stats.ok)
            kkts.append(stats.kkt_res)
        end.record()
        end.synchronize()
        eager_ms = start.elapsed_time(end) / TICKS
        eager_counts = _build.launch_counts()
        check_tick(oks, kkts, cmd, f"{what} eager")

        graphed = GraphedController(spec, data, lanes)
        graphed.load_inputs(*inputs)
        counts = graphed.capture()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        start.record()
        oks, kkts = [], []
        for _ in range(TICKS):
            g_state, g_cmd, g_stats = graphed.step(*inputs)
            oks.append(g_stats.ok.clone())
            kkts.append(g_stats.kkt_res.clone())
        end.record()
        end.synchronize()
        if _build.launch_counts():
            raise AssertionError(f"{what}: replays launched {_build.launch_counts()}")
        graphed_ms = start.elapsed_time(end) / TICKS
        check_tick(oks, kkts, g_cmd, f"{what} graphed")
        gap = max(float((g - e).abs().max()) for g, e in zip((*g_state, *g_cmd), (*state, *cmd)))
        if not (gap <= GRAPH_TOL and torch.equal(g_stats.ok, stats.ok)):
            raise AssertionError(f"{what}: graphed tick departs from the eager one by {gap:.3e}")
        split = _tick_breakdown(torch, lambda: graphed.step(*inputs))
        return dict(eager_ms=eager_ms, graphed_ms=graphed_ms, launches=counts,
                    eager_launches=eager_counts,
                    kkt_max=float(torch.stack(kkts).max()), graphed_vs_eager=gap,
                    device_ms=None if split is None else split[0],
                    kernel_ms=None if split is None else split[1])

    def check_tick(oks, kkts, cmd, what):
        ok, kkt = torch.stack(oks), torch.stack(kkts)
        if not bool(ok.all()) or not bool(torch.isfinite(kkt).all()):
            raise AssertionError(f"{what}: {int((~ok).sum())} lane-ticks not ok")
        if not bool(torch.isfinite(cmd.v).all() & torch.isfinite(cmd.w).all()):
            raise AssertionError(f"{what}: non-finite command")

    def report(phase, what, lanes, r, per_tick):
        """Print a run_ticks result; raise unless the eager chain launched
        exactly TICKS ticks' kernels and the capture exactly one tick's."""
        print(f"phase {phase} {what} N=40 B={lanes} eager: {TICKS} chained ticks, all lanes "
              f"ok, launches {r['eager_launches']}, {r['eager_ms']:.3f} ms/tick")
        share = ("not measured" if r["device_ms"] is None else
                 f"device {r['device_ms']:.3f} ms/tick (idle "
                 f"{100 * (1 - r['device_ms'] / r['graphed_ms']):.1f}%), port kernels "
                 f"{r['kernel_ms']:.3f} ms ({100 * r['kernel_ms'] / r['graphed_ms']:.1f}% of the tick)")
        print(f"phase {phase} {what} N=40 B={lanes} graphed: {TICKS} chained replays, all lanes "
              f"ok, max kkt_res {r['kkt_max']:.3e}, launches at capture {r['launches']}, "
              f"{r['graphed_ms']:.3f} ms/tick, max |graphed - eager| {r['graphed_vs_eager']:.3e}; "
              f"{share}")
        if r["launches"] != per_tick:
            raise AssertionError(f"phase {phase} {what} B={lanes}: launch counts at capture "
                                 f"{r['launches']}, expected exactly {per_tick}")
        want = {k: v * TICKS for k, v in per_tick.items()}
        if r["eager_launches"] != want:
            raise AssertionError(f"phase {phase} {what} B={lanes}: eager launch counts "
                                 f"{r['eager_launches']}, expected exactly {want}")

    wide = run_ticks(spec, data, 2048, "phase 3")
    report(3, "main path diff", 2048, wide, PER_TICK)
    for name in PER_TICK:
        kernels[name]["launches"] = wide["launches"][name]
    one = run_ticks(spec, data, 1, "phase 3")
    report(3, "main path diff", 1, one, PER_TICK)
    print(f"phase 3 ms/tick graphed (eager): B=2048 {wide['graphed_ms']:.3f} "
          f"({wide['eager_ms']:.3f}) ms, B=1 {one['graphed_ms']:.3f} ({one['eager_ms']:.3f}) ms")
    if not one["graphed_ms"] < BUDGET_MS:
        raise AssertionError(f"phase 3: the graphed B=1 tick takes {one['graphed_ms']:.3f} ms, "
                             f"not under the {BUDGET_MS} ms budget")
    record.update(main_path={"2048": wide, "1": one})

    # ---- Phase 4: card against CPU, 5 ticks at B=256. ----
    # Two f32 runs of 8 IPM iterations differ by more than summation order
    # where a lane sits at an input bound: the f32 barrier resolves u there
    # only to ~3e-3 (measured against f64 on the CPU at these inputs).  So
    # the bound is that of the f32 golden suite (tests/test_rti_oracle.py),
    # and the f64 CPU run is printed as the referee.
    runs = {}
    for where, dtype in (("card", torch.float32), ("cpu", torch.float32),
                         ("cpu64", torch.float64)):
        d = dev if where == "card" else "cpu"
        spec_w, data_w = _controller(torch, d, dtype)
        inputs = [t.to(dtype) if t.is_floating_point() else t
                  for t in _bench_inputs(torch, 256, d)]
        st = controller_init(spec_w, 256, dtype, d)
        for _ in range(5):
            st, _, stats = controller_step(spec_w, data_w, st, *inputs)
        if not bool(stats.ok.all()):
            raise AssertionError(f"phase 4 {where}: lanes not ok")
        runs[where] = st.us.double().cpu()
    gap = (runs["card"] - runs["cpu"]).abs()
    ref = {w: float((runs[w] - runs["cpu64"]).abs().max()) for w in ("card", "cpu")}
    print(f"phase 4 card vs CPU, B=256, 5 ticks: max |us_card - us_cpu| {float(gap.max()):.3e}, "
          f"mean {float(gap.mean()):.3e}; max |us - us_f64|: card {ref['card']:.3e}, "
          f"cpu {ref['cpu']:.3e}")
    if not (float(gap.max()) < torch_golden.U_TOL and float(gap.mean()) < torch_golden.U_MEAN_TOL):
        raise AssertionError("card and CPU runs of the port disagree")
    record.update(card_vs_cpu_max_abs_us=float(gap.max()), vs_f64=ref)

    # ---- Phase 5: golden closed loop on the card. ----
    err = torch_golden.track("diff_pose_N40", torch.float32, dev)
    print(f"phase 5 golden diff_pose_N40 on the card: {err}")
    if not torch_golden.within_tolerance(err):
        raise AssertionError(f"golden tracking out of tolerance: {err}")
    record.update(golden=err)

    # ---- Phase 6: each Riccati kernel against its plain version. ----
    # The JSON line carries the (11, 4) numbers: phase 7's main path is omni4.
    # Three lanes hold a negative pivot, a NaN and an Inf (where B has them);
    # N = 13 and 1 at B=17 put the chunk edges of both redesigned kernels
    # at a ragged last block; N=80 at B=1 is phase 12's node tick (five
    # whole 16-stage chunks, one lane).
    record["riccati_7x2"] = {}
    for nx, nu in ((7, 2), (11, 4)):
        for horizon, lanes in ((N, 2048), (N, 1), (N, 1000), (2 * N, 1), (13, 17), (1, 17)):
            x = add_riccati_faults(random_riccati_inputs(nx, nu, horizon, lanes, seed=lanes))
            for name, (kern, plain, args, outs) in _riccati_calls(torch, rf, x, dev).items():
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                got_l, ref_l = _leaves(tuple(got)), _leaves(tuple(ref))
                abs_err, excess = 0.0, 0.0
                for out, g, r in zip(outs, got_l, ref_l):
                    e = _placed_errors(torch, g, r, *RICCATI_TOL[out])
                    abs_err, excess = max(abs_err, e[0]), max(excess, e[1])
                print(f"phase 6 {name} ({nx},{nu}) N={horizon} B={lanes}: max abs err "
                      f"{abs_err:.3e}, worst err/(atol+rtol|ref|) {excess:.3f}, NaN and Inf "
                      f"{'placed alike' if excess < float('inf') else 'placed apart'}")
                if not excess <= 1.0:
                    raise AssertionError(f"{name} ({nx},{nu}) N={horizon} B={lanes}: kernel "
                                         "disagrees with plain version")
                k = kernels[name]
                k["max_abs_err"] = max(k["max_abs_err"], abs_err)
                if lanes == 1:
                    dev_ms = _device_ms(torch, kern)
                    print(f"phase 6 {name} ({nx},{nu}) N={horizon} B=1: device {dev_ms} ms")
                    key = "device_ms_B1" if horizon == N else "device_ms_B1_N80"
                    record[key][f"{name}/{nx}x{nu}"] = dev_ms
                if lanes != 2048:
                    continue
                ms, plain_ms, dev_ms = _time_pair(torch, kern, plain)
                bound_ms, bound_by = _bound(_moved_bytes(name, args, tuple(got), nx, lanes),
                                            _flops(name, nx, nu, 0, 0, 0) * N * lanes)
                print(f"phase 6 {name} ({nx},{nu}) B=2048: kernel {ms:.4f} ms per call "
                      f"(device {dev_ms} ms), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                      f"({bound_by})")
                entry = dict(ms=ms, plain_ms=plain_ms, device_ms=dev_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None)
                if (nx, nu) == (11, 4):
                    k.update(entry)
                else:
                    record["riccati_7x2"][name] = entry

    # ---- Phase 7: the Riccati route, omni4 (then diff, tric) at B=2048. ----
    _set_route("0")
    record["riccati_route"] = {}
    for geometry in ("omni4", "diff", "tric"):
        spec_g, data_g = _controller(torch, dev, geometry=geometry)
        entry = {"2048": run_ticks(spec_g, data_g, 2048, f"phase 7 {geometry}")}
        report(7, f"Riccati route {geometry}", 2048, entry["2048"], RICCATI_PER_TICK)
        if geometry == "omni4":
            for name in RICCATI_PER_TICK:
                kernels[name]["launches"] = entry["2048"]["launches"][name]
            entry["1"] = run_ticks(spec_g, data_g, 1, "phase 7 omni4")
            report(7, "Riccati route omni4", 1, entry["1"], RICCATI_PER_TICK)
        record["riccati_route"][geometry] = entry

    # ---- Phase 8: omni4 and tric on the default route. ----
    _set_route("1")
    record["default_route"] = {}
    for geometry in ("omni4", "tric"):
        spec_g, data_g = _controller(torch, dev, geometry=geometry)
        r = run_ticks(spec_g, data_g, 2048, f"phase 8 {geometry}")
        report(8, f"default route {geometry}", 2048, r, PER_TICK)
        record["default_route"][geometry] = r
    for name, v in record["ipm_omni4"].items():
        print(f"phase 8 omni4 {name} B=2048: kernel {v['ms']:.4f} ms per call "
              f"(device {v['device_ms']} ms), plain {v['plain_ms']:.4f} ms, "
              f"bound {v['bound_ms']:.4f} ms")

    # ---- Phase 9: goldens on the card, both routes: N=40 eager, N=80 graphed. ----
    record["goldens"] = {}
    n80 = ("diff_pose_N80", "omni4_pose_N80", "tric_pose_N80")
    for route, n40 in (("0", ("diff_pose_N40", "omni4_pose_N40", "tric_pose_N40",
                              "tric_bug_pose_N40")),
                       ("1", ("omni4_pose_N40", "tric_pose_N40"))):
        _set_route(route)
        label = "Riccati" if route == "0" else "default"
        for name, graphed in [(n, False) for n in n40] + [(n, True) for n in n80]:
            err = torch_golden.track(name, torch.float32, dev, graphed=graphed)
            how = "graphed" if graphed else "eager"
            print(f"phase 9 golden {name} on the card, {label} route, {how}: {err}")
            if not torch_golden.within_tolerance(err):
                raise AssertionError(f"golden {name} ({label} route, {how}) out of tolerance: "
                                     f"{err}")
            record["goldens"][f"{name}/{label}/{how}"] = err

    # ---- Phase 10: f64 controllers on the card, both routes. ----
    # f64 takes the plain versions on the card (qp.ipm.kernel_impl): no
    # kernel may launch, and the run agrees with the f64 CPU run to rounding.
    record["f64"] = {}
    for route in ("1", "0"):
        _set_route(route)
        runs = {}
        for where in ("card", "cpu"):
            d = dev if where == "card" else "cpu"
            spec_w, data_w = _controller(torch, d, torch.float64)
            inputs = [t.double() if t.is_floating_point() else t
                      for t in _bench_inputs(torch, 256, d)]
            st = controller_init(spec_w, 256, torch.float64, d)
            _build.reset_launch_counts()
            for _ in range(5):
                st, _, stats = controller_step(spec_w, data_w, st, *inputs)
            counts = _build.launch_counts()
            if counts or not bool(stats.ok.all()):
                raise AssertionError(f"phase 10 f64 {where} route {route}: launches {counts}, "
                                     f"{int((~stats.ok).sum())} lanes not ok")
            runs[where] = st.us.cpu()
        gap = float((runs["card"] - runs["cpu"]).abs().max())
        label = "Riccati" if route == "0" else "default"
        print(f"phase 10 f64 diff N=40 B=256 on the card, {label} route, 5 ticks: no kernel "
              f"launched, max |us_card - us_cpu| {gap:.3e}")
        if not gap <= F64_TOL:
            raise AssertionError(f"phase 10: f64 card and CPU runs differ by {gap:.3e}")
        record["f64"][label] = gap
    _set_route("1")

    # ---- Phase 11: the navigation tick, fleet and single robot. ----
    t_nav = time.perf_counter()
    record["nav"] = _phase_nav(torch, dev, {"2048": wide["graphed_ms"], "1": one["graphed_ms"]})
    print(f"phase 11: {time.perf_counter() - t_nav:.1f} s")

    # ---- Phase 12: the host runtime and the command line at N=80. ----
    record["runtime"] = _phase_runtime(torch)

    # ---- Phase 13: the parallel layers and the simulation demos. ----
    _set_route("1")
    t13 = time.perf_counter()
    record["fleet"] = _phase_fleet(torch, dev)
    record["long_horizon"] = _phase_long_horizon(torch, dev, kernels)
    record["multihost"] = _phase_multihost(torch, dev)
    record["demos"] = _phase_demos(torch, dev)
    print(f"phase 13: {time.perf_counter() - t13:.1f} s (fleet {record['fleet']['seconds']:.1f}, "
          f"N={LONG_N} {record['long_horizon']['seconds']:.1f}, multihost "
          f"{record['multihost']['seconds']:.1f}, demos {record['demos']['seconds']:.1f})")

    # ---- Phase 14: the AOT tick artifacts. ----
    record["aot"] = _phase_aot(torch, dev, smi)

    # ---- Phase 15: the bench, the scaling sweep and the probes. ----
    _set_route("1")
    record["measure"] = _phase_measure(torch, dev, smi,
                                       {"2048": wide["graphed_ms"], "1": one["graphed_ms"]},
                                       record["nav"]["diff/2048"]["graphed_ms"])

    elapsed = time.perf_counter() - t_start
    print(f"chip_smoke: all phases passed in {elapsed:.1f} s")
    out = {"kernels": [{k: v for k, v in e.items() if k != "device_ms"}
                       for e in kernels.values()]}
    record.update(out, device_ms={n: e.get("device_ms") for n, e in kernels.items()},
                  seconds=elapsed)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
