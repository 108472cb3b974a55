#!/usr/bin/env python3
"""Smoke run of the torch port (``nmpc_nav_control_tpu_torch``) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

It imports nothing of JAX.  Phases, each printing one line per result:

  1. device and build: the card's name and power limit from nvidia-smi;
     the CUDA kernels built from ``nmpc_nav_control_tpu_torch/csrc``;
  2. each IPM sweep kernel against its plain torch version on the card, on
     random valid IPM inputs at N=40 for the diff and the omni4
     specialisations, with B = 2048, 1 and 1000 (a ragged last block),
     within rtol 1e-4 / atol 1e-5; kernel and plain times at B=2048 from
     CUDA events, device times from the profiler;
  3. the main path: 20 chained batched ``controller_step`` ticks, diff N=40,
     B=2048, 8 IPM iterations, f32, with the inputs of ``bench.py``; every
     lane ``ok``, finite ``kkt_res``, and the launch counts exactly 8/8/8/8/1
     per tick; ms per tick at B=2048 and at B=1 (CUDA events);
  4. card against CPU: 5 ticks at B=256 through the port on the card and on
     the CPU (plain sweeps), ``us`` within the f32 bounds of the golden suite
     (max 5e-3, mean 2e-4), with an f64 CPU run as referee;
  5. golden closed loop: ``diff_pose_N40`` replayed through
     ``tests/oracle/numpy_rti.closed_loop`` with the port's step on the card,
     within the bounds of ``tests/test_rti_oracle.py``;
  6. each Riccati kernel against its plain version on the card, at
     (nx, nu) = (7, 2) and (11, 4), N=40, B = 2048, 1 and 1000, within the
     f32 bounds of ``tests/test_pallas_riccati.py``; times at B=2048;
  7. the Riccati route (``NMPC_TPU_TILED_IPM=0``): 20 chained ticks of
     ``bench.py``'s omni4 configuration at B=2048, every lane ``ok``, launch
     counts exactly 8 / 16 / 16 Riccati kernels per tick and no IPM sweep;
     ms per tick at B=2048 and B=1; the same at B=2048 for diff and tric;
  8. omni4 and tric on the default route (the fused sweeps): launches
     8/8/8/8/1 per tick and no Riccati kernel, ms per tick;
  9. goldens on the card: ``diff_pose_N40``, ``omni4_pose_N40``,
     ``tric_pose_N40`` and ``tric_bug_pose_N40`` through the Riccati route,
     ``omni4_pose_N40`` and ``tric_pose_N40`` through the default route,
     within the golden bounds.

Any failure raises, and the script exits non-zero.  Before the last line it
prints the kernels as one JSON object (each with its bound: the bytes it
must read and write over 3.35 TB/s or its flops over the 67 TFLOP/s f32
peak, whichever is larger); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
A fuller record (with the nvcc/ptxas log) goes to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
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


def _device_ms(torch, fn, reps=10):
    """Device time per call from torch.profiler (CUPTI), for a call that
    launches one kernel and nothing else on the card; None if the trace
    shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages())
    return total / reps / 1000.0 if total > 0 else None


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
        "riccati_factor": (4 * nx ** 3 + 6 * nu * nx * nx + nu * (nu + 1) * nx
                           + 2 * nu * nu * nx + nu ** 3 + 2 * nx * nx),
        "riccati_solve_bwd": 4 * nx * nx + 4 * nx * nu + 2 * nu * nu + 2 * nx,
        "riccati_solve_fwd": 2 * nx * nx + 4 * nx * nu + 2 * nx,
    }[name]


def _bound(nbytes, flops):
    """(least ms the card needs, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from nmpc_nav_control_tpu_torch.control import controller_init, controller_step
    from nmpc_nav_control_tpu_torch.ops import _build
    from nmpc_nav_control_tpu_torch.ops import ipm_fused as tp
    from nmpc_nav_control_tpu_torch.ops import riccati_fused as rf
    import torch_golden
    from torch_sweep_inputs import random_riccati_inputs, random_sweep_inputs

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
    for fn, spill, reg in re.findall(
            r"entry function '(\w+)' for \S+\n.*\n\s*\d+ bytes stack frame, "
            r"(\d+) bytes spill stores.*\n.*Used (\d+) registers", log):
        m = re.search(r"([a-z]+(?:_[a-z]+)*_kernel)I(\w+?)EE", fn)
        print(f"phase 1 ptxas {m.group(1)}<{m.group(2)}>: {reg} registers, "
              f"{spill} bytes spill stores")
    record.update(device=smi, kind=kind, build_s=build_s, ptxas=log)

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
    # omni4 specialisation is checked and timed too (phase 8's path).
    record["ipm_omni4"] = {}
    for config in ("diff", "omni4"):
        spec_c = _controller(torch, "cpu", geometry=config)[0]
        m = spec_c.dims.model
        cfg = tp.SweepConfig(m.nx, m.nu, m.idxbx, m.idxbu, *spec_c.rti.spars)
        nx, nu, nbx, nbu = cfg.nx, cfg.nu, cfg.nbx, cfg.nbu
        for lanes in (2048, 1, 1000):
            x = random_sweep_inputs(nx, nu, nbx, nbu, cfg.asp, cfg.bsp, N, lanes, seed=lanes)
            for name, (kern, plain, args) in _sweep_calls(torch, tp, cfg, x, dev).items():
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                abs_err, rel_err, excess = _errors(torch, got, ref)
                print(f"phase 2 {name} {config} B={lanes}: max abs err {abs_err:.3e}, "
                      f"max rel err {rel_err:.3e}, worst err/(atol+rtol|ref|) {excess:.3f}")
                if not excess <= 1.0:
                    raise AssertionError(f"{name} {config} B={lanes}: kernel disagrees with plain")
                k = kernels[name]
                k["max_abs_err"] = max(k["max_abs_err"], abs_err)
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
    def run_ticks(spec, data, lanes, count):
        inputs = _bench_inputs(torch, lanes, dev)
        warm = controller_init(spec, lanes, torch.float32, dev)
        controller_step(spec, data, warm, *inputs)       # first-call set-up
        state = controller_init(spec, lanes, torch.float32, dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if count:
            _build.reset_launch_counts()
        start.record()
        stats_all = []
        for _ in range(TICKS):
            state, cmd, stats = controller_step(spec, data, state, *inputs)
            stats_all.append(stats)
        end.record()
        end.synchronize()
        counts = _build.launch_counts() if count else None
        ok = torch.stack([s.ok for s in stats_all])
        kkt = torch.stack([s.kkt_res for s in stats_all])
        if not bool(ok.all()) or not bool(torch.isfinite(kkt).all()):
            raise AssertionError(f"B={lanes}: {int((~ok).sum())} lane-ticks not ok")
        if not bool(torch.isfinite(cmd.v).all() & torch.isfinite(cmd.w).all()):
            raise AssertionError(f"B={lanes}: non-finite command")
        return start.elapsed_time(end) / TICKS, counts, float(kkt[-1].max())

    def check_counts(counts, per_tick, what):
        want = {k: v * TICKS for k, v in per_tick.items()}
        if counts != want:
            raise AssertionError(f"{what}: launch counts {counts}, expected exactly {want}")

    ms_2048, counts, kkt_max = run_ticks(spec, data, 2048, count=True)
    print(f"phase 3 main path diff N=40 B=2048: {TICKS} ticks, all lanes ok, "
          f"max kkt_res {kkt_max:.3e}, launches {counts}")
    check_counts(counts, PER_TICK, "phase 3")
    for name in PER_TICK:
        kernels[name]["launches"] = counts[name]
    ms_1, _, _ = run_ticks(spec, data, 1, count=False)
    print(f"phase 3 ms/tick: B=2048 {ms_2048:.3f} ms, B=1 {ms_1:.3f} ms")
    record.update(ms_per_tick_B2048=ms_2048, ms_per_tick_B1=ms_1, launches=counts)

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
    record["riccati_7x2"] = {}
    for nx, nu in ((7, 2), (11, 4)):
        for lanes in (2048, 1, 1000):
            x = random_riccati_inputs(nx, nu, N, lanes, seed=lanes)
            for name, (kern, plain, args, outs) in _riccati_calls(torch, rf, x, dev).items():
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                got_l, ref_l = _leaves(tuple(got)), _leaves(tuple(ref))
                abs_err, excess = 0.0, 0.0
                for out, g, r in zip(outs, got_l, ref_l):
                    e = _errors(torch, g, r, *RICCATI_TOL[out])
                    abs_err, excess = max(abs_err, e[0]), max(excess, e[2])
                print(f"phase 6 {name} ({nx},{nu}) B={lanes}: max abs err {abs_err:.3e}, "
                      f"worst err/(atol+rtol|ref|) {excess:.3f}")
                if not excess <= 1.0:
                    raise AssertionError(f"{name} ({nx},{nu}) B={lanes}: kernel disagrees "
                                         "with plain version")
                k = kernels[name]
                k["max_abs_err"] = max(k["max_abs_err"], abs_err)
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
        ms_g, counts, kkt_max = run_ticks(spec_g, data_g, 2048, count=True)
        print(f"phase 7 Riccati route {geometry} N=40 B=2048: {TICKS} ticks, all lanes ok, "
              f"max kkt_res {kkt_max:.3e}, launches {counts}, {ms_g:.3f} ms/tick")
        check_counts(counts, RICCATI_PER_TICK, f"phase 7 {geometry}")
        entry = dict(ms_per_tick_B2048=ms_g, launches=counts)
        if geometry == "omni4":
            for name in RICCATI_PER_TICK:
                kernels[name]["launches"] = counts[name]
            entry["ms_per_tick_B1"], _, _ = run_ticks(spec_g, data_g, 1, count=False)
            print(f"phase 7 Riccati route omni4 ms/tick: B=2048 {ms_g:.3f} ms, "
                  f"B=1 {entry['ms_per_tick_B1']:.3f} ms")
        record["riccati_route"][geometry] = entry

    # ---- Phase 8: omni4 and tric on the default route. ----
    _set_route("1")
    record["default_route"] = {}
    for geometry in ("omni4", "tric"):
        spec_g, data_g = _controller(torch, dev, geometry=geometry)
        ms_g, counts, kkt_max = run_ticks(spec_g, data_g, 2048, count=True)
        print(f"phase 8 default route {geometry} N=40 B=2048: {TICKS} ticks, all lanes ok, "
              f"max kkt_res {kkt_max:.3e}, launches {counts}, {ms_g:.3f} ms/tick")
        check_counts(counts, PER_TICK, f"phase 8 {geometry}")
        record["default_route"][geometry] = dict(ms_per_tick_B2048=ms_g, launches=counts)
    for name, v in record["ipm_omni4"].items():
        print(f"phase 8 omni4 {name} B=2048: kernel {v['ms']:.4f} ms per call "
              f"(device {v['device_ms']} ms), plain {v['plain_ms']:.4f} ms, "
              f"bound {v['bound_ms']:.4f} ms")

    # ---- Phase 9: goldens on the card, both routes. ----
    record["goldens"] = {}
    for route, names in (("0", ("diff_pose_N40", "omni4_pose_N40", "tric_pose_N40",
                                "tric_bug_pose_N40")),
                         ("1", ("omni4_pose_N40", "tric_pose_N40"))):
        _set_route(route)
        for name in names:
            err = torch_golden.track(name, torch.float32, dev)
            label = "Riccati" if route == "0" else "default"
            print(f"phase 9 golden {name} on the card, {label} route: {err}")
            if not torch_golden.within_tolerance(err):
                raise AssertionError(f"golden {name} ({label} route) out of tolerance: {err}")
            record["goldens"][f"{name}/{label}"] = err
    _set_route("1")

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
