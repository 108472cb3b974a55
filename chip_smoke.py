#!/usr/bin/env python3
"""Smoke run of the torch port (``nmpc_nav_control_tpu_torch``) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

It imports nothing of JAX.  Phases, each printing one line per result:

  1. device and build: the card's name and power limit from nvidia-smi;
     the CUDA kernels built from ``nmpc_nav_control_tpu_torch/csrc``;
  2. each kernel against its plain torch version on the card, on random
     valid IPM inputs at diff N=40 with B = 2048, 1 and 1000 (a ragged last
     block), within rtol 1e-4 / atol 1e-5; kernel and plain times at B=2048
     from CUDA events;
  3. the main path: 20 chained batched ``controller_step`` ticks, diff N=40,
     B=2048, 8 IPM iterations, f32, with the inputs of ``bench.py``; every
     lane ``ok``, finite ``kkt_res``, and the launch counts exactly 8/8/8/8/1
     per tick; ms per tick at B=2048 and at B=1 (CUDA events);
  4. card against CPU: 5 ticks at B=256 through the port on the card and on
     the CPU (plain sweeps), ``us`` within the f32 bounds of the golden suite
     (max 5e-3, mean 2e-4), with an f64 CPU run as referee;
  5. golden closed loop: ``diff_pose_N40`` replayed through
     ``tests/oracle/numpy_rti.closed_loop`` with the port's step on the card,
     within the bounds of ``tests/test_rti_oracle.py``.

Any failure raises, and the script exits non-zero.  Before the last line it
prints the kernels as one JSON object; the last line is
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


def _leaves(x):
    if isinstance(x, tuple):
        return [t for v in x for t in _leaves(v)]
    return [x]


def _errors(torch, got, ref):
    """(max abs error, max relative error, worst |err| / (atol + rtol |ref|))."""
    worst = [0.0, 0.0, 0.0]
    for g, r in zip(_leaves(got), _leaves(ref)):
        d = (g - r).abs()
        rel = d / r.abs().clamp_min(torch.finfo(r.dtype).tiny)
        excess = d / (ATOL + RTOL * r.abs())
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
                          lambda: tp.bwd_fused_plain(cfg, *bwd, reg=REG, d_cap=D_CAP)),
        "ipm_fwd_affine": (lambda: tp.ipm_fwd_affine(cfg, *fwd, tau=TAU),
                           lambda: tp.fwd_affine_plain(cfg, *fwd, tau=TAU)),
        "ipm_bwd_corr": (lambda: tp.ipm_bwd_corr(cfg, *bc),
                         lambda: tp.bwd_corr_plain(cfg, *bc)),
        "ipm_fwd_corr": (lambda: tp.ipm_fwd_corr(cfg, *fc, tau=TAU),
                         lambda: tp.fwd_corr_plain(cfg, *fc, tau=TAU)),
        "ipm_kkt_fused": (lambda: tp.ipm_kkt_fused(cfg, *kk),
                          lambda: tp.kkt_fused_plain(cfg, *kk)),
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


def _controller(torch, dev, dtype=None):
    """bench.py's diff controller (``_build``), N=40, 8 IPM iterations."""
    from nmpc_nav_control_tpu_torch.control import make_controller

    return make_controller(
        "diff", 1.0 / 40.0, N, dist_b=0.27, tau_v=0.1, v_max=1.0, a_max=2.0,
        q_diag=[10.0, 10.0, 5.0, 0, 0, 0, 0], r_diag=[1.0, 1.0], ipm_iters=8,
        dtype=dtype or torch.float32, device=dev)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from nmpc_nav_control_tpu_torch.control import controller_init, controller_step
    from nmpc_nav_control_tpu_torch.ops import _build
    from nmpc_nav_control_tpu_torch.ops import ipm_fused as tp
    import torch_golden
    from torch_sweep_inputs import random_sweep_inputs

    dev = torch.device("cuda", 0)
    record = {}

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
    record.update(device=smi, kind=kind, build_s=build_s, ptxas=log)

    spec, data = _controller(torch, dev)
    cfg = tp.SweepConfig(7, 2, (5, 6), (0, 1), *spec.rti.spars)

    # ---- Phase 2: each kernel against its plain version. ----
    kernels = {name: dict(name=name, route="cuda",
                          source="nmpc_nav_control_tpu_torch/csrc/ipm_fused.cu",
                          replaces=tp.KERNELS[name], launches=0, max_abs_err=0.0)
               for name in PER_TICK}
    for lanes in (2048, 1, 1000):
        x = random_sweep_inputs(7, 2, 2, 2, *spec.rti.spars, N, lanes, seed=lanes)
        for name, (kern, plain) in _sweep_calls(torch, tp, cfg, x, dev).items():
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            abs_err, rel_err, excess = _errors(torch, got, ref)
            print(f"phase 2 {name} B={lanes}: max abs err {abs_err:.3e}, "
                  f"max rel err {rel_err:.3e}, worst err/(atol+rtol|ref|) {excess:.3f}")
            if not excess <= 1.0:
                raise AssertionError(f"{name} B={lanes}: kernel disagrees with plain version")
            k = kernels[name]
            k["max_abs_err"] = max(k["max_abs_err"], abs_err)
            if lanes == 2048:
                # plain, kernel, kernel, plain: one card, one call, in turns.
                t = [_time_ms(torch, f) for f in (plain, kern, kern, plain)]
                k["ms"], k["plain_ms"] = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
                k["device_ms"] = _device_ms(torch, kern)
                print(f"phase 2 {name} B=2048: kernel {k['ms']:.4f} ms per call "
                      f"(device {k['device_ms']} ms), plain {k['plain_ms']:.4f} ms")

    # ---- Phase 3: the main path, bench inputs, 20 chained ticks. ----
    def run_ticks(lanes, count):
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

    ms_2048, counts, kkt_max = run_ticks(2048, count=True)
    want = {k: v * TICKS for k, v in PER_TICK.items()}
    print(f"phase 3 main path diff N=40 B=2048: {TICKS} ticks, all lanes ok, "
          f"max kkt_res {kkt_max:.3e}, launches {counts}")
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    for name in PER_TICK:
        kernels[name]["launches"] = counts[name]
    ms_1, _, _ = run_ticks(1, count=False)
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

    out = {"kernels": list(kernels.values())}
    record.update(out)
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
