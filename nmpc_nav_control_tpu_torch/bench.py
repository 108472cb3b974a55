"""Benchmark sweep of the port: batched NMPC solves/s on one card across
geometry, horizon and batch.

Port of ``bench.py`` (the JAX package's benchmark).  It prints one JSON
line per configuration, with ``bench.py``'s metric names, e.g.
  {"metric": "nmpc_solves_per_s_per_chip_N40", "value": ..., "unit": "solves/s",
   "vs_baseline": ..., "config": {..., "device": "NVIDIA H100 80GB HBM3, 700.00 W"}, ...}
and finishes with the headline configuration (diff, N=40, B=2048) as the
last line.  The metric counts full RTI solves (``controller_step``: the yref
chain, the packed linearization, the cost blocks and the 8-iteration box-IPM
whose sweeps are the CUDA kernels), batched over scenarios on one card.

Timing: the chained-slope method of ``bench.py``.  On the card the inputs
are loaded once into a ``GraphedController`` (``GraphedNavigator`` for the
fleet line); a chain of k dependent ticks is k replays of its CUDA graph,
each reading the state the one before wrote, and
``utils/profiling.py::steady_state_seconds_per_step`` times chains of
``BENCH_CHAIN_LO`` and ``BENCH_CHAIN_HI`` replays with CUDA events, best of
``BENCH_REPS``, and returns the slope.  Every tick's ``kkt_res`` is checked
finite in an untimed chain before the timed ones, so that no host read or
extra op falls inside a timed chain.  With ``--device cpu`` the chain is
eager ``controller_step`` (``node_tick``) calls timed on the host clock: a
check of the control flow, not a measurement of the card.

Baseline: the reference runs 1 robot x 40 solves/s on a CPU
(``NMPCNavControlROS.cpp:36-41``; BASELINE.md).  vs_baseline = value / 40.
The roofline shares use the H100 SXM's data-sheet figures, 3.35 TB/s of
HBM and 67 TFLOP/s of f32 outside the tensor cores: ``hbm_roofline_frac``
against the full-streaming byte model of :func:`_hbm_bytes_per_solve` and
``f32_peak_frac`` against :func:`_flops_per_solve`.

Sweep control (``bench.py``'s variables):
  BENCH_SWEEP=headline   only the headline config
  BENCH_SWEEP=full       geometry x {N=40,80} x {B=2048,4096} + B=1 latency
                         + fleet line (default)
  BENCH_GEOMETRY / BENCH_HORIZON / BENCH_BATCH   a single custom config
  BENCH_REPS (10), BENCH_CHAIN_LO (1), BENCH_CHAIN_HI (33)

The aggregate goes to ``BENCH_torch.json`` (full sweep) or
``BENCH_torch_partial.json`` at the checkout's root; ``BENCH.json`` holds
the TPU history and is never written.  A failed latency or fleet
measurement prints an ``"error"`` line and makes ``main`` return 1.
Run: ``python -m nmpc_nav_control_tpu_torch bench [--device cuda|cpu]``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import traceback

import numpy as np
import torch

from nmpc_nav_control_tpu_torch.utils.profiling import steady_state_seconds_per_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_SOLVES_PER_S = 40.0      # 1 robot x 40 Hz on the reference CPU node
BUDGET_MS = 25.0                  # the 40 Hz real-time tick budget
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12           # H100 SXM, f32 outside the tensor cores
HEADLINE_B = 2048
FLEET_B = 2048

# bench.py's controllers (``_build``): dt 1/40, each geometry's parameters.
CONTROLLER_KW = {
    "diff": dict(dist_b=0.27, tau_v=0.1, v_max=1.0, a_max=2.0,
                 q_diag=[10.0, 10.0, 5.0, 0, 0, 0, 0], r_diag=[1.0, 1.0]),
    "omni4": dict(l1_plus_l2=0.535, tau_v=0.1, v_max=1.0, a_max=1.0,
                  q_diag=[10.0, 10.0, 5.0] + [0.0] * 8, r_diag=[1.0] * 4),
    "tric": dict(dist_d=1.05, tau_v=0.1, tau_a=0.1, v_max=1.0, a_max=2.0,
                 alpha_min=-math.radians(60.0), alpha_max=math.radians(60.0),
                 dalpha_max=math.radians(90.0), q_diag=[10.0, 10.0, 5.0, 0, 0, 0, 0],
                 r_diag=[1.0, 1.0]),
}


def _flops_per_solve(nx, nu, nnzA, nnzB, nbx, nbu, N, iters):
    """Analytic FLOP estimate of one full RTI solve, counted from the
    algorithm: RK4 linearization with forward sensitivities + per-iteration
    factor/solve sweeps with the A/B sparsity the kernels exploit.  FMA = 2
    flops.  Estimate class: +-20%.  ``bench.py``'s arithmetic, to the
    integer."""
    cf = 12 * nx                     # continuous dynamics eval (approx)
    lin = N * (4 * cf * (1 + 2 * (nx + nu)) + 12 * nx)
    tri = nu * (nu + 1) // 2
    factor = (
        2 * nx * nnzA + 2 * nx * nnzB       # P@A, P@B
        + 2 * tri * nx + 2 * nnzB * nx      # Quu, Qux
        + nu ** 3 // 3 + 2 * nx * nu ** 2   # chol + K solve
        + 2 * nx * nnzA + 2 * nu * nx * nx  # P update (A'PA sym + Qux'K)
        + 2 * nx * nx                       # Pc
        + 2 * (nnzA + nnzB)                 # dynamics residual
    )
    vec_bwd = 2 * (nnzA + nnzB + nu * nx + nu * nu + 3 * nx)
    fwd = 2 * (nu * nx + nnzA + nnzB) + 14 * (nbx + nbu)
    barrier = 30 * (nbx + nbu)
    per_iter_stage = factor + 2 * vec_bwd + 2 * fwd + barrier
    return lin + iters * N * per_iter_stage


def _hbm_bytes_per_solve(nx, nu, nnzA, nnzB, nbx, nbu, N, iters):
    """Analytic streaming bytes of one solve on the fused-sweep route.

    Counts every per-stage tensor each of the four IPM sweeps reads and
    writes per iteration (``ipm_bwd_fused``, ``ipm_fwd_affine``,
    ``ipm_bwd_corr``, ``ipm_fwd_corr``) plus the iterate update, at f32
    (4 B/entry), and the one-time costs (linearization write-out, the
    post-solve KKT sweep) as a single extra pass.  ``bench.py``'s
    arithmetic, to the integer.

    This is the full-streaming upper model: every operand of every sweep is
    assumed to make a round trip to HBM.  Operands that stay in the L2
    between sweeps do not, so ``hbm_roofline_frac`` (the streaming floor
    time over the measured time) reads what the tick would need at the
    HBM's rate if nothing were cached, not the bytes the kernels move.
    """
    a, b, x, u = nnzA, nnzB, nx, nu
    S = nbx + nbu
    tri = u * (u + 1) // 2
    in1 = a + b + 5 * x + 3 * u + 6 * S
    out1 = u * x + tri + 2 * x + u + 2 * S
    in2 = a + b + u * x + u + x + 6 * S
    out2 = 2 * S
    in3 = a + b + u * x + tri + 3 * x + 3 * u + 8 * S
    out3 = u
    in4 = a + b + u * x + u + x + 8 * S
    out4 = x + u + 4 * S
    update = 3 * (x + u + 4 * S)
    e_iter = in1 + out1 + in2 + out2 + in3 + out3 + in4 + out4 + update
    e_once = 3 * (a + b) + 8 * x + 4 * u + 4 * S   # linearize + KKT pass
    return 4 * N * (iters * e_iter + e_once)


def _build(geom, N, ipm_iters=8, dtype=torch.float32, device="cuda"):
    """``bench.py``'s controller for a geometry: (spec, data) on ``device``."""
    from nmpc_nav_control_tpu_torch.control import make_controller

    if geom not in CONTROLLER_KW:
        raise SystemExit(f"unknown geometry {geom!r}")
    return make_controller(geom, 1.0 / 40.0, N, ipm_iters=ipm_iters, dtype=dtype,
                           device=device, **CONTROLLER_KW[geom])


def _counts(spec, N):
    """(flops, streaming bytes) of one solve of ``spec``."""
    m = spec.dims.model
    asp, bsp = spec.rti.spars
    args = (m.nx, m.nu, sum(map(sum, asp)), sum(map(sum, bsp)), len(m.idxbx),
            len(m.idxbu), N, spec.rti.ipm_iters)
    return _flops_per_solve(*args), _hbm_bytes_per_solve(*args)


def _inputs(B, N, device):
    """``bench.py::_measure_config``'s per-lane inputs, same generator and
    order: (poses, vels, trajs, n_valids)."""
    rng = np.random.default_rng(0)
    poses = rng.normal(size=(B, 3)) * 0.1
    vels = rng.normal(size=(B, 3)) * 0.1
    trajs = np.zeros((B, N + 1, 3))
    trajs[:, 0, 0] = rng.uniform(0.3, 1.5, size=(B,))
    f32 = torch.float32
    return (torch.tensor(poses, dtype=f32, device=device),
            torch.tensor(vels, dtype=f32, device=device),
            torch.tensor(trajs, dtype=f32, device=device),
            torch.ones(B, dtype=torch.int32, device=device))


def _slope(step, carry, reps, k_lo, k_hi, device):
    """Chained-slope seconds per step; a non-positive slope (a noise spike
    on the short chain) is measured once more, then raises."""
    for _ in range(2):
        per_step = steady_state_seconds_per_step(step, carry, k_lo=k_lo, k_hi=k_hi,
                                                 reps=reps, device=device)
        if per_step > 0:
            return per_step
    raise RuntimeError("non-positive marginal step time (noisy device?)")


def _check_chain(step, carry, k, what):
    """Run ``k`` chained steps outside any timed chain and raise unless
    every tick's outputs (``step`` returns (state, outputs), with
    ``kkt_res`` first) and the anti-DCE sum of ``bench.py`` (the last
    state's ``xs`` and every output) are finite.  Returns the carry."""
    outs = []
    for _ in range(k):
        carry = step(carry)
        outs.append(tuple(o.clone() for o in carry[1]))
    stacked = [torch.stack(col) for col in zip(*outs)]
    rti = getattr(carry[0], "rti", carry[0])           # NodeState or RTIState
    total = rti.xs.sum() + sum(s.sum() for s in stacked)
    if not (bool(torch.isfinite(stacked[0]).all()) and bool(torch.isfinite(total))):
        raise RuntimeError(f"non-finite KKT residuals in {what}")
    return carry


def _measure_config(geom, N, B, reps, k_lo, k_hi, device="cuda"):
    """Steady-state seconds per batched solve of ``B`` lanes by the chained
    slope, with the analytic flops and streaming bytes of one solve:
    (per_step, flops_per_solve, hbm_bytes_per_solve)."""
    from nmpc_nav_control_tpu_torch.control import (
        GraphedController,
        controller_init,
        controller_step,
    )

    device = torch.device(device)
    spec, data = _build(geom, N, device=device)
    inputs = _inputs(B, N, device)
    if device.type == "cuda":
        graphed = GraphedController(spec, data, B)
        graphed.load_inputs(*inputs)
        graphed.capture()

        def step(carry):
            _, stats = graphed._replay()
            return graphed.state, (stats.kkt_res,)

        carry = (graphed.state, ())
    else:
        def step(carry):
            state, _, stats = controller_step(spec, data, carry[0], *inputs)
            return state, (stats.kkt_res,)

        carry = (controller_init(spec, B, torch.float32, device), ())
    carry = _check_chain(step, carry, k_hi, f"the {geom} N={N} B={B} batch")
    per_step = _slope(step, carry, reps, k_lo, k_hi, device)
    return (per_step, *_counts(spec, N))


def _fleet_state(spec, cfg, B, device):
    """``bench.py::_measure_fleet``'s lanes: a 50 m line at 0.5 m/s set on
    every lane as a path (request 1), every robot at the origin with valid
    measurements: (NodeState, Measurements)."""
    from nmpc_nav_control_tpu_torch.control import state_machine as sm
    from nmpc_nav_control_tpu_torch.paths import PathSegment, make_line_segment

    seg = make_line_segment((0.0, 0.0), (50.0, 0.0), velocity=0.5, device=device)
    segs = PathSegment(*(
        torch.cat([x[None], torch.zeros((cfg.path_capacity - 1,) + x.shape, dtype=x.dtype,
                                        device=device)])[None].expand(B, *((-1,) * (x.dim() + 1)))
        for x in seg))
    state = sm.on_path_set(sm.node_init(spec, cfg, B, torch.float32, device), cfg, segs, 1, 1)
    flag = torch.ones(B, dtype=torch.bool, device=device)
    zeros = torch.zeros(B, 3, device=device)
    return state, sm.Measurements(zeros, zeros.clone(), zeros[:, 0].clone(), flag, flag, flag)


def _measure_fleet(geom, N, B, reps, k_lo, k_hi, device="cuda"):
    """Steady-state seconds per tick of the full navigation tick
    (``node_tick``: projection, windowing, the resampler, the safety and
    termination lanes and the solve) for ``B`` robots following a path."""
    from nmpc_nav_control_tpu_torch.control import GraphedNavigator
    from nmpc_nav_control_tpu_torch.control import state_machine as sm

    device = torch.device(device)
    spec, data = _build(geom, N, device=device)
    cfg = sm.NavConfig()
    state0, meas = _fleet_state(spec, cfg, B, device)
    if device.type == "cuda":
        nav = GraphedNavigator(spec, data, cfg, B)
        nav.load_state(state0)
        nav.load_measurements(meas)
        nav.capture()

        def step(carry):
            out = nav._replay()
            return nav.state, (out.kkt_res, out.cmd.v)

        carry = (nav.state, ())
    else:
        def step(carry):
            state, out = sm.node_tick(spec, data, cfg, carry[0], meas)
            return state, (out.kkt_res, out.cmd.v)

        carry = (state0, ())
    carry = _check_chain(step, carry, k_hi, "the fleet batch")
    return _slope(step, carry, reps, k_lo, k_hi, device)


def device_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them, or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _emit(geom, N, B, per_step, flops_per_solve, hbm_bytes=None, extra=None, device="cpu"):
    """Print and return one record; ``device`` is :func:`device_label`'s."""
    solves_per_s = B / per_step
    suffix = "" if geom == "diff" else f"_{geom}"
    rec = {
        "metric": f"nmpc_solves_per_s_per_chip_N{N}{suffix}",
        "value": round(solves_per_s, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / BASELINE_SOLVES_PER_S, 2),
        "config": {"geometry": geom, "N": N, "batch": B,
                   "ipm_iters": 8, "dtype": "float32", "device": device},
    }
    if flops_per_solve:
        achieved = flops_per_solve * solves_per_s
        rec["flops_per_solve"] = round(flops_per_solve)
        rec["achieved_gflops"] = round(achieved / 1e9, 1)
        rec["f32_peak_frac"] = round(achieved / F32_FLOPS_PER_S, 4)
    if hbm_bytes:
        rec["hbm_bytes_per_solve"] = round(hbm_bytes)
        rec["hbm_gb_per_s"] = round(hbm_bytes * solves_per_s / 1e9, 1)
        rec["hbm_roofline_frac"] = round(hbm_bytes * solves_per_s / HBM_BYTES_PER_S, 4)
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)
    return rec


def _custom(env) -> bool:
    return any(k in env for k in ("BENCH_GEOMETRY", "BENCH_HORIZON", "BENCH_BATCH"))


def configs(sweep, env) -> list:
    """The (geometry, N, B) list ``bench.py::main`` measures for a
    ``BENCH_SWEEP`` value and an environment, the headline last."""
    headline = ("diff", 40, int(env.get("BENCH_BATCH", str(HEADLINE_B))))
    if _custom(env):
        return [(env.get("BENCH_GEOMETRY", "diff"), int(env.get("BENCH_HORIZON", "40")),
                 int(env.get("BENCH_BATCH", str(HEADLINE_B))))]
    if sweep == "headline":
        return [headline]
    # All geometries, both reference horizons (the reference default config
    # yields N=80), two batch sizes; headline last so tail-parsers take it.
    return [
        ("diff", 40, 4096),
        ("diff", 80, 2048),
        ("diff", 80, 4096),
        ("omni4", 40, 2048),
        ("omni4", 40, 4096),
        ("omni4", 80, 2048),
        ("tric", 40, 2048),
        ("tric", 40, 4096),
        ("tric", 80, 2048),
        headline,
    ]


def _probe(metric, measure):
    """A latency or fleet record, or an ``"error"`` line and None."""
    try:
        rec = measure()
    except Exception as e:  # the sweep goes on; main returns 1
        traceback.print_exc()
        print(json.dumps({"metric": metric, "error": str(e)}), flush=True)
        return None
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nmpc_nav_control_tpu_torch bench",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or on the CPU")
    device = torch.device(ap.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device (pass --device cpu to run on the CPU)")
    env = os.environ
    reps = int(env.get("BENCH_REPS", "10"))
    k_lo = int(env.get("BENCH_CHAIN_LO", "1"))
    k_hi = int(env.get("BENCH_CHAIN_HI", "33"))
    sweep = env.get("BENCH_SWEEP", "full")
    custom = _custom(env)
    todo = configs(sweep, env)
    label = device_label(device)

    def measure(geom, N, B, extra=None):
        per_step, flops, hbm = _measure_config(geom, N, B, reps, k_lo, k_hi, device)
        return _emit(geom, N, B, per_step, flops, hbm, extra=extra, device=label)

    records = [measure(*c) for c in todo[:-1]]
    headline_extra, failed = {}, False
    if sweep != "headline" and not custom:
        # One robot on the 25 ms budget: chained-slope tick latency at B=1.
        def latency():
            per_step = _measure_config("diff", 40, 1, reps, k_lo, k_hi, device)[0]
            return {"metric": "single_robot_tick_latency_ms_N40",
                    "value": round(per_step * 1e3, 4), "unit": "ms",
                    "vs_baseline": round(BUDGET_MS / (per_step * 1e3), 1),
                    "config": {"geometry": "diff", "N": 40, "batch": 1, "device": label,
                               "note": "vs_baseline = 25ms budget / latency"}}

        # The full FollowPath tick (projection + windowing + resampler +
        # safety + solve) over a robot fleet.
        def fleet():
            per_step = _measure_fleet("diff", 40, FLEET_B, reps, k_lo, k_hi, device)
            return {"metric": "fleet_nav_ticks_per_s_per_chip_N40",
                    "value": round(FLEET_B / per_step, 1), "unit": "ticks/s",
                    "vs_baseline": round(FLEET_B / per_step / BASELINE_SOLVES_PER_S, 2),
                    "config": {"geometry": "diff", "N": 40, "batch": FLEET_B, "device": label,
                               "note": "full FollowPath node_tick incl. path "
                                       "subsystem, not just the RTI solve"}}

        for metric, fn, key in (
                ("single_robot_tick_latency_ms_N40", latency, "single_robot_tick_latency_ms"),
                ("fleet_nav_ticks_per_s_per_chip_N40", fleet, "fleet_nav_ticks_per_s")):
            rec = _probe(metric, fn)
            if rec is None:
                failed = True
            else:
                records.append(rec)
                headline_extra[key] = rec["value"]

    # Headline last, with the latency and fleet numbers folded in.
    records.append(measure(*todo[-1], extra=headline_extra or None))
    name = "BENCH_torch.json" if sweep == "full" and not custom else "BENCH_torch_partial.json"
    with open(os.path.join(ROOT, name), "w") as f:
        json.dump({"records": records}, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
