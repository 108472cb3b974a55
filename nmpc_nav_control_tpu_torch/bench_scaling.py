"""Multi-card data-parallel scaling benchmark of the port.

Port of ``bench_scaling.py``.  Target: >= 90% linear scaling of batched
NMPC tick throughput with card count (BASELINE.md / BASELINE.json north
star).  The data-parallel tick has no collective: each device owns its
scenario lanes, so the efficiency mostly reflects launch and
synchronisation overhead.

For each device count n (1, 2, 4, ... up to all), the batch of
``n * SCALING_BATCH_PER_CHIP`` lanes is split over a 1-D ``data`` mesh
(``parallel/sharding.py::make_mesh((n,), ("data",))``, each device one
contiguous ``lane_blocks`` block).  Each device holds a
``GraphedController`` over its block (eager ``controller_step`` calls on a
CPU mesh), and one chained step replays every device's graph in mesh
order.  The chained-slope method
(``utils/profiling.py::steady_state_seconds_per_step``) times chains of
steps: with several cards on the host clock, every card of the mesh
synchronised before and after each chain; with one card by CUDA events.
It prints one JSON line per count and a final ``scaling_efficiency`` line
(throughput_n / (n * throughput_1)).  With fewer than two CUDA devices
``main`` prints a ``skipped`` line; the CPU tests run the sweep on a mesh
that names ``cpu`` twice.

Env: SCALING_BATCH_PER_CHIP (default 1024), SCALING_HORIZON (default 40),
SCALING_REPS (5), SCALING_CHAIN_LO/HI (1, 9).
Run: ``python -m nmpc_nav_control_tpu_torch.bench_scaling``.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from nmpc_nav_control_tpu_torch.bench import _slope
from nmpc_nav_control_tpu_torch.parallel.sharding import (
    make_mesh,
    replicate,
    shard_leading_axis,
)


def _lanes(B, N):
    """``bench_scaling.py``'s inputs, same generator: (poses, vels, trajs,
    n_valids) on the CPU."""
    rng = np.random.default_rng(0)
    poses = torch.tensor(rng.normal(size=(B, 3)) * 0.1, dtype=torch.float32)
    trajs = torch.zeros(B, N + 1, 3)
    trajs[:, 0, 0] = 1.0
    return poses, torch.zeros(B, 3), trajs, torch.ones(B, dtype=torch.int32)


def _block_step(spec, data, inputs):
    """One device's tick over its lanes: a graph replay on a card, an
    eager ``controller_step`` elsewhere.  Returns (step(state) -> state,
    the first state)."""
    from nmpc_nav_control_tpu_torch.control import (
        GraphedController,
        controller_init,
        controller_step,
    )

    device = data.p.device
    B = inputs[0].shape[0]
    if device.type == "cuda":
        graphed = GraphedController(spec, data, B)
        graphed.load_inputs(*inputs)
        graphed.capture()

        def replay(state):
            _, stats = graphed._replay()
            return graphed.state, stats.kkt_res

        return replay, graphed.state

    def tick(state):
        state, _, stats = controller_step(spec, data, state, *inputs)
        return state, stats.kkt_res

    return tick, controller_init(spec, B, torch.float32, device)


def measure_scaling(device_counts=None, batch_per_chip=None, N=None, reps=None, k_lo=None,
                    k_hi=None, emit=print, devices=None):
    """Run the sweep over ``devices`` (default: every visible card);
    returns the list of per-count records."""
    from nmpc_nav_control_tpu_torch.control import make_controller

    batch_per_chip = batch_per_chip or int(os.environ.get("SCALING_BATCH_PER_CHIP", "1024"))
    N = N or int(os.environ.get("SCALING_HORIZON", "40"))
    reps = reps or int(os.environ.get("SCALING_REPS", "5"))
    k_lo = k_lo or int(os.environ.get("SCALING_CHAIN_LO", "1"))
    k_hi = k_hi or int(os.environ.get("SCALING_CHAIN_HI", "9"))

    if devices is None:
        devices = list(make_mesh().devices.ravel())
    if device_counts is None:
        device_counts, n = [], 1
        while n <= len(devices):
            device_counts.append(n)
            n *= 2
        if device_counts[-1] != len(devices):
            device_counts.append(len(devices))

    spec, data = make_controller(
        "diff", 0.025, N, dist_b=0.27, tau_v=0.1, v_max=1.0, a_max=2.0,
        q_diag=[10.0, 10.0, 5.0, 0, 0, 0, 0], r_diag=[1.0, 1.0], device="cpu")

    records = []
    for n_dev in device_counts:
        B = batch_per_chip * n_dev
        mesh = make_mesh((n_dev,), ("data",), devices=devices[:n_dev])
        blocks = shard_leading_axis(_lanes(B, N), mesh)
        ticks, states = zip(*(_block_step(spec, d, inputs)
                              for d, inputs in zip(replicate(data, mesh), blocks.blocks)))

        def step(carry):
            """One tick on every device; carry: [(state, kkt_res)] a device."""
            return [tick(state) for tick, (state, _) in zip(ticks, carry)]

        carry = [(state, None) for state in states]
        for _ in range(k_hi):                       # untimed check chain
            carry = step(carry)
            if not all(bool(torch.isfinite(kkt).all()) for _, kkt in carry):
                raise RuntimeError("non-finite solve in scaling sweep")
        thr = B / _slope(step, carry, reps, k_lo, k_hi, blocks.devices)
        rec = {"metric": "scaling_solves_per_s", "devices": n_dev,
               "batch": B, "value": round(thr, 1), "unit": "solves/s"}
        records.append(rec)
        emit(json.dumps(rec))

    base = records[0]["value"] / records[0]["devices"]
    last = records[-1]
    eff = (last["value"] / last["devices"]) / base
    emit(json.dumps({
        "metric": "scaling_efficiency",
        "value": round(eff, 4),
        "unit": "fraction",
        "vs_baseline": round(eff / 0.9, 3),   # target >= 0.9
        "config": {"devices": last["devices"],
                   "batch_per_chip": batch_per_chip, "N": N},
    }))
    return records


def main() -> int:
    n = torch.cuda.device_count()
    if n < 2:
        print(json.dumps({
            "metric": "scaling_efficiency",
            "skipped": True,
            "reason": f"only {n} CUDA device(s) visible; the sweep needs >= 2 cards "
                      "(exercised on a CPU mesh in tests/test_torch_bench.py)",
        }))
        return 0
    measure_scaling()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
