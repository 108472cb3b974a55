#!/usr/bin/env python3
"""Device time of the port's IPM sweep and Riccati kernels, for one or more
checkouts on one card, in one run (the torch port; needs a CUDA card,
imports no JAX).

    python3 tools/torch_sweep_times.py build/parent . . build/parent

Each ROOT is the root of a checkout (its ``chip_smoke.py`` and
``nmpc_nav_control_tpu_torch``); each is measured in a process of its own,
in the order given, so old and new kernels can be compared on the same card
(parent, change, change, parent).  For the diff and omni4 specialisations at
N=40 and B = 2048 and 1 it prints, per sweep kernel, the device ms per call
from the profiler, on the inputs of ``chip_smoke.py`` phase 2 (random valid
IPM data; each sweep after the first takes the plain versions' outputs);
then the same for the three Riccati kernels at (nx, nu) = (7, 2) and (11, 4),
on random LQR data (the solve halves take the plain factors and kff, as in
phase 6).  The last line is a JSON list of every reading.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

N = 40
LANES = (2048, 1)
GEOMETRIES = {"diff": "config_diff.cuh", "omni4": "config_omni4.cuh"}
RICCATI_SHAPES = ((7, 2), (11, 4))


def measure(root):
    """Readings of one checkout: dicts of root, kernel, geometry, lanes, ms."""
    import torch

    root = os.path.abspath(root)
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import chip_smoke
    from nmpc_nav_control_tpu_torch.ops import _build
    from nmpc_nav_control_tpu_torch.ops import ipm_fused as tp
    from nmpc_nav_control_tpu_torch.ops import riccati_fused as rf
    from torch_sweep_inputs import random_riccati_inputs, random_sweep_inputs

    dev = torch.device("cuda", 0)
    _build.build()
    out = []

    def read(calls, geometry, lanes):
        for name, (kern, *_) in calls.items():
            ms = chip_smoke._device_ms(torch, kern, reps=20)
            out.append(dict(root=os.path.relpath(root), kernel=name, geometry=geometry,
                            lanes=lanes, device_ms=ms))
            print(f"{out[-1]['root']} {name} {geometry} N={N} B={lanes}: device {ms} ms",
                  flush=True)

    for geometry, header in GEOMETRIES.items():
        cfg = tp.SweepConfig(*_build.header_config(header))
        for lanes in LANES:
            x = random_sweep_inputs(cfg.nx, cfg.nu, cfg.nbx, cfg.nbu, cfg.asp, cfg.bsp, N, lanes,
                                    seed=lanes)
            read(chip_smoke._sweep_calls(torch, tp, cfg, x, dev), geometry, lanes)
    for nx, nu in RICCATI_SHAPES:
        for lanes in LANES:
            x = random_riccati_inputs(nx, nu, N, lanes, seed=lanes)
            read(chip_smoke._riccati_calls(torch, rf, x, dev), f"{nx}x{nu}", lanes)
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        print(json.dumps(measure(argv[2])))
        return 0
    roots = argv[1:] or ["."]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0])
    readings = []
    for root in roots:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                             capture_output=True, text=True, timeout=1200)
        sys.stdout.write("".join(run.stdout.splitlines(keepends=True)[:-1]))
        if run.returncode != 0:
            sys.stderr.write(run.stderr)
            return run.returncode
        readings += json.loads(run.stdout.splitlines()[-1])
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
