#!/usr/bin/env python3
"""Device time of the port's IPM sweep and Riccati kernels, for one or more
checkouts on one card, in one run (the torch port; needs a CUDA card,
imports no JAX).

    python3 tools/torch_sweep_times.py build/parent . . build/parent
    python3 tools/torch_sweep_times.py --n 80 --lanes 1,2,4 --ipm-only .

Each ROOT is the root of a checkout (its ``chip_smoke.py`` and
``nmpc_nav_control_tpu_torch``); each is measured in a process of its own,
in the order given, so old and new kernels can be compared on the same card
(parent, change, change, parent).  For the diff and omni4 specialisations at
N=40 and B = 2048 and 1 it prints, per sweep kernel, the device ms per call
from the profiler, on the inputs of ``chip_smoke.py`` phase 2 (random valid
IPM data; each sweep after the first takes the plain versions' outputs);
then the same for the three Riccati kernels at (nx, nu) = (7, 2) and (11, 4),
on random LQR data (the solve halves take the plain factors and kff, as in
phase 6).  ``--n`` and ``--lanes`` set the horizon and the batches,
``--ipm-only`` leaves the Riccati kernels out.  The last line is a JSON
list of every reading.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

N = 40
LANES = (2048, 1)
GEOMETRIES = {"diff": "config_diff.cuh", "omni4": "config_omni4.cuh"}
RICCATI_SHAPES = ((7, 2), (11, 4))


def measure(root, n=N, lanes_list=LANES, ipm_only=False):
    """Readings of one checkout: dicts of root, kernel, geometry, lanes, N, ms."""
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
                            lanes=lanes, N=n, device_ms=ms))
            print(f"{out[-1]['root']} {name} {geometry} N={n} B={lanes}: device {ms} ms",
                  flush=True)

    for geometry, header in GEOMETRIES.items():
        cfg = tp.SweepConfig(*_build.header_config(header))
        for lanes in lanes_list:
            x = random_sweep_inputs(cfg.nx, cfg.nu, cfg.nbx, cfg.nbu, cfg.asp, cfg.bsp, n, lanes,
                                    seed=lanes)
            read(chip_smoke._sweep_calls(torch, tp, cfg, x, dev), geometry, lanes)
    for nx, nu in () if ipm_only else RICCATI_SHAPES:
        for lanes in lanes_list:
            x = random_riccati_inputs(nx, nu, n, lanes, seed=lanes)
            read(chip_smoke._riccati_calls(torch, rf, x, dev), f"{nx}x{nu}", lanes)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*", default=["."])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--lanes", default=",".join(map(str, LANES)))
    ap.add_argument("--ipm-only", action="store_true")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv[1:])
    lanes = [int(v) for v in args.lanes.split(",")]
    if args.one:
        print(json.dumps(measure(args.roots[0], args.n, lanes, args.ipm_only)))
        return 0
    roots = args.roots
    opts = ["--n", str(args.n), "--lanes", args.lanes] + (["--ipm-only"] if args.ipm_only else [])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0])
    readings = []
    for root in roots:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root, *opts],
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
