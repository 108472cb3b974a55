"""The correctness check's readings: the program's and its control's.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] --seconds <s>

For each seed, one process set-up of the cell, a window of ``--seconds`` at
the cell's own load, then the compared numbers of the program's sampled
ticks against the reference in the configuration's precision (float32 with
TF32 off, or float64), and of the control: the reference itself put in the
program's place and computed in the nearest precision below (float32 with
TF32 matrix products, or float32 with TF32 off), against the same reference
on the same samples.
One JSON line per seed.  The limits in ``workloads/<cell>.json`` lie
between the two: above the largest program reading, below the smallest
control reading.  The benchmark's own runs do not run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, seconds: float, device="cuda") -> dict:
    """{"program": numbers, "control": numbers} of one seed's window."""
    from benchmark import loop
    from benchmark.reference.controller import control, reference

    driver = cell.driver.Driver(cell, seed, device)
    driver.warm()
    driver.window(seconds)
    driver.release()
    refs = driver.outputs(reference(cell.dtype), device)
    ctl = driver.outputs(control(cell.dtype), device)
    return {"program": loop.worst([loop.gaps(prog, ref) for ref, prog in refs]),
            "control": loop.worst([loop.gaps(c, r) for (c, _), (r, _) in zip(ctl, refs)])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    import benchmark.run as run

    run._env()
    cell = harness.load_cell(ROOT, args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(cell, seed, args.seconds)
        print(json.dumps(dict(workload=args.workload, seed=seed, s=time.perf_counter() - t,
                              limits=cell.check["limits"], **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
