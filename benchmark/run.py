"""Run one cell of the benchmark once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell needs.
Set-up (imports, the program's objects, the kernels' build and captures, the
warm-up ticks of the cell's own shapes) counts as ``setup_s``; then the
window runs for ``--seconds`` and gives the cell's end-to-end metrics
(``--trace 0``), or is followed by a few profiled ticks that give its
per-layer metrics (``--trace 1``).  After the window the program's memory
peak is read, its state freed, and the reference
(``benchmark/reference/``, in the configuration's precision) recomputes the
sampled ticks from the inputs the benchmark made: each compared number is
printed beside its limit on the last lines of standard error and under
``checks`` in the result.
Steadiness notes (rate or p50 by third of the window, ``nvidia-smi``
clocks and power) go to standard error before them.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
SETTLE_TICKS = 2      # profiled ticks before the traced window starts


def _env() -> None:
    """Caches in fixed directories of the checkout; no JAX through a library."""
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0][:96]


def per_layer(cell, trace, info, window: dict) -> tuple:
    """The cell's per-layer metrics and the trace's breakdown."""
    from benchmark import harness
    from benchmark import kernels as K
    from benchmark.metrics import Context

    ctx = Context(trace, info["ticks"], info["groups"], K.load_all(),
                  {label: K.dims(robot) for label, (robot, _) in info["groups"].items()}, window,
                  cell.dtype)
    metrics = {}
    for m in cell.per_layer:
        suffix = m["name"].split(".", 1)[1] if "." in m["name"] else ""
        value = harness.reader(m["name"]).read(ctx, suffix)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    by_op, by_gap = {}, {}
    for op in trace.ops:
        by_op[_short(op.name)] = by_op.get(_short(op.name), 0.0) + (op.end - op.start)
    for a, b in trace.gaps():
        label = trace.label_at(a)
        by_gap[label] = by_gap.get(label, 0.0) + (b - a)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return metrics, {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda") -> dict:
    """Set up, warm up, measure, check: the result (without ``device``)."""
    import torch

    from benchmark import harness, loop
    from benchmark import trace as tr
    from benchmark.reference.controller import reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = cell.driver.Driver(cell, seed, device)
    driver.warm()
    setup_s = time.perf_counter() - T_START
    if device != "cpu":
        from nmpc_nav_control_tpu_torch.ops import _build

        _log("launch counts at set-up (captures and eager warm-up ticks):",
             json.dumps(_build.launch_counts()))
    gpu = harness.GpuSampler() if device != "cpu" else None
    if gpu:
        gpu.mark("window start")
    win = driver.window(seconds, mark=gpu and (lambda i: gpu.mark(f"third {i} end")))
    if gpu:
        gpu.mark("window end")
    result = {"attempted": win["attempted"], "failed": win["failed"]}
    extra = {}
    if trace:
        path = BUILD / "benchmark" / f"trace_{cell.name}.json"
        t, info = tr.profile(lambda: driver.trace(driver.trace_ticks), path,
                             settle=lambda: driver.trace(SETTLE_TICKS))
        metrics, extra["breakdown"] = per_layer(cell, t, info, win["metrics"])
        _log("traced:", json.dumps(dict(window_s=t.window_s, busy_s=t.busy(), ticks=info["ticks"])))
        extra["device_trace"] = {"busy_s": t.busy(), "window_s": t.window_s}
    else:
        setup = {"setup_s": {"value": setup_s, "unit": "s"}}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = setup | {k: {"value": v, "unit": units[k]} for k, v in win["metrics"].items()
                           if k in units}
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    notes = dict(win["notes"], setup_s=setup_s)
    if gpu:
        notes["nvidia_smi"] = gpu.readings()
    _log("window:", json.dumps(notes))
    driver.release()
    t_check = time.perf_counter()
    pairs = driver.outputs(reference(cell.dtype), device)
    numbers = loop.worst([loop.gaps(prog, ref) for ref, prog in pairs])
    if numbers is None:        # no sampled tick fell inside the window: nothing judged
        numbers = {k: float("nan") for k in cell.check["limits"]}
    checks = harness.checks_of(numbers, cell.check["limits"])
    _log(f"reference check: {time.perf_counter() - t_check:.3f} s")
    result.update(correct=harness.correct(checks), metrics=metrics, peak=peak, checks=checks,
                  **extra)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    from benchmark import harness

    cell = harness.load_cell(ROOT, args.workload)
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"{args.workload} needs {chips} CUDA device(s); "
             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        _log("modules of JAX or the JAX package were loaded:", ", ".join(found))
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": res.pop("peak")}
    device.update(res.pop("device_trace", {}))
    for name, c in res["checks"].items():
        _log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": res["metrics"], "device": device}
    if "breakdown" in res:
        out["breakdown"] = res["breakdown"]
    out["checks"] = res["checks"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
