"""The harness's data model: cells found by name, statistics and the result.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Everything else
is found by name under this folder:

  configs/<file>              the configuration (the upstream YAML's keys, and
                              optionally ``precision``: its arithmetic)
  traffic/<traffic>.json      the traffic mix; its ``driver`` names
                              ``drivers/<driver>.py``
  workloads/<cell>.json       what the correctness check samples, and its limits
  metrics/<metric>.py         a per-layer metric's reader (the name up to its
                              first dot: ``device_idle_frac.ticks`` is read by
                              ``metrics/device_idle_frac.py``)
  kernels/<kernel>.py         a kernel's name in the trace, bytes and flops

so a later cell or metric is added with new files alone.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nmpc_nav_control_tpu")
PRECISIONS = ("float32", "float64")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict               # the workloads entry
    config: dict              # the configuration file's contents
    traffic: dict             # the traffic mix
    check: dict               # workloads/<cell>.json: samples and limits
    end_to_end: list          # BENCHMARK.json metrics this cell reports
    per_layer: list

    @property
    def driver(self):
        return importlib.import_module(f"benchmark.drivers.{self.traffic['driver']}")

    @property
    def dtype(self):
        """The ``torch.dtype`` the configuration states in its top-level
        ``precision`` (a fleet's covers every group); float32 where it
        states none.  The drivers, the reference, the control and the
        kernel count all take the cell's arithmetic from here."""
        import torch

        name = self.config.get("precision", "float32")
        if name not in PRECISIONS:
            raise ValueError(f"{self.name}: precision {name!r} is not one of {PRECISIONS}")
        return getattr(torch, name)


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(root: Path, name: str, here: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files under ``here``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, entry, json.loads((root / conf["file"]).read_text()),
                json.loads((here / "traffic" / f"{entry['traffic']}.json").read_text()),
                json.loads((here / "workloads" / f"{name}.json").read_text()),
                e2e, per_layer)


def reader(metric: str):
    """The per-layer metric's reader module."""
    return importlib.import_module(f"benchmark.metrics.{metric.split('.')[0]}")


def percentile(values, p: float) -> float:
    """Nearest-rank percentile over every value (inf for a failed one)."""
    v = sorted(values)
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's (whole names: the port's package is allowed)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class GpuSampler:
    """``nvidia-smi`` readings of clock, power and its limit, taken without
    waiting: ``mark`` starts a reading, ``readings`` collects them all."""

    QUERY = ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"]

    def __init__(self):
        self.procs = []

    def mark(self, label: str) -> None:
        try:
            p = subprocess.Popen(self.QUERY, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                                 text=True)
        except OSError:
            return
        self.procs.append((label, p))

    def readings(self) -> dict:
        out = {}
        for label, p in self.procs:
            text, _ = p.communicate(timeout=30)
            out[label] = text.strip().splitlines()[0] if text.strip() else None
        self.procs = []
        return out


def checks_of(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every compared number."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
