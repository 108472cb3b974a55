"""Shared set-up of the benchmark's CPU tests: a tiny copy of each cell.

``tiny`` writes a checkout-like root holding a ``BENCHMARK.json`` whose cells
are the real ones cut to a CPU's size (N=10, a few lanes, short windows),
with their configuration, traffic and workload files beside it: new files
only, the way a later change adds a cell.  Everything is derived from the
entries of ``BENCHMARK.json`` and the files they name, so a cell added there
is covered by every test over ``CELLS`` with no edit here.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark import harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
TINY_TF_INI = 0.25        # s: N=10 at 40 Hz
TINY_LANES = 16           # a fleet's lanes, split as its configuration splits them
SMALL = {"robot": dict(warm_cycles=2), "fleet": dict(warm_ticks=2, redraw_ticks=16),
         "sweep": dict(lanes=16, warm_ticks=2, redraw_ticks=16)}


def _load(path):
    return json.loads(Path(path).read_text())


def drivers(root: Path = ROOT) -> dict:
    """{cell: the driver its traffic names} of every cell of ``root/BENCHMARK.json``."""
    return {w["name"]: harness.load_cell(root, w["name"], root / "benchmark").traffic["driver"]
            for w in _load(root / "BENCHMARK.json")["workloads"]}


CELLS = drivers()


def _cut(config: dict) -> dict:
    """The configuration at N=10, a fleet at ``TINY_LANES`` lanes; its geometry kept."""
    out = dict(config)
    if "groups" in out:
        out["groups"] = {k: g | {"tf_ini": TINY_TF_INI} for k, g in out["groups"].items()}
    else:
        out["tf_ini"] = TINY_TF_INI
    if "scenarios" in out:
        total = sum(out["scenarios"].values())
        out["scenarios"] = {k: max(1, n * TINY_LANES // total)
                            for k, n in out["scenarios"].items()}
    return out


def build_tiny(src: Path, root: Path) -> Path:
    """Write into ``root`` the tiny copy of the benchmark of the checkout ``src``."""
    for d in ("configs", "traffic", "workloads"):
        (root / d).mkdir(parents=True, exist_ok=True)
    bench = _load(src / "BENCHMARK.json")
    for c in bench["configs"]:
        config = _cut(_load(src / c["file"]))
        c["file"] = f"configs/{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(config))
    for w in bench["workloads"]:
        mix = _load(src / "benchmark" / "traffic" / f"{w['traffic']}.json")
        (root / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(mix | SMALL[mix["driver"]]))
        check = _load(src / "benchmark" / "workloads" / f"{w['name']}.json")
        check |= dict(sample_ticks=3, sample_lanes=1 if mix["driver"] == "robot" else 4)
        (root / "workloads" / f"{w['name']}.json").write_text(json.dumps(check))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return build_tiny(ROOT, tmp_path_factory.mktemp("tiny"))


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
