"""Shared set-up of the benchmark's CPU tests: a tiny copy of each cell.

``tiny`` writes a checkout-like root holding a ``BENCHMARK.json`` whose cells
are the real ones cut to a CPU's size (N=10, a few lanes, short windows),
with their traffic and workload files beside it: new files only, the way a
later change adds a cell.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
CELLS = {"robot_diff_n80_40hz": "r", "fleet_mixed_n80_moving": "fl", "sweep_diff_n80_b4096": "s"}


def _load(path):
    return json.loads(Path(path).read_text())


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("tiny")
    for d in ("configs", "traffic", "workloads"):
        (root / d).mkdir()
    bench = _load(ROOT / "BENCHMARK.json")
    diff = _load(HERE / "configs" / "diff_n80.json") | {"tf_ini": 0.25}
    fleet = _load(HERE / "configs" / "fleet_mixed_n80.json")
    fleet["groups"] = {k: v | {"tf_ini": 0.25} for k, v in fleet["groups"].items()}
    fleet["scenarios"] = {"diff": 8, "omni4": 4, "tric": 4}
    (root / "configs" / "d.json").write_text(json.dumps(diff))
    (root / "configs" / "f.json").write_text(json.dumps(fleet))
    bench["configs"] = [dict(name="d", source="s", file="configs/d.json", reduced=[], why="w"),
                        dict(name="f", source="s", file="configs/f.json", reduced=[], why="w")]
    traffic = {w["name"]: w["traffic"] for w in bench["workloads"]}
    bench["workloads"] = [dict(w, name=CELLS[w["name"]], config={"diff_n80": "d"}.get(
        w["config"], "f")) for w in bench["workloads"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELLS[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    small = {"robot": dict(warm_cycles=2), "fleet": dict(warm_ticks=2, redraw_ticks=16),
             "sweep": dict(lanes=16, warm_ticks=2, redraw_ticks=16)}
    for cell, short in CELLS.items():
        mix = _load(HERE / "traffic" / f"{traffic[cell]}.json")
        (root / "traffic" / f"{traffic[cell]}.json").write_text(
            json.dumps(mix | small[mix["driver"]]))
        check = _load(HERE / "workloads" / f"{cell}.json")
        check |= dict(sample_ticks=3, sample_lanes=4 if mix["driver"] != "robot" else 1)
        (root / "workloads" / f"{short}.json").write_text(json.dumps(check))
    return root


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
