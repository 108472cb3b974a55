"""The harness finds cells, configurations, traffic, workloads, kernels and
metrics by name, and BENCHMARK.json keeps to its contract."""
from __future__ import annotations

import json
import re
import shutil
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark import kernels as K
from benchmark.tests.conftest import CELLS, HERE, ROOT, build_tiny, drivers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", list(CELLS))
def test_each_cell_loads_by_name(cell):
    c = harness.load_cell(ROOT, cell)
    assert c.driver.Driver is not None
    gaps, counts = ["cmd_gap", "us_gap"], {"flag_mismatches"}
    if c.traffic["driver"] != "sweep":   # a node's state after the cycle is compared too
        gaps.append("state_rel_gap" if c.traffic["driver"] == "robot" else "state_gap")
        counts.add("window_mismatches")
    split = {f"{g}_{part}" for g in gaps for part in ("on_path", "new_path")}
    assert set(c.check["limits"]) in (set(gaps) | counts, split | counts)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert hasattr(harness.reader(m["name"]), "read")


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and "\t" not in c["why"]
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4), "at most a quarter of the cells take 4"
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25
    for m in BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher") and m["workloads"]
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


def _groups(config: dict) -> list:
    return list(config.get("groups", {"one": config}).values())


def test_a_cell_is_added_by_new_files_alone(tiny):
    for cell, driver in CELLS.items():
        c = harness.load_cell(tiny, cell, tiny)
        assert all(g["tf_ini"] == 0.25 for g in _groups(c.config))
        assert [g["steering_geometry"] for g in _groups(c.config)] == [
            g["steering_geometry"] for g in _groups(harness.load_cell(ROOT, cell).config)]
        assert c.traffic["driver"] == driver


def add_cell(tmp_path, like: str, new: str, config_name: str, config: dict,
             check: dict) -> Path:
    """A copy of the benchmark under ``tmp_path`` with the cell ``new`` added
    the way a later change adds one: its configuration and its workload file
    as new files, and list entries (the cell, the configuration, the cell's
    name wherever the cell ``like`` is listed) alone; then cut to size.  The
    tiny copy's root."""
    src = tmp_path / "src"
    for d in ("configs", "traffic", "workloads"):
        shutil.copytree(HERE / d, src / "benchmark" / d)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == like)
    (src / "benchmark" / "configs" / f"{config_name}.json").write_text(json.dumps(config))
    (src / "benchmark" / "workloads" / f"{new}.json").write_text(json.dumps(check))
    bench["configs"].append(dict(name=config_name, source=bench["configs"][0]["source"],
                                 file=f"benchmark/configs/{config_name}.json", reduced=[],
                                 why=config_name))
    bench["workloads"].append(dict(entry, name=new, config=config_name))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(new)
    (src / "BENCHMARK.json").write_text(json.dumps(bench))
    assert drivers(src)[new] == CELLS[like] and new not in CELLS
    return build_tiny(src, tmp_path / "tiny")


def test_a_cell_the_repo_lacks_runs_from_new_files_and_list_entries(tmp_path):
    """A tric robot, which no cell of the benchmark runs, is added to a copy of
    the benchmark as new files (its configuration, its limits) and list
    entries alone, then cut to size, loaded by name and run correct."""
    import yaml

    from benchmark.run import run_cell

    repo_before = (ROOT / "BENCHMARK.json").read_bytes()
    robot = next(c for c, d in CELLS.items() if d == "robot")
    new = "robot_tric_n80_40hz"
    conf = yaml.safe_load((ROOT / "config" / "runtime_tric.yaml").read_text())
    tiny = add_cell(tmp_path, robot, new, "tric_n80", conf,
                    json.loads((HERE / "workloads" / f"{robot}.json").read_text()))
    c = harness.load_cell(tiny, new, tiny)
    assert c.config["steering_geometry"] == "tric" and c.config["tf_ini"] == 0.25
    like = harness.load_cell(ROOT, robot)
    assert [m["name"] for m in c.end_to_end + c.per_layer] == [
        m["name"] for m in like.end_to_end + like.per_layer]
    res = run_cell(c, 20241017, 1.0, False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert (ROOT / "BENCHMARK.json").read_bytes() == repo_before
    assert not (HERE / "workloads" / f"{new}.json").exists()


def test_kernels_and_metrics_are_found_by_file(tmp_path, monkeypatch):
    assert set(K.load_all()) == {"ipm_bwd_fused", "ipm_fwd_affine", "ipm_bwd_corr",
                                 "ipm_fwd_corr", "ipm_kkt_fused"}
    pkg = tmp_path / "more"
    pkg.mkdir()
    (pkg / "extra_kernel.py").write_text(
        "PATTERN = 'extra'\n\ndef entries(d, N, B):\n    return N * B\n\n"
        "def flops(d, N, B):\n    return N * B\n")
    (pkg / "extra_metric.py").write_text("def read(ctx, suffix):\n    return 1.0\n")
    monkeypatch.setattr(K, "__path__", list(K.__path__) + [str(pkg)])
    import benchmark.metrics as M

    monkeypatch.setattr(M, "__path__", list(M.__path__) + [str(pkg)])
    try:
        assert "extra_kernel" in K.load_all()
        assert K.which(K.load_all(), "void extra(float*)") == "extra_kernel"
        assert harness.reader("extra_metric.ticks").read(None, "ticks") == 1.0
    finally:
        for m in ("benchmark.kernels.extra_kernel", "benchmark.metrics.extra_metric"):
            sys.modules.pop(m, None)


def test_every_per_layer_metric_has_a_reader():
    files = {p.stem for p in (HERE / "metrics").glob("*.py")}
    for m in BENCH["per_layer"]:
        assert m["name"].split(".")[0] in files


# The float64 omni4 robot's limits at the tiny size (N=10, a 1 s window, 3
# sampled cycles): the program's float64 path on the CPU against the float64
# reference read at most cmd 4.1e-19, us 5.2e-18 and state_rel 3.4e-18 over
# 13 seeds (a few units in the last place), and the control, the reference
# in float32 with TF32 off, at least cmd 2.8e-10, us 2.8e-9 and state_rel
# 1.1e-8 on the same seeds; each limit lies between, nearer the control's.
F64_LIMITS = dict(cmd_gap=1e-13, us_gap=1e-12, state_rel_gap=1e-12, flag_mismatches=0,
                  window_mismatches=0)


def test_a_float64_cell_is_added_by_new_files_and_list_entries(tmp_path):
    """The upstream's omni4 robot in its solver's own float64: the omni4
    configuration with ``"precision": "float64"`` and the robot traffic, added
    as new files and list entries alone, runs correct through the port's
    float64 path, and its control (float32) breaks its limits."""
    from benchmark.control import readings
    from benchmark.run import run_cell

    like, new = "robot_omni4_n80_40hz", "robot_omni4_n80_f64_40hz"
    conf = json.loads((HERE / "configs" / "omni4_n80.json").read_text()) | {
        "precision": "float64"}
    check = json.loads((HERE / "workloads" / f"{like}.json").read_text()) | {
        "limits": F64_LIMITS}
    tiny = add_cell(tmp_path, like, new, "omni4_n80_f64", conf, check)
    c = harness.load_cell(tiny, new, tiny)
    assert c.dtype == torch.float64 and c.traffic["driver"] == "robot"
    assert c.config["tf_ini"] == 0.25 and c.check["limits"] == F64_LIMITS
    res = run_cell(c, 20241017, 1.0, False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    r = readings(c, 2 ** 31 + 77, 1.0, device="cpu")
    assert harness.correct(harness.checks_of(r["program"], F64_LIMITS)), r
    assert not harness.correct(harness.checks_of(r["control"], F64_LIMITS)), r
    assert r["control"]["us_gap"] > 1e3 * F64_LIMITS["us_gap"], r


def test_a_cells_precision_is_its_configurations():
    for cell in CELLS:
        c = harness.load_cell(ROOT, cell)
        assert c.dtype == torch.float32 and c.config.get("precision", "float32") == "float32"
    c = harness.load_cell(ROOT, next(iter(CELLS)))
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        c.config = dict(c.config, precision=name)
        assert c.dtype == dtype
    c.config["precision"] = "bfloat16"
    with pytest.raises(ValueError):
        _ = c.dtype
