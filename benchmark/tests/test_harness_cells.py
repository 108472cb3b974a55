"""The harness finds cells, configurations, traffic, workloads, kernels and
metrics by name, and BENCHMARK.json keeps to its contract."""
from __future__ import annotations

import json
import re
import sys

import pytest

from benchmark import harness
from benchmark import kernels as K
from benchmark.tests.conftest import CELLS, HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", list(CELLS))
def test_each_cell_loads_by_name(cell):
    c = harness.load_cell(ROOT, cell)
    assert c.driver.Driver is not None
    numbers = {"cmd_gap", "us_gap", "flag_mismatches"}
    if c.traffic["driver"] != "sweep":   # a node's state after the cycle is compared too
        numbers |= {"window_mismatches",
                    "state_rel_gap" if c.traffic["driver"] == "robot" else "state_gap"}
    assert set(c.check["limits"]) == numbers
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
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25
    for m in BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher") and m["workloads"]
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_cell_is_added_by_new_files_alone(tiny):
    for short in CELLS.values():
        c = harness.load_cell(tiny, short, tiny)
        groups = c.config.get("groups", {"one": c.config})
        assert all(g["tf_ini"] == 0.25 for g in groups.values())
        assert c.traffic["driver"] in ("robot", "fleet", "sweep")


def test_kernels_and_metrics_are_found_by_file(tmp_path, monkeypatch):
    assert set(K.load_all()) == {"ipm_bwd_fused", "ipm_fwd_affine", "ipm_bwd_corr",
                                 "ipm_fwd_corr", "ipm_kkt_fused"}
    pkg = tmp_path / "more"
    pkg.mkdir()
    (pkg / "extra_kernel.py").write_text(
        "PATTERN = 'extra'\n\ndef moved_bytes(d, N, B):\n    return 4 * N * B\n\n"
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
