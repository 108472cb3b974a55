"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole), and the reference loads nothing of the program."""
from __future__ import annotations

import subprocess
import sys

from benchmark import harness
from benchmark.tests.conftest import CELLS, ROOT


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT),
                                           "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "nmpc_nav_control_tpu_torch.fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlib_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    monkeypatch.setitem(sys.modules, "nmpc_nav_control_tpu.x", sys)
    assert harness.forbidden_modules() == ["jaxlib", "nmpc_nav_control_tpu"]


def test_a_run_loads_no_jax(tiny):
    one_per_driver = sorted({d: c for c, d in CELLS.items()}.values())
    code = f"""
import torch
torch.set_num_threads(2)
import benchmark.run as run
from pathlib import Path
from benchmark import harness
root = Path({str(tiny)!r})
for cell in {one_per_driver!r}:
    res = run.run_cell(harness.load_cell(root, cell, root), 5, 2.0, False, device="cpu")
    assert res["correct"], res
print(harness.forbidden_modules())
"""
    assert _run(code) == "[]"


def test_the_reference_loads_nothing_of_the_program():
    code = """
import sys
import benchmark.reference.controller, benchmark.reference.navigation, benchmark.reference.models
print(sorted(m for m in sys.modules if m.split('.')[0].startswith('nmpc_nav_control_tpu')))
"""
    assert _run(code) == "[]"
