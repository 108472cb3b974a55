"""The port's command line (``python -m nmpc_nav_control_tpu_torch``)
against the JAX package's.

On the CPU (``--device cpu``, f32 as the JAX CLI runs):
- ``prepare`` on a small models YAML prints the JAX CLI's lines, numbers
  within 2e-3; a file with no ``*_params`` section returns 1 in both;
- ``run --no-rt`` on a small runtime YAML (N=10), to a goal and on a path:
  the JAX CLI's lines, numbers within 2e-3, except the timing line, where
  the cycle count and the budget are compared;
- ``export --platform cpu`` prints the JAX CLI's line and writes an
  artifact that ``runtime.aot.load_tick`` loads;
(Without a card the default device and ``--device cuda`` raise:
``test_torch_no_jax.py``.)

``gpu`` (skip without a card; this file imports JAX only inside its CPU
tests, so it runs with ``--noconftest`` where JAX is not installed):
- ``run`` on the card at the runtime YAMLs' N=80 reaches IDLE with the
  native timer, the capture's launches one tick's, and the cycles after the
  capture under the 25 ms budget at p50;
- a checkpoint of the graphed node, loaded into a fresh graphed node,
  resumes bit for bit.
"""
import ast
import os
import re

import pytest
import torch

from nmpc_nav_control_tpu_torch.__main__ import main as port_main

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PER_TICK = {"ipm_bwd_fused": 8, "ipm_fwd_affine": 8, "ipm_bwd_corr": 8, "ipm_fwd_corr": 8,
            "ipm_kkt_fused": 1}
NUMBER = re.compile(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?")

# N = ceil(0.25 * 20) = 5 (diff) and 5 (tric).
TINY_MODELS_YAML = """
diff_params:
  tf_ini: 0.25
  freq: 20
  dist_b: 0.270
  tau_v: 0.1
  v_max: 1.0
  a_max: 2.0
  Q_diag:  [10.0, 10.0, 5.0, 0.0, 0.0, 0.0, 0.0]
  R_diag:  [1.0, 1.0]
  QN_diag: [1000.0, 1000.0, 500.0, 0.0, 0.0, 0.0, 0.0]

tric_params:
  tf_ini: 0.25
  freq: 20
  dist_d: 0.270
  tau_v: 0.1
  tau_a: 0.5
  v_max: 1.0
  a_max: 1.0
  alpha_min: -30.0
  alpha_max: 30.0
  dalpha_max: 120.0
  Q_diag:  [10.0, 10.0, 5.0, 0.0, 0.0, 0.0, 0.0]
  R_diag:  [1.0, 1.0]
  QN_diag: [1000.0, 1000.0, 500.0, 0.0, 0.0, 0.0, 0.0]
"""

# N = ceil(0.5 * 20) = 10.
TINY_RUNTIME_YAML = """
steering_geometry: diff
control_freq: 20
tf_ini: 0.5
final_position_error: 0.03
final_orientation_error: 5.0
rob_dist_between_wh: 0.270
rob_wh_vel_time_const: 0.1
rob_wh_max_vel: 1.0
rob_wh_max_ace: 2.0
cost_matrix_weights_state_diag: [10.0, 10.0, 5.0, 0.0, 0.0, 0.0, 0.0]
cost_matrix_weights_input_diag: [1.0, 1.0]
"""


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _both(argv, capsys, monkeypatch):
    """(rc, stdout lines) of the port's CLI on the CPU and of the JAX CLI,
    on the same arguments; the Python timer's sleeps skipped."""
    import time

    from nmpc_nav_control_tpu.__main__ import main as jax_main

    monkeypatch.setattr(time, "sleep", lambda s: None)
    out = []
    for main, extra in ((port_main, ["--device", "cpu"]), (jax_main, [])):
        rc = main(argv + extra)
        out.append((rc, capsys.readouterr().out.splitlines()))
    return out


def _same_lines(got, want, timing_prefix="cycles="):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        if g.startswith(timing_prefix):
            keep = re.compile(r"cycles=\d+|budget=\d+ms")
            assert keep.findall(g) == keep.findall(w), (g, w)
            continue
        assert NUMBER.sub("#", g) == NUMBER.sub("#", w), (g, w)
        for a, b in zip(NUMBER.findall(g), NUMBER.findall(w)):
            assert abs(float(a) - float(b)) <= 2e-3, (g, w)


def test_cli_prepare_matches_jax(tmp_path, capsys, monkeypatch):
    models = _write(tmp_path, "models.yaml", TINY_MODELS_YAML)
    (trc, tout), (jrc, jout) = _both(["prepare", models], capsys, monkeypatch)
    assert trc == jrc == 0
    _same_lines(tout, jout)
    assert tout[-1] == "prepared 2 solver(s): diff, tric"
    (trc, tout), (jrc, jout) = _both(["prepare", models, "--geometry", "tric"], capsys,
                                     monkeypatch)
    assert trc == jrc == 0 and tout[-1] == jout[-1] == "prepared 1 solver(s): tric"
    bad = _write(tmp_path, "bad.yaml", "nothing: here\n")
    (trc, _), (jrc, _) = _both(["prepare", bad], capsys, monkeypatch)
    assert trc == jrc == 1


@pytest.mark.parametrize("mode", [["--goal", "0.4", "0.0", "0.0"],
                                  ["--path", "0", "0", "0.2", "0", "0.4", "0.02",
                                   "--path-vel", "0.3"]], ids=["goal", "path"])
def test_cli_run_matches_jax(tmp_path, capsys, monkeypatch, mode):
    cfg = _write(tmp_path, "runtime.yaml", TINY_RUNTIME_YAML)
    argv = ["run", "--config", cfg, "--ticks", "100", "--no-rt", *mode]
    (trc, tout), (jrc, jout) = _both(argv, capsys, monkeypatch)
    assert trc == jrc == 0
    _same_lines(tout, jout)
    assert "goal reached -> Idle" in tout


def test_cli_export_roundtrip(tmp_path, capsys):
    """``export`` writes an artifact that ``runtime.aot.load_tick`` loads and
    runs, and prints the JAX CLI's line (``tests/test_cli.py``)."""
    from nmpc_nav_control_tpu.__main__ import main as jax_main
    from nmpc_nav_control_tpu_torch.runtime.aot import load_tick

    cfg = _write(tmp_path, "runtime.yaml", TINY_RUNTIME_YAML)
    out, jax_out = tmp_path / "tick.aot", tmp_path / "jax_tick.aot"
    lines = []
    for main, path in ((port_main, out), (jax_main, jax_out)):
        assert main(["export", "--config", cfg, "-o", str(path), "--platform", "cpu"]) == 0
        lines.append([line.replace(str(path), "PATH")
                      for line in capsys.readouterr().out.splitlines()])
    assert lines[0] == lines[1] == [
        "exported diff tick (N=10, batch=None, platforms=['cpu']) -> PATH"]
    aot = load_tick(out.read_bytes(), device="cpu")
    assert aot.meta["geometry"] == "diff" and aot.meta["horizon"] == 10
    assert aot.meta["platforms"] == ["cpu"] and aot.meta["batch"] is None


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphed node has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cli_run_on_the_card(cuda_device, capsys):
    rc = port_main(["run", "--config", os.path.join(ROOT, "config", "runtime_diff.yaml"),
                    "--goal", "1.0", "0.0", "0.0", "--ticks", "300"])
    out = capsys.readouterr().out
    assert rc == 0 and "N=80" in out and "goal reached -> Idle" in out, out
    launches = re.search(r"launches (\{.*\})", out).group(1)
    assert ast.literal_eval(launches) == PER_TICK, out
    p50 = float(re.search(r"cycles after the capture: .*p50=([\d.]+)ms", out).group(1))
    assert p50 < 25.0 and "native timer" in out, out
    err = float(re.search(r"final position error: ([\d.]+) cm", out).group(1))
    assert err < 1.0, out


@pytest.mark.gpu
def test_checkpoint_resumes_the_graphed_node_on_the_card(cuda_device, tmp_path):
    from nmpc_nav_control_tpu_torch.runtime import (
        NmpcNavControlNode,
        ParametricPath,
        ParametricPathSet2,
        load_config,
    )
    from nmpc_nav_control_tpu_torch.runtime.checkpoint import load_state, save_state

    config = load_config(os.path.join(ROOT, "config", "runtime_diff.yaml"))
    msg = ParametricPathSet2(paths=[ParametricPath("map", [0.0, 1.0], [0.0, 0.0], 0.5)],
                             request_id=1)

    def meas(k):
        return (0.01 * k, 0.0, 0.0), (0.4, 0.0, 0.0)

    node = NmpcNavControlNode(config)
    node.on_path_no_stack_up_2(msg)
    for k in range(5):
        node.tick(*meas(k))
    path = str(tmp_path / "node.npz")
    save_state(path, node.state)
    fresh = NmpcNavControlNode(config)
    fresh.set_state(load_state(path, fresh.state))
    for k in range(5, 10):
        ta, sa = node.tick(*meas(k))
        tb, sb = fresh.tick(*meas(k))
        assert ta == tb and sa == sb and node.last_cmd == fresh.last_cmd, k
