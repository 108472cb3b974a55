"""The torch port runs where JAX is not installed.

In a subprocess where ``import jax`` fails, the port is imported and one
batched controller tick runs for each geometry on each IPM route (the fused
sweeps and the Riccati solve), then one navigation tick (``node_tick``, on a
path and on a goal) for each geometry, one tick of the runtime's node, and
the command line's ``run`` for 3 ticks and ``export`` for the CPU, the
artifact loaded (``runtime/aot.py``) and ticked once, which between them and
the host runtime's imports (executor, ingest, simulation, checkpoint,
native, models config, ROS bridge, profiling), the stage-parallel and
2-D mesh solves, a fleet tick on a mesh, both simulation demos, the
benchmark (``bench.main`` on a small custom configuration on the CPU),
the scaling sweep on a mesh that names ``cpu`` twice and both probes import
every module of the package; and no module of the package names JAX in an
import.  Without a
card, ``prepare_solvers`` and the command line (``bench`` included) raise
unless asked for the CPU, as the other entry points do
(``test_torch_slice.py::test_entry_points_default_to_the_card``), and so do
the parallel layers' meshes, ``init_distributed`` on NCCL, the simulation
demos, ``bench.main``, the probes and the scaling sweep.
"""
import ast
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "nmpc_nav_control_tpu_torch")

torch.set_num_threads(1)

SCRIPT = """
import os
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from nmpc_nav_control_tpu_torch.control import controller_init, controller_step, make_controller
import nmpc_nav_control_tpu_torch.convert
import nmpc_nav_control_tpu_torch.ops.riccati
GEOMETRIES = (("diff", dict(dist_b=0.27, q_diag=[1.0] * 7, r_diag=[1.0] * 2)),
              ("omni4", dict(l1_plus_l2=0.535, q_diag=[1.0] * 11, r_diag=[1.0] * 4)),
              ("tric", dict(dist_d=1.05, alpha_min=-1.0, alpha_max=1.0,
                            dalpha_max=1.5, q_diag=[1.0] * 7, r_diag=[1.0] * 2)))
for route in ("1", "0"):
    os.environ["NMPC_TPU_TILED_IPM"] = route
    for geometry, kw in GEOMETRIES:
        spec, data = make_controller(geometry, 0.025, 10, v_max=1.0, a_max=2.0, device="cpu", **kw)
        state = controller_init(spec, 2, device="cpu")
        traj = torch.zeros(2, 11, 3)
        traj[:, 0, 0] = 1.0
        state, cmd, stats = controller_step(spec, data, state, torch.zeros(2, 3),
                                            torch.zeros(2, 3), traj,
                                            torch.ones(2, dtype=torch.int32))
        assert bool(stats.ok.all()), (geometry, route, stats)
from nmpc_nav_control_tpu_torch.control import state_machine as sm
from nmpc_nav_control_tpu_torch.paths import make_line_segment
from nmpc_nav_control_tpu_torch import runtime
os.environ["NMPC_TPU_TILED_IPM"] = "1"


def cat(a, b):
    if isinstance(a, tuple):
        return type(a)(*(cat(x, y) for x, y in zip(a, b)))
    return torch.cat([a, b])


for geometry, kw in GEOMETRIES:
    spec, data = make_controller(geometry, 0.025, 10, v_max=1.0, a_max=2.0, device="cpu", **kw)
    cfg = sm.NavConfig(path_capacity=4)
    seg = make_line_segment((0, 0), (1, 0), velocity=0.5, device="cpu")
    segs = type(seg)(*(torch.cat([x[None], torch.zeros((3,) + x.shape, dtype=x.dtype)])[None]
                       for x in seg))
    goal = torch.tensor([0.3, 0.0, 0.0])
    on_path = sm.on_path_set(sm.on_goal_pose(sm.node_init(spec, cfg, 1, device="cpu"), goal),
                             cfg, segs, 1)
    state = cat(on_path, sm.on_goal_pose(sm.node_init(spec, cfg, 1, device="cpu"), goal))
    flag = torch.ones(2, dtype=torch.bool)
    meas = sm.Measurements(torch.zeros(2, 3), torch.zeros(2, 3), torch.zeros(2), flag, flag, flag)
    state, out = sm.node_tick(spec, data, cfg, state, meas)
    assert state.status.tolist() == [sm.FOLLOW_PATH, sm.GO_TO_POSE], (geometry, state.status)
    assert bool(out.solve_ok.all()) and bool(out.publish_cmd.all()), geometry
node = runtime.NmpcNavControlNode(runtime.from_dict(dict(
    steering_geometry="diff", tf_ini=0.25, rob_dist_between_wh=0.27, rob_wh_vel_time_const=0.1,
    rob_wh_max_vel=1.0, rob_wh_max_ace=2.0, cost_matrix_weights_state_diag=[10.0] * 3 + [0] * 4,
    cost_matrix_weights_input_diag=[1.0, 1.0])), device="cpu")
node.on_pose_goal(runtime.PoseStamped("map", 0.3, 0.0, 0.0))
twist, status = node.tick((0, 0, 0), (0, 0, 0))
assert status.status == 1 and twist is not None
import contextlib
import io
import nmpc_nav_control_tpu_torch.runtime.checkpoint
import nmpc_nav_control_tpu_torch.runtime.ingest
import nmpc_nav_control_tpu_torch.runtime.native
import nmpc_nav_control_tpu_torch.runtime.ros_bridge
import nmpc_nav_control_tpu_torch.runtime.simulation
import nmpc_nav_control_tpu_torch.utils.profiling
from nmpc_nav_control_tpu_torch.__main__ import main
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = main(["run", "--config", {runtime_yaml!r}, "--device", "cpu", "--no-rt", "--ticks", "3",
               "--goal", "0.3", "0.0", "0.0"])
text = out.getvalue()
assert rc == 0 and "N=10: GoToPose" in text and "status=1" in text, text
from nmpc_nav_control_tpu_torch.examples import sim_follow_path, sim_pose_goal
from nmpc_nav_control_tpu_torch.parallel import gather, make_mesh, solve_box_qp_2d
from nmpc_nav_control_tpu_torch.parallel.fleet import Fleet, FleetGroup
from nmpc_nav_control_tpu_torch.qp import BoxQP, solve_box_qp
qp = BoxQP(A=torch.eye(4).expand(2, 5, 4, 4), B=torch.ones(2, 5, 4, 2) * 0.1,
           c=torch.zeros(2, 5, 4), Qd=torch.ones(2, 6, 4), qx=torch.ones(2, 6, 4),
           Rd=torch.ones(2, 5, 2), qu=torch.ones(2, 5, 2), dx0=torch.zeros(2, 4),
           lbx=-torch.ones(2, 5, 2), ubx=torch.ones(2, 5, 2), lbu=-torch.ones(2, 5, 2),
           ubu=torch.ones(2, 5, 2))
one = solve_box_qp(qp, (1, 3), (0, 1), iters=4, stage_parallel=True)
two = solve_box_qp_2d(qp, (1, 3), (0, 1), make_mesh((1, 2), ("data", "stage"), ["cpu"] * 2),
                      iters=4).gather()
assert float((one.dus - two.dus).abs().max()) < 1e-5
spec, data = make_controller("diff", 0.025, 10, v_max=1.0, a_max=2.0, device="cpu",
                             **GEOMETRIES[0][1])
fleet = Fleet({{"diff": FleetGroup(spec, data, sm.NavConfig(path_capacity=4), 3)}},
              mesh=make_mesh((2,), devices=["cpu"] * 2))
fleet.set_states("diff", sm.on_goal_pose(fleet.groups["diff"].init_states(),
                                         torch.tensor([0.3, 0.0, 0.0])))
flag = torch.ones(3, dtype=torch.bool)
tick = gather(fleet.tick({{"diff": sm.Measurements(torch.zeros(3, 3), torch.zeros(3, 3),
                                                   torch.zeros(3), flag, flag, flag)}})["diff"])
assert bool(tick.solve_ok.all()) and tick.status_code.tolist() == [1, 1, 1]
with contextlib.redirect_stdout(io.StringIO()):
    sim_pose_goal.main(["diff", "--device", "cpu", "--ticks", "2", "--horizon", "10"])
    sim_follow_path.main(["--device", "cpu", "--ticks", "2"])
with contextlib.redirect_stdout(io.StringIO()):
    rc = main(["export", "--config", {runtime_yaml!r}, "-o", {artifact!r}, "--platform", "cpu"])
assert rc == 0
from nmpc_nav_control_tpu_torch.runtime.aot import load_tick
tick = load_tick(open({artifact!r}, "rb").read(), device="cpu")
config = runtime.load_config({runtime_yaml!r})
spec, _ = make_controller("diff", config.dt, config.horizon, device="cpu",
                          **config.controller_kwargs())


def lane(x):
    return type(x)(*(lane(v) for v in x)) if isinstance(x, tuple) else x[0]


flag = torch.ones(1, dtype=torch.bool)
_, out = tick(lane(sm.on_goal_pose(sm.node_init(spec, config.nav, 1, device="cpu"),
                                   torch.tensor([0.3, 0.0, 0.0]))),
              lane(sm.Measurements(torch.zeros(1, 3), torch.zeros(1, 3), torch.zeros(1), flag,
                                   flag, flag)))
assert bool(out.solve_ok) and int(out.status_code) == 1 and tick.meta["horizon"] == 10
from nmpc_nav_control_tpu_torch import bench, bench_scaling
from nmpc_nav_control_tpu_torch.tools import node_probe, phase_probe
os.environ.update(BENCH_GEOMETRY="diff", BENCH_HORIZON="6", BENCH_BATCH="4", BENCH_REPS="1",
                  BENCH_CHAIN_HI="3", NODE_PROBE_MARCH="1")
bench.ROOT = {tmp!r}
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert bench.main(["--device", "cpu"]) == 0
    assert phase_probe.main(["diff", "6", "4", "--device", "cpu"]) == 0
    assert node_probe.main(["diff", "6", "4", "--device", "cpu"]) == 0
    recs = bench_scaling.measure_scaling(device_counts=[1, 2], batch_per_chip=4, N=6, reps=1,
                                         k_lo=1, k_hi=3, devices=["cpu"] * 2)
lines = out.getvalue().splitlines()
assert len(lines) == 14 and '"nmpc_solves_per_s_per_chip_N6"' in lines[0], lines
assert os.path.exists(os.path.join({tmp!r}, "BENCH_torch_partial.json"))
assert [r["devices"] for r in recs] == [1, 2]
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules if sys.modules[m] is not None)
print("ok", float(cmd.v[0]))
"""


RUNTIME_YAML = """
steering_geometry: diff
control_freq: 40
tf_ini: 0.25
rob_dist_between_wh: 0.27
rob_wh_vel_time_const: 0.1
rob_wh_max_vel: 1.0
rob_wh_max_ace: 2.0
cost_matrix_weights_state_diag: [10.0, 10.0, 5.0, 0.0, 0.0, 0.0, 0.0]
cost_matrix_weights_input_diag: [1.0, 1.0]
"""


def test_port_imports_and_ticks_without_jax(tmp_path):
    runtime_yaml = tmp_path / "runtime.yaml"
    runtime_yaml.write_text(RUNTIME_YAML)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    script = SCRIPT.format(root=ROOT, runtime_yaml=str(runtime_yaml),
                           artifact=str(tmp_path / "tick.aot"), tmp=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok"), proc.stdout


def test_no_module_of_the_port_imports_jax():
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    mods = [node.module or ""]
                else:
                    continue
                for m in mods:
                    assert m.split(".")[0] not in ("jax", "jaxlib", "nmpc_nav_control_tpu"), (
                        f"{path} imports {m}")


WRAPPERS = [os.path.join(ROOT, "examples", "ros", "scripts", name)
            for name in ("ros_bridge_torch_main", "ros_bridge_torch_prepare")]

WRAPPER_SCRIPT = """
import runpy
import sys
sys.modules["jax"] = None
sys.modules["nmpc_nav_control_tpu"] = None
sys.path.insert(0, {root!r})
import nmpc_nav_control_tpu_torch.runtime.ros_bridge as rb
seen = []
rb.main = rb.main_prepare = lambda argv=None: seen.append(list(sys.argv)) or 0
for path in {wrappers!r}:
    sys.argv = [path, "config.yaml", "--device", "cpu"]
    try:
        runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
assert seen == [[p, "config.yaml", "--device", "cpu"] for p in {wrappers!r}], seen
assert not any(m == "jax" or m.startswith(("jax.", "nmpc_nav_control_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""


def test_ros_wrappers_run_without_jax():
    for path in WRAPPERS:
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""])
                assert all(m.split(".")[0] in ("sys", "nmpc_nav_control_tpu_torch")
                           for m in mods), (path, mods)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", WRAPPER_SCRIPT.format(root=ROOT,
                                                                       wrappers=WRAPPERS)],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok", proc.stdout


def test_prepare_and_cli_default_to_the_card(tmp_path):
    """Without a device argument ``prepare_solvers`` and the subcommands
    run on the card; on a machine without one they raise rather than carry
    on on the CPU, with the default and with ``--device cuda`` (``export``'s
    default platforms include the card's)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default works")
    from nmpc_nav_control_tpu_torch.__main__ import main
    from nmpc_nav_control_tpu_torch.runtime import prepare_solvers

    runtime_yaml = tmp_path / "runtime.yaml"
    runtime_yaml.write_text(RUNTIME_YAML)
    models = os.path.join(ROOT, "config", "models.yaml")
    with pytest.raises(RuntimeError, match="CUDA"):
        prepare_solvers(models, log=lambda *_: None)
    for argv in (["run", "--config", str(runtime_yaml)],
                 ["run", "--config", str(runtime_yaml), "--device", "cuda"],
                 ["prepare", models], ["prepare", models, "--device", "cuda"],
                 ["export", "--config", str(runtime_yaml), "-o", str(tmp_path / "tick.aot")],
                 ["bench"], ["bench", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)


def test_parallel_layers_and_demos_default_to_the_card():
    """Without devices named, the meshes take the visible cards, NCCL
    needs a card, and the demos run on the card: without one they raise,
    never carry on on the CPU or on gloo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default works")
    from nmpc_nav_control_tpu_torch.examples import sim_follow_path, sim_pose_goal
    from nmpc_nav_control_tpu_torch.parallel import global_data_mesh, init_distributed, make_mesh

    for call in (make_mesh, global_data_mesh,
                 lambda: init_distributed("127.0.0.1:1", 1, 0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not torch.distributed.is_initialized()
    for main, argv in ((sim_pose_goal.main, ["--ticks", "1"]),
                       (sim_follow_path.main, ["--ticks", "1"])):
        with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
            main(argv)


def test_measurement_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """The benchmark and the probes run on the card unless given
    ``--device cpu``, and the scaling sweep takes the visible cards: without
    one they raise, before measuring or writing anything; the scaling
    command prints its ``skipped`` line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default works")
    from nmpc_nav_control_tpu_torch import bench, bench_scaling
    from nmpc_nav_control_tpu_torch.tools import node_probe, phase_probe

    monkeypatch.setattr(bench, "ROOT", str(tmp_path))
    for main, argv in ((bench.main, []), (bench.main, ["--device", "cuda"]),
                       (phase_probe.main, []), (node_probe.main, ["diff", "6", "4"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_scaling.measure_scaling()
    assert os.listdir(tmp_path) == []
    proc = subprocess.run([sys.executable, "-m", "nmpc_nav_control_tpu_torch.bench_scaling"],
                          capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["skipped"] is True
