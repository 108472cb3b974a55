"""The port's tick artifacts (``runtime/aot.py``) on the CPU.

The tiny diff config of ``tests/test_aot.py`` (N=10).  Each artifact is
exported once (``_blob``, shared by the tests) for the ``cpu`` platform and
loaded once (``_loaded``); an export and a load take 20-40 s on a CPU.
Two artifacts cover both routes (``NMPC_TPU_TILED_IPM``), both dtypes and
both batch forms: (fused, f32, single robot) and (Riccati, f64, B=4); the
other two of the four that pair each route with both dtypes and both
forms, (fused, f64, B=4) and (Riccati, f32, single robot), are marked
``slow``.  Each is held against the port's eager ``node_tick`` bit for bit
over 3 ticks (B=4: two GoToPose lanes, one FollowPath lane and an idle
one), and the two unmarked ones against the JAX package's own
single-robot artifact (``nmpc_nav_control_tpu.runtime.aot``) on the same
state and measurements, carried across with ``convert`` (into every lane
of the B=4 one): f64 within 1e-9 on every float leaf and integer leaves
equal, f32 commands within the golden bound 2.5e-3 and the statuses
equal.  Also: the header and the artifacts that ``load_tick`` refuses, an
eager tick after an export (no tracer tensor kept in the index caches),
and loading in a process where JAX is blocked, which imports none of the
port's model code.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmpc_nav_control_tpu.control.state_machine as JS
from nmpc_nav_control_tpu.control import make_controller as jmake
from nmpc_nav_control_tpu.runtime import aot as jaot
from nmpc_nav_control_tpu.runtime.config import from_dict as jfrom_dict
from nmpc_nav_control_tpu_torch import convert
from nmpc_nav_control_tpu_torch.control import make_controller
from nmpc_nav_control_tpu_torch.control import state_machine as TS
from nmpc_nav_control_tpu_torch.ops import _build
from nmpc_nav_control_tpu_torch.paths import PathSegment, make_line_segment
from nmpc_nav_control_tpu_torch.runtime import aot
from nmpc_nav_control_tpu_torch.runtime.config import from_dict
from nmpc_nav_control_tpu_torch.utils.index import index_tensor, mask_tensor

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW = {
    "steering_geometry": "diff",
    "control_freq": 40,
    "tf_ini": 0.25,
    "rob_dist_between_wh": 0.27,
    "rob_wh_vel_time_const": 0.1,
    "rob_wh_max_vel": 1.0,
    "rob_wh_max_ace": 2.0,
    "cost_matrix_weights_state_diag": [10.0, 10.0, 5.0, 0, 0, 0, 0],
    "cost_matrix_weights_input_diag": [1.0, 1.0],
    "final_position_error": 0.03,
    "final_orientation_error": 3.0,
}
TICKS = 3
FLOAT_TOL = 1e-9
CMD_TOL_F32 = 2.5e-3          # the golden bound (tests/test_rti_oracle.py)
CASES = [("1", "float32", None), ("0", "float64", 4),
         pytest.param("1", "float64", 4, marks=pytest.mark.slow),
         pytest.param("0", "float32", None, marks=pytest.mark.slow)]
CONFIG = from_dict(RAW)


@functools.lru_cache(maxsize=None)
def _blob(route, dtype, batch):
    """A cpu-platform artifact, exported on ``route``."""
    old = os.environ.get("NMPC_TPU_TILED_IPM")
    os.environ["NMPC_TPU_TILED_IPM"] = route
    try:
        return aot.export_tick(CONFIG, batch=batch, platforms=("cpu",),
                               dtype=getattr(torch, dtype))
    finally:
        if old is None:
            del os.environ["NMPC_TPU_TILED_IPM"]
        else:
            os.environ["NMPC_TPU_TILED_IPM"] = old


@functools.lru_cache(maxsize=None)
def _loaded(route, dtype, batch):
    return aot.load_tick(_blob(route, dtype, batch), device="cpu")


@functools.lru_cache(maxsize=None)
def _controller(dtype):
    return make_controller(CONFIG.steering_geometry, CONFIG.dt, CONFIG.horizon,
                           dtype=getattr(torch, dtype), device="cpu",
                           **CONFIG.controller_kwargs())


def _tree(fn, *trees):
    if isinstance(trees[0], tuple):
        return type(trees[0])(*(_tree(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def _inputs(dtype, batch):
    """(state, measurements) with a lane axis: B=1 on a goal for the single
    robot; for B=4 two goals, a 2 m line at 0.5 m/s and an idle lane."""
    spec, _ = _controller(dtype)
    dt = getattr(torch, dtype)
    cfg = CONFIG.nav

    def one():
        return TS.node_init(spec, cfg, 1, dt, "cpu")

    def goal(g):
        return TS.on_goal_pose(one(), torch.tensor(g, dtype=dt))

    if batch is None:
        lanes = [goal((1.0, 0.5, 0.2))]
    else:
        seg = make_line_segment((0.0, 0.0), (2.0, 0.0), velocity=0.5, dtype=dt, device="cpu")
        cap = cfg.path_capacity
        segs = PathSegment(*(torch.cat([x[None], torch.zeros((cap - 1,) + x.shape,
                                                             dtype=x.dtype)])[None] for x in seg))
        lanes = [goal((1.0, 0.5, 0.2)), goal((0.5, -0.3, -0.4)),
                 TS.on_path_set(one(), cfg, segs, 1, 7), one()]
    state = _tree(lambda *xs: torch.cat(xs), *lanes)
    rng = np.random.default_rng(len(lanes))
    B = len(lanes)
    flag = torch.ones(B, dtype=torch.bool)
    meas = TS.Measurements(pose=torch.tensor(rng.normal(size=(B, 3)) * 0.05, dtype=dt),
                           vel=torch.tensor(rng.normal(size=(B, 3)) * 0.05, dtype=dt),
                           steer_angle=torch.zeros(B, dtype=dt), pose_valid=flag,
                           vel_valid=flag.clone(), steer_valid=flag.clone())
    return state, meas


def _squeeze(tree):
    return _tree(lambda x: x[0], tree)


@pytest.mark.parametrize("route,dtype,batch", CASES)
def test_round_trip_equals_eager_tick(route, dtype, batch, monkeypatch):
    tick = _loaded(route, dtype, batch)
    assert tick.meta["batch"] == batch and tick.meta["dtype"] == dtype
    assert tick.meta["route"] == ("fused" if route == "1" else "riccati")
    monkeypatch.setenv("NMPC_TPU_TILED_IPM", route)
    spec, data = _controller(dtype)
    state, meas = _inputs(dtype, batch)
    got_s, got_m = (state, meas) if batch else (_squeeze(state), _squeeze(meas))
    for _ in range(TICKS):
        state, out = TS.node_tick(spec, data, CONFIG.nav, state, meas)
        got_s, got_out = tick(got_s, got_m)
        assert isinstance(got_s, TS.NodeState) and isinstance(got_out, TS.TickOutput)
        for g, w in zip(aot._leaves((got_s, got_out)), aot._leaves((state, out))):
            w = w if batch else w[0]
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w)
    assert bool(out.solve_ok.all()) and int(out.status_code[0]) == TS.STATUS_WORKING
    if batch:
        assert out.status_code.tolist()[2:] == [TS.STATUS_WORKING, TS.STATUS_IDLE]


@functools.lru_cache(maxsize=None)
def _jax_tick(dtype):
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    return jaot.load_tick(jaot.export_tick(jfrom_dict(RAW), platforms=("cpu",), dtype=jdt))


def _named(tree, prefix=""):
    """{field path: numpy leaf} of a NamedTuple tree (JAX or the port's)."""
    if isinstance(tree, tuple):
        out = {}
        for f, v in zip(getattr(tree, "_fields", range(len(tree))), tree):
            out.update(_named(v, f"{prefix}{f}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("route,dtype,batch", CASES[:2])
def test_matches_the_jax_artifact(route, dtype, batch):
    """The artifacts against JAX's own single-robot artifact of the same
    config (its serial solve on a CPU), on JAX's state carried across into
    every lane."""
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    jspec, _ = jmake("diff", CONFIG.dt, CONFIG.horizon, dtype=jdt,
                     **jfrom_dict(RAW).controller_kwargs())
    jcfg = jfrom_dict(RAW).nav
    jstate = JS.on_goal_pose(JS.node_init(jspec, jcfg, jdt), jnp.asarray([1.0, 0.5, 0.2], jdt))
    jmeas = JS.Measurements(pose=jnp.asarray([0.1, -0.2, 0.3], jdt),
                            vel=jnp.asarray([0.05, 0.0, -0.02], jdt),
                            steer_angle=jnp.zeros((), jdt), pose_valid=jnp.asarray(True),
                            vel_valid=jnp.asarray(True), steer_valid=jnp.asarray(True))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    dt = getattr(torch, dtype)
    state = convert.node_state_from_numpy(to_np(jstate), device="cpu", dtype=dt)
    meas = convert.measurements_from_numpy(to_np(jmeas), device="cpu", dtype=dt)
    state, meas = (_squeeze(state), _squeeze(meas)) if batch is None else (
        _tree(lambda x: x.expand(batch, *x.shape[1:]).clone(), t) for t in (state, meas))
    tick, jtick = _loaded(route, dtype, batch), _jax_tick(dtype)
    for _ in range(TICKS):
        state, out = tick(state, meas)
        jstate, jout = jtick(jstate, jmeas)
        got, want = _named((state, out)), _named((jstate, jout))
        if batch is not None:
            want = {k: np.broadcast_to(w, (batch,) + w.shape) for k, w in want.items()}
        assert set(got) == set(want)
        if dtype == "float64":
            for k, g in got.items():
                if g.dtype.kind == "f":
                    np.testing.assert_allclose(g, want[k], rtol=0, atol=FLOAT_TOL, err_msg=k)
                else:
                    np.testing.assert_array_equal(g, want[k], err_msg=k)
        else:
            for k in ("1.cmd.v", "1.cmd.vn", "1.cmd.w"):
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=CMD_TOL_F32, err_msg=k)
            for k in ("0.status", "1.status_code", "1.publish_cmd", "1.solve_ok"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert bool((out.status_code == TS.STATUS_WORKING).all())


def test_header():
    meta = _loaded("1", "float32", None).meta
    assert meta["format"] == 1 and meta["geometry"] == "diff" and meta["horizon"] == 10
    assert meta["dt"] == CONFIG.dt and meta["batch"] is None and meta["dtype"] == "float32"
    assert meta["platforms"] == ["cpu"] and meta["route"] == "fused"
    assert meta["torch"] == torch.__version__ and meta["kernels"] == _build.source_hash()
    assert len(meta["sizes"]) == 1 and meta["inputs"][:2] == ["status", "goal_pose"]
    assert meta["inputs"][-1] == "steer_valid" and meta["outputs"][-1] == "next_frame"
    assert "window.segs.cx" in meta["inputs"] and "cmd.vn" in meta["outputs"]


def test_load_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="JAX artifact"):
        aot.load_tick(jaot.export_tick(jfrom_dict(RAW), platforms=("cpu",)), device="cpu")
    with pytest.raises(ValueError, match="not an nmpc_nav_control_tpu_torch AOT artifact"):
        aot.load_tick(b"not an artifact at all", device="cpu")
    blob = _blob("1", "float32", None)
    for device in (None, "cuda"):
        with pytest.raises(ValueError, match="no 'cuda' platform"):
            aot.load_tick(blob, device=device)
    meta, off = aot._header(blob)
    changed = blob.replace(b'"next_frame"', b'"last_frame"')
    with pytest.raises(ValueError, match="leaves differ"):
        aot.load_tick(changed, device="cpu")
    with pytest.raises(ValueError, match="format"):
        aot.load_tick(blob.replace(b'"format": 1', b'"format": 2'), device="cpu")
    assert off == len(aot._MAGIC) + 4 + int.from_bytes(blob[8:12], "little")


def test_export_needs_a_card_for_the_cuda_platform():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the cuda platform exports")
    with pytest.raises(RuntimeError, match="CUDA"):
        aot.export_tick(CONFIG, platforms=("cuda", "cpu"))
    with pytest.raises(ValueError, match="platform"):
        aot.export_tick(CONFIG, platforms=("tpu",))


def test_eager_tick_after_an_export_holds_real_tensors():
    """An export traces the index caches' users under a fake mode; the
    caches keep none of its tensors, so an eager tick after it computes
    with real tensors and as before it."""
    spec, data = _controller("float32")

    def ticks():
        state, meas = _inputs("float32", 4)
        for _ in range(2):
            state, out = TS.node_tick(spec, data, CONFIG.nav, state, meas)
        return aot._leaves((state, out))

    before = ticks()
    _blob("0", "float64", 4)
    after = ticks()
    assert all(type(t) is torch.Tensor for t in after)
    assert all(torch.equal(a, b) for a, b in zip(after, before))


def test_index_caches_keep_no_tracer_tensor():
    from torch._subclasses.fake_tensor import FakeTensorMode

    idx, mask = (5, 3, 8), ((True, False), (False, True))
    with FakeTensorMode():
        traced = index_tensor(idx, "cpu"), mask_tensor(mask, "cpu")
    assert all(type(t) is not torch.Tensor for t in traced)
    real = index_tensor(idx, "cpu")
    assert type(real) is torch.Tensor and real.tolist() == list(idx)
    assert index_tensor(idx, "cpu") is real
    assert mask_tensor(mask, "cpu").tolist() == [list(r) for r in mask]


LOADER = """
import sys
sys.modules["jax"] = None
import torch
from nmpc_nav_control_tpu_torch.runtime.aot import load_tick
tick = load_tick(open(sys.argv[1], "rb").read(), device="cpu")
inp = torch.load(sys.argv[2], weights_only=False)
state, out = tick(inp["state"], inp["meas"])
assert bool(out.solve_ok) and bool(torch.isfinite(out.cmd.v)), out
print(" ".join(m for m in sys.modules if m.startswith("nmpc_nav_control_tpu_torch.")))
"""


def test_loading_imports_no_model_code(tmp_path):
    """Load and run an artifact where JAX cannot be imported.  Loading
    imports the ops of both routes (``ops/riccati.py`` holds the Riccati
    kernels' plain recursion, so that none of ``qp/`` is needed)."""
    artifact, inputs = tmp_path / "tick.aot", tmp_path / "inputs.pt"
    artifact.write_bytes(_blob("1", "float32", None))
    state, meas = _inputs("float32", None)
    torch.save({"state": _squeeze(state), "meas": _squeeze(meas)}, inputs)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", LOADER, str(artifact), str(inputs)], cwd=ROOT,
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    mods = proc.stdout.split()
    assert "nmpc_nav_control_tpu_torch.runtime.aot" in mods
    assert "nmpc_nav_control_tpu_torch.ops.riccati" in mods
    for m in mods:
        part = m.split(".")[1]
        assert part not in ("models", "rti", "qp", "paths", "ocp"), m
        assert m not in ("nmpc_nav_control_tpu_torch.control",
                         "nmpc_nav_control_tpu_torch.control.controllers"), m
