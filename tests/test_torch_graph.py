"""The graphed controller tick and the kernel-or-plain rule of the torch port.

CPU:
- ``qp.ipm.kernel_impl``: f32 on a CUDA device takes the kernels on either
  route; f64 on any device, and every CPU solve, the plain versions (the
  JAX package's ``supported()`` dtype test).  No switch sends f32 on the
  card to the plain versions.
- A tick hands every kernel wrapper the ``impl`` of that rule, on both
  routes (the wrappers are wrapped to record it).
- The tick path (``qp/``, ``rti/``, ``control/`` with the state machine,
  ``paths/``, ``ops/linearize_packed.py``) holds no host synchronisation
  and no index copied from the host.  A
  CUDA graph cannot capture those.  Two checks: a scan of the source for
  ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``, ``.nonzero()``,
  ``bool()``, ``float()`` or ``int()`` of a value, ``torch.tensor(``,
  ``torch.as_tensor(``, ``torch.from_numpy(``, ``.any()``/``.all()`` as an
  ``if`` or ``while`` test, and lists as indices; and a whole tick on
  ``meta`` tensors, which hold no values, so that any read of a value on
  the host (a truth test, ``int()``, ``.item()``, ...) raises; the same
  for a whole navigation tick (``node_tick``) per geometry.
- ``GraphedController`` and ``GraphedNavigator`` raise without a card; the
  wrappers take "kernel" or "plain" and nothing else.

``gpu`` (skip without a card; run with ``--noconftest`` where JAX is not
installed):
- the graphed tick equals the eager one over 5 chained ticks, diff on the
  default route and omni4 on the Riccati route, B = 1 and 256, with the
  capture's launch counts exactly one tick's; ``reset`` zeroes the static
  trajectory and keeps the carry;
- an f64 controller on the card (default device) agrees with the f64 CPU
  run to rounding on both routes and launches no kernel, eagerly and
  graphed;
- the graphed navigation tick (``GraphedNavigator``) equals the eager
  ``node_tick`` over chained ticks of a mixed batch (idle, GoToPose,
  FollowPath, Break, invalid input) with events between replays, diff on
  the default route and omni4 and tric on the Riccati route, with the
  capture's launch counts exactly one controller tick's; ``reset`` makes
  every lane an idle node;
- a tick artifact exported for the card (``runtime/aot.py``), loaded,
  equals a ``GraphedNavigator`` bit for bit on both routes, its capture
  launching one controller tick's kernels;
- a captured B=1 navigation tick counts its 33 IPM sweeps under
  ``kernels.plan.one_lane`` and a captured B=2048 controller tick under
  ``kernels.plan.batched``, each launch once.
"""
import ast
import collections
import math
import os

import numpy as np
import pytest
import torch

import nmpc_nav_control_tpu_torch.qp.ipm as ipm
import nmpc_nav_control_tpu_torch.qp.ipm_batched as ipm_batched
from nmpc_nav_control_tpu_torch.control import (
    GraphedController,
    GraphedNavigator,
    controller_init,
    controller_step,
    make_controller,
)
from nmpc_nav_control_tpu_torch.control import graph as control_graph
from nmpc_nav_control_tpu_torch.control import state_machine as sm
from nmpc_nav_control_tpu_torch.paths import make_line_segment
from nmpc_nav_control_tpu_torch.ops import _build
from nmpc_nav_control_tpu_torch.ops import riccati_fused as rf
from nmpc_nav_control_tpu_torch.utils import telemetry

torch.set_num_threads(1)

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "nmpc_nav_control_tpu_torch")
TICK_PATH = ("qp", "rti", "control", "paths", os.path.join("ops", "linearize_packed.py"))
N = 10
GEOMETRIES = {
    "diff": dict(dist_b=0.27, tau_v=0.1, v_max=1.0, a_max=2.0,
                 q_diag=[10.0, 10.0, 5.0, 0, 0, 0, 0], r_diag=[1.0, 1.0]),
    "omni4": dict(l1_plus_l2=0.535, tau_v=0.1, v_max=1.0, a_max=0.1,
                  q_diag=[10.0, 10.0, 5.0] + [0.0] * 8, r_diag=[1.0] * 4),
    "tric": dict(dist_d=1.05, tau_v=0.1, tau_a=0.1, v_max=1.0, a_max=0.2,
                 alpha_min=-math.radians(60.0), alpha_max=math.radians(60.0),
                 dalpha_max=0.2, q_diag=[10.0, 10.0, 5.0, 0, 0, 0, 0], r_diag=[1.0, 1.0]),
}
PER_TICK = {"1": {"ipm_bwd_fused": 8, "ipm_fwd_affine": 8, "ipm_bwd_corr": 8,
                  "ipm_fwd_corr": 8, "ipm_kkt_fused": 1},
            "0": {"riccati_factor": 8, "riccati_solve_bwd": 16, "riccati_solve_fwd": 16}}
# A graphed tick against the eager one: the same kernels and ops in the same
# order, so at most the f32 batched-vs-serial bound (ROADMAP section 3).
GRAPH_ATOL = 3.6e-6


def _inputs(B, N, dtype, device, seed=0):
    """Pose-goal and path lanes in the style of tests/test_torch_slice.py."""
    rng = np.random.default_rng(seed)
    poses = rng.normal(size=(B, 3)) * 0.3
    vels = rng.normal(size=(B, 3)) * 0.3
    trajs = np.zeros((B, N + 1, 3))
    trajs[:, 0] = np.stack([rng.uniform(0.3, 3.0, B), rng.uniform(-2.0, 2.0, B),
                            rng.uniform(-3.1, 3.1, B)], -1)
    n_valid = np.ones(B, np.int64)
    for lane in range(min(B, 3)):
        s = np.linspace(0.0, 1.0, N + 1)
        trajs[lane] = np.stack([s, 0.3 * s * (lane + 1),
                                np.mod(3.0 + 0.4 * s * (lane + 1) + np.pi, 2 * np.pi) - np.pi], -1)
        n_valid[lane] = N + 1 - 3 * lane
    steer = rng.uniform(-0.5, 0.5, B)

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    return t(poses), t(vels), t(trajs), torch.as_tensor(n_valid, device=device), t(steer)


# --------------------------------------------------------------------------- #
# CPU
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("route", ["1", "0"])
def test_kernel_impl_rule(route, monkeypatch):
    """The rule reads dtype and device only: neither the route nor the JAX
    package's switch to XLA (``NMPC_TPU_PALLAS_RICCATI``) moves f32 on the
    card off the kernels."""
    monkeypatch.setenv("NMPC_TPU_TILED_IPM", route)
    monkeypatch.setenv("NMPC_TPU_PALLAS_RICCATI", "0")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert ipm.kernel_impl(torch.float32, cuda) == "kernel"
    assert ipm.kernel_impl(torch.float32, "cuda:0") == "kernel"
    assert ipm.kernel_impl(torch.float64, cuda) == "plain"
    assert ipm.kernel_impl(torch.float32, cpu) == "plain"
    assert ipm.kernel_impl(torch.float64, "cpu") == "plain"


def _record_impls(monkeypatch):
    """Wrap every kernel wrapper where the solves look it up; returns the
    list of (wrapper, impl) each call was handed."""
    seen = []

    def recording(name, fn):
        def wrapper(*args, **kw):
            seen.append((name, kw.get("impl")))
            return fn(*args, **kw)
        return wrapper

    for name in ("ipm_bwd_fused", "ipm_fwd_affine", "ipm_bwd_corr", "ipm_fwd_corr",
                 "ipm_kkt_fused"):
        monkeypatch.setattr(ipm_batched, name, recording(name, getattr(ipm_batched, name)))
    for name in ("riccati_factor_fused", "riccati_solve_bwd_fused", "riccati_solve_fwd_fused"):
        monkeypatch.setattr(rf, name, recording(name, getattr(rf, name)))
    return seen


@pytest.mark.parametrize("route", ["1", "0"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_tick_hands_the_wrappers_the_plain_impl_off_the_card(route, dtype, monkeypatch):
    """On the CPU (f32 or f64) every wrapper call of a tick is handed
    "plain", on either route: the choice is made once per solve and passed
    down, not left to the wrappers' device test."""
    monkeypatch.setenv("NMPC_TPU_TILED_IPM", route)
    seen = _record_impls(monkeypatch)
    tdt = getattr(torch, dtype)
    spec, data = make_controller("omni4", 0.025, N, dtype=tdt, device="cpu",
                                 **GEOMETRIES["omni4"])
    pose, vel, traj, n_valid, _ = _inputs(4, N, tdt, "cpu")
    _, _, stats = controller_step(spec, data, controller_init(spec, 4, tdt, "cpu"),
                                  pose, vel, traj, n_valid)
    assert bool(stats.ok.all())
    wrapper = {"riccati_factor": "riccati_factor_fused",
               "riccati_solve_bwd": "riccati_solve_bwd_fused",
               "riccati_solve_fwd": "riccati_solve_fwd_fused"}
    assert collections.Counter(n for n, _ in seen) == {
        wrapper.get(k, k): v for k, v in PER_TICK[route].items()}
    assert {impl for _, impl in seen} == {"plain"}


def test_wrappers_take_kernel_or_plain():
    """"plain" runs the plain version on any device; "kernel" sends CPU
    tensors to it too; any other value, or mixed devices, raise."""
    cpu = [torch.zeros(2)]
    assert not _build.use_kernel(cpu, "kernel") and not _build.use_kernel(cpu, "plain")
    with pytest.raises(ValueError):
        _build.use_kernel(cpu, "cuda")
    with pytest.raises(ValueError):
        _build.use_kernel([torch.zeros(2), torch.zeros(2, device="meta")], "plain")
    A = torch.rand(3, 49, 5, dtype=torch.float64)
    Bm = torch.rand(3, 14, 5, dtype=torch.float64)
    Qd, Rd = torch.rand(4, 7, 5, dtype=torch.float64) + 1, torch.rand(3, 2, 5, dtype=torch.float64) + 1
    for got, want in zip(rf.riccati_factor_fused(A, Bm, Qd, Rd, impl="plain"),
                         rf.factor_plain(A, Bm, Qd, Rd)):
        assert torch.equal(got, want)


# Functions of the scanned files that build a controller, a path segment, a
# window or a node state and never run in a tick: they copy host values to
# the device by design.
BUILD_TIME = {"make_controller", "make_line_segment", "make_cubic_segment", "_make_segment",
              "make_path_list", "window_init", "node_init"}


def _nodes(tree):
    """Every node of ``tree`` outside the ``BUILD_TIME`` functions."""
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.FunctionDef) and node.name in BUILD_TIME:
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _calls(tree):
    """(line, text) of every host synchronisation or host-built index."""
    found = []
    for node in _nodes(tree):
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            for sub in ast.walk(node.test):
                if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in ("any", "all")):
                    found.append((node.lineno, f".{sub.func.attr}() as a test"))
        if isinstance(node, ast.Subscript):
            parts = node.slice.elts if isinstance(node.slice, ast.Tuple) else [node.slice]
            for p in parts:
                if isinstance(p, (ast.List, ast.ListComp)) or (
                        isinstance(p, ast.Call) and isinstance(p.func, ast.Name)
                        and p.func.id == "list"):
                    found.append((node.lineno, "list index"))
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in ("item", "cpu", "tolist", "numpy",
                                                           "nonzero"):
                found.append((node.lineno, f".{f.attr}()"))
            elif (isinstance(f, ast.Attribute)
                  and f.attr in ("tensor", "as_tensor", "from_numpy")
                  and isinstance(f.value, ast.Name) and f.value.id == "torch"):
                found.append((node.lineno, f"torch.{f.attr}("))
            elif isinstance(f, ast.Name) and f.id in ("bool", "float", "int"):
                found.append((node.lineno, f"{f.id}()"))
    return found


def test_tick_path_has_no_host_syncs():
    files = []
    for part in TICK_PATH:
        path = os.path.join(PKG, part)
        if os.path.isdir(path):
            files += [os.path.join(path, n) for n in sorted(os.listdir(path)) if n.endswith(".py")]
        else:
            files.append(path)
    assert len(files) >= 16
    bad = []
    for path in files:
        tree = ast.parse(open(path).read(), path)
        bad += [f"{os.path.relpath(path, PKG)}:{line}: {what}" for line, what in _calls(tree)]
    assert not bad, bad
    # The scan itself finds each kind, and skips the build-time functions.
    probe = ast.parse("x[:, [1, 2]]; y[list(i)]; z.item(); w.cpu(); torch.tensor(v); bool(t)\n"
                      "int(n); m.nonzero(); torch.as_tensor(a); torch.from_numpy(b)\n"
                      "if m.any(): pass\n"
                      "while m.all(): pass\n"
                      "def make_controller(): torch.as_tensor(a)")
    assert len(_calls(probe)) == 12


@pytest.mark.parametrize("route", ["1", "0"])
@pytest.mark.parametrize("geometry", ["diff", "omni4", "tric"])
def test_tick_reads_no_value_on_the_host(geometry, route, monkeypatch):
    """A whole tick on ``meta`` tensors: they carry shapes and no values, so
    every read of a value on the host raises (``.item()``, ``int()``, a
    truth test, ``.nonzero()``, a copy to the CPU).  The wrappers are told
    to take their plain versions, which run on any device."""
    monkeypatch.setenv("NMPC_TPU_TILED_IPM", route)
    monkeypatch.setattr(_build, "use_kernel", lambda tensors, impl: False)
    spec, data = make_controller(geometry, 0.025, N, device="cpu", **GEOMETRIES[geometry])
    data = type(data)(*(t.to("meta") for t in data))
    with pytest.raises((RuntimeError, NotImplementedError)):
        bool(data.p.sum())                              # meta holds no values
    pose, vel, traj, n_valid, steer = (t.to("meta") for t in _inputs(4, N, torch.float32, "cpu"))
    state = controller_init(spec, 4, torch.float32, "meta")
    for _ in range(2):
        state, cmd, stats = controller_step(spec, data, state, pose, vel, traj, n_valid, steer)
    assert cmd.v.device.type == "meta" and cmd.v.shape == (4,)
    assert state.us.shape == (4, N, spec.dims.model.nu) and stats.ok.shape == (4,)


@pytest.mark.parametrize("geometry", ["diff", "omni4", "tric"])
def test_node_tick_reads_no_value_on_the_host(geometry, monkeypatch):
    """Two whole navigation ticks on ``meta`` tensors (default route, the
    "fast" discretizer), as for the controller tick above."""
    monkeypatch.setattr(_build, "use_kernel", lambda tensors, impl: False)
    spec, data = make_controller(geometry, 0.025, N, device="cpu", **GEOMETRIES[geometry])
    data = type(data)(*(t.to("meta") for t in data))
    cfg = sm.NavConfig(path_capacity=8)
    state = sm.node_init(spec, cfg, 4, torch.float32, "meta")
    pose, vel, _, _, steer = (t.to("meta") for t in _inputs(4, N, torch.float32, "cpu"))
    flag = torch.ones(4, dtype=torch.bool, device="meta")
    meas = sm.Measurements(pose, vel, steer, flag, flag, flag)
    for _ in range(2):
        state, out = sm.node_tick(spec, data, cfg, state, meas)
    assert out.cmd.v.device.type == "meta" and out.debug_path.shape == (4, N + 1, 3)
    assert state.window.segs.cx.shape == (4, 8, 8) and out.status_code.dtype == torch.int32


def test_graphed_controller_needs_a_card():
    spec, data = make_controller("diff", 0.025, N, device="cpu", **GEOMETRIES["diff"])
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphedController(spec, data, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphedNavigator(spec, data, sm.NavConfig(), 4)


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 256])
@pytest.mark.parametrize("geometry,route", [("diff", "1"), ("omni4", "0")])
def test_graphed_tick_equals_eager(cuda_device, geometry, route, lanes, monkeypatch):
    monkeypatch.setenv("NMPC_TPU_TILED_IPM", route)
    spec, data = make_controller(geometry, 0.025, 40, **GEOMETRIES[geometry])
    inputs = _inputs(lanes, 40, torch.float32, cuda_device)
    graphed = GraphedController(spec, data, lanes)
    graphed.load_inputs(*inputs)
    assert graphed.capture() == PER_TICK[route]
    _build.reset_launch_counts()
    replays = []
    for _ in range(5):
        g_state, g_cmd, g_stats = graphed.step(*inputs)
        replays.append([t.clone() for t in (*g_state, *g_cmd, g_stats.kkt_res, g_stats.mu,
                                            g_stats.ok)])
    assert _build.launch_counts() == {}                   # replays count nothing
    state = controller_init(spec, lanes)
    for k, got in enumerate(replays):
        state, cmd, stats = controller_step(spec, data, state, *inputs)
        want = (*state, *cmd, stats.kkt_res, stats.mu)
        for name, g, w in zip(("xs", "us", "x0_carry", "v", "vn", "w", "kkt_res", "mu"),
                              got, want):
            torch.testing.assert_close(g, w, rtol=0.0, atol=GRAPH_ATOL, msg=f"tick {k} {name}")
        assert torch.equal(got[-1], stats.ok) and bool(stats.ok.all())
    carry = graphed.state.x0_carry.clone()
    graphed.reset()
    assert not bool(graphed.state.xs.any()) and not bool(graphed.state.us.any())
    assert torch.equal(graphed.state.x0_carry, carry)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["1", "0"])
@pytest.mark.parametrize("geometry", ["diff", "omni4", "tric"])
def test_f64_controller_on_the_card(cuda_device, geometry, route, monkeypatch):
    """The default device with dtype f64: the plain versions on the card,
    no kernel launched, the f64 CPU run to rounding; graphed too."""
    monkeypatch.setenv("NMPC_TPU_TILED_IPM", route)
    f64 = torch.float64
    runs = {}
    for where in ("cpu", "cuda", "graph"):
        dev = "cpu" if where == "cpu" else cuda_device
        kw = dict(device="cpu") if where == "cpu" else {}
        spec, data = make_controller(geometry, 0.025, N, dtype=f64, **kw, **GEOMETRIES[geometry])
        inputs = _inputs(8, N, f64, dev)
        _build.reset_launch_counts()
        if where == "graph":
            graphed = GraphedController(spec, data, 8)
            for _ in range(5):
                state, _, stats = graphed.step(*inputs)
        else:
            state = controller_init(spec, 8, f64, **kw)
            for _ in range(5):
                state, _, stats = controller_step(spec, data, state, *inputs)
        assert _build.launch_counts() == {}, where
        assert bool(stats.ok.all())
        runs[where] = state.us.cpu()
    for where in ("cuda", "graph"):
        torch.testing.assert_close(runs[where], runs["cpu"], rtol=0.0, atol=1e-8, msg=where)


def _nav_lanes(spec, cfg, device):
    """A mixed batch built from single-lane states: idle, GoToPose, two
    FollowPath lanes, Break, and a GoToPose lane whose input turns invalid;
    returns (state, per-lane pose offsets, vel_valid)."""
    def fresh():
        return sm.node_init(spec, cfg, 1, torch.float32, device)

    def path(*segs):
        segs = [make_line_segment(*s, device=device) for s in segs]
        stacked = type(segs[0])(*(torch.stack(x) for x in zip(*segs)))
        pad = cfg.path_capacity - len(segs)
        return sm.on_path_set(fresh(), cfg, type(stacked)(*(
            torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype, device=device)])[None]
            for x in stacked)), len(segs), 7)

    goal = torch.tensor([0.5, 0.1, 0.2], device=device)
    lanes = [fresh(), sm.on_goal_pose(fresh(), goal),
             path(((0, 0), (1.0, 0)), ((1.0, 0), (2.0, 0.5))),
             path(((0, 0), (0.2, 0), 0.5), ((0.2, 0), (0.0, 0), -0.5)),
             sm.on_command(sm.on_goal_pose(fresh(), goal), "break"),
             sm.on_goal_pose(fresh(), goal)]

    def cat(*xs):
        if isinstance(xs[0], tuple):
            return type(xs[0])(*(cat(*v) for v in zip(*xs)))
        return torch.cat(xs)

    poses = torch.tensor([[0, 0, 0], [0, 0, 0], [0.02, 0.01, 0.05], [0.19, 0, 0], [0, 0, 0],
                          [0, 0, 0]], dtype=torch.float32, device=device)
    vel_valid = torch.tensor([True] * 5 + [False], device=device)
    return cat(*lanes), poses, vel_valid


@pytest.mark.gpu
@pytest.mark.parametrize("geometry,route", [("diff", "1"), ("omni4", "0"), ("tric", "0")])
def test_graphed_navigator_equals_eager(cuda_device, geometry, route, monkeypatch):
    monkeypatch.setenv("NMPC_TPU_TILED_IPM", route)
    spec, data = make_controller(geometry, 0.025, 40, **GEOMETRIES[geometry])
    cfg = sm.NavConfig(path_capacity=8)
    state, poses, vel_valid = _nav_lanes(spec, cfg, cuda_device)
    lanes = poses.shape[0]
    graphed = GraphedNavigator(spec, data, cfg, lanes)
    graphed.load_state(state)
    rng = np.random.default_rng(2)
    goal = torch.tensor([0.4, -0.1, 0.0], device=cuda_device)
    seg = make_line_segment((0, 0), (0.8, 0.1), velocity=0.4, device=cuda_device)
    segs = type(seg)(*(torch.cat([x[None], torch.zeros((7,) + x.shape, dtype=x.dtype,
                                                        device=cuda_device)])[None]
                       .expand(lanes, *((-1,) * (x.dim() + 1))) for x in seg))
    events = {2: ("on_goal_pose", (goal,)), 3: ("on_path_set", (segs, 1, 9)),
              4: ("on_command", ("break",))}
    eager = state
    for k in range(6):
        if k in events:
            name, args = events[k]
            getattr(graphed, name)(*args)
            if name == "on_path_set":
                eager = sm.on_path_set(eager, cfg, *args)
            else:
                eager = getattr(sm, name)(eager, *args)
        noise = torch.as_tensor(rng.normal(size=(lanes, 3)) * 1e-3, dtype=torch.float32,
                                device=cuda_device)
        flag = torch.ones(lanes, dtype=torch.bool, device=cuda_device)
        meas = sm.Measurements(poses + noise, noise, noise[:, 0], flag, vel_valid, flag)
        if k == 0:
            graphed.load_measurements(meas)
            assert graphed.capture() == PER_TICK[route]
            _build.reset_launch_counts()
        g_state, g_out = graphed.step(meas)
        got = [t.clone() for t in (*_tensors(g_state), *_tensors(g_out))]
        eager, out = sm.node_tick(spec, data, cfg, eager, meas)
        want = [*_tensors(eager), *_tensors(out)]
        for i, (g, w) in enumerate(zip(got, want)):
            if w.is_floating_point():
                torch.testing.assert_close(g, w, rtol=0.0, atol=GRAPH_ATOL, msg=f"tick {k} {i}")
            else:
                assert torch.equal(g, w), f"tick {k} leaf {i}"
    # Replays count nothing: the counts are the 6 eager ticks'.
    assert _build.launch_counts() == {k: 6 * v for k, v in PER_TICK[route].items()}
    # The break at tick 4 idles every lane but the one with invalid input.
    assert g_state.status.tolist() == [sm.IDLE] * (lanes - 1) + [sm.ERROR]
    graphed.reset()
    assert graphed.state.status.tolist() == [sm.IDLE] * lanes
    assert not bool(graphed.state.window.total_count.any())


def _tensors(tree):
    """Every tensor of a nested NamedTuple, in field order."""
    if isinstance(tree, tuple):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["1", "0"])
def test_aot_tick_on_the_card(cuda_device, route, monkeypatch):
    """A tick artifact for the card (``runtime/aot.py``), exported and
    loaded: its first call captures one controller tick's launches, and
    over chained ticks it equals a ``GraphedNavigator`` of the same config
    bit for bit."""
    from nmpc_nav_control_tpu_torch.runtime import aot
    from nmpc_nav_control_tpu_torch.runtime.config import from_dict

    monkeypatch.setenv("NMPC_TPU_TILED_IPM", route)
    config = from_dict(dict(
        steering_geometry="diff", tf_ini=0.25, rob_dist_between_wh=0.27,
        rob_wh_vel_time_const=0.1, rob_wh_max_vel=1.0, rob_wh_max_ace=2.0,
        cost_matrix_weights_state_diag=[10.0, 10.0, 5.0, 0, 0, 0, 0],
        cost_matrix_weights_input_diag=[1.0, 1.0]))
    tick = aot.load_tick(aot.export_tick(config, batch=2, platforms=("cuda",)))
    spec, data = make_controller("diff", config.dt, config.horizon, **config.controller_kwargs())
    nav = GraphedNavigator(spec, data, config.nav, 2)
    state = sm.on_goal_pose(sm.node_init(spec, config.nav, 2),
                            torch.tensor([0.5, 0.1, 0.0], device=cuda_device))
    nav.load_state(state)
    flag = torch.ones(2, dtype=torch.bool, device=cuda_device)
    for k in range(4):
        pose = torch.tensor([[0.02 * k, 0.0, 0.0], [0.0, 0.01 * k, 0.05]], device=cuda_device)
        meas = sm.Measurements(pose, torch.zeros_like(pose), torch.zeros(2, device=cuda_device),
                               flag, flag, flag)
        want = nav.step(meas)
        state, out = tick(state, meas)
        for g, w in zip(aot._leaves((state, out)), aot._leaves(want)):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert tick.capture_launches == PER_TICK[route]
    assert bool(out.solve_ok.all())


@pytest.mark.gpu
def test_capture_counts_each_launch_plan(cuda_device, monkeypatch):
    """The sweeps' launch plan follows the batch: a captured B=1 navigation
    tick (the single-robot node's) counts its 33 IPM launches under
    ``kernels.plan.one_lane`` and none under ``kernels.plan.batched``, a
    captured B=2048 controller tick the reverse; a capture counts each
    launch once, its warm-up ticks' too, as ``launch_counts()`` does, and a
    replay counts nothing."""
    monkeypatch.setenv("NMPC_TPU_TILED_IPM", "1")
    spec, data = make_controller("diff", 0.025, 80, **GEOMETRIES["diff"])
    counters = telemetry.metrics()

    def plans():
        return {p: counters.counter(f"kernels.plan.{p}").value for p in ("one_lane", "batched")}

    per_tick = sum(PER_TICK["1"].values())
    ticks = control_graph.WARMUP_TICKS + 1
    nav = GraphedNavigator(spec, data, sm.NavConfig(), 1)
    ctl = GraphedController(spec, data, 2048)
    ctl.load_inputs(*_inputs(2048, 80, torch.float32, cuda_device))
    for graphed, plan in ((nav, "one_lane"), (ctl, "batched")):
        before = plans()
        assert sum(graphed.capture().values()) == per_tick == 33
        after = plans()
        assert {p: after[p] - before[p] for p in after} == {
            p: per_tick * ticks if p == plan else 0 for p in after}, plan
        graphed._replay()
        assert plans() == after
