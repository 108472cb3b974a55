"""The port's path subsystem (``nmpc_nav_control_tpu_torch/paths/``) against JAX.

Batches of path lists made with the JAX package's constructors go, as numpy
leaves (``convert.path_segment_from_numpy``), through the port's batched
functions and through ``jax.jit(jax.vmap(...))`` of the JAX functions on
the CPU, in f64: sampling (with the end clamp and an empty list), the
projection, both resamplers (tangent and holonomic headings; lines, curves,
reverse driving, speed changes, a zero-length segment, u0 at and past the
end, an empty list), ``select_rows``, ``ingest`` (empty frame ids, ``n_new``
below the rows given), ``top_up`` (length cap, velocity-sign and frame
barriers), ``pop_completed``, ``rotate_end_of_curve``, ``active_length`` and
``path_remains``; all within 1e-10, integer leaves equal.  Also: the port's
fast resampler against its march within the bounds ``tests/test_paths.py``
pins for the JAX package, the constructors against JAX's, and the constructors'
default device (the card).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmpc_nav_control_tpu.paths as J
import nmpc_nav_control_tpu_torch.paths as T
from nmpc_nav_control_tpu.paths.segment import poly_deriv_eval as jderiv
from nmpc_nav_control_tpu.paths.segment import poly_eval as jpoly
from nmpc_nav_control_tpu.paths.windowing import select_rows as jselect
from nmpc_nav_control_tpu_torch.convert import path_segment_from_numpy
from nmpc_nav_control_tpu_torch.paths.segment import poly_deriv_eval, poly_eval, seg_arc_length
from nmpc_nav_control_tpu_torch.paths.windowing import select_rows

torch.set_num_threads(1)

TOL = 1e-10
CAP = 4
DT, NUM = 0.025, 21


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jsegs():
    """Named single-segment constructors of the JAX package (f64)."""
    line, cubic = J.make_line_segment, J.make_cubic_segment
    return {
        "line": [line((0, 0), (1, 0), velocity=0.8)],
        "curvy": [cubic([0.0, 2.0, -1.0, 0.3], [0.0, 0.1, 1.5, -0.6], velocity=0.6,
                        ch_coeffs=[0.2, 1.1, -0.5]),
                  cubic([1.3, 0.5, 0.2], [1.0, 1.2, -0.4], velocity=0.3, ch_coeffs=[0.8, -0.3])],
        "short": [line((0, 0), (0.05, 0), velocity=1.0)],
        "reverse": [line((0, 0), (2, 0), velocity=-0.5), line((2, 0), (2, 1), velocity=-0.3)],
        "speeds": [line((0, 0), (0.3, 0), velocity=0.9), line((0.3, 0), (0.6, 0), velocity=0.3),
                   line((0.6, 0), (2.0, 0), velocity=0.7)],
        "degenerate": [line((0, 0), (1, 0), velocity=0.8), cubic([1.0], [0.0], velocity=0.8),
                       line((1, 0), (2, 0), velocity=0.2)],
        "junction": [line((0, 0), (1, 0), velocity=0.8),
                     cubic([1.0, 1.0, 0.0], [0.0, 0.5, 0.5], velocity=0.5)],
    }


def _lanes(lanes):
    """[(segments, count or None)] -> (JAX PathList batch, port PathList)."""
    plists = []
    for segs, count in lanes:
        pl = J.make_path_list(segs, CAP)
        if count is not None:
            pl = pl._replace(count=jnp.asarray(count, jnp.int32))
        plists.append(_np(pl))
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *plists)
    jpl = jax.tree_util.tree_map(jnp.asarray, stacked)
    tpl = T.PathList(segs=path_segment_from_numpy(stacked.segs, device="cpu"),
                     count=torch.as_tensor(stacked.count))
    return jpl, tpl


def _close(got, want, what, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _u(x):
    return torch.as_tensor(np.array(x, np.float64))


@functools.lru_cache(maxsize=None)
def _jit(name, *static):
    """jax.jit(jax.vmap) of a JAX path function over (plist, u), compiled
    once per function and static arguments."""
    fn = getattr(J, name)
    return jax.jit(jax.vmap(lambda pl, u: fn(pl, u, *static)))


RESAMPLE_LANES = [("line", None, 0.0), ("line", None, 0.3), ("curvy", None, 0.0),
                  ("curvy", None, 0.97), ("curvy", None, 1.5), ("short", None, 0.0),
                  ("reverse", None, 0.3), ("reverse", None, 1.2), ("speeds", None, 0.3),
                  ("speeds", None, 1.5), ("degenerate", None, 0.9), ("degenerate", None, 1.5),
                  ("junction", None, 0.3), ("line", None, 1.0), ("line", None, 1.7),
                  ("line", 0, 0.0)]


@pytest.mark.parametrize("holonomic", [False, True])
def test_resamplers_match_jax(holonomic):
    segs = _jsegs()
    jpl, tpl = _lanes([(segs[name], count) for name, count, _ in RESAMPLE_LANES])
    u0 = np.array([u for _, _, u in RESAMPLE_LANES])
    for port, name in ((T.get_next_n_poses_fast, "get_next_n_poses_fast"),
                       (T.get_next_n_poses, "get_next_n_poses")):
        want = _jit(name, DT, NUM, holonomic)(jpl, jnp.asarray(u0))
        got = port(tpl, _u(u0), DT, NUM, is_holonomic=holonomic)
        _close(got, want, name)
        assert np.isfinite(got.numpy()).all()


def test_sampling_and_projection_match_jax():
    segs = _jsegs()
    names = ["curvy", "reverse", "speeds", "junction", "line"]
    jpl, tpl = _lanes([(segs[n], None) for n in names] + [(segs["line"], 0)])
    B = len(names) + 1
    rng = np.random.default_rng(3)
    # Global u inside, at segment joins, before the start and past the end.
    u = np.concatenate([rng.uniform(-0.5, 3.5, (B, 6)), np.tile([0.0, 1.0, 2.0, 3.0], (B, 1))], 1)
    for holonomic in (False, True):
        want = jax.jit(jax.vmap(jax.vmap(lambda pl, uu, h=holonomic: J.pose_sample(pl, uu, h),
                                         (None, 0))))(jpl, jnp.asarray(u))
        _close(T.pose_sample(tpl, _u(u), holonomic), want, f"pose_sample {holonomic}")
    want = jax.vmap(jax.vmap(J.vel_sample, (None, 0)))(jpl, jnp.asarray(u))
    _close(T.vel_sample(tpl, _u(u)), want, "vel_sample")

    rx, ry = rng.uniform(-0.5, 2.5, B), rng.uniform(-0.5, 2.5, B)
    want = jax.jit(jax.vmap(J.project_to_path))(jpl, jnp.asarray(rx), jnp.asarray(ry))
    got = T.project_to_path(tpl, _u(rx), _u(ry))
    for f in T.MinDistResult._fields:
        _close(getattr(got, f), getattr(want, f), f"project_to_path {f}")


def test_polynomials_and_constructors_match_jax():
    rng = np.random.default_rng(4)
    c, u = rng.normal(size=(5, 8)), rng.uniform(0, 1, 5)
    _close(poly_eval(_u(c), _u(u)), jpoly(jnp.asarray(c), jnp.asarray(u)), "poly_eval")
    _close(poly_deriv_eval(_u(c), _u(u)), jderiv(jnp.asarray(c), jnp.asarray(u)), "poly_deriv")
    pairs = [(T.make_line_segment((0.5, -1.0), (2.0, 3.0), velocity=-0.4, frame_id=3,
                                  theta_holonomic=0.7, dtype=torch.float64, device="cpu"),
              J.make_line_segment((0.5, -1.0), (2.0, 3.0), velocity=-0.4, frame_id=3,
                                  theta_holonomic=0.7)),
             (T.make_cubic_segment([0.0, 2.0, -1.0, 0.3], [0.0, 0.1, 1.5], velocity=0.6,
                                   ch_coeffs=[0.2, 1.1], dtype=torch.float64, device="cpu"),
              J.make_cubic_segment([0.0, 2.0, -1.0, 0.3], [0.0, 0.1, 1.5], velocity=0.6,
                                   ch_coeffs=[0.2, 1.1]))]
    for got, want in pairs:
        for f in T.PathSegment._fields:
            _close(getattr(got, f), getattr(want, f), f)
    _close(seg_arc_length(_u(c), _u(c[::-1])),
           jax.vmap(J.segment.seg_arc_length)(jnp.asarray(c), jnp.asarray(c[::-1])), "arc")
    pl = T.make_path_list([p[0] for p in pairs], CAP)
    jl = J.make_path_list([p[1] for p in pairs], CAP)
    for f in T.PathSegment._fields:
        _close(getattr(pl.segs, f)[0], getattr(jl.segs, f), f"make_path_list {f}")
    assert pl.count.tolist() == [2] and pl.count.dtype == torch.int32
    with pytest.raises(ValueError):
        T.make_path_list([p[0] for p in pairs] * 3, CAP)


def _store(lanes, cap=8):
    """Segment stores [(segs, n_new)] -> (JAX leaves [B, cap], port, n_new)."""
    rows = []
    for segs in lanes:
        pl = _np(J.make_path_list(segs, cap))
        rows.append(pl.segs)
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *rows)
    return jax.tree_util.tree_map(jnp.asarray, stacked), path_segment_from_numpy(stacked,
                                                                               device="cpu")


def _window_lanes():
    line = J.make_line_segment
    return [
        # 2 m segments: the 5 m cap takes three.
        [line((2 * i, 0), (2 * i + 2, 0), velocity=1.0, frame_id=1) for i in range(3)],
        # A velocity-sign flip blocks the second segment.
        [line((0, 0), (2, 0), velocity=1.0, frame_id=1), line((2, 0), (4, 0), velocity=-1.0,
                                                                frame_id=1)],
        # Empty frame ids are dropped, a frame change is a barrier.
        [line((0, 0), (1, 0), frame_id=0), line((1, 0), (2, 0), frame_id=2),
         line((2, 0), (3, 0), frame_id=0), line((3, 0), (4, 0), frame_id=5),
         line((4, 0), (5, 0), frame_id=5)],
        # Short segments, more than the cap would take, n_new below them.
        [line((0.5 * i, 0), (0.5 * i + 0.5, 0.1), velocity=0.5, frame_id=1) for i in range(7)],
    ]


def _window_equal(got, want, what):
    for g, w in zip(jax.tree_util.tree_leaves(tuple(got)), jax.tree_util.tree_leaves(want)):
        _close(g, w, what)


def test_windowing_matches_jax():
    jsegs, tsegs = _store(_window_lanes())
    n_new = np.array([3, 2, 5, 6], np.int32)
    B, cap = len(n_new), 8
    ingest_j = jax.jit(jax.vmap(lambda w, s, n: J.ingest(w, s, n, 3.0)))
    jwin = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                                  J.window_init(cap, jnp.float64))
    jwin = ingest_j(jwin, jsegs, jnp.asarray(n_new))
    twin = T.ingest(T.window_init(cap, B, torch.float64, "cpu"), tsegs, torch.as_tensor(n_new),
                    3.0)
    _window_equal(twin, jwin, "ingest")
    assert twin.active_count.tolist() == [2, 1, 1, 6] and twin.total_count.tolist() == [3, 2, 3, 6]

    u = np.array([1.4, 0.25, 0.0, 2.7])
    _close(T.active_length(twin, _u(u)), jax.vmap(J.active_length)(jwin, jnp.asarray(u)),
           "active_length")
    _close(T.path_remains(twin, _u(u)), jax.vmap(J.path_remains)(jwin, jnp.asarray(u)),
           "path_remains")
    jpop, ju = jax.vmap(J.pop_completed)(jwin, jnp.asarray(u))
    tpop, tu = T.pop_completed(twin, _u(u))
    _window_equal(tpop, jpop, "pop_completed")
    _close(tu, ju, "rebased u")
    for max_len in (1.0, 5.0):
        _window_equal(T.top_up(tpop, tu, max_len),
                      jax.vmap(lambda w, uu, m=max_len: J.top_up(w, uu, m))(jpop, ju), "top_up")
    _window_equal(T.rotate_end_of_curve(tpop), jax.vmap(J.rotate_end_of_curve)(jpop), "rotate")
    jl = jax.vmap(lambda w: J.active_path_list(w, 4))(jpop)
    tl = T.active_path_list(tpop, 4)
    for g, w in zip(jax.tree_util.tree_leaves(tuple(tl)), jax.tree_util.tree_leaves(jl)):
        _close(g, w, "active_path_list")
    # n_new = 0 keeps no segment.
    empty = T.ingest(twin, tsegs, 0, 5.0)
    assert empty.total_count.tolist() == [0] * B and empty.active_count.tolist() == [0] * B


def test_select_rows_matches_jax_in_range():
    """The port's select_rows clamps where JAX's one-hot gives zeros; every
    caller clips first, and in range the two agree for every leaf."""
    jsegs, tsegs = _store(_window_lanes())
    idx = np.array([[0, 2, 1, 7], [3, 3, 0, 1], [4, 0, 6, 2], [1, 5, 7, 0]])
    want = jax.vmap(jselect)(jsegs, jnp.asarray(idx))
    got = select_rows(tsegs, torch.as_tensor(idx))
    for g, w in zip(got, want):
        _close(g, w, "select_rows [B, K]")
    want = jax.vmap(jselect)(jsegs, jnp.asarray(idx[:, 1]))
    for g, w in zip(select_rows(tsegs, torch.as_tensor(idx[:, 1])), want):
        _close(g, w, "select_rows [B]")


def test_fast_resampler_tracks_the_march():
    """The port's two resamplers within the bounds tests/test_paths.py pins
    for the JAX package's: 1.5e-3 m and 1e-2 rad on lines, curves, short
    and reverse paths; 1e-2 m across speed boundaries."""
    segs = _jsegs()
    lanes = [(n, u0) for n in ("line", "curvy", "short", "reverse") for u0 in (0.0, 0.3, 0.97)]
    lanes += [("speeds", u0) for u0 in (0.0, 0.3, 0.97, 1.5)]
    _, tpl = _lanes([(segs[n], None) for n, _ in lanes])
    u0 = _u([u for _, u in lanes])
    a = T.get_next_n_poses(tpl, u0, DT, 41).numpy()
    b = T.get_next_n_poses_fast(tpl, u0, DT, 41).numpy()
    dpos = np.sqrt(((a[..., :2] - b[..., :2]) ** 2).sum(-1)).max(1)
    dth = np.abs(np.angle(np.exp(1j * (a[..., 2] - b[..., 2])))).max(1)
    for (name, u), dp, dt in zip(lanes, dpos, dth):
        if name == "speeds":
            assert dp < 1e-2, (name, u, dp)
        else:
            assert dp < 1.5e-3 and dt < 1e-2, (name, u, dp, dt)


def test_constructors_default_to_the_card():
    """Without a device argument the constructors put their tensors on the card,
    and on a machine without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default works")
    calls = {
        "make_line_segment": lambda: T.make_line_segment((0, 0), (1, 0)),
        "make_cubic_segment": lambda: T.make_cubic_segment([0.0, 1.0], [0.0]),
        "window_init": lambda: T.window_init(4, 2),
        "path_segment_from_numpy": lambda: path_segment_from_numpy(
            _np(J.make_line_segment((0, 0), (1, 0)))),
    }
    for what, call in calls.items():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda|NVIDIA"):
            call()
            pytest.fail(f"{what} ran without a card")
