"""The port's 2-D (data, stage) mesh solve with its stage blocks on the stage
devices (``parallel/mesh2d.py`` over ``qp/ipm.py::solve_box_qp_blocks``).

Against the JAX package's stage-parallel solve (``jax.vmap(solve_box_qp(...,
stage_parallel=True))``; JAX's own 2-D solve needs the horizon to divide
evenly, ``tests/test_torch_multihost.py`` holds it at N=16) within 1e-10 in
f64: a (1, 3) mesh at N=10 (stage blocks of 4, 4, 2) and a (2, 6) mesh at
N=10 (five blocks of 2; the sixth stage device gets none), and ``kkt_res``
and ``mu`` of an iterate three iterations in, summed and maxed across the
blocks.  A lane with a non-finite ``c`` row in one block freezes on every
block, as in the 1-D solve, and so does a lane whose corrector step is
non-finite on one block only (a NaN in ``c`` spreads to every block
through the scans; this one does not).  In f32 the 2-D solve is within the
batched-vs-serial bound (3.6e-6) of the f32 1-D solve.  Every cross-device
move goes through ``parallel_riccati.move``; recording its calls shows that
after the initial split an iteration moves only single stage rows and
per-lane values, and as many at N=48 as at N=24.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_nav_control_tpu.qp.ipm import BoxQP as JBoxQP
from nmpc_nav_control_tpu.qp.ipm import solve_box_qp as jsolve
from nmpc_nav_control_tpu_torch.parallel import make_mesh, solve_box_qp_2d
from nmpc_nav_control_tpu_torch.qp import BoxQP, ipm, parallel_riccati, solve_box_qp

torch.set_num_threads(1)

IDXBX, IDXBU = (1, 3), (0, 1)
FIELDS = ("dxs", "dus", "lam_xl", "lam_xu", "lam_ul", "lam_uu", "mu", "kkt_res")


def _qp(N, B=4, nx=4, nu=2, nbx=2, nbu=2, seed=2):
    """tests/test_multihost.py's 2-D instance (inputs within reach of their
    bounds)."""
    rng = np.random.default_rng(seed)
    return dict(
        A=rng.normal(size=(B, N, nx, nx)) * 0.2 + np.eye(nx) * 0.9,
        B=rng.normal(size=(B, N, nx, nu)) * 0.4,
        c=rng.normal(size=(B, N, nx)) * 0.05,
        Qd=rng.uniform(0.5, 2.0, size=(B, N + 1, nx)),
        qx=rng.normal(size=(B, N + 1, nx)) * 0.5,
        Rd=rng.uniform(0.5, 2.0, size=(B, N, nu)),
        qu=rng.normal(size=(B, N, nu)) * 0.5,
        dx0=rng.normal(size=(B, nx)) * 0.1,
        lbx=np.full((B, N, nbx), -1.0), ubx=np.full((B, N, nbx), 1.0),
        lbu=np.full((B, N, nbu), -0.3), ubu=np.full((B, N, nbu), 0.3),
    )


def _torch(d, dtype=torch.float64):
    return BoxQP(**{k: torch.tensor(v, dtype=dtype) for k, v in d.items()})


def _jax_1d(d, iters):
    qp = JBoxQP(**{k: jnp.asarray(v) for k, v in d.items()})
    return jax.jit(jax.vmap(lambda q: jsolve(q, IDXBX, IDXBU, iters=iters,
                                             stage_parallel=True)))(qp)


def _spans(monkeypatch):
    """The stage spans of every row's split, recorded."""
    seen, split = [], ipm._split

    def record(qp, idxbx, idxbu, devices):
        blocks = split(qp, idxbx, idxbu, devices)
        seen.append([b.Rd.shape[0] for b in blocks])
        return blocks

    monkeypatch.setattr(ipm, "_split", record)
    return seen


@pytest.mark.parametrize("shape,blocks", [((1, 3), [4, 4, 2]), ((2, 6), [2, 2, 2, 2, 2])])
def test_2d_mesh_matches_jax_1d(monkeypatch, shape, blocks):
    d = _qp(10)
    seen = _spans(monkeypatch)
    mesh = make_mesh(shape, ("data", "stage"), devices=["cpu"] * (shape[0] * shape[1]))
    got = solve_box_qp_2d(_torch(d), IDXBX, IDXBU, mesh, iters=12).gather()
    assert seen == [blocks] * shape[0]
    want = _jax_1d(d, 12)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-10, err_msg=name)
    assert got.dxs.shape == (4, 11, 4) and got.lam_xl.shape == (4, 10, 2)
    assert float(got.mu.max()) < 1e-8
    assert (got.dus.abs() > 0.3 - 1e-6).any(), "no input reaches its bound"


def test_kkt_res_and_mu_across_blocks_match_jax():
    """Three iterations in, far from convergence, the costate recursion
    crosses every block boundary with a large residual."""
    d = _qp(14)
    mesh = make_mesh((1, 4), ("data", "stage"), devices=["cpu"] * 4)
    got = solve_box_qp_2d(_torch(d), IDXBX, IDXBU, mesh, iters=3).gather()
    want = _jax_1d(d, 3)
    assert float(np.min(want.kkt_res)) > 1e-4
    for name in ("kkt_res", "mu", "dxs"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-10, err_msg=name)


def test_non_finite_lane_freezes_on_every_block():
    """A NaN in one stage of one lane's ``c``, inside the third of four
    blocks: the lane keeps its first iterate on every block, as the 1-D
    solve's does, and the other lanes are untouched."""
    d = _qp(14)
    d["c"][2, 9, 1] = np.nan
    qp = _torch(d)
    mesh = make_mesh((2, 4), ("data", "stage"), devices=["cpu"] * 8)
    got = solve_box_qp_2d(qp, IDXBX, IDXBU, mesh, iters=12).gather()
    one = solve_box_qp(qp, IDXBX, IDXBU, iters=12, stage_parallel=True)
    for name in FIELDS:
        g, w = getattr(got, name), getattr(one, name)
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-10, err_msg=name)
    assert float(got.dxs[2].abs().max()) == 0.0 and float(got.dus[2].abs().max()) == 0.0
    assert float(got.dus[3].abs().max()) > 0.0 and float(got.mu[3]) < 1e-8


def test_a_step_bad_on_one_block_freezes_the_lane_on_all(monkeypatch):
    """A NaN in ``c`` reaches every block through the scans, so the test
    above cannot tell one freeze decision a lane from one a block.  Here
    every corrector step of lane 1 is poisoned on the third block only (the
    affine step and the other blocks stay finite): the lane must keep its
    first iterate on all four blocks, and the other lanes solve as
    without the poison."""
    qp = _torch(_qp(14))
    mesh = make_mesh((1, 4), ("data", "stage"), devices=["cpu"] * 4)
    clean = solve_box_qp_2d(qp, IDXBX, IDXBU, mesh, iters=6).gather()
    calls, real = [0], ipm.plqr_solve_blocks

    def poisoned(blocks, dx0):
        dxs, dus = real(blocks, dx0)
        calls[0] += 1
        if calls[0] % 2 == 0:                       # the corrector pass
            dus[2] = dus[2].clone()
            dus[2][1] = float("nan")
        return dxs, dus

    monkeypatch.setattr(ipm, "plqr_solve_blocks", poisoned)
    got = solve_box_qp_2d(qp, IDXBX, IDXBU, mesh, iters=6).gather()
    assert calls[0] == 12
    assert float(got.dxs[1].abs().max()) == 0.0 and float(got.dus[1].abs().max()) == 0.0
    assert bool(torch.isfinite(got.lam_ul[1]).all())
    keep = [0, 2, 3]
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name)[keep].numpy(),
                                      getattr(clean, name)[keep].numpy(), err_msg=name)


def test_f32_2d_mesh_within_the_batched_bound():
    """f32 on a (2, 4) mesh against the f32 1-D solve, within the
    batched-vs-serial bound of 3.6e-6."""
    qp = _torch(_qp(16), torch.float32)
    mesh = make_mesh((2, 4), ("data", "stage"), devices=["cpu"] * 8)
    got = solve_box_qp_2d(qp, IDXBX, IDXBU, mesh, iters=8).gather()
    one = solve_box_qp(qp, IDXBX, IDXBU, iters=8, stage_parallel=True)
    assert got.dus.dtype == torch.float32
    for name in ("dxs", "dus"):
        gap = float((getattr(got, name) - getattr(one, name)).abs().max())
        assert gap <= 3.6e-6, (name, gap)


def _record_moves(monkeypatch, N, iters):
    """Every ``move`` of a (1, 4) mesh solve as (iteration, shape); the
    iteration is None outside ``ipm._iteration``."""
    calls, state = [], {"k": -1, "inside": False}
    real_move, real_iteration = parallel_riccati.move, ipm._iteration

    def move(x, device):
        calls.append((state["k"] if state["inside"] else None, tuple(x.shape)))
        return real_move(x, device)

    def iteration(*args, **kw):
        state["k"] += 1
        state["inside"] = True
        try:
            return real_iteration(*args, **kw)
        finally:
            state["inside"] = False

    with monkeypatch.context() as m:
        for mod in (parallel_riccati, ipm):
            m.setattr(mod, "move", move)
        m.setattr(ipm, "_iteration", iteration)
        d = _qp(N, B=3, nx=5, nu=3, nbx=3, nbu=3, seed=N)
        mesh = make_mesh((1, 4), ("data", "stage"), devices=["cpu"] * 4)
        solve_box_qp_2d(_torch(d), (0, 1, 3), (0, 1, 2), mesh, iters=iters)
    return calls


def test_iterations_move_only_rows_and_lane_values(monkeypatch):
    """Lanes 3, nx 5, nu and both bound groups 3: a stage block of N=24 or
    48 on four devices has 6 or 12 stages, so any tensor holding a block's
    rows has an axis of 6 or more.  Inside the iterations every move holds
    at most one stage row (an axis of 1) or is a per-lane value ([B] or
    [B, nx]); the iterations move as often as each other, at both N."""
    per_iter = {}
    for N in (24, 48):
        calls = _record_moves(monkeypatch, N, iters=3)
        inside = [(i, s) for i, s in calls if i is not None]
        counts = [sum(1 for i, _ in inside if i == k) for k in range(3)]
        assert counts[0] == counts[1] == counts[2] > 0, counts
        per_iter[N] = counts[0]
        for _, shape in inside:
            assert max(shape) <= 5 and (len(shape) <= 2 or 1 in shape), shape
        split = [s for i, s in calls if i is None]
        assert max(max(s) for s in split) >= N // 4, "the split moves whole blocks"
    assert per_iter[24] == per_iter[48]
