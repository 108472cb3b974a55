"""The port's Riccati-based box-QP solve against the JAX package's.

``nmpc_nav_control_tpu_torch.qp.solve_box_qp`` with ``NMPC_TPU_TILED_IPM=0``
(``solve_box_qp_serial``: one Riccati factorization and two Riccati solves
per Mehrotra iteration, through the plain versions of the Riccati kernels
on CPU tensors) against ``jax.vmap(nmpc_nav_control_tpu.qp.solve_box_qp)``
with the same setting, on random QPs in the style of ``tests/test_qp.py`` at
B=8, N=10, for (nx, nu) = (7, 2) and (11, 4): f64 to 1e-10 in every output,
f32 within the batched-vs-serial bound of ``tests/test_qp.py``.  One case
starts from a warm start that touches an input bound exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmpc_nav_control_tpu_torch.qp.ipm as ipm
from nmpc_nav_control_tpu.qp.ipm import BoxQP as JBoxQP
from nmpc_nav_control_tpu.qp.ipm import solve_box_qp as jsolve
from nmpc_nav_control_tpu_torch.qp import BoxQP, solve_box_qp

torch.set_num_threads(1)

B, N = 8, 10
SHAPES = {(7, 2): ((5, 6), (0, 1)), (11, 4): ((7, 8, 9, 10), (0, 1, 2, 3))}
FIELDS = ("dxs", "dus", "lam_xl", "lam_xu", "lam_ul", "lam_uu", "mu", "kkt_res")
TOL = {"float64": {f: dict(rtol=0.0, atol=1e-10) for f in FIELDS},
       "float32": dict(dxs=dict(atol=3e-4, rtol=1e-3), dus=dict(atol=3e-4, rtol=1e-3),
                       mu=dict(atol=1e-6, rtol=0.2))}


@pytest.fixture(autouse=True)
def _riccati_route(monkeypatch):
    monkeypatch.setenv("NMPC_TPU_TILED_IPM", "0")


def _random_qps(nx, nu, seed, touch_bound=False):
    rng = np.random.default_rng(seed)
    nbx, nbu = len(SHAPES[nx, nu][0]), len(SHAPES[nx, nu][1])
    lbx = np.full((B, N, nbx), -1.0)
    lbu = np.full((B, N, nbu), -2.0)
    qu = rng.normal(size=(B, N, nu)) * 2.0
    if touch_bound:
        # The zero warm start sits exactly on the lower bound of u_0 in
        # every stage (gap 0, slack clamped to s_min) and the gradient
        # pushes u_0 into it: the start that used to make the corrector cycle.
        lbu[..., 0] = 0.0
        qu[..., 0] = np.abs(qu[..., 0]) + 1.0
    return dict(
        A=rng.normal(size=(B, N, nx, nx)) * 0.2 + np.eye(nx) * 0.95,
        B=rng.normal(size=(B, N, nx, nu)) * 0.4,
        c=rng.normal(size=(B, N, nx)) * 0.05,
        Qd=rng.uniform(0.5, 2.0, size=(B, N + 1, nx)),
        qx=rng.normal(size=(B, N + 1, nx)) * 0.5,
        Rd=rng.uniform(0.5, 2.0, size=(B, N, nu)),
        qu=qu, dx0=rng.normal(size=(B, nx)) * 0.1,
        lbx=lbx, ubx=-lbx, lbu=lbu, ubu=np.full((B, N, nbu), 2.0),
    )


def _both(d, nx, nu, dtype, iters):
    idxbx, idxbu = SHAPES[nx, nu]
    want = jax.jit(jax.vmap(lambda q: jsolve(q, idxbx, idxbu, iters=iters)))(
        JBoxQP(**{k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in d.items()}))
    got = solve_box_qp(
        BoxQP(**{k: torch.tensor(v, dtype=getattr(torch, dtype)) for k, v in d.items()}),
        idxbx, idxbu, iters=iters)
    return got, want


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nx,nu", list(SHAPES))
def test_riccati_solve_matches_jax(nx, nu, dtype):
    got, want = _both(_random_qps(nx, nu, 42), nx, nu, dtype, iters=10)
    for name, tol in TOL[dtype].items():
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   err_msg=name, **tol)
    # The instances are constrained: some input bound is active.
    assert np.abs(got.dus.numpy()).max() > 1.99


@pytest.mark.parametrize("nx,nu", list(SHAPES))
def test_riccati_solve_bound_touching_warm_start(nx, nu):
    got, want = _both(_random_qps(nx, nu, 7, touch_bound=True), nx, nu, "float64", iters=20)
    for name, tol in TOL["float64"].items():
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   err_msg=name, **tol)
    assert float(got.mu.max()) < 1e-8          # no cycling: the barrier is driven out
    assert np.abs(got.dus[..., 0].numpy()).min() < 1e-6   # and the bound is active


def test_solve_box_qp_routes_by_env(monkeypatch):
    """NMPC_TPU_TILED_IPM is read per call: "0" takes the Riccati solve,
    anything else the fused sweeps; both agree in f64."""
    calls = []
    orig = ipm.solve_box_qp_serial
    monkeypatch.setattr(ipm, "solve_box_qp_serial",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    d = _random_qps(7, 2, 3)
    qp = BoxQP(**{k: torch.tensor(v) for k, v in d.items()})
    ric = solve_box_qp(qp, (5, 6), (0, 1), iters=10)
    assert calls == [1]
    monkeypatch.setenv("NMPC_TPU_TILED_IPM", "1")
    fused = solve_box_qp(qp, (5, 6), (0, 1), iters=10)
    assert calls == [1]
    for name in FIELDS:
        np.testing.assert_allclose(getattr(ric, name).numpy(), getattr(fused, name).numpy(),
                                   rtol=0.0, atol=1e-10, err_msg=name)


def test_solve_box_qp_takes_the_callers_route(monkeypatch):
    """A route passed by the caller (``rti_step`` passes the one it read)
    wins over the environment, both ways."""
    calls = []
    orig = ipm.solve_box_qp_serial
    monkeypatch.setattr(ipm, "solve_box_qp_serial",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    qp = BoxQP(**{k: torch.tensor(v) for k, v in _random_qps(7, 2, 5).items()})
    solve_box_qp(qp, (5, 6), (0, 1), iters=2, tiled=True)
    assert calls == []
    monkeypatch.setenv("NMPC_TPU_TILED_IPM", "1")
    solve_box_qp(qp, (5, 6), (0, 1), iters=2, tiled=False)
    assert calls == [1]


def test_riccati_solve_hands_the_kernels_what_they_take(monkeypatch):
    """Every operand the solve passes to the Riccati kernel wrappers is
    contiguous and of the problem's dtype: what the CUDA kernels check on
    the card (here the wrappers take the plain versions)."""
    import nmpc_nav_control_tpu_torch.ops.riccati_fused as rf

    seen = []

    def checked(fn):
        def wrapper(*args, **kw):
            seen.append(fn.__name__)
            for t in args:
                assert t.is_contiguous() and t.dtype == torch.float32, fn.__name__
            return fn(*args, **kw)
        return wrapper

    for name in ("riccati_factor_fused", "riccati_solve_bwd_fused", "riccati_solve_fwd_fused"):
        monkeypatch.setattr(rf, name, checked(getattr(rf, name)))
    d = _random_qps(11, 4, 3)
    solve_box_qp(BoxQP(**{k: torch.tensor(v, dtype=torch.float32) for k, v in d.items()}),
                 *SHAPES[11, 4], iters=2)
    assert seen.count("riccati_factor_fused") == 2 and seen.count("riccati_solve_fwd_fused") == 4
