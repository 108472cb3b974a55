"""The port's stage-parallel LQR and stage-parallel box-IPM against JAX's.

``nmpc_nav_control_tpu_torch.qp.parallel_riccati.plqr_solve`` (log-depth
scans, batched) against ``jax.vmap`` of the JAX package's ``plqr_solve``
and against the port's serial ``lqr_solve``, in f64 within 1e-10 of each
output's largest entry (the scans' trees differ, so rounding does); the
same with the horizon split into stage blocks (the two-level scan of
``parallel/mesh2d.py``).  Then ``solve_box_qp(..., stage_parallel=True)``
against ``jax.vmap(solve_box_qp(..., stage_parallel=True))`` within 1e-9,
launching no kernel wrapper.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_nav_control_tpu.qp.ipm import BoxQP as JBoxQP
from nmpc_nav_control_tpu.qp.ipm import solve_box_qp as jsolve
from nmpc_nav_control_tpu.qp.parallel_riccati import plqr_solve as jplqr
from nmpc_nav_control_tpu_torch.ops import ipm_fused, riccati_fused
from nmpc_nav_control_tpu_torch.qp import BoxQP, ipm, ipm_batched, solve_box_qp
from nmpc_nav_control_tpu_torch.qp.parallel_riccati import plqr_solve, stage_blocks
from nmpc_nav_control_tpu_torch.qp.riccati import lqr_solve

torch.set_num_threads(1)

TOL = 1e-10


def _problem(rng, batch, N, nx, nu, zero_q=False):
    """tests/test_parallel_riccati.py's random LQR, with a batch axis."""
    Qd = rng.uniform(0.1, 2.0, size=(batch, N + 1, nx))
    if zero_q:
        Qd[..., 3:] = 0.0        # the reference's velocity states carry no weight
    return (rng.normal(size=(batch, N, nx, nx)) * 0.3 + np.eye(nx) * 0.9,
            rng.normal(size=(batch, N, nx, nu)) * 0.5, Qd,
            rng.uniform(0.5, 2.0, size=(batch, N, nu)),
            rng.normal(size=(batch, N + 1, nx)), rng.normal(size=(batch, N, nu)),
            rng.normal(size=(batch, N, nx)) * 0.1, rng.normal(size=(batch, nx)))


def _close(got, want):
    scale = np.abs(want).max()
    assert np.abs(np.asarray(got) - want).max() <= TOL * scale


@pytest.mark.parametrize("N,nx,nu,batch,zero_q", [(1, 4, 2, 1, False), (2, 4, 2, 3, False),
                                                  (7, 7, 2, 4, True), (16, 11, 4, 5, False)])
def test_plqr_matches_jax_and_serial(N, nx, nu, batch, zero_q):
    prob = _problem(np.random.default_rng(N + nx), batch, N, nx, nu, zero_q)
    want_dxs, want_dus = map(np.asarray, jax.jit(jax.vmap(jplqr))(*map(jnp.asarray, prob)))
    args = [torch.tensor(x) for x in prob]
    dxs, dus = plqr_solve(*args)
    _close(dxs, want_dxs)
    _close(dus, want_dus)
    serial = [x.numpy() for x in lqr_solve(*args)]
    _close(dxs, serial[0])
    _close(dus, serial[1])
    # A lane solved alone is the lane of the batch.
    one = plqr_solve(*(x[batch - 1:] for x in args))
    _close(one[1][0], dus[-1].numpy())
    # The two-level scan over stage blocks (a mesh's stage axis).
    for n_blocks in (2, 3, 8):
        blocked = plqr_solve(*args, stage_devices=["cpu"] * n_blocks)
        _close(blocked[0], want_dxs)
        _close(blocked[1], want_dus)


def test_plqr_at_a_long_horizon_matches_serial():
    """N=40: six levels of the log-depth scan, where a wrong operand order
    shows at once."""
    args = [torch.tensor(x) for x in _problem(np.random.default_rng(40), 2, 40, 7, 2)]
    serial = [x.numpy() for x in lqr_solve(*args)]
    for got, want in zip(plqr_solve(*args), serial):
        _close(got, want)


def test_stage_blocks():
    assert stage_blocks(16, 4) == [(0, 4), (4, 8), (8, 12), (12, 16)]
    assert stage_blocks(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert stage_blocks(5, 4) == [(0, 2), (2, 4), (4, 5)]
    assert stage_blocks(7, 1) == [(0, 7)]


B, N, NX, NU = 6, 9, 7, 2
IDXBX, IDXBU = (5, 6), (0, 1)


def _random_qps(seed):
    """tests/test_torch_qp.py's instances, inputs large enough to hit bounds."""
    rng = np.random.default_rng(seed)
    lbx, lbu = np.full((B, N, 2), -1.0), np.full((B, N, 2), -2.0)
    return dict(
        A=rng.normal(size=(B, N, NX, NX)) * 0.2 + np.eye(NX) * 0.95,
        B=rng.normal(size=(B, N, NX, NU)) * 0.4,
        c=rng.normal(size=(B, N, NX)) * 0.05,
        Qd=rng.uniform(0.5, 2.0, size=(B, N + 1, NX)),
        qx=rng.normal(size=(B, N + 1, NX)) * 0.5,
        Rd=rng.uniform(0.5, 2.0, size=(B, N, NU)),
        qu=rng.normal(size=(B, N, NU)) * 2.0,
        dx0=rng.normal(size=(B, NX)) * 0.1,
        lbx=lbx, ubx=-lbx, lbu=lbu, ubu=-lbu,
    )


@functools.lru_cache(maxsize=None)
def _jax_stage_parallel(seed):
    qp = JBoxQP(**{k: jnp.asarray(v) for k, v in _random_qps(seed).items()})
    return jax.jit(jax.vmap(lambda q: jsolve(q, IDXBX, IDXBU, iters=10, stage_parallel=True)))(qp)


@pytest.mark.parametrize("route", ["1", "0"])
def test_stage_parallel_ipm_matches_jax(route, monkeypatch):
    """Either route setting: the stage-parallel solve takes the Riccati
    solve's iteration, with no factorization and no kernel wrapper."""
    monkeypatch.setenv("NMPC_TPU_TILED_IPM", route)
    d = _random_qps(7)
    want = _jax_stage_parallel(7)
    calls = []
    wrappers = ("ipm_bwd_fused", "ipm_fwd_affine", "ipm_bwd_corr", "ipm_fwd_corr",
                "ipm_kkt_fused", "riccati_factor_fused", "riccati_solve_bwd_fused",
                "riccati_solve_fwd_fused")
    for mod in (ipm_fused, riccati_fused, ipm_batched, ipm, ipm.rf):
        for name in set(wrappers) & set(vars(mod)):
            monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: calls.append(_n))
    got = solve_box_qp(BoxQP(**{k: torch.tensor(v) for k, v in d.items()}), IDXBX, IDXBU,
                       iters=10, stage_parallel=True)
    assert calls == []
    for name in ("dxs", "dus", "lam_xl", "lam_xu", "lam_ul", "lam_uu", "mu", "kkt_res"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0.0, atol=1e-9, err_msg=name)
    assert np.abs(got.dus.numpy()).max() > 1.99        # an input bound is active
