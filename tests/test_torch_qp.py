"""The port's batched box-QP solve against the JAX package's.

``nmpc_nav_control_tpu_torch.qp.solve_box_qp`` (dense QP data packed to the
dense 7x2 pattern, then the fused-sweep iteration of ``qp/ipm_batched.py``)
against ``jax.vmap(nmpc_nav_control_tpu.qp.solve_box_qp)`` on JAX's default
CPU path (the serial per-problem IPM), on random QPs in the style of
``tests/test_qp.py``: f64 to rounding, f32 within that file's
batched-vs-serial bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_nav_control_tpu.qp.ipm import BoxQP as JBoxQP
from nmpc_nav_control_tpu.qp.ipm import solve_box_qp as jsolve
from nmpc_nav_control_tpu_torch.qp import BoxQP, solve_box_qp

torch.set_num_threads(1)

B, N, NX, NU = 16, 6, 7, 2
IDXBX, IDXBU = (5, 6), (0, 1)


def _random_qps(seed):
    rng = np.random.default_rng(seed)
    lbx = np.full((B, N, 2), -1.0)
    lbu = np.full((B, N, 2), -2.0)
    return dict(
        A=rng.normal(size=(B, N, NX, NX)) * 0.2 + np.eye(NX) * 0.95,
        B=rng.normal(size=(B, N, NX, NU)) * 0.4,
        c=rng.normal(size=(B, N, NX)) * 0.05,
        Qd=rng.uniform(0.5, 2.0, size=(B, N + 1, NX)),
        qx=rng.normal(size=(B, N + 1, NX)) * 0.5,
        Rd=rng.uniform(0.5, 2.0, size=(B, N, NU)),
        qu=rng.normal(size=(B, N, NU)) * 2.0,     # large enough to hit bounds
        dx0=rng.normal(size=(B, NX)) * 0.1,
        lbx=lbx, ubx=-lbx, lbu=lbu, ubu=-lbu,
    )


@pytest.mark.parametrize("dtype,tol", [("float64", dict(rtol=0.0, atol=1e-8)),
                                       ("float32", dict(rtol=1e-3, atol=3e-4))])
def test_batched_solve_matches_jax(dtype, tol):
    d = _random_qps(42)
    want = jax.jit(jax.vmap(lambda q: jsolve(q, IDXBX, IDXBU, iters=10)))(
        JBoxQP(**{k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in d.items()}))
    got = solve_box_qp(
        BoxQP(**{k: torch.tensor(v, dtype=getattr(torch, dtype)) for k, v in d.items()}),
        IDXBX, IDXBU, iters=10)
    for name in ("dxs", "dus", "lam_xl", "lam_xu", "lam_ul", "lam_uu", "mu", "kkt_res"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   err_msg=name, **tol)
    # The instances are constrained: some input bound is active.
    assert np.abs(got.dus.numpy()).max() > 1.99
