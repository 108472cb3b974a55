"""The port's packed batched linearization against the JAX package.

``nmpc_nav_control_tpu_torch/ops/linearize_packed.py::linearize_packed``
must produce what ``nmpc_nav_control_tpu/ops/tiled_linearize.py::
linearize_packed_tiled`` produces, converted from the TPU tile layout to the
port's batch-minor [N, e, B]: f32 at B=1024, on the pattern of
``tests/test_tiled_linearize.py`` (same tolerances), and f64 at a small
batch against the dense per-trajectory ``linearize_trajectory``, with the
model's pattern and, for every geometry, with the dense pattern that the
Riccati route of ``rti/step.py`` linearizes with.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_nav_control_tpu.models import diff as jdiff
from nmpc_nav_control_tpu.models import omni4 as jomni4
from nmpc_nav_control_tpu.models import tric as jtric
from nmpc_nav_control_tpu.ocp.integrator import linearize_trajectory
from nmpc_nav_control_tpu.ops.pallas_ipm import pack_sparse
from nmpc_nav_control_tpu.ops.tiled_linearize import linearize_packed_tiled
from nmpc_nav_control_tpu_torch.models import diff, omni4, tric
from nmpc_nav_control_tpu_torch.ocp.sparsity import detect_jacobian_sparsity
from nmpc_nav_control_tpu_torch.ops.ipm_fused import dense_sparsity
from nmpc_nav_control_tpu_torch.ops.linearize_packed import linearize_packed

torch.set_num_threads(1)

DT = 0.025
P = [0.27, 0.1]


def _untile(t):
    """JAX tiles [G, N, e, 8, 128] -> [N, e, B]."""
    t = np.asarray(t)
    return t.transpose(1, 2, 0, 3, 4).reshape(t.shape[1], t.shape[2], -1)


def _spars(dtype):
    return detect_jacobian_sparsity(diff.f, DT, 7, 2, torch.tensor(P, dtype=dtype))


@pytest.mark.parametrize("per_lane_params", [False, True])
def test_matches_jax_tiled_linearization_f32(per_lane_params):
    B, N = 1024, 40
    rng = np.random.default_rng(3)
    xs = (rng.normal(size=(B, N + 1, 7)) * 0.2).astype(np.float32)
    us = (rng.normal(size=(B, N, 2)) * 0.2).astype(np.float32)
    if per_lane_params:
        p = np.stack([rng.uniform(0.2, 0.4, B), rng.uniform(0.05, 0.2, B)], -1)
    else:
        p = np.asarray(P)
    p = p.astype(np.float32)
    asp, bsp = _spars(torch.float32)
    At, Bt, xnt = jax.jit(lambda a, b, pp: linearize_packed_tiled(
        jdiff.f, DT, a, b, pp, asp, bsp))(jnp.asarray(xs), jnp.asarray(us), jnp.asarray(p))
    A, Bm, xn = linearize_packed(diff.f, DT, torch.from_numpy(xs), torch.from_numpy(us),
                                 torch.from_numpy(p), asp, bsp)
    for got, want in ((A, At), (Bm, Bt), (xn, xnt)):
        np.testing.assert_allclose(got.numpy(), _untile(want), rtol=2e-5, atol=2e-6)


def test_matches_dense_jacobians_f64():
    B, N = 5, 12
    rng = np.random.default_rng(4)
    xs, us = rng.normal(size=(B, N + 1, 7)) * 0.5, rng.normal(size=(B, N, 2)) * 0.5
    asp, bsp = _spars(torch.float64)
    A, Bm, xn = linearize_packed(diff.f, DT, torch.from_numpy(xs), torch.from_numpy(us),
                                 torch.tensor(P, dtype=torch.float64), asp, bsp)
    xn_d, A_d, B_d = jax.vmap(lambda x, u: linearize_trajectory(
        jdiff.f, DT, x, u, jnp.asarray(P)))(jnp.asarray(xs), jnp.asarray(us))
    tol = dict(rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(A.numpy(), np.asarray(pack_sparse(A_d, asp)).transpose(1, 2, 0), **tol)
    np.testing.assert_allclose(Bm.numpy(), np.asarray(pack_sparse(B_d, bsp)).transpose(1, 2, 0), **tol)
    np.testing.assert_allclose(xn.numpy(), np.asarray(xn_d).transpose(1, 2, 0), **tol)


@pytest.mark.parametrize("model,jmodel,p", [
    (diff.SPEC, jdiff.SPEC, [0.27, 0.1]),
    (omni4.SPEC, jomni4.SPEC, [0.535, 0.1]),
    (tric.SPEC, jtric.SPEC, [1.05, 0.1, 0.1]),
    (tric.SPEC_BUG_COMPAT, jtric.SPEC_BUG_COMPAT, [1.05, 0.1, 0.1]),
], ids=["diff", "omni4", "tric", "tric_bug"])
def test_dense_pattern_matches_linearize_trajectory_f64(model, jmodel, p):
    """Complex step with the dense pattern: the dense A/B of the JAX
    package's jacfwd linearization, row-major, to rounding."""
    B, N, nx, nu = 4, 8, model.nx, model.nu
    rng = np.random.default_rng(5)
    xs, us = rng.normal(size=(B, N + 1, nx)) * 0.5, rng.normal(size=(B, N, nu)) * 0.5
    A, Bm, xn = linearize_packed(model.f, DT, torch.from_numpy(xs), torch.from_numpy(us),
                                 torch.tensor(p, dtype=torch.float64), *dense_sparsity(nx, nu))
    xn_d, A_d, B_d = jax.vmap(lambda x, u: linearize_trajectory(
        jmodel.f, DT, x, u, jnp.asarray(p)))(jnp.asarray(xs), jnp.asarray(us))
    tol = dict(rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(A.numpy(), np.asarray(A_d).reshape(B, N, -1).transpose(1, 2, 0),
                               **tol)
    np.testing.assert_allclose(Bm.numpy(), np.asarray(B_d).reshape(B, N, -1).transpose(1, 2, 0),
                               **tol)
    np.testing.assert_allclose(xn.numpy(), np.asarray(xn_d).transpose(1, 2, 0), **tol)
