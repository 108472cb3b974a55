"""Leaf modules of the torch port against their JAX counterparts, in f64.

Angles, the diff, omni4 and tric models and their kinematic maps, RK4, the
stage linearization, the rollout, OCPDims and the structural sparsity
detection: the same numpy inputs through both packages, agreement to f64
rounding.  Also: the compile-time patterns of the CUDA specialisations equal
the patterns detected for each model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_nav_control_tpu.models import diff as jdiff
from nmpc_nav_control_tpu.models import omni4 as jomni4
from nmpc_nav_control_tpu.models import tric as jtric
from nmpc_nav_control_tpu.ocp import integrator as jint
from nmpc_nav_control_tpu.ocp.sparsity import detect_jacobian_sparsity as jdetect
from nmpc_nav_control_tpu.ocp.spec import OCPDims as JOCPDims
from nmpc_nav_control_tpu.utils import angles as jang
from nmpc_nav_control_tpu_torch.models import diff, omni4, tric
from nmpc_nav_control_tpu_torch.ocp import integrator
from nmpc_nav_control_tpu_torch.ocp.sparsity import detect_jacobian_sparsity
from nmpc_nav_control_tpu_torch.ocp.spec import OCPDims
from nmpc_nav_control_tpu_torch.ops._build import header_config
from nmpc_nav_control_tpu_torch.utils import angles

torch.set_num_threads(1)

DT = 0.025
P = np.array([0.27, 0.1])
TOL = dict(rtol=1e-13, atol=1e-14)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _j(x):
    return jnp.asarray(np.asarray(x, np.float64))


def test_angles_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(-20.0, 20.0, 257)
    b = rng.uniform(-20.0, 20.0, 257)
    np.testing.assert_allclose(angles.norm_ang_rad(_t(a)).numpy(),
                               np.asarray(jang.norm_ang_rad(_j(a))), **TOL)
    np.testing.assert_allclose(angles.unwrap_angle(_t(a), _t(b)).numpy(),
                               np.asarray(jang.unwrap_angle(_j(a), _j(b))), **TOL)
    xy = rng.normal(size=(4, 257))
    np.testing.assert_allclose(angles.dist(*map(_t, xy)).numpy(),
                               np.asarray(jang.dist(*map(_j, xy))), **TOL)


def test_diff_model_and_kinematics_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(5):
        x, u = rng.normal(size=7), rng.normal(size=2)
        np.testing.assert_allclose(diff.f(_t(x), _t(u), _t(P)).numpy(),
                                   np.asarray(jdiff.f(_j(x), _j(u), _j(P))), **TOL)
    v, w = rng.normal(size=(2, 64))
    for port, ref in ((diff.direct_kinematics, jdiff.direct_kinematics),
                      (diff.inverse_kinematics, jdiff.inverse_kinematics)):
        got = port(_t(v), _t(w), 0.27)
        want = ref(_j(v), _j(w), 0.27)
        for g, r in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    assert (diff.SPEC.nx, diff.SPEC.nu, diff.SPEC.idxbx, diff.SPEC.idxbu) == (
        jdiff.SPEC.nx, jdiff.SPEC.nu, jdiff.SPEC.idxbx, jdiff.SPEC.idxbu)


def test_rk4_linearize_rollout_match_jax():
    rng = np.random.default_rng(2)
    N = 6
    xs, us = rng.normal(size=(N + 1, 7)) * 0.5, rng.normal(size=(N, 2)) * 0.5
    np.testing.assert_allclose(
        integrator.rk4_step(diff.f, _t(xs[0]), _t(us[0]), _t(P), DT).numpy(),
        np.asarray(jint.rk4_step(jdiff.f, _j(xs[0]), _j(us[0]), _j(P), DT)), **TOL)
    got = integrator.linearize_trajectory(diff.f, DT, _t(xs), _t(us), _t(P))
    want = jint.linearize_trajectory(jdiff.f, DT, _j(xs), _j(us), _j(P))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(
        integrator.rollout(diff.f, DT, _t(xs[0]), _t(us), _t(P)).numpy(),
        np.asarray(jint.rollout(jdiff.f, DT, _j(xs[0]), _j(us), _j(P))), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sparsity_pattern_matches_jax(dtype):
    """Same sample points (numpy generator, seed 0) -> the same pattern:
    23 of 49 structural nonzeros in A, 10 of 14 in B."""
    asp, bsp = detect_jacobian_sparsity(diff.f, DT, 7, 2,
                                        torch.tensor(P, dtype=getattr(torch, dtype)))
    jasp, jbsp = jdetect(jdiff.f, DT, 7, 2, jnp.asarray(P, getattr(jnp, dtype)))
    assert (asp, bsp) == (jasp, jbsp)
    assert (sum(map(sum, asp)), sum(map(sum, bsp))) == (23, 10)


def test_ocp_dims_from_freq_matches_jax():
    for tf, freq in ((2.0, 40), (1.0, 40), (2.0, 20), (0.7, 30)):
        got = OCPDims.from_freq(diff.SPEC, tf, freq)
        want = JOCPDims.from_freq(jdiff.SPEC, tf, freq)
        assert (got.N, got.dt) == (want.N, want.dt)


def test_batched_model_evaluation_is_elementwise():
    """The port's f evaluates a whole [nx, ...] block at once; each column
    equals the JAX model on that column (the layout linearize_packed uses)."""
    rng = np.random.default_rng(3)
    x, u = rng.normal(size=(7, 5, 3)), rng.normal(size=(2, 5, 3))
    got = diff.f(_t(x), _t(u), _t(P)).numpy()
    want = jax.vmap(jax.vmap(lambda a, b: jdiff.f(a, b, _j(P)), in_axes=(1, 1), out_axes=1),
                    in_axes=(1, 1), out_axes=1)(_j(x), _j(u))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


# geometry -> (port spec, JAX spec, parameters, kernel header, A / B nonzeros)
GEOMETRIES = {
    "omni4": (omni4.SPEC, jomni4.SPEC, [0.535, 0.1], "config_omni4.cuh", 41, 20),
    "tric": (tric.SPEC, jtric.SPEC, [1.05, 0.1, 0.1], "config_diff.cuh", 23, 10),
    "tric_bug": (tric.SPEC_BUG_COMPAT, jtric.SPEC_BUG_COMPAT, [1.05, 0.1, 0.1],
                 "config_diff.cuh", 23, 10),
}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_geometry_model_matches_jax(geometry):
    spec, jspec, p = GEOMETRIES[geometry][:3]
    rng = np.random.default_rng(5)
    for _ in range(5):
        x, u = rng.normal(size=spec.nx), rng.normal(size=spec.nu)
        np.testing.assert_allclose(spec.f(_t(x), _t(u), _t(p)).numpy(),
                                   np.asarray(jspec.f(_j(x), _j(u), _j(p))), **TOL)
    # Elementwise over trailing axes, as linearize_packed evaluates it.
    x, u = rng.normal(size=(spec.nx, 4, 3)), rng.normal(size=(spec.nu, 4, 3))
    want = jax.vmap(jax.vmap(lambda a, b: jspec.f(a, b, _j(p)), in_axes=(1, 1), out_axes=1),
                    in_axes=(1, 1), out_axes=1)(_j(x), _j(u))
    np.testing.assert_allclose(spec.f(_t(x), _t(u), _t(p)).numpy(), np.asarray(want), **TOL)
    assert (spec.name, spec.nx, spec.nu, spec.npar, spec.idxbx, spec.idxbu) == (
        jspec.name, jspec.nx, jspec.nu, jspec.npar, jspec.idxbx, jspec.idxbu)


def test_omni4_kinematics_and_params_match_jax():
    rng = np.random.default_rng(6)
    v, vn, w = rng.normal(size=(3, 64))
    for g, r in zip(omni4.direct_kinematics(_t(v), _t(vn), _t(w), 0.535),
                    jomni4.direct_kinematics(_j(v), _j(vn), _j(w), 0.535)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    wheels = rng.normal(size=(4, 64))
    for g, r in zip(omni4.inverse_kinematics(*map(_t, wheels), 0.535),
                    jomni4.inverse_kinematics(*map(_j, wheels), 0.535)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(omni4.make_params(0.535, 0.1).numpy(),
                               np.asarray(jomni4.make_params(0.535, 0.1)), **TOL)
    np.testing.assert_allclose(tric.make_params(1.05, 0.1, 0.2).numpy(),
                               np.asarray(jtric.make_params(1.05, 0.1, 0.2)), **TOL)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_geometry_sparsity_matches_jax_and_kernel_header(geometry):
    """The detected patterns equal JAX's (41/121 A nonzeros for omni4, 23/49
    for tric), and the CUDA specialisation that serves the model was
    compiled for exactly that pattern, for several parameters and steps."""
    spec, jspec, p, header, nnz_a, nnz_b = GEOMETRIES[geometry]
    for dtype in ("float32", "float64"):
        asp, bsp = detect_jacobian_sparsity(spec.f, DT, spec.nx, spec.nu,
                                            torch.tensor(p, dtype=getattr(torch, dtype)))
        assert (asp, bsp) == jdetect(jspec.f, DT, spec.nx, spec.nu,
                                     jnp.asarray(p, getattr(jnp, dtype)))
        assert (sum(map(sum, asp)), sum(map(sum, bsp))) == (nnz_a, nnz_b)
    for scale, dt in ((1.0, 0.025), (2.0, 0.0125), (0.5, 0.1)):
        pats = detect_jacobian_sparsity(spec.f, dt, spec.nx, spec.nu,
                                        torch.tensor(p) * scale)
        assert header_config(header) == (spec.nx, spec.nu, spec.idxbx, spec.idxbu, *pats)
