"""The port's Riccati modules and kernels against the JAX package.

- ``ops/linalg_small.py`` and ``ops/riccati.py`` (plain torch, batch-explicit)
  and the routed wrappers of ``ops/riccati_fused.py`` (the batched entry
  points, reached through ``to_bm`` / ``from_bm``) against ``jax.vmap`` of
  ``nmpc_nav_control_tpu/qp/{linalg_small,riccati}.py`` on the same numpy
  inputs, at (nx, nu) = (7, 2) and (11, 4): f64 to 1e-12, f32 within the
  bounds of ``tests/test_pallas_riccati.py`` (Ps atol 5e-4 / rtol 1e-4, Ks
  atol 5e-5 / rtol 1e-4, dxs and dus atol 5e-5).
- The plain versions of the three Riccati kernels (``ops/riccati_fused.py``,
  what the wrappers take for CPU tensors) against the Pallas kernels they
  replace (``nmpc_nav_control_tpu/ops/pallas_riccati.py``) in interpret
  mode, at B=1024, N=4, within the same f32 bounds, Ps row 0 included.
- The plain versions against Pallas on lanes with a non-positive Quu pivot,
  a NaN in c and an Inf in qx (``add_riccati_faults``): NaN and Inf in the
  same places, N=6, B=1024.
- Each kernel as a ``torch.library`` op (``nmpc_tpu::<kernel>``) on the
  CPU: ``opcheck`` and its outputs equal to the plain version's bit for bit.
- ``gpu``: each CUDA kernel against its plain version on the card, at N = 1,
  13 and 40 and B = 1, 17, 1000, 2048, the faulty lanes included; skips
  without a card.  JAX is imported only by the fixtures that need it, so
  these run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from nmpc_nav_control_tpu_torch.ops import riccati_fused as rf
from nmpc_nav_control_tpu_torch.ops import linalg_small, riccati
from torch_sweep_inputs import (
    INF_QX_LANE,
    NAN_C_LANE,
    NEG_RD_LANE,
    add_riccati_faults,
    random_riccati_inputs,
    riccati_fault_stage,
)

torch.set_num_threads(1)

SHAPES = [(7, 2), (11, 4)]
F64 = dict(rtol=1e-12, atol=1e-12)
F32 = {"Ps": dict(atol=5e-4, rtol=1e-4), "Ks": dict(atol=5e-5, rtol=1e-4),
       "Ls": dict(atol=5e-5, rtol=1e-4), "kff": dict(atol=5e-5, rtol=1e-4),
       "dxs": dict(atol=5e-5, rtol=0.0), "dus": dict(atol=5e-5, rtol=0.0)}


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _factor_routed(A, B, Qd, Rd):
    """``riccati_factor`` through the routed wrapper, in the JAX layout."""
    nx, nu = B.shape[-2:]
    f = rf.riccati_factor_fused(rf.to_bm(A), rf.to_bm(B), rf.to_bm(Qd), rf.to_bm(Rd))
    return riccati.RiccatiFactors(Ps=rf.from_bm(f.Ps, nx, nx), Ks=rf.from_bm(f.Ks, nu, nx),
                                  Ls=rf.from_bm(rf.unpack_L(f.Ls, nu), nu, nu))


def _solve_routed(factors, A, B, qx, qu, c, dx0):
    """``riccati_solve`` through the two routed wrappers, in the JAX layout."""
    nx, nu = B.shape[-2:]
    Am, Bm, Km, cm = rf.to_bm(A), rf.to_bm(B), rf.to_bm(factors.Ks), rf.to_bm(c)
    kff = rf.riccati_solve_bwd_fused(Am, Bm, Km, rf.pack_L(rf.to_bm(factors.Ls), nu),
                                     rf.to_bm(factors.Ps), rf.to_bm(qx), rf.to_bm(qu), cm)
    dxs, dus = rf.riccati_solve_fwd_fused(Am, Bm, Km, kff, cm, dx0.mT.contiguous())
    return rf.from_bm(dxs, nx), rf.from_bm(dus, nu)


def _lqr(nx, nu, N, B, seed):
    """JAX-layout [B, ...] float64 numpy LQR data."""
    x = random_riccati_inputs(nx, nu, N, B, seed)

    def bf(v, *entry):
        return np.moveaxis(v, -1, 0).reshape(B, v.shape[0], *entry).astype(np.float64)

    return dict(A=bf(x["A"], nx, nx), B=bf(x["Bm"], nx, nu), Qd=bf(x["Qd"], nx),
                Rd=bf(x["Rd"], nu), qx=bf(x["qx"], nx), qu=bf(x["qu"], nu), c=bf(x["c"], nx),
                dx0=x["dx0"].T.astype(np.float64))


@pytest.mark.parametrize("n", [2, 4, 7])
def test_linalg_small_matches_jax(n):
    jax, jnp = _jax()
    from nmpc_nav_control_tpu.qp import linalg_small as jls

    rng = np.random.default_rng(n)
    G = rng.normal(size=(5, n, n))
    M = G @ np.swapaxes(G, -1, -2) + n * np.eye(n)
    rhs_v, rhs_m = rng.normal(size=(5, n)), rng.normal(size=(5, n, 3))
    L = linalg_small.cholesky_small(torch.tensor(M))
    np.testing.assert_allclose(L.numpy(), np.asarray(jls.cholesky_small(jnp.asarray(M))), **F64)
    for rhs in (rhs_v, rhs_m):
        np.testing.assert_allclose(
            linalg_small.cho_solve_small(L, torch.tensor(rhs)).numpy(),
            np.asarray(jls.cho_solve_small(jnp.asarray(np.asarray(L)), jnp.asarray(rhs))), **F64)
        np.testing.assert_allclose(
            linalg_small.solve_spd_small(torch.tensor(M), torch.tensor(rhs), reg=1e-3).numpy(),
            np.asarray(jls.solve_spd_small(jnp.asarray(M), jnp.asarray(rhs), reg=1e-3)), **F64)
    # A non-positive pivot gives NaN, as in the JAX package.
    assert torch.isnan(linalg_small.cholesky_small(-torch.tensor(M))).any()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nx,nu", SHAPES)
def test_riccati_factor_solve_lqr_match_jax(nx, nu, dtype):
    jax, jnp = _jax()
    from nmpc_nav_control_tpu.qp import riccati as jr

    d = _lqr(nx, nu, 12, 16, seed=nx)
    jd = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in d.items()}
    td = {k: torch.tensor(v, dtype=getattr(torch, dtype)) for k, v in d.items()}
    j_args = (jd["A"], jd["B"], jd["Qd"], jd["Rd"])
    want_f = jax.jit(jax.vmap(jr.riccati_factor))(*j_args)
    want_s = jax.jit(jax.vmap(jr.riccati_solve))(want_f, jd["A"], jd["B"], jd["qx"], jd["qu"],
                                                 jd["c"], jd["dx0"])
    want_l = jax.jit(jax.vmap(lambda *a: jr.lqr_solve(*a, reg=1e-6)))(
        *j_args, jd["qx"], jd["qu"], jd["c"], jd["dx0"])

    def tol(name):
        return F64 if dtype == "float64" else F32[name]

    t_args = (td["A"], td["B"], td["Qd"], td["Rd"])
    for factor in (riccati.riccati_factor, _factor_routed):
        got_f = factor(*t_args)
        for name in ("Ps", "Ks", "Ls"):
            np.testing.assert_allclose(getattr(got_f, name).numpy(),
                                       np.asarray(getattr(want_f, name)),
                                       err_msg=f"{factor.__name__} {name}", **tol(name))
    for solve in (riccati.riccati_solve, _solve_routed):
        got_s = solve(got_f, td["A"], td["B"], td["qx"], td["qu"], td["c"], td["dx0"])
        for name, g, w in zip(("dxs", "dus"), got_s, want_s):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=f"{solve.__name__} {name}", **tol(name))
    got_l = riccati.lqr_solve(*t_args, td["qx"], td["qu"], td["c"], td["dx0"], reg=1e-6)
    for name, g, w in zip(("dxs", "dus"), got_l, want_l):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"lqr {name}", **tol(name))


def _bm_torch(x):
    return {k: torch.from_numpy(v) for k, v in x.items()}


@pytest.mark.parametrize("nx,nu", SHAPES)
def test_plain_kernels_match_pallas(nx, nu, monkeypatch):
    """Each plain version against the Pallas kernel it replaces, run by the
    Pallas interpreter; the solve halves take the Pallas factors."""
    jax, jnp = _jax()
    from nmpc_nav_control_tpu.ops.pallas_riccati import (
        riccati_factor_batched,
        riccati_solve_batched,
    )

    monkeypatch.setenv("NMPC_TPU_PALLAS_INTERPRET", "1")
    N, B = 4, 1024
    x = random_riccati_inputs(nx, nu, N, B, seed=3)
    d = _lqr(nx, nu, N, B, seed=3)
    jd = {k: jnp.asarray(v, jnp.float32) for k, v in d.items()}
    Ps, Ks, Ls = jax.jit(riccati_factor_batched)(jd["A"], jd["B"], jd["Qd"], jd["Rd"])
    dxs, dus = jax.jit(riccati_solve_batched)(Ps, Ks, Ls, jd["A"], jd["B"], jd["qx"],
                                              jd["qu"], jd["c"], jd["dx0"])

    def bm(v):
        v = np.asarray(v)
        return torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(v.reshape(B, v.shape[1], -1), 0, -1)))

    t = _bm_torch(x)
    f = rf.riccati_factor_fused(t["A"], t["Bm"], t["Qd"], t["Rd"])
    np.testing.assert_allclose(f.Ps[0].numpy(), bm(Ps)[0].numpy(), err_msg="Ps row 0", **F32["Ps"])
    np.testing.assert_allclose(f.Ps.numpy(), bm(Ps).numpy(), err_msg="Ps", **F32["Ps"])
    np.testing.assert_allclose(f.Ks.numpy(), bm(Ks).numpy(), err_msg="Ks", **F32["Ks"])
    np.testing.assert_allclose(rf.unpack_L(f.Ls, nu).numpy(), bm(Ls).numpy(), err_msg="Ls",
                               **F32["Ls"])

    jPs, jKs, jLs = bm(Ps), bm(Ks), rf.pack_L(bm(Ls), nu)
    kff = rf.riccati_solve_bwd_fused(t["A"], t["Bm"], jKs, jLs, jPs, t["qx"], t["qu"], t["c"])
    got_x, got_u = rf.riccati_solve_fwd_fused(t["A"], t["Bm"], jKs, kff, t["c"], t["dx0"])
    np.testing.assert_allclose(got_x.numpy(), bm(dxs).numpy(), err_msg="dxs", **F32["dxs"])
    np.testing.assert_allclose(got_u.numpy(), bm(dus).numpy(), err_msg="dus", **F32["dus"])


def _assert_same_nonfinite(got, want, name):
    """NaN, +Inf and -Inf in the same places of [rows, e, B] arrays; finite
    values within the f32 bound of the output ``name``, its rtol taken of the
    largest finite entry of the same row and lane: at a stage whose P holds a
    barrier-sized entry (Qd ~ 1e3), a small off-diagonal entry of L is
    rounded by the two f32 versions in opposite directions, past the
    entrywise bound."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64).reshape(np.shape(got))
    for what, f in (("NaN", np.isnan), ("+Inf", np.isposinf), ("-Inf", np.isneginf)):
        np.testing.assert_array_equal(f(got), f(want), err_msg=f"{name}: {what} placement")
    ok = np.isfinite(want)
    scale = np.abs(np.where(ok, want, 0.0)).max(axis=1, keepdims=True)
    tol = F32[name]["atol"] + F32[name]["rtol"] * scale
    bad = ok & ~(np.abs(np.where(ok, got - want, 0.0)) <= tol)
    assert not bad.any(), f"{name}: {np.argwhere(bad)[:5].tolist()} out of tolerance"


def _check_fault_semantics(Ps, Ls, kff):
    """What the faulty lanes of ``add_riccati_faults`` must show in any
    correct version ([rows, e, B] numpy): the negative pivot poisons its
    stage's last L entry and every factor before it, the NaN in c its
    stage's kff and every one before, the Inf in qx[k+1] kff from stage k."""
    k = riccati_fault_stage(kff.shape[0])
    lane = NEG_RD_LANE
    assert np.isnan(Ps[:k + 1, :, lane]).all() and np.isfinite(Ps[k + 1:, :, lane]).all()
    assert np.isnan(Ls[k, -1, lane]) and np.isfinite(Ls[k, :-1, lane]).all()
    assert np.isnan(Ls[:k, :, lane]).all() and np.isfinite(Ls[k + 1:, :, lane]).all()
    assert np.isnan(kff[:k + 1, :, NAN_C_LANE]).all()
    assert np.isfinite(kff[k + 1:, :, NAN_C_LANE]).all()
    assert not np.isfinite(kff[k, :, INF_QX_LANE]).all()
    assert np.isfinite(kff[k + 1:, :, INF_QX_LANE]).all()
    clean = np.ones(kff.shape[-1], bool)
    clean[[NEG_RD_LANE, NAN_C_LANE, INF_QX_LANE]] = False
    assert np.isfinite(Ps[..., clean]).all() and np.isfinite(kff[..., clean]).all()


@pytest.mark.parametrize("nx,nu", SHAPES)
def test_nonfinite_lanes_match_pallas(nx, nu, monkeypatch):
    """A lane with a non-positive Quu pivot, one with a NaN in c and one with
    an Inf in qx (``add_riccati_faults``) through the plain versions and the
    Pallas kernels (interpret mode), N=6, B=1024: NaN and Inf land in the
    same places of Ps, Ks, Ls, dxs and dus, and the finite values agree."""
    jax, jnp = _jax()
    from nmpc_nav_control_tpu.ops.pallas_riccati import (
        riccati_factor_batched,
        riccati_solve_batched,
    )

    monkeypatch.setenv("NMPC_TPU_PALLAS_INTERPRET", "1")
    N, B = 6, 1024
    x = add_riccati_faults(random_riccati_inputs(nx, nu, N, B, seed=4))

    def jx(v, *entry):
        return jnp.asarray(np.moveaxis(v, -1, 0).reshape(B, v.shape[0], *entry))

    def bm(v):
        v = np.asarray(v)
        return torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(v.reshape(B, v.shape[1], -1), 0, -1)))

    A, Bj = jx(x["A"], nx, nx), jx(x["Bm"], nx, nu)
    Ps, Ks, Ls = jax.jit(riccati_factor_batched)(A, Bj, jx(x["Qd"], nx), jx(x["Rd"], nu))
    dxs, dus = jax.jit(riccati_solve_batched)(Ps, Ks, Ls, A, Bj, jx(x["qx"], nx),
                                              jx(x["qu"], nu), jx(x["c"], nx),
                                              jnp.asarray(x["dx0"].T))
    t = _bm_torch(x)
    f = rf.riccati_factor_fused(t["A"], t["Bm"], t["Qd"], t["Rd"])
    _assert_same_nonfinite(f.Ps, bm(Ps), "Ps")
    _assert_same_nonfinite(f.Ks, bm(Ks), "Ks")
    _assert_same_nonfinite(rf.unpack_L(f.Ls, nu), bm(Ls), "Ls")

    jPs, jKs, jLs = bm(Ps), bm(Ks), rf.pack_L(bm(Ls), nu)
    kff = rf.riccati_solve_bwd_fused(t["A"], t["Bm"], jKs, jLs, jPs, t["qx"], t["qu"], t["c"])
    got_x, got_u = rf.riccati_solve_fwd_fused(t["A"], t["Bm"], jKs, kff, t["c"], t["dx0"])
    _assert_same_nonfinite(got_x, bm(dxs), "dxs")
    _assert_same_nonfinite(got_u, bm(dus), "dus")
    _check_fault_semantics(f.Ps.numpy(), f.Ls.numpy(), kff.numpy())


def test_wrappers_route_by_device():
    """CPU tensors take the plain version; mixed devices never silently
    fall back, and a shape without a CUDA kernel is named."""
    t = _bm_torch(random_riccati_inputs(7, 2, 3, 5, seed=1))
    with pytest.raises(ValueError):
        rf.riccati_factor_fused(t["A"].to("meta"), t["Bm"], t["Qd"], t["Rd"])
    with pytest.raises(NotImplementedError, match="nx=5, nu=1"):
        rf._config(5, 1)
    assert rf._config(11, 4) == "11x4"
    f = rf.riccati_factor_fused(t["A"], t["Bm"], t["Qd"], t["Rd"])
    assert f.Ps.shape == (4, 49, 5) and f.Ks.shape == (3, 14, 5) and f.Ls.shape == (3, 3, 5)


# --------------------------------------------------------------------------- #
# CUDA kernels vs their plain versions (on the card only)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", list(rf.OPS))
@pytest.mark.parametrize("nx,nu,lanes,dtype", [(7, 2, 1, torch.float32),
                                               (11, 4, 5, torch.float32),
                                               (7, 2, 5, torch.float64)])
def test_riccati_ops_on_the_cpu(name, nx, nu, lanes, dtype):
    """Each kernel as a ``torch.library`` op (``nmpc_tpu::<kernel>``) on the
    CPU: ``opcheck``, and its outputs equal to the plain version's bit for
    bit."""
    x = {k: torch.from_numpy(v).to(dtype) for k, v in
         random_riccati_inputs(nx, nu, 6, lanes, seed=lanes).items()}
    A, Bm = x["A"], x["Bm"]
    f = rf.factor_plain(A, Bm, x["Qd"], x["Rd"], reg=1e-8)
    kff = rf.solve_bwd_plain(A, Bm, f.Ks, f.Ls, f.Ps, x["qx"], x["qu"], x["c"])
    ins, f0, want = {
        "riccati_factor": ([A, Bm, x["Qd"], x["Rd"]], 1e-8, list(f)),
        "riccati_solve_bwd": ([A, Bm, f.Ks, f.Ls, f.Ps, x["qx"], x["qu"], x["c"]], 0.0, [kff]),
        "riccati_solve_fwd": ([A, Bm, f.Ks, kff, x["c"], x["dx0"]], 0.0,
                              list(rf.solve_fwd_plain(A, Bm, f.Ks, kff, x["c"], x["dx0"]))),
    }[name]
    op = getattr(torch.ops.nmpc_tpu, name).default
    torch.library.opcheck(op, ("", ins, f0, 0.0))
    got = op("", ins, f0, 0.0)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape and g.is_contiguous()
        assert torch.equal(g, w)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("horizon", [1, 13, 40])
@pytest.mark.parametrize("lanes", [1, 17, 1000, 2048])
@pytest.mark.parametrize("nx,nu", SHAPES)
def test_cuda_riccati_kernels_match_plain(cuda_device, nx, nu, lanes, horizon):
    """Each kernel against its plain version on the card, with the faulty
    lanes of ``add_riccati_faults`` where B holds them (NaN and Inf in the
    same places); 13 and 1 stages end the kernels' chunks early."""
    x = add_riccati_faults(random_riccati_inputs(nx, nu, horizon, lanes, seed=lanes))
    t = {k: v.to(cuda_device) for k, v in _bm_torch(x).items()}
    ref = rf.factor_plain(t["A"], t["Bm"], t["Qd"], t["Rd"])
    got = rf.riccati_factor_fused(t["A"], t["Bm"], t["Qd"], t["Rd"])
    torch.cuda.synchronize()
    for name in ("Ps", "Ks", "Ls"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name), msg=name,
                                   equal_nan=True, **F32[name])
    args = (t["A"], t["Bm"], ref.Ks, ref.Ls, ref.Ps, t["qx"], t["qu"], t["c"])
    kff = rf.solve_bwd_plain(*args)
    torch.testing.assert_close(rf.riccati_solve_bwd_fused(*args), kff, equal_nan=True,
                               **F32["kff"])
    args = (t["A"], t["Bm"], ref.Ks, kff, t["c"], t["dx0"])
    for name, g, r in zip(("dxs", "dus"), rf.riccati_solve_fwd_fused(*args),
                          rf.solve_fwd_plain(*args)):
        torch.testing.assert_close(g, r, msg=name, equal_nan=True, **F32[name])
