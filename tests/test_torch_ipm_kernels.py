"""The five IPM sweeps of the torch port against the JAX Pallas kernels.

Each plain torch sweep (``nmpc_nav_control_tpu_torch/ops/ipm_fused.py``,
the version the wrappers take for CPU tensors) is held against the Pallas
kernel it replaces (``nmpc_nav_control_tpu/ops/pallas_ipm.py``) run by the
Pallas interpreter on the CPU, on the same f32 inputs, at B=1024 and N=6,
for the diff model's A/B pattern and for the dense 7x2 pattern.  The sweeps
are chained as in one IPM iteration; each kernel's inputs downstream of the
first are the JAX kernels' outputs, so every comparison isolates one kernel.
Tolerance rtol 1e-4 / atol 1e-5: same algorithm and conventions, so only the
f32 summation order differs.

Each sweep is also held as a ``torch.library`` op (``nmpc_tpu::<kernel>``)
on the CPU: ``opcheck``, its outputs equal to the plain version's bit for
bit, and one node in an exported program.

The ``gpu`` tests hold each CUDA kernel against its plain version on the
card and skip where there is none.  JAX is imported only by the fixture that
needs it, so the ``gpu`` tests also run where JAX is not installed (with
``--noconftest``, since ``tests/conftest.py`` imports JAX).
"""
import numpy as np
import pytest
import torch

from nmpc_nav_control_tpu_torch.models import diff
from nmpc_nav_control_tpu_torch.ocp.sparsity import detect_jacobian_sparsity
from nmpc_nav_control_tpu_torch.ops import _build
from nmpc_nav_control_tpu_torch.ops import ipm_fused as tp
from nmpc_nav_control_tpu_torch.ops._build import header_config
from torch_sweep_inputs import random_sweep_inputs

torch.set_num_threads(1)

N, B = 6, 1024
NX, NU = 7, 2
IDXBX, IDXBU = (5, 6), (0, 1)
TAU, REG, D_CAP = 0.995, 1e-8, 1e10
RTOL, ATOL = 1e-4, 1e-5
DIFF_SP = detect_jacobian_sparsity(diff.f, 0.025, NX, NU, torch.tensor([0.27, 0.1]))
PATTERNS = {"diff": DIFF_SP, "dense": tp.dense_sparsity(NX, NU)}


def _tiles(x):
    """Port [rows, e, B] -> JAX tile layout [B/1024, rows, e, 8, 128]."""
    rows, e = x.shape[:2]
    return x.reshape(rows, e, -1, 8, 128).transpose(2, 0, 1, 3, 4)


def _untile(t):
    """JAX tiles [G, rows, e, 8, 128] -> port [rows, e, B]."""
    t = np.asarray(t)
    return t.transpose(1, 2, 0, 3, 4).reshape(t.shape[1], t.shape[2], -1)


def _t(x):
    if isinstance(x, tuple):
        return tuple(torch.from_numpy(np.ascontiguousarray(v)) for v in x)
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(port, ref, name):
    np.testing.assert_allclose(port.numpy(), ref, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.fixture(scope="module", params=list(PATTERNS))
def chain(request):
    """Inputs and the JAX Pallas kernels' outputs of one IPM iteration."""
    jnp = pytest.importorskip("jax.numpy")
    from nmpc_nav_control_tpu.ops import pallas_ipm as jp

    asp, bsp = PATTERNS[request.param]
    cfg = tp.SweepConfig(NX, NU, IDXBX, IDXBU, asp, bsp)
    x = random_sweep_inputs(NX, NU, 2, 2, asp, bsp, N, B, seed=11)

    def T(v):
        return jnp.asarray(_tiles(v))

    At, Bt = T(x["A"]), T(x["Bm"])
    Qdt, Rdt, qxt, qut = T(x["Qd"]), T(x["Rd"]), T(x["qx"]), T(x["qu"])
    dxt, dut = T(x["dx"]), T(x["du"])
    st, lt = [T(v) for v in x["s"]], [T(v) for v in x["lam"]]
    r_init_t = T(x["r_init"][None])
    sm_t = T(x["sigma_mu"].reshape(1, 1, -1))
    sp = dict(asp=asp, bsp=bsp)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NMPC_TPU_PALLAS_INTERPRET", "1")
        bwd = jp.ipm_bwd_fused(At, Bt, Qdt, Rdt, qxt, qut, T(x["c"]), dxt, dut,
                               *st, *lt, *[T(v) for v in x["bnd"]],
                               IDXBX, IDXBU, NX, NU, reg=REG, d_cap=D_CAP, **sp)
        Kt, Lt, Pct, rdynt, kfft = bwd[:5]
        rpt = bwd[5:9]
        aff = jp.ipm_fwd_affine(At, Bt, Kt, kfft, rdynt, r_init_t, *st, *lt,
                                *rpt, IDXBX, IDXBU, TAU, NX, NU, **sp)
        corr_t = [aff[4] * c for c in aff[:4]]     # scaled by a_aff, as each iteration does
        kffc = jp.ipm_bwd_corr(At, Bt, Kt, Lt, Pct, Qdt, qxt, dxt, Rdt, qut, dut,
                               *st, *lt, *rpt, *corr_t, sm_t, IDXBX, IDXBU,
                               NX, NU, **sp)
        fc = jp.ipm_fwd_corr(At, Bt, Kt, kffc, rdynt, r_init_t, *st, *lt, *rpt,
                             *corr_t, sm_t, IDXBX, IDXBU, TAU, NX, NU, **sp)
        kkt = jp.ipm_kkt_fused(At, Bt, Qdt, qxt, dxt, Rdt, qut, dut, *lt, *st,
                               IDXBX, IDXBU, NX, NU, **sp)
    u = _untile
    return dict(
        cfg=cfg, x=x,
        bwd=dict(K=u(Kt), L=u(Lt), Pc=u(Pct), rdyn=u(rdynt), kff=u(kfft),
                 rp=tuple(u(v) for v in rpt), musum=u(bwd[9]).reshape(-1)),
        aff=dict(corr=tuple(u(v) for v in aff[:4]), alpha=u(aff[4]).reshape(-1),
                 c12=u(aff[5])[0]),
        corr_scaled=tuple(u(v) for v in corr_t),
        kffc=u(kffc),
        fc=dict(ddx=u(fc[0]), ddu=u(fc[1]), ddx_N=u(fc[2])[0],
                ds=tuple(u(v) for v in fc[3:7]), dl=tuple(u(v) for v in fc[7:11]),
                alpha=u(fc[11]).reshape(-1), finite=u(fc[12]).reshape(-1)),
        kkt=dict(kkt=u(kkt[0]).reshape(-1), musum=u(kkt[1]).reshape(-1)),
    )


def _compare(out, ref):
    for name, want in ref.items():
        got = getattr(out, name)
        if isinstance(want, tuple):
            for g, (a, b) in zip(("xl", "xu", "ul", "uu"), zip(got, want)):
                _close(a, b, f"{name}_{g}")
        else:
            _close(got, want, name)


def _bwd_args(x):
    return (_t(x["A"]), _t(x["Bm"]), _t(x["Qd"]), _t(x["Rd"]), _t(x["qx"]),
            _t(x["qu"]), _t(x["c"]), _t(x["dx"]), _t(x["du"]), _t(x["s"]),
            _t(x["lam"]), _t(x["bnd"]))


def test_bwd_fused_matches_pallas(chain):
    out = tp.ipm_bwd_fused(chain["cfg"], *_bwd_args(chain["x"]), reg=REG, d_cap=D_CAP)
    _compare(out, chain["bwd"])


def test_fwd_affine_matches_pallas(chain):
    x, b = chain["x"], chain["bwd"]
    out = tp.ipm_fwd_affine(chain["cfg"], _t(x["A"]), _t(x["Bm"]), _t(b["K"]),
                            _t(b["kff"]), _t(b["rdyn"]), _t(x["r_init"]),
                            _t(x["s"]), _t(x["lam"]), _t(b["rp"]), tau=TAU)
    _compare(out, chain["aff"])


def test_bwd_corr_matches_pallas(chain):
    x, b = chain["x"], chain["bwd"]
    out = tp.ipm_bwd_corr(chain["cfg"], _t(x["A"]), _t(x["Bm"]), _t(b["K"]),
                          _t(b["L"]), _t(b["Pc"]), _t(x["Qd"]), _t(x["qx"]),
                          _t(x["dx"]), _t(x["Rd"]), _t(x["qu"]), _t(x["du"]),
                          _t(x["s"]), _t(x["lam"]), _t(b["rp"]),
                          _t(chain["corr_scaled"]), _t(x["sigma_mu"]))
    _close(out, chain["kffc"], "kff_c")


def test_fwd_corr_matches_pallas(chain):
    x, b = chain["x"], chain["bwd"]
    out = tp.ipm_fwd_corr(chain["cfg"], _t(x["A"]), _t(x["Bm"]), _t(b["K"]),
                          _t(chain["kffc"]), _t(b["rdyn"]), _t(x["r_init"]),
                          _t(x["s"]), _t(x["lam"]), _t(b["rp"]),
                          _t(chain["corr_scaled"]), _t(x["sigma_mu"]), tau=TAU)
    _compare(out, chain["fc"])
    assert chain["fc"]["finite"].min() == 1.0


def test_kkt_fused_matches_pallas(chain):
    x = chain["x"]
    out = tp.ipm_kkt_fused(chain["cfg"], _t(x["A"]), _t(x["Bm"]), _t(x["Qd"]),
                           _t(x["qx"]), _t(x["dx"]), _t(x["Rd"]), _t(x["qu"]),
                           _t(x["du"]), _t(x["lam"]), _t(x["s"]))
    _compare(out, chain["kkt"])


# Lanes of the non-finite input set: an Inf in the dynamics residual at the
# last stage, a NaN slack whose delta is negative, a slack at the 1e-9 floor
# (lambda/s = 2e10, past the 1e10 barrier cap), a NaN feed-forward.
INF_LANE, NAN_S_LANE, FLOOR_LANE, NAN_KFF_LANE = 3, 70, 200, 500


def _nonfinite_set(cfg, N, lanes, seed=3):
    """One f32 input set for ``bwd_fused``, ``fwd_affine`` and ``fwd_corr``
    with the four faulty lanes above.  The forward sweeps' K, kff, rdyn, rp
    and corr come from the plain sweeps on the clean inputs; then the faults
    go in.  Returns a dict of numpy arrays (bound groups as tuples)."""
    x = random_sweep_inputs(cfg.nx, cfg.nu, cfg.nbx, cfg.nbu, cfg.asp, cfg.bsp, N, lanes,
                            seed=seed)
    bwd = tp.bwd_fused_plain(cfg, *_bwd_args(x), reg=REG, d_cap=D_CAP)
    fwd = (_t(x["A"]), _t(x["Bm"]), bwd.K, bwd.kff, bwd.rdyn, _t(x["r_init"]),
           _t(x["s"]), _t(x["lam"]), bwd.rp)
    aff = tp.fwd_affine_plain(cfg, *fwd, tau=TAU)
    x = {k: tuple(np.array(t) for t in v) if isinstance(v, tuple) else np.array(v)
         for k, v in x.items()}
    x.update(K=bwd.K.numpy(), L=bwd.L.numpy(), Pc=bwd.Pc.numpy(),
             kff=bwd.kff.numpy().copy(), rdyn=bwd.rdyn.numpy().copy(),
             rp=tuple(r.numpy().copy() for r in bwd.rp),
             corr=tuple((aff.alpha * c).numpy() for c in aff.corr))
    ix = cfg.idxbx[0]
    x["c"][N - 1, ix, INF_LANE] = np.inf          # dz = Inf at the last stage
    x["rdyn"][N - 1, ix, INF_LANE] = np.inf
    x["s"][0][2, 1, NAN_S_LANE] = np.nan          # x lower, stage 2, entry 1 ...
    x["rp"][0][2, 1, NAN_S_LANE] = -10.0          # ... with a negative delta
    x["s"][2][1, 0, FLOOR_LANE] = 1e-9
    x["lam"][2][1, 0, FLOOR_LANE] = 20.0
    x["kff"][min(3, N - 1), 0, NAN_KFF_LANE] = np.nan
    return x


def _nonfinite_args(x, conv):
    """(bwd_fused args, fwd_affine args, fwd_corr args) with ``conv`` applied
    to every array."""
    g = {k: tuple(conv(t) for t in v) if isinstance(v, tuple) else conv(v) for k, v in x.items()}
    bwd = (g["A"], g["Bm"], g["Qd"], g["Rd"], g["qx"], g["qu"], g["c"], g["dx"], g["du"],
           g["s"], g["lam"], g["bnd"])
    aff = (g["A"], g["Bm"], g["K"], g["kff"], g["rdyn"], g["r_init"], g["s"], g["lam"], g["rp"])
    return bwd, aff, aff + (g["corr"], g["sigma_mu"])


def _assert_same_nonfinite(got, want, name):
    """NaN, +Inf and -Inf in the same places; finite values within rtol
    1e-4 / atol 1e-5, but rtol 1e-3 on the floor lane, whose deltas are
    lambda/s = 2e10 times rollout values that f32 rounds at ~6e-8."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64).reshape(np.shape(got))
    for what, f in (("NaN", np.isnan), ("+Inf", np.isposinf), ("-Inf", np.isneginf)):
        np.testing.assert_array_equal(f(got), f(want), err_msg=f"{name}: {what} placement")
    rtol = np.full(got.shape[-1], RTOL)
    if got.shape[-1] > FLOOR_LANE:
        rtol[FLOOR_LANE] = 1e-3
    ok = np.isfinite(want)
    tol = ATOL + rtol * np.abs(np.where(ok, want, 0.0))
    bad = ok & ~(np.abs(np.where(ok, got, 0.0) - np.where(ok, want, 0.0)) <= tol)
    assert not bad.any(), f"{name}: {np.argwhere(bad)[:5].tolist()} out of tolerance"


def _check_nonfinite_semantics(bwd, aff, fc):
    """What the faulty lanes must show, in any correct version."""
    assert np.isnan(bwd["musum"][NAN_S_LANE]) and np.isfinite(bwd["musum"][INF_LANE])
    for out in (aff, fc):
        assert np.isnan(out["alpha"][NAN_S_LANE])                    # NaN ratio reached alpha
        assert np.isfinite(out["alpha"][NAN_KFF_LANE])               # NaN deltas: sentinel
        assert out["alpha"][INF_LANE] == 0.0                         # dl = -Inf: ratio 0
    assert fc["finite"][NAN_KFF_LANE] == 0 and fc["finite"][INF_LANE] == 0
    assert fc["finite"][FLOOR_LANE] == 1 and 0 < aff["alpha"][FLOOR_LANE] < 1e-8


def test_nonfinite_lanes_match_pallas():
    """NaN and Inf reach the same outputs, and alpha, finite, c12 and musum
    agree per lane, in the plain sweeps and the Pallas kernels (interpret
    mode), diff pattern, N=6, B=1024."""
    jnp = pytest.importorskip("jax.numpy")
    from nmpc_nav_control_tpu.ops import pallas_ipm as jp

    asp, bsp = DIFF_SP
    cfg = tp.SweepConfig(NX, NU, IDXBX, IDXBU, asp, bsp)
    x = _nonfinite_set(cfg, N, B)
    bwd_a, aff_a, fc_a = _nonfinite_args(x, lambda v: jnp.asarray(_tiles(v if v.ndim == 3 else
                                                                          v.reshape(1, -1, v.shape[-1]))))
    sp = dict(asp=asp, bsp=bsp)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NMPC_TPU_PALLAS_INTERPRET", "1")
        jb = jp.ipm_bwd_fused(*bwd_a[:9], *bwd_a[9], *bwd_a[10], *bwd_a[11], IDXBX, IDXBU,
                              NX, NU, reg=REG, d_cap=D_CAP, **sp)
        ja = jp.ipm_fwd_affine(*aff_a[:6], *aff_a[6], *aff_a[7], *aff_a[8], IDXBX, IDXBU,
                               TAU, NX, NU, **sp)
        jc = jp.ipm_fwd_corr(*fc_a[:6], *fc_a[6], *fc_a[7], *fc_a[8], *fc_a[9], fc_a[10],
                             IDXBX, IDXBU, TAU, NX, NU, **sp)
    bwd_t, aff_t, fc_t = _nonfinite_args(x, _t)
    pb = tp.bwd_fused_plain(cfg, *bwd_t, reg=REG, d_cap=D_CAP)
    pa = tp.fwd_affine_plain(cfg, *aff_t, tau=TAU)
    pc = tp.fwd_corr_plain(cfg, *fc_t, tau=TAU)
    flat = [(pb, jb, "bwd"), (pa, ja, "aff"), (pc, jc, "corr")]
    for port, ref, tag in flat:
        leaves = [t for v in port for t in (v if isinstance(v, tuple) else (v,))]
        assert len(leaves) == len(ref)
        for i, (g, w) in enumerate(zip(leaves, ref)):
            _assert_same_nonfinite(g.numpy(), _untile(w), f"{tag} output {i}")
    _check_nonfinite_semantics(
        dict(musum=pb.musum.numpy()), dict(alpha=pa.alpha.numpy()),
        dict(alpha=pc.alpha.numpy(), finite=pc.finite.numpy()))


# Lanes the backward vector sweeps add to the set: a NaN corrector product at
# stage FAULT_STAGE, a NaN multiplier there, an Inf in qx at its consumption
# row (stage FAULT_STAGE).
NAN_CORR_LANE, NAN_LAM_LANE, INF_QX_LANE, FAULT_STAGE = 130, 260, 390, 3


def _vector_set(cfg, N, lanes):
    """The non-finite set with the three lanes above added, for
    ``bwd_corr`` and ``kkt`` (the slack-floor lane stays as it is)."""
    x = _nonfinite_set(cfg, N, lanes)
    x["corr"][0][FAULT_STAGE, 1, NAN_CORR_LANE] = np.nan
    x["lam"][1][FAULT_STAGE, 0, NAN_LAM_LANE] = np.nan
    x["qx"][FAULT_STAGE + 1, 2, INF_QX_LANE] = np.inf
    return x


def _vector_args(x, conv):
    """(bwd_corr args, kkt args) with ``conv`` applied to every array."""
    g = {k: tuple(conv(t) for t in v) if isinstance(v, tuple) else conv(v) for k, v in x.items()}
    bc = (g["A"], g["Bm"], g["K"], g["L"], g["Pc"], g["Qd"], g["qx"], g["dx"], g["Rd"], g["qu"],
          g["du"], g["s"], g["lam"], g["rp"], g["corr"], g["sigma_mu"])
    kk = (g["A"], g["Bm"], g["Qd"], g["qx"], g["dx"], g["Rd"], g["qu"], g["du"], g["lam"], g["s"])
    return bc, kk


def _check_vector_semantics(kffc, kkt, musum):
    """What the faulty lanes must show in any correct version: a NaN reaches
    its stage's kff_c and every earlier one, and kkt."""
    k = FAULT_STAGE
    for lane in (NAN_CORR_LANE, NAN_LAM_LANE, NAN_S_LANE):
        first = k if lane != NAN_S_LANE else 2
        assert np.isnan(kffc[:first + 1, :, lane]).all()
        assert np.isfinite(kffc[first + 1:, :, lane]).all()
    assert np.isnan(kkt[NAN_LAM_LANE]) and np.isnan(musum[NAN_LAM_LANE])
    assert not np.isfinite(kkt[INF_QX_LANE]) and np.isfinite(musum[INF_QX_LANE])
    assert np.isfinite(kkt[NAN_CORR_LANE]) and np.isfinite(kkt[FLOOR_LANE])
    assert np.isfinite(kffc[:, :, FLOOR_LANE]).all()


def test_nonfinite_vector_sweeps_match_pallas():
    """The set above through ``bwd_corr`` and ``kkt``: NaN and Inf reach the
    same outputs, and the finite values agree, in the plain sweeps and the
    Pallas kernels (interpret mode), diff pattern, N=6, B=1024."""
    jnp = pytest.importorskip("jax.numpy")
    from nmpc_nav_control_tpu.ops import pallas_ipm as jp

    asp, bsp = DIFF_SP
    cfg = tp.SweepConfig(NX, NU, IDXBX, IDXBU, asp, bsp)
    x = _vector_set(cfg, N, B)
    bc_a, kk_a = _vector_args(x, lambda v: jnp.asarray(_tiles(v if v.ndim == 3 else
                                                                v.reshape(1, -1, v.shape[-1]))))
    sp = dict(asp=asp, bsp=bsp)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NMPC_TPU_PALLAS_INTERPRET", "1")
        jc = jp.ipm_bwd_corr(*bc_a[:11], *bc_a[11], *bc_a[12], *bc_a[13], *bc_a[14], bc_a[15],
                             IDXBX, IDXBU, NX, NU, **sp)
        jk = jp.ipm_kkt_fused(*kk_a[:8], *kk_a[8], *kk_a[9], IDXBX, IDXBU, NX, NU, **sp)
    bc_t, kk_t = _vector_args(x, _t)
    pc = tp.bwd_corr_plain(cfg, *bc_t)
    pk = tp.kkt_fused_plain(cfg, *kk_t)
    _assert_same_nonfinite(pc.numpy(), _untile(jc), "kff_c")
    _assert_same_nonfinite(pk.kkt.numpy(), _untile(jk[0]), "kkt")
    _assert_same_nonfinite(pk.musum.numpy(), _untile(jk[1]), "musum")
    _check_vector_semantics(pc.numpy(), pk.kkt.numpy(), pk.musum.numpy())


def test_config_diff_header_matches_detected_pattern():
    """The compile-time pattern tables of the diff kernels equal the pattern
    the port detects (a false zero would silently drop dynamics terms) for
    several parameter sets and sample times."""
    for p, dt in (([0.27, 0.1], 0.025), ([0.5, 0.3], 0.0125), ([0.27, 0.1], 0.1)):
        asp, bsp = detect_jacobian_sparsity(diff.f, dt, NX, NU, torch.tensor(p))
        assert header_config("config_diff.cuh") == (NX, NU, IDXBX, IDXBU, asp, bsp)
    assert header_config("config_dense72.cuh") == (
        NX, NU, IDXBX, IDXBU, *tp.dense_sparsity(NX, NU))


def test_wrappers_route_by_device():
    """CPU tensors take the plain version; a float64 CUDA request or mixed
    devices never silently fall back."""
    asp, bsp = DIFF_SP
    cfg = tp.SweepConfig(NX, NU, IDXBX, IDXBU, asp, bsp)
    assert cfg.cuda_config == "diff"
    odd = tp.SweepConfig(NX, NU, IDXBX, (0,), asp, bsp)
    with pytest.raises(NotImplementedError):
        odd.cuda_config
    x = random_sweep_inputs(NX, NU, 2, 2, asp, bsp, 3, 5, seed=1)
    args = list(_bwd_args(x))
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError):
        tp.ipm_bwd_fused(cfg, *args, reg=REG, d_cap=D_CAP)


# --------------------------------------------------------------------------- #
# The sweeps as torch.library ops (nmpc_tpu::<kernel>), on the CPU
# --------------------------------------------------------------------------- #


def _op_calls(cfg, x):
    """Per op: (flat operands, f0, f1, the plain version's flat outputs)."""
    A, Bm, Qd, Rd, qx, qu, c, dx, du, s, lam, bnd = _bwd_args(x)
    r_init, sigma_mu = _t(x["r_init"]), _t(x["sigma_mu"])
    bwd = tp.bwd_fused_plain(cfg, A, Bm, Qd, Rd, qx, qu, c, dx, du, s, lam, bnd, reg=REG,
                             d_cap=D_CAP)
    corr = tp.fwd_affine_plain(cfg, A, Bm, bwd.K, bwd.kff, bwd.rdyn, r_init, s, lam, bwd.rp,
                               tau=TAU).corr
    fwd = (A, Bm, bwd.K, bwd.kff, bwd.rdyn, r_init, *s, *lam, *bwd.rp)
    return {
        "ipm_bwd_fused": ([A, Bm, Qd, Rd, qx, qu, c, dx, du, *s, *lam, *bnd], REG, D_CAP, bwd),
        "ipm_fwd_affine": (list(fwd), TAU, 0.0, tp.fwd_affine_plain(
            cfg, A, Bm, bwd.K, bwd.kff, bwd.rdyn, r_init, s, lam, bwd.rp, tau=TAU)),
        "ipm_bwd_corr": ([A, Bm, bwd.K, bwd.L, bwd.Pc, Qd, qx, dx, Rd, qu, du, *s, *lam,
                          *bwd.rp, *corr, sigma_mu], 0.0, 0.0, tp.bwd_corr_plain(
            cfg, A, Bm, bwd.K, bwd.L, bwd.Pc, Qd, qx, dx, Rd, qu, du, s, lam, bwd.rp, corr,
            sigma_mu)),
        "ipm_fwd_corr": ([*fwd, *corr, sigma_mu], TAU, 0.0, tp.fwd_corr_plain(
            cfg, A, Bm, bwd.K, bwd.kff, bwd.rdyn, r_init, s, lam, bwd.rp, corr, sigma_mu,
            tau=TAU)),
        "ipm_kkt_fused": ([A, Bm, Qd, qx, dx, Rd, qu, du, *lam, *s], 0.0, 0.0,
                          tp.kkt_fused_plain(cfg, A, Bm, Qd, qx, dx, Rd, qu, du, lam, s)),
    }


def check_op(op, args, plain_out):
    """``torch.library.opcheck`` (schema, fake against real, the aliasing
    rules), and the op's CPU outputs equal to the plain version's bit for
    bit, in value, shape, dtype and strides."""
    torch.library.opcheck(op, args)
    got = op(*args)
    want = tp._flat(plain_out)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.is_contiguous()
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", list(tp.OPS))
@pytest.mark.parametrize("pattern,lanes,dtype", [("diff", 1, torch.float32),
                                                 ("dense", 5, torch.float32),
                                                 ("diff", 5, torch.float64)])
def test_sweep_ops_on_the_cpu(name, pattern, lanes, dtype):
    asp, bsp = PATTERNS[pattern]
    cfg = tp.SweepConfig(NX, NU, IDXBX, IDXBU, asp, bsp)
    assert tp.SweepConfig.from_key(cfg.key) == cfg
    x = random_sweep_inputs(NX, NU, 2, 2, asp, bsp, N, lanes, seed=lanes)
    npd = np.float64 if dtype == torch.float64 else np.float32
    x = {k: tuple(a.astype(npd) for a in v) if isinstance(v, tuple) else v.astype(npd)
         for k, v in x.items()}
    ins, f0, f1, plain_out = _op_calls(cfg, x)[name]
    check_op(getattr(torch.ops.nmpc_tpu, name).default, (cfg.key, ins, f0, f1), plain_out)


def test_a_traced_sweep_is_one_op_node():
    """Under ``torch.export`` a wrapper records its op, whose CPU
    implementation is the plain version; eager CPU calls take the plain
    version itself (``_build.use_op``)."""
    asp, bsp = DIFF_SP
    cfg = tp.SweepConfig(NX, NU, IDXBX, IDXBU, asp, bsp)
    x = random_sweep_inputs(NX, NU, 2, 2, asp, bsp, N, 3, seed=3)
    A, Bm, Qd, Rd, qx, qu, c, dx, du, s, lam, _ = _bwd_args(x)
    assert not _build.use_op([A], "kernel") and not _build.use_op([A], "plain")

    class Kkt(torch.nn.Module):
        def forward(self, A, Bm, Qd, qx, dx, Rd, qu, du, *ls):
            return tuple(tp.ipm_kkt_fused(cfg, A, Bm, Qd, qx, dx, Rd, qu, du, ls[:4], ls[4:],
                                          impl="plain"))

    args = (A, Bm, Qd, qx, dx, Rd, qu, du, *lam, *s)
    program = torch.export.export(Kkt(), args, strict=False)
    calls = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert calls.count(torch.ops.nmpc_tpu.ipm_kkt_fused.default) == 1
    assert all("aten" not in str(t) for t in calls), calls
    want = tp.kkt_fused_plain(cfg, A, Bm, Qd, qx, dx, Rd, qu, du, lam, s)
    assert all(torch.equal(g, w) for g, w in zip(program.module()(*args), want))


# --------------------------------------------------------------------------- #
# CUDA kernels vs their plain versions (on the card only)
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _gpu_cfg(pattern):
    """Sweep shape of a compiled specialisation: diff, dense (7x2) or omni4
    (nx=11, nu=4, bounds (7, 8, 9, 10) / (0, 1, 2, 3))."""
    if pattern == "omni4":
        return tp.SweepConfig(*header_config("config_omni4.cuh"))
    return tp.SweepConfig(NX, NU, IDXBX, IDXBU, *PATTERNS[pattern])


@pytest.mark.gpu
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("pattern", [*PATTERNS, "omni4"])
@pytest.mark.parametrize("horizon", [1, 13, 40, 80])
@pytest.mark.parametrize("lanes", [1, 17, 1000, 2048])
def test_cuda_sweeps_match_plain(cuda_device, lanes, horizon, pattern, shifted):
    """Every sweep kernel against its plain version on the card; 17 lanes are
    ragged and break 16-byte alignment of the batch rows, ``shifted`` inputs
    start 4 bytes past a 16-byte boundary, and 13 stages are no multiple of
    any sweep's chunk of stages."""
    cfg = _gpu_cfg(pattern)
    x = random_sweep_inputs(cfg.nx, cfg.nu, cfg.nbx, cfg.nbu, cfg.asp, cfg.bsp, horizon,
                            lanes, seed=5)

    def dev(v):
        if isinstance(v, tuple):
            return tuple(dev(t) for t in v)
        t = _t(v).to(cuda_device)
        if shifted:
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
            t = buf[1:].view(t.shape).copy_(t)
        return t

    a = {k: dev(v) for k, v in x.items()}
    bwd_args = (a["A"], a["Bm"], a["Qd"], a["Rd"], a["qx"], a["qu"], a["c"],
                a["dx"], a["du"], a["s"], a["lam"], a["bnd"])
    ref = tp.bwd_fused_plain(cfg, *bwd_args, reg=REG, d_cap=D_CAP)
    got = tp.ipm_bwd_fused(cfg, *bwd_args, reg=REG, d_cap=D_CAP)
    torch.cuda.synchronize()
    _compare_cuda(got, ref)
    fwd = (a["A"], a["Bm"], ref.K, ref.kff, ref.rdyn, a["r_init"], a["s"], a["lam"], ref.rp)
    aff = tp.fwd_affine_plain(cfg, *fwd, tau=TAU)
    _compare_cuda(tp.ipm_fwd_affine(cfg, *fwd, tau=TAU), aff)
    corr = tuple(aff.alpha * c for c in aff.corr)
    bc = (a["A"], a["Bm"], ref.K, ref.L, ref.Pc, a["Qd"], a["qx"], a["dx"], a["Rd"],
          a["qu"], a["du"], a["s"], a["lam"], ref.rp, corr, a["sigma_mu"])
    kffc = tp.bwd_corr_plain(cfg, *bc)
    torch.testing.assert_close(tp.ipm_bwd_corr(cfg, *bc), kffc, rtol=RTOL, atol=ATOL)
    fc = fwd[:3] + (kffc,) + fwd[4:] + (corr, a["sigma_mu"])
    _compare_cuda(tp.ipm_fwd_corr(cfg, *fc, tau=TAU), tp.fwd_corr_plain(cfg, *fc, tau=TAU))
    kk = (a["A"], a["Bm"], a["Qd"], a["qx"], a["dx"], a["Rd"], a["qu"], a["du"],
          a["lam"], a["s"])
    _compare_cuda(tp.ipm_kkt_fused(cfg, *kk), tp.kkt_fused_plain(cfg, *kk))


def _compare_cuda(got, ref):
    for name, g, r in zip(ref._fields, got, ref):
        for gi, ri in zip(*((g, r) if isinstance(r, tuple) else ((g,), (r,)))):
            torch.testing.assert_close(gi, ri, rtol=RTOL, atol=ATOL, msg=name)


@pytest.mark.gpu
def test_cuda_nonfinite_lanes_match_plain(cuda_device):
    """The non-finite input sets of ``test_nonfinite_lanes_match_pallas``
    and ``test_nonfinite_vector_sweeps_match_pallas`` through the kernels:
    NaN and Inf in the same places as the plain versions, alpha, finite,
    c12, kkt and musum per lane equal."""
    cfg = tp.SweepConfig(NX, NU, IDXBX, IDXBU, *DIFF_SP)
    x = _nonfinite_set(cfg, N, B)
    args = _nonfinite_args(x, lambda v: _t(v).to(cuda_device))
    outs = []
    for kern, plain, a, kw in ((tp.ipm_bwd_fused, tp.bwd_fused_plain, args[0],
                                dict(reg=REG, d_cap=D_CAP)),
                               (tp.ipm_fwd_affine, tp.fwd_affine_plain, args[1], dict(tau=TAU)),
                               (tp.ipm_fwd_corr, tp.fwd_corr_plain, args[2], dict(tau=TAU))):
        got, ref = kern(cfg, *a, **kw), plain(cfg, *a, **kw)
        torch.cuda.synchronize()
        for name, g, r in zip(ref._fields, got, ref):
            for i, (gi, ri) in enumerate(zip(*((g, r) if isinstance(r, tuple) else ((g,), (r,))))):
                _assert_same_nonfinite(gi.cpu().numpy(), ri.cpu().numpy(),
                                       f"{kern.__name__} {name}[{i}]")
        outs.append(got)
    _check_nonfinite_semantics(
        dict(musum=outs[0].musum.cpu().numpy()), dict(alpha=outs[1].alpha.cpu().numpy()),
        dict(alpha=outs[2].alpha.cpu().numpy(), finite=outs[2].finite.cpu().numpy()))
    bc, kk = _vector_args(_vector_set(cfg, N, B), lambda v: _t(v).to(cuda_device))
    kffc, ref = tp.ipm_bwd_corr(cfg, *bc), tp.bwd_corr_plain(cfg, *bc)
    got, want = tp.ipm_kkt_fused(cfg, *kk), tp.kkt_fused_plain(cfg, *kk)
    torch.cuda.synchronize()
    _assert_same_nonfinite(kffc.cpu().numpy(), ref.cpu().numpy(), "ipm_bwd_corr kff_c")
    for name, g, r in zip(want._fields, got, want):
        _assert_same_nonfinite(g.cpu().numpy(), r.cpu().numpy(), f"ipm_kkt_fused {name}")
    _check_vector_semantics(kffc.cpu().numpy(), got.kkt.cpu().numpy(), got.musum.cpu().numpy())
