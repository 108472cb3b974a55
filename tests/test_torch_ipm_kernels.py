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
# CUDA kernels vs their plain versions (on the card only)
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", list(PATTERNS))
@pytest.mark.parametrize("lanes", [1, 1000, 2048])
def test_cuda_sweeps_match_plain(cuda_device, lanes, pattern):
    asp, bsp = PATTERNS[pattern]
    cfg = tp.SweepConfig(NX, NU, IDXBX, IDXBU, asp, bsp)
    x = random_sweep_inputs(NX, NU, 2, 2, asp, bsp, 40, lanes, seed=5)

    def dev(v):
        if isinstance(v, tuple):
            return tuple(dev(t) for t in v)
        return _t(v).to(cuda_device)

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
