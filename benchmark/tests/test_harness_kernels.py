"""The kernel models' bytes and flops are those of ``chip_smoke.py`` at the
shapes the cells use, and their shapes those of the program; the count
reckons a launch at the cell's precision, float32 as it always did."""
from __future__ import annotations

import importlib.util
import json
import sys

import pytest
import torch

from benchmark import kernels as K
from benchmark.reference.models import robot_from_yaml
from benchmark.tests.conftest import HERE, ROOT


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    yield _module("chip_smoke_for_bench_tests", ROOT / "chip_smoke.py")
    sys.modules.pop("chip_smoke_for_bench_tests", None)


def _robots():
    fleet = json.loads((HERE / "configs" / "fleet_mixed_n80.json").read_text())
    return [robot_from_yaml(g) for g in fleet["groups"].values()]


@pytest.mark.parametrize("geometry", ["diff", "omni4", "tric"])
def test_dims_are_the_programs(geometry):
    from nmpc_nav_control_tpu_torch.control import make_controller
    from nmpc_nav_control_tpu_torch.runtime.config import from_dict

    robot = next(r for r in _robots() if r.geometry == geometry)
    raw = json.loads((HERE / "configs" / "fleet_mixed_n80.json").read_text())["groups"][geometry]
    conf = from_dict(raw)
    spec, _ = make_controller(geometry, conf.dt, conf.horizon, device="cpu",
                              **conf.controller_kwargs())
    asp, bsp = spec.rti.spars
    d = K.dims(robot)
    m = spec.dims.model
    assert (d.nx, d.nu, d.nbx, d.nbu) == (m.nx, m.nu, len(m.idxbx), len(m.idxbu))
    assert (d.nnzA, d.nnzB) == (sum(map(sum, asp)), sum(map(sum, bsp)))
    assert robot.N == spec.dims.N == 80


@pytest.mark.parametrize("geometry", ["diff", "omni4"])
def test_bytes_and_flops_equal_chip_smokes(smoke, geometry):
    from nmpc_nav_control_tpu_torch.ops import ipm_fused as tp

    sys.path.insert(0, str(ROOT / "tests"))
    try:
        from torch_sweep_inputs import random_sweep_inputs
    finally:
        sys.path.remove(str(ROOT / "tests"))
    robot = next(r for r in _robots() if r.geometry == geometry)
    d = K.dims(robot)
    from nmpc_nav_control_tpu_torch.control import make_controller
    from nmpc_nav_control_tpu_torch.runtime.config import from_dict

    raw = json.loads((HERE / "configs" / "fleet_mixed_n80.json").read_text())["groups"][geometry]
    conf = from_dict(raw)
    spec, _ = make_controller(geometry, conf.dt, conf.horizon, device="cpu",
                              **conf.controller_kwargs())
    m = spec.dims.model
    cfg = tp.SweepConfig(m.nx, m.nu, m.idxbx, m.idxbu, *spec.rti.spars)
    N, lanes = smoke.N, 6
    x = random_sweep_inputs(m.nx, m.nu, d.nbx, d.nbu, cfg.asp, cfg.bsp, N, lanes)
    for name, (_, plain, args) in smoke._sweep_calls(torch, tp, cfg, x, "cpu").items():
        kern = K.load_all()[name]
        assert K.moved_bytes(kern, d, N, lanes) == smoke._moved_bytes(name, args, plain(), m.nx,
                                                                       lanes), name
        assert kern.flops(d, N, lanes) == smoke._flops(
            name, m.nx, m.nu, d.nnzA, d.nnzB, d.groups) * N * lanes, name


def test_patterns_match_the_kernel_names_the_profiler_shows():
    names = {"ipm_bwd_fused": "void (anonymous namespace)::bwd_fused_kernel<DiffConfig>(P)",
             "ipm_fwd_affine": "void (anonymous namespace)::fwd_kernel<Omni4Config, false>(P)",
             "ipm_bwd_corr": "void (anonymous namespace)::bwd_corr_kernel<DiffConfig>(P)",
             "ipm_fwd_corr": "void (anonymous namespace)::fwd_kernel<DiffConfig, true>(P)",
             "ipm_kkt_fused": "void (anonymous namespace)::kkt_kernel<DiffConfig>(P)"}
    kernels = K.load_all()
    for name, shown in names.items():
        assert K.which(kernels, shown) == name
        # the same sweep instantiated for another scalar type is the same kernel
        typed = shown.replace(">(P)", ", double>(P)")
        assert K.which(kernels, typed) == name, typed
        assert K.which(kernels, typed.replace("<", "<double, ", 1)) == name, typed
    assert K.which(kernels, "void at::native::elementwise_kernel<128, 4>(P)") is None


# The least time of one launch, in seconds, as the count gave it before it
# took a precision (every entry 4 bytes, flops at 67 TFLOP/s), at each
# geometry's dims and the (N, lanes) of the cells' groups; one value a kernel
# in ``sorted(K.load_all())`` order.  Tric's dims are diff's.
FLOAT32_LEAST = {
    ("diff", 80, 1): [1.1272835820895522e-08, 1.2618507462686566e-08, 8.417910447761194e-09,
                      1.0814328358208955e-08, 7.262089552238806e-09],
    ("omni4", 80, 1): [2.2831044776119404e-08, 2.4945671641791046e-08, 1.7592835820895523e-08,
                       2.2095522388059702e-08, 1.3184477611940298e-08],
    ("diff", 80, 4096): [4.617353552238806e-05, 5.1685406567164176e-05, 3.447976119402985e-05,
                         4.429548895522388e-05, 2.974551880597015e-05],
    ("diff", 80, 2048): [2.308676776119403e-05, 2.5842703283582088e-05, 1.7239880597014926e-05,
                         2.214774447761194e-05, 1.4872759402985075e-05],
    ("omni4", 80, 1024): [2.337898985074627e-05, 2.554436776119403e-05, 1.8015063880597016e-05,
                          2.2625814925373135e-05, 1.3500905074626866e-05],
    ("tric", 80, 1024): [1.1543383880597015e-05, 1.2921351641791044e-05, 8.619940298507463e-06,
                         1.107387223880597e-05, 7.436379701492537e-06],
    ("diff", 40, 2048): [1.1544606567164179e-05, 1.2931133134328359e-05, 8.632167164179105e-06,
                         1.1094657910447761e-05, 7.438825074626865e-06],
    ("omni4", 40, 1024): [1.1690106268656716e-05, 1.277952e-05, 9.016090746268657e-06,
                          1.132819104477612e-05, 6.751675223880597e-06],
    ("tric", 40, 1024): [5.7723032835820894e-06, 6.4655665671641795e-06, 4.3160835820895526e-06,
                         5.5473289552238805e-06, 3.7194125373134327e-06],
}


def _cell_groups():
    """(geometry, N, lanes, Dims) of every group of every cell of BENCHMARK.json."""
    from benchmark import harness
    from benchmark.tests.conftest import CELLS

    out = set()
    for cell in CELLS:
        c = harness.load_cell(ROOT, cell)
        groups = c.config.get("groups", {"one": c.config})
        lanes = c.config.get("scenarios") or {"one": c.traffic.get("lanes", 1)}
        for name, raw in groups.items():
            robot = robot_from_yaml(raw)
            out.add((robot.geometry, robot.N, lanes[name], K.dims(robot)))
    return sorted(out, key=lambda g: g[:3])


def test_least_seconds_at_float32_is_the_count_before_precisions():
    groups = _cell_groups()
    assert {g[:3] for g in groups} <= set(FLOAT32_LEAST)
    kernels = K.load_all()
    for geometry, N, lanes, d in groups:
        got = [K.least_seconds(kernels[name], d, N, lanes) for name in sorted(kernels)]
        assert got == FLOAT32_LEAST[geometry, N, lanes], (geometry, N, lanes)
        assert got == [K.least_seconds(kernels[name], d, N, lanes, torch.float32)
                       for name in sorted(kernels)]


def test_float64_reckons_8_byte_entries_at_the_float64_rate():
    kernels = K.load_all()
    for geometry, N, lanes, d in _cell_groups():
        for name, kern in kernels.items():
            f32 = K.moved_bytes(kern, d, N, lanes)
            assert f32 == 4 * kern.entries(d, N, lanes)
            assert K.moved_bytes(kern, d, N, lanes, torch.float64) == 2 * f32
            assert K.least_seconds(kern, d, N, lanes, torch.float64) == max(
                2 * f32 / 3.35e12, kern.flops(d, N, lanes) / 34e12), (name, geometry)
