"""The kernel models' bytes and flops are those of ``chip_smoke.py`` at the
shapes the cells use, and their shapes those of the program."""
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
        assert kern.moved_bytes(d, N, lanes) == smoke._moved_bytes(name, args, plain(), m.nx,
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
    assert K.which(kernels, "void at::native::elementwise_kernel<128, 4>(P)") is None
