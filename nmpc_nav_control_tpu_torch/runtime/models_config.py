"""Offline solver-preparation config: the codegen-toolchain analog.

Port of ``nmpc_nav_control_tpu/runtime/models_config.py``.  The reference
generates per-model C solvers offline from a models YAML
(``scripts/generate_acados_libs.py:24-51`` reading
``config/nmpc_nav_control_acados_models.yaml``, with per-geometry parameter
loaders in ``scripts/{diff,omni4,tric}/common.py``).  Here the
"generation" step is:

  1. parse the same ``{geom}_params`` schema (tf_ini/freq, robot constants,
     Q/R/QN diagonals, deg->rad for the tric steering bounds);
  2. build the controller (spec, data) pair;
  3. on the card, build the CUDA kernels (``ops/_build.py``: the ``.so``
     analog, cached in ``build/kernels/`` across processes) and capture one
     B=1 controller tick in a CUDA graph (``control.GraphedController``);
     on the CPU, run the tick eagerly.  A CUDA graph cannot be serialized,
     so nothing but the built kernels persists from one process to the
     next: a node captures its own graph at its first tick;
  4. run a smoke tick and fail on non-finite output (the reference's
     post-generation ``solve()`` check, ``scripts/diff/generate_c_code.py:79-83``).
"""
from __future__ import annotations

import math
import time
from typing import Any, Mapping, Sequence

import torch

__all__ = [
    "GEOMETRIES",
    "load_models_config",
    "controller_from_models_params",
    "prepare_solvers",
]

GEOMETRIES = ("omni4", "diff", "tric")

_REQUIRED = {
    "diff": ("tf_ini", "freq", "dist_b", "tau_v", "v_max", "a_max",
             "Q_diag", "R_diag", "QN_diag"),
    "omni4": ("tf_ini", "freq", "l1_plus_l2", "tau_v", "v_max", "a_max",
              "Q_diag", "R_diag", "QN_diag"),
    "tric": ("tf_ini", "freq", "dist_d", "tau_v", "tau_a", "v_max", "a_max",
             "alpha_min", "alpha_max", "dalpha_max",
             "Q_diag", "R_diag", "QN_diag"),
}


def load_models_config(path: str) -> dict:
    """Parse a models YAML into ``{geometry: params}``.

    Accepts the reference schema verbatim: top-level ``omni4_params`` /
    ``diff_params`` / ``tric_params`` sections, each validated against the
    keys its ``scripts/<geom>/common.py`` loader reads.
    """
    import yaml

    with open(path) as fh:
        raw = yaml.safe_load(fh) or {}
    out = {}
    for geom in GEOMETRIES:
        section = raw.get(f"{geom}_params")
        if section is None:
            continue
        missing = [k for k in _REQUIRED[geom] if k not in section]
        if missing:
            raise ValueError(
                f"{geom}_params is missing: {', '.join(missing)}"
            )
        out[geom] = dict(section)
    if not out:
        raise ValueError(
            f"no *_params sections found in {path} "
            f"(expected one of: {', '.join(f'{g}_params' for g in GEOMETRIES)})"
        )
    return out


def controller_from_models_params(
    geometry: str,
    params: Mapping[str, Any],
    *,
    dtype=torch.float32,
    ipm_iters: int = 8,
    tric_bug_compat: bool = False,
    device="cuda",
):
    """Build (spec, data) from one ``{geom}_params`` section, on ``device``.

    Mirrors ``scripts/<geom>/common.py``: N = ceil(tf_ini * freq), tric
    steering bounds converted deg->rad (``scripts/tric/common.py:17-19``),
    and — unlike the runtime ctor path — the terminal weight comes from
    QN_diag, matching the offline-generated solvers.
    """
    from nmpc_nav_control_tpu_torch.control import make_controller

    dt = 1.0 / float(params["freq"])
    N = int(math.ceil(float(params["tf_ini"]) / dt))
    common = dict(
        tau_v=float(params["tau_v"]),
        v_max=float(params["v_max"]),
        a_max=float(params["a_max"]),
        q_diag=[float(v) for v in params["Q_diag"]],
        r_diag=[float(v) for v in params["R_diag"]],
        qn_diag=[float(v) for v in params["QN_diag"]],
        ipm_iters=ipm_iters,
        dtype=dtype,
        device=device,
    )
    deg = math.pi / 180.0
    if geometry == "diff":
        return make_controller(
            "diff", dt, N, dist_b=float(params["dist_b"]), **common)
    if geometry == "omni4":
        return make_controller(
            "omni4", dt, N, l1_plus_l2=float(params["l1_plus_l2"]), **common)
    if geometry == "tric":
        return make_controller(
            "tric", dt, N,
            dist_d=float(params["dist_d"]),
            tau_a=float(params["tau_a"]),
            alpha_min=float(params["alpha_min"]) * deg,
            alpha_max=float(params["alpha_max"]) * deg,
            dalpha_max=float(params["dalpha_max"]) * deg,
            tric_bug_compat=tric_bug_compat,
            **common,
        )
    raise ValueError(f"unknown steering geometry: {geometry!r}")


def prepare_solvers(
    path: str,
    geometries: Sequence[str] | None = None,
    *,
    dtype=torch.float32,
    device="cuda",
    log=print,
) -> dict:
    """Build, capture and smoke-test every solver in a models YAML.

    The ``generate_acados_libs.py`` analog: for each ``{geom}_params``
    section, build the controller and run one smoke tick at B=1, raising on
    a non-finite command or ``kkt_res``.  On a CUDA device the kernels are
    built first (or found in ``build/kernels/``) and the tick is captured
    in a CUDA graph and replayed (a third log line gives the capture's
    seconds and launches); with ``device="cpu"`` it runs eagerly.  Without
    a card and without ``device="cpu"`` it raises.  Returns
    ``{geometry: (spec, data)}`` for direct reuse.
    """
    from nmpc_nav_control_tpu_torch.control import (
        GraphedController,
        controller_init,
        controller_step,
    )
    from nmpc_nav_control_tpu_torch.ops import _build

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("prepare_solvers: no CUDA device (pass device='cpu' to "
                               "prepare on the CPU)")
        _build.build()
    sections = load_models_config(path)
    built = {}
    for geom, params in sections.items():
        if geometries is not None and geom not in geometries:
            continue
        spec, data = controller_from_models_params(geom, params, dtype=dtype, device=device)
        dt = spec.dims.dt
        N = spec.dims.N
        log(f"[{geom}] building solver: N={N} dt={dt:.4f}s "
            f"nx={spec.dims.model.nx} nu={spec.dims.model.nu}")
        zeros = torch.zeros(1, 3, dtype=dtype, device=device)
        traj = torch.zeros(1, N + 1, 3, dtype=dtype, device=device)
        traj[0, 0, 0] = 0.5
        inputs = (zeros, zeros.clone(), traj, torch.ones(1, dtype=torch.int32, device=device))
        if device.type == "cuda":
            graphed = GraphedController(spec, data, 1)
            graphed.load_inputs(*inputs)
            t0 = time.perf_counter()
            launches = graphed.capture()
            torch.cuda.synchronize(device)
            log(f"[{geom}] captured one tick in a CUDA graph: "
                f"{time.perf_counter() - t0:.3f}s, launches {launches}")
            _, cmd, stats = graphed.step(*inputs)
        else:
            _, cmd, stats = controller_step(spec, data, controller_init(spec, 1, dtype, device),
                                            *inputs)
        vals = [float(cmd.v[0]), float(cmd.vn[0]), float(cmd.w[0]), float(stats.kkt_res[0])]
        kkt = vals[3]
        if not all(math.isfinite(v) for v in vals):
            raise RuntimeError(
                f"[{geom}] smoke solve produced non-finite output: "
                f"cmd={vals[:3]} kkt={kkt}"
            )
        log(f"[{geom}] smoke solve OK: cmd=({vals[0]:+.3f},{vals[1]:+.3f},"
            f"{vals[2]:+.3f}) kkt={kkt:.2e}")
        built[geom] = (spec, data)
    return built
