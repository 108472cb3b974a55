"""Phase breakdown of the full navigation tick (``node_tick``) on the card.

Port of ``tools/node_probe.py``.  The fleet metric
(``bench.py::_measure_fleet``, ``nmpc_nav_control_tpu_torch/bench.py``)
drives ``control.state_machine.node_tick``: projection + windowing + the
resampler + safety/termination + the RTI solve.  This probe times, by the
chained-slope method of ``phase_probe``, the marginal per-batch cost of:

  1. ``node_tick``: the whole tick, replays of a ``GraphedNavigator`` on
     the fleet's 50 m line;
  2. ``controller_step``: the solve the headline metric measures, replays
     of a ``GraphedController``;
  3. ``discretizer_march``: the reference's resampling march
     (``get_next_n_poses``), only with ``NODE_PROBE_MARCH=1`` as in the JAX
     probe (some 820 masked steps at N=40: a long graph);
  4. ``discretizer_fast``: the chord-table resampler the tick runs;
  5. ``projection``: the nearest-point projection;
  6. ``windowing``: ``pop_completed`` + ``top_up``.

Phases 3-6 are each one step captured in a CUDA graph (``phase_probe.
chain_step``), chained through a per-lane carry as the JAX probe chains
them.  Each line carries ``per_batch_ms``, ``per_robot_us`` and, on the
card, the profiler's ``device_ms`` and ``kernel_ms`` of one step.

Usage: python -m nmpc_nav_control_tpu_torch.tools.node_probe [geometry] [N] [B]
       [--device cuda|cpu]
"""
from __future__ import annotations

import os

import numpy as np
import torch

from nmpc_nav_control_tpu_torch.tools.phase_probe import Probe, chain_step


def main(argv=None) -> int:
    from nmpc_nav_control_tpu_torch.bench import _build, _fleet_state
    from nmpc_nav_control_tpu_torch.control import (
        GraphedController,
        GraphedNavigator,
        controller_init,
        controller_step,
    )
    from nmpc_nav_control_tpu_torch.control import state_machine as sm
    from nmpc_nav_control_tpu_torch.paths.discretizer import (
        get_next_n_poses,
        get_next_n_poses_fast,
    )
    from nmpc_nav_control_tpu_torch.paths.projection import project_to_path
    from nmpc_nav_control_tpu_torch.paths.windowing import (
        active_path_list,
        pop_completed,
        top_up,
    )

    probe = Probe("python -m nmpc_nav_control_tpu_torch.tools.node_probe", "per_robot_us",
                  argv)
    N, B, dev = probe.N, probe.B, probe.device
    f32 = torch.float32
    spec, data = _build(probe.geometry, N, device=dev)
    cfg = sm.NavConfig()
    dt = spec.dims.dt
    states, meas = _fleet_state(spec, cfg, B, dev)

    # ---------------- 1. full node_tick ----------------
    if dev.type == "cuda":
        nav = GraphedNavigator(spec, data, cfg, B)
        nav.load_state(states)
        nav.load_measurements(meas)
        nav.capture()
        probe.measure("node_tick", lambda c: (nav._replay(), nav.state)[1], nav.state)
    else:
        probe.measure("node_tick", lambda s: sm.node_tick(spec, data, cfg, s, meas)[0], states)

    # ---------------- 2. controller_step only ----------------
    rng = np.random.default_rng(0)
    poses = torch.tensor(rng.normal(size=(B, 3)) * 0.1, dtype=f32, device=dev)
    vels = torch.tensor(rng.normal(size=(B, 3)) * 0.1, dtype=f32, device=dev)
    trajs = torch.zeros(B, N + 1, 3, device=dev)
    trajs[:, 0, 0] = 1.0
    n_valids = torch.full((B,), N + 1, dtype=torch.int32, device=dev)
    if dev.type == "cuda":
        graphed = GraphedController(spec, data, B)
        graphed.load_inputs(poses, vels, trajs, n_valids)
        graphed.capture()
        probe.measure("controller_step", lambda c: (graphed._replay(), graphed.state)[1],
                      graphed.state)
    else:
        probe.measure("controller_step",
                      lambda s: controller_step(spec, data, s, poses, vels, trajs, n_valids)[0],
                      controller_init(spec, B, f32, dev))

    # ---------------- shared path-batch data ----------------
    windows = states.window
    plists = active_path_list(windows, cfg.path_capacity)
    u0s = (torch.tensor(rng.uniform(0.0, 0.5, size=(B,)), dtype=f32, device=dev),)

    # ---------------- 3. discretizer only (march + fast) ----------------
    def disc_step(fn):
        def step(us):
            poses = fn(plists, us, dt, N + 1)
            return (us + 1e-7 * torch.tanh(poses.sum((1, 2))),)
        return step

    if os.environ.get("NODE_PROBE_MARCH", "0") == "1":
        probe.measure("discretizer_march",
                      chain_step(data, disc_step(get_next_n_poses), u0s), u0s)
    probe.measure("discretizer_fast", chain_step(data, disc_step(get_next_n_poses_fast), u0s),
                  u0s)

    # ---------------- 4. projection only ----------------
    def proj_step(rxy):
        res = project_to_path(plists, rxy[:, 0], rxy[:, 1])
        return (rxy + 1e-7 * torch.tanh(torch.stack([res.x, res.y], -1)),)

    rxy = (torch.tensor(rng.uniform(0.0, 2.0, size=(B, 2)), dtype=f32, device=dev),)
    probe.measure("projection", chain_step(data, proj_step, rxy), rxy)

    # ---------------- 5. windowing only ----------------
    def win_step(us):
        w2, u2 = pop_completed(windows, us)
        w3 = top_up(w2, u2, cfg.max_active_path_length)
        return (u2 + 1e-7 * torch.tanh(w3.segs.cx.sum((1, 2)) + w3.active_count.to(f32)),)

    probe.measure("windowing", chain_step(data, win_step, u0s), u0s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
