"""Controller sweep: many scenarios through the controller tick alone.

``control/graph.py::GraphedController`` (``controller_step`` captured in a
CUDA graph) at the mix's lane count, closed loop on the benchmark's plants:
ticks back to back, each lane's pose reference held at its goal
(``n_valid`` 1), and every lane's goal redrawn 0.5-2 m from where it stands
on a staggered period, so the lanes never all rest.  No state machine, no
paths.  On the CPU (tests) the tick runs eagerly.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import adapter, loop, plant, traffic
from benchmark.reference.controller import controller_tick
from benchmark.reference.models import robot_from_yaml


class _Eager:
    """``GraphedController``'s ``step`` over an eager ``controller_step``."""

    def __init__(self, spec, data, batch):
        from nmpc_nav_control_tpu_torch.control import controllers

        self.ctl, self.spec, self.data = controllers, spec, data
        self.state = controllers.controller_init(spec, batch, data.p.dtype, data.p.device)

    def step(self, pose, vel, traj, n_valid, steer=None):
        self.state, cmd, stats = self.ctl.controller_step(self.spec, self.data, self.state, pose,
                                                          vel, traj, n_valid, steer)
        return self.state, cmd, stats


class Driver:
    per_tick_label = "tick.controller"
    trace_ticks = 20          # ticks the traced run profiles

    def __init__(self, cell, seed: int, device):
        from nmpc_nav_control_tpu_torch.control import GraphedController, make_controller
        from nmpc_nav_control_tpu_torch.runtime.config import from_dict

        mix = cell.traffic
        self.cell, self.seed, self.device, self.mix = cell, seed, torch.device(device), mix
        self.robot = robot_from_yaml(cell.config)
        conf = from_dict(cell.config)
        spec, data = make_controller(conf.steering_geometry, conf.dt, conf.horizon,
                                     dtype=cell.dtype, device=self.device,
                                     **conf.controller_kwargs())
        B, N = mix["lanes"], self.robot.N
        self.B = B
        cls = GraphedController if self.device.type == "cuda" else _Eager
        self.ctl = cls(spec, data, B)
        g = traffic.rng(seed, 1)
        start = np.stack([g.uniform(-mix["spread_m"], mix["spread_m"], B),
                          g.uniform(-mix["spread_m"], mix["spread_m"], B),
                          g.uniform(-np.pi, np.pi, B)], -1)
        fp = dict(dtype=cell.dtype, device=self.device)
        self.plants = torch.zeros(B, plant.size(self.robot), **fp)
        self.plants[:, :3] = torch.tensor(start, **fp)
        self.offsets = torch.tensor(traffic.goal_offsets(g, (mix["redraws"], B), mix), **fp)
        self.goal = traffic.relative_to(self.plants[:, :3], self.offsets[0])
        self.traj = torch.zeros(B, N + 1, 3, **fp)
        self.n_valid = torch.ones(B, dtype=torch.long, device=self.device)
        cohorts = mix["cohorts"]
        self.every = mix["redraw_ticks"] // cohorts
        self.cohort = [torch.arange(B, device=self.device) % cohorts == c for c in range(cohorts)]
        self.failed = torch.zeros((), dtype=torch.long, device=self.device)
        self.g, self.plan, self.samples = 0, {}, []

    # One tick: redraws, measurements, the program's tick, the plants.
    def tick(self, k: int) -> None:
        g = self.g
        if g % self.every == 0:
            q = g // self.every
            c = q % len(self.cohort)
            off = self.offsets[(q // len(self.cohort) + 1) % self.offsets.shape[0]]
            new = traffic.relative_to(self.plants[:, :3], off)
            self.goal = torch.where(self.cohort[c][:, None], new, self.goal)
        pose, vel, steer = plant.measure(self.robot, self.plants)
        self.traj[:, 0] = self.goal
        lanes = self.plan.get(k)
        if lanes is not None:
            pre = adapter.rti_state(self.ctl.state, lanes)
            inputs = dict(pose=pose[lanes], vel=vel[lanes], steer=steer[lanes],
                          traj=self.traj[lanes], n_valid=self.n_valid[lanes])
        with record_function(self.per_tick_label):
            state, cmd, stats = self.ctl.step(pose, vel, self.traj, self.n_valid, steer)
        cmd = torch.stack([cmd.v, cmd.vn, cmd.w], -1)
        self.failed += (~stats.ok | ~torch.isfinite(stats.kkt_res)).sum()
        if lanes is not None:
            self.samples.append(dict(pre=pre, inputs=inputs, out=dict(
                cmd=cmd[lanes].clone(), us=state.us[lanes].clone(), ok=stats.ok[lanes].clone())))
        with record_function("plant"):
            self.plants = plant.step(self.robot, self.plants,
                                     plant.references(self.robot, cmd, steer))
        self.g += 1

    def warm(self) -> None:
        for k in range(self.mix["warm_ticks"]):
            self.tick(-1 - k)
        loop.sync(self.device)
        t = loop.clock()
        for k in range(self.mix["warm_ticks"]):
            self.tick(-1 - k)
        loop.sync(self.device)
        self.tick_s = (loop.clock() - t) / self.mix["warm_ticks"]

    def window(self, seconds: float, mark=None) -> dict:
        expected = int(0.8 * seconds / max(self.tick_s, 1e-6))
        g, check = traffic.rng(self.seed, 2), self.cell.check
        self.plan = {k: torch.as_tensor(traffic.lanes(g, self.B, check["sample_lanes"]),
                                        device=self.device)
                     for k in traffic.ticks(g, expected, check["sample_ticks"])}
        self.failed.zero_()
        ticks, t0, t1, done = loop.closed_loop(self.tick, seconds, self.device, mark=mark)
        self.plan = {}
        return dict(metrics={"scenario_ticks_per_s": ticks * self.B / (t1 - t0)},
                    attempted=ticks * self.B, failed=int(self.failed),
                    notes=dict(ticks=ticks, window_s=t1 - t0,
                               rate_by_third=loop.thirds(done, t0, t1, self.B),
                               sampled_ticks=len(self.samples)))

    def trace(self, ticks: int) -> dict:
        for k in range(ticks):
            self.tick(-1 - k)
        return dict(ticks=ticks, groups={self.per_tick_label: (self.robot, self.B)})

    def release(self) -> None:
        self.samples = adapter.to_host(adapter.concat(self.samples)) if self.samples else None
        del self.ctl, self.plants, self.offsets
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def outputs(self, prec, device) -> list:
        """[(reference's outputs in ``prec``, program's)] on the sampled
        ticks, as batches on ``device``."""
        if self.samples is None:
            return []
        s = adapter.to_device(self.samples, device)
        pre, x = s["pre"], s["inputs"]
        ref = controller_tick(self.robot, prec, pre["xs"], pre["us"], pre["carry"], x["pose"],
                              x["vel"], x["steer"], x["traj"], x["n_valid"])
        M = ref["ok"].shape[0]
        flat = dict(publish=torch.ones(M, dtype=torch.bool, device=device),
                    status_code=torch.zeros(M, dtype=torch.long, device=device))
        out = s["out"]
        prog = dict(flat, cmd=out["cmd"], us=out["us"], solve_ok=out["ok"])
        return [(dict(flat, cmd=ref["cmd"], us=ref["us"], solve_ok=ref["ok"]), prog)]

