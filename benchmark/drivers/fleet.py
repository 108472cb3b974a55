"""Fleet simulation: a mixed-geometry fleet moving through GoToPose and
FollowPath.

``parallel/fleet.py::Fleet`` with one group per geometry of the
configuration (each group's ``GraphedNavigator`` replays ``node_tick`` in a
CUDA graph), closed loop on the benchmark's plants: ticks back to back, the
groups in the configuration's order, each group's plants advanced by its
published commands (zero where none is published).  The first tick sends
every lane its first goal or path.  The first half of each group drives to
goals 0.5-1.95 m away, redrawn from where the robot stands on a staggered
period; the second half follows multi-segment paths sent from its pose, and
gets a new one on its period once it has left FollowPath.  The benchmark
keeps its own copy of each lane's last path and goal for the reference.
On the CPU (tests) the groups tick eagerly.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import adapter, loop, plant, traffic
from benchmark.reference.models import robot_from_yaml

PATH_ROUNDS = 2


def _where(mask, new, old):
    """Per-lane select over a NamedTuple of [B, ...] tensors (nested)."""
    if isinstance(new, tuple):
        return type(new)(*(_where(mask, a, b) for a, b in zip(new, old)))
    return torch.where(mask.reshape(-1, *[1] * (new.dim() - 1)), new, old)


class _Group:
    def __init__(self, name, raw, lanes, seed, stream, mix, device, dtype):
        from nmpc_nav_control_tpu_torch.control import make_controller
        from nmpc_nav_control_tpu_torch.parallel.fleet import FleetGroup
        from nmpc_nav_control_tpu_torch.runtime.config import from_dict

        self.name, self.robot, self.B = name, robot_from_yaml(raw), lanes
        conf = from_dict(raw)
        spec, data = make_controller(conf.steering_geometry, conf.dt, conf.horizon,
                                     dtype=dtype, device=device, **conf.controller_kwargs())
        self.group = FleetGroup(spec, data, conf.nav, lanes)
        fp = dict(dtype=dtype, device=device)
        g = traffic.rng(seed, stream)
        half = lanes // 2
        self.gtp = torch.arange(lanes, device=device) < half
        self.plants = torch.zeros(lanes, plant.size(self.robot), **fp)
        spread = mix["spread_m"]
        self.plants[:, 0] = torch.tensor(g.uniform(-spread, spread, lanes), **fp)
        self.plants[:, 1] = torch.tensor(g.uniform(-spread, spread, lanes), **fp)
        self.plants[:, 2] = torch.tensor(g.uniform(-3.14159, 3.14159, lanes), **fp)
        self.offsets = torch.tensor(traffic.goal_offsets(g, (mix["redraws"], lanes), mix), **fp)
        drawn = [traffic.paths(g, lanes, mix) for _ in range(PATH_ROUNDS)]
        self.paths = [{k: torch.tensor(d[k], **fp) for k in ("cx", "cy", "ch", "vel")}
                      | {"count": torch.tensor(d["count"], dtype=torch.int32, device=device)}
                      for d in drawn]
        self.failed = torch.zeros((), dtype=torch.long, device=device)
        # What the benchmark has sent each lane: the reference's path store and goal.
        cap, deg = self.paths[0]["cx"].shape[1:]
        self.own = {k: torch.zeros(lanes, cap, deg, **fp) for k in ("cx", "cy", "ch")} | dict(
            vel=torch.zeros(lanes, cap, **fp), goal=torch.zeros(lanes, 3, **fp),
            count=torch.zeros(lanes, dtype=torch.int32, device=device))

    def events(self, fleet, mask, rnd) -> dict:
        """New goals for the GoToPose lanes of ``mask``, new paths for its
        FollowPath lanes that are not following one; round ``rnd`` of the
        draws.  Returns what each lane was sent (``goal_set``, ``path``
        masks, the goals and paths)."""
        from nmpc_nav_control_tpu_torch.control import state_machine as sm
        from nmpc_nav_control_tpu_torch.paths import PathSegment
        from nmpc_nav_control_tpu_torch.paths.segment import seg_arc_length

        state = fleet.states[self.name]
        pose = self.plants[:, :3]
        goals = traffic.relative_to(pose, self.offsets[rnd % self.offsets.shape[0]])
        p = traffic.place(self.paths[rnd % PATH_ROUNDS], pose)
        segs = PathSegment(cx=p["cx"], cy=p["cy"], ch=p["ch"], velocity=p["vel"],
                           frame_id=(p["vel"] != 0).to(torch.int32),
                           length=seg_arc_length(p["cx"], p["cy"]))
        new_goal = sm.on_goal_pose(state, goals)
        new_path = sm.on_path_set(state, self.group.cfg, segs, p["count"], 1)
        to_goal = mask & self.gtp
        to_path = mask & ~self.gtp & (state.status != sm.FOLLOW_PATH)
        fleet.set_states(self.name, _where(to_goal, new_goal, _where(to_path, new_path, state)))
        sent = dict(goal_set=to_goal, path=to_path, goal=goals, cx=p["cx"], cy=p["cy"], ch=p["ch"],
                    vel=p["vel"], count=p["count"])
        self.own = loop.sent_after(self.own, sent)
        return sent

    def nothing_sent(self, lanes) -> dict:
        none = torch.zeros(lanes.shape[0], dtype=torch.bool, device=lanes.device)
        return {k: torch.zeros_like(v[lanes]) for k, v in self.own.items()} | dict(
            goal_set=none, path=none)

    def meas(self):
        from nmpc_nav_control_tpu_torch.control.state_machine import Measurements

        pose, vel, steer = plant.measure(self.robot, self.plants)
        ok = torch.ones(self.B, dtype=torch.bool, device=pose.device)
        return Measurements(pose.contiguous(), vel, steer, ok, ok, ok)


class Driver:
    trace_ticks = 4           # ticks the traced run profiles

    def __init__(self, cell, seed: int, device):
        from nmpc_nav_control_tpu_torch.parallel.fleet import Fleet

        mix = cell.traffic
        self.cell, self.seed, self.device, self.mix = cell, seed, torch.device(device), mix
        conf = cell.config
        self.groups = [_Group(name, conf["groups"][name], lanes, seed, 10 + i, mix, self.device,
                              cell.dtype)
                       for i, (name, lanes) in enumerate(conf["scenarios"].items())]
        self.B = sum(g.B for g in self.groups)
        self.fleet = Fleet({g.name: g.group for g in self.groups})
        cohorts = mix["cohorts"]
        self.every = mix["redraw_ticks"] // cohorts
        self.cohorts = cohorts
        every_lane = [torch.arange(g.B, device=self.device) % cohorts for g in self.groups]
        self.cohort = [[c == k for k in range(cohorts)] for c in every_lane]
        self.g, self.samples = 0, {g.name: [] for g in self.groups}
        # The first tick sends every lane its first goal or path: the
        # reference checks that start on lanes drawn from the seed.
        start = traffic.rng(seed, 3)
        self.plan = {-1: {g.name: torch.as_tensor(traffic.lanes(start, g.B, cell.check[
            "sample_lanes"]), device=self.device) for g in self.groups}}

    def tick(self, k: int) -> None:
        step = self.g
        event = step % self.every == 0
        if step == 0:               # the start: every lane, the first draws
            rnd = 0
        elif event:
            q = step // self.every
            c, rnd = q % self.cohorts, q // self.cohorts + 1
        lanes_of = self.plan.pop(k, None)
        for i, g in enumerate(self.groups):
            lanes = None if lanes_of is None else lanes_of[g.name]
            if lanes is not None:
                sample = dict(pre=adapter.node_state(self.fleet.states[g.name], lanes),
                              own={f: v[lanes].clone() for f, v in g.own.items()},
                              event=g.nothing_sent(lanes))
            if event:
                mask = (torch.ones(g.B, dtype=torch.bool, device=self.device) if step == 0
                        else self.cohort[i][c])
                with record_function("events"):
                    sent = g.events(self.fleet, mask, rnd)
                if lanes is not None:
                    sample["event"] = {f: v[lanes].clone() for f, v in sent.items()}
            meas = g.meas()
            if lanes is not None:
                sample["inputs"] = dict(pose=meas.pose[lanes].clone(), vel=meas.vel[lanes].clone(),
                                        steer=meas.steer_angle[lanes].clone())
            with record_function(f"tick.{g.name}"):
                out = self.fleet.tick({g.name: meas})[g.name]
            g.failed += ((~out.solve_ok) | ~torch.isfinite(out.kkt_res)
                         | (out.status_code == 2)).sum()
            if lanes is not None:
                sample.update(out=adapter.tick_outputs(out, lanes),
                              post=adapter.node_state(self.fleet.states[g.name], lanes))
                self.samples[g.name].append(sample)
            with record_function("plant"):
                cmd = torch.stack([out.cmd.v, out.cmd.vn, out.cmd.w], -1)
                ref = plant.references(g.robot, cmd, meas.steer_angle)
                ref = torch.where(out.publish_cmd[:, None], ref, 0.0)
                g.plants = plant.step(g.robot, g.plants, ref)
        self.g += 1

    def warm(self) -> None:
        n = self.mix["warm_ticks"]
        for k in range(n):
            self.tick(-1 - k)
        loop.sync(self.device)
        t = loop.clock()
        for k in range(n):
            self.tick(-1 - k)
        loop.sync(self.device)
        self.tick_s = (loop.clock() - t) / n

    def window(self, seconds: float, mark=None) -> dict:
        expected = int(0.8 * seconds / max(self.tick_s, 1e-6))
        g, check = traffic.rng(self.seed, 2), self.cell.check
        n = check["sample_ticks"]
        # Half the sampled ticks are ticks on which a cohort is sent goals and paths.
        ks = np.arange(1, max(expected, 2))
        on_event = ks[(self.g + ks) % self.every == 0]
        chosen = set(int(k) for k in on_event[traffic.lanes(g, len(on_event), n // 2)]
                     ) if len(on_event) else set()
        chosen |= set(traffic.ticks(g, expected, n - len(chosen)))
        self.plan = {k: {gr.name: torch.as_tensor(traffic.lanes(g, gr.B, check["sample_lanes"]),
                                                  device=self.device) for gr in self.groups}
                     for k in sorted(chosen)}
        for gr in self.groups:
            gr.failed.zero_()
        ticks, t0, t1, done = loop.closed_loop(self.tick, seconds, self.device, mark=mark)
        self.plan = {}
        return dict(metrics={"scenario_ticks_per_s": ticks * self.B / (t1 - t0)},
                    attempted=ticks * self.B,
                    failed=sum(int(gr.failed) for gr in self.groups),
                    notes=dict(ticks=ticks, window_s=t1 - t0,
                               rate_by_third=loop.thirds(done, t0, t1, self.B),
                               samples=sum(len(v) for v in self.samples.values())))

    def trace(self, ticks: int) -> dict:
        for k in range(ticks):
            self.tick(-1 - k)
        return dict(ticks=ticks, groups={f"tick.{g.name}": (g.robot, g.B) for g in self.groups})

    def release(self) -> None:
        self.samples = {k: adapter.to_host(adapter.concat(v)) for k, v in self.samples.items() if v}
        self.robots = {g.name: g.robot for g in self.groups}
        del self.fleet, self.groups
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def outputs(self, prec, device) -> list:
        """(reference's outputs and state in ``prec``, program's) on the
        sampled ticks, one pair of batches on ``device`` per group."""
        return [loop.node_pair(self.robots[name], prec, adapter.to_device(s, device))
                for name, s in self.samples.items()]
