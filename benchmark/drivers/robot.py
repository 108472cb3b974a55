"""One deployed robot: the ROS node's 40 Hz loop.

``runtime/node.py::NmpcNavControlNode`` (its tick a CUDA-graph replay at
B=1 on the card), driven open loop on absolute due times at the mix's rate:
each cycle's latency runs from its due time to the moment its command (or
its "no command") is on the host, so a late cycle also delays the next.
Paths arrive through ``on_path_no_stack_up``; when the node goes idle at a
path's end, the next path is sent from where the robot stands.  The robot is
the benchmark's plant on the host, advanced one period by each published
command.  Work between cycles (the plant, path messages, the correctness
snapshots) runs after a cycle's command is out and before the next is due.
"""
from __future__ import annotations

import gc
import math

import torch
from torch.profiler import record_function

from benchmark import adapter, loop, plant, traffic
from benchmark.reference.models import robot_from_yaml

PATH_ROUNDS = 16


class Driver:
    per_tick_label = "tick.node"
    trace_ticks = 20          # ticks the traced run profiles

    def __init__(self, cell, seed: int, device):
        from nmpc_nav_control_tpu_torch.runtime.config import from_dict
        from nmpc_nav_control_tpu_torch.runtime.node import NmpcNavControlNode

        mix = cell.traffic
        self.cell, self.seed, self.device, self.mix = cell, seed, torch.device(device), mix
        self.dtype = cell.dtype
        self.robot = robot_from_yaml(cell.config)
        self.period = 1.0 / mix["rate_hz"]
        self.node = NmpcNavControlNode(from_dict(cell.config), dtype=self.dtype,
                                       device=self.device)
        g = traffic.rng(seed, 1)
        self.paths = traffic.paths(g, PATH_ROUNDS, mix)
        self.plant = torch.zeros(1, plant.size(self.robot), dtype=torch.float64)
        self.plant[0, 2] = g.uniform(-math.pi, math.pi)
        self.own = dict(goal=torch.zeros(1, 3, dtype=torch.float64))
        self.sent = 0
        self.send_path()
        self.samples, self.plan, self.sampling = [], set(), False

    def send_path(self) -> None:
        from nmpc_nav_control_tpu_torch.runtime.messages import ParametricPath, ParametricPathSet

        i = self.sent % PATH_ROUNDS
        one = {k: torch.as_tensor(v[i:i + 1]) for k, v in self.paths.items() if k != "count"}
        p = traffic.place(one, self.plant[:, :3])
        n = int(self.paths["count"][i])
        msg = ParametricPathSet(paths=[
            ParametricPath(frame_id="map", cx=p["cx"][0, j].tolist(), cy=p["cy"][0, j].tolist(),
                           velocity=float(p["vel"][0, j]), ch=p["ch"][0, j].tolist())
            for j in range(n)])
        self.node.on_path_no_stack_up(msg)
        self.own = dict(cx=p["cx"], cy=p["cy"], ch=p["ch"], vel=p["vel"],
                        count=torch.tensor([n]), goal=self.own["goal"])
        self.sent += 1

    def _event(self, path: bool) -> dict:
        """This cycle's event for the reference: the path just sent, or none."""
        ev = {k: v if path else torch.zeros_like(v) for k, v in self.own.items()}
        return ev | dict(path=torch.tensor([path]), goal_set=torch.tensor([False]))

    def cycle(self):
        """One cycle: (twist or None, status, raw command or None, inputs)."""
        # The node reads the configuration's precision; both it and the
        # reference get these values, rounded to it.
        pose, vel, steer = (x.to(self.dtype) for x in plant.measure(self.robot, self.plant))
        if self.robot.geometry == "tric":
            self.node.set_steering_wheel_angle(float(steer[0]))
        with record_function(self.per_tick_label):
            twist, status = self.node.tick(tuple(pose[0].tolist()), tuple(vel[0].tolist()))
        cmd = self.node.last_cmd if twist is not None else None
        return twist, status, cmd, dict(pose=pose, vel=vel, steer=steer)

    def between(self, status, cmd, sample: bool = False) -> None:
        """After a cycle: the plant one period on, the next path if idle;
        ``sample``: the node's state and what the benchmark sent taken for
        the reference before that path goes in."""
        with record_function("plant"):
            c = torch.tensor([cmd if cmd is not None else (0.0, 0.0, 0.0)], dtype=torch.float64)
            ref = plant.references(self.robot, c, self.plant[:, 4])
            self.plant = plant.step(self.robot, self.plant, ref)
        if sample:
            self.samples.append(dict(pre=self._snapshot(), own=dict(self.own),
                                     event=self._event(False)))
        if status.status == 0:
            with record_function("events"):
                self.send_path()
            if sample:
                self.samples[-1]["event"] = self._event(True)

    def _snapshot(self) -> dict:
        return adapter.to_host(adapter.node_state(self.node.state, torch.zeros(
            1, dtype=torch.long, device=self.device)))

    def warm(self) -> None:
        for _ in range(self.mix["warm_cycles"]):
            _, status, cmd, _ = self.cycle()
            self.between(status, cmd)
        self.send_path()          # a path message mid-run, as the window may send
        self._snapshot()

    def run(self, cycles: int, t0: float, mark=None):
        """``cycles`` cycles on the schedule from ``t0``: latencies and
        failures; ``mark(i)`` after the last cycle of third i = 1, 2.  While
        ``sampling``, the planned cycles and each cycle after a path is sent
        are kept for the reference."""
        lat, failed, keep = [], 0, False
        for k in range(cycles):
            if mark is not None and k and k % (cycles // 3) == 0 and k // (cycles // 3) < 3:
                mark(k // (cycles // 3))
            due = t0 + k * self.period
            loop.sleep_until(due)
            self.k = k
            twist, status, cmd, inputs = self.cycle()
            done = loop.clock()
            bad = status.status == 2 or (status.status == 1 and twist is None)
            failed += bad
            lat.append(math.inf if bad else done - due)
            if keep:
                self.samples[-1].update(inputs=inputs, post=self._snapshot(), out=dict(
                    cmd=torch.tensor([cmd if cmd is not None else (0.0, 0.0, 0.0)],
                                     dtype=self.dtype),
                    publish=torch.tensor([twist is not None]),
                    status_code=torch.tensor([status.status])))
            keep = k + 1 < cycles and (k + 1 in self.plan
                                       or (self.sampling and status.status == 0))
            self.between(status, cmd, keep)
        return lat, failed

    def window(self, seconds: float, mark=None) -> dict:
        """The measured cycles.  ``mark`` is not called: an ``nvidia-smi``
        started mid-window would run beside the cycles it reads, so the
        robot's clock readings bracket the window."""
        from benchmark.harness import percentile

        cycles = int(round(seconds * self.mix["rate_hz"]))
        self.plan = set(traffic.ticks(traffic.rng(self.seed, 2), cycles,
                                      self.cell.check["sample_ticks"]))
        t0 = loop.clock() + self.period
        self.sampling, self.k, collected, began = True, -1, [], []

        def on_gc(phase, info):     # the process's collections, by the cycle they fell in
            if phase == "start":
                began[:] = [loop.clock()]
            elif began:
                collected.append([info["generation"], 1e3 * (loop.clock() - began[0]), self.k])

        gc.callbacks.append(on_gc)
        try:
            lat, failed = self.run(cycles, t0)
        finally:
            gc.callbacks.remove(on_gc)
        self.plan, self.sampling = set(), False
        ms = [x * 1e3 for x in lat]
        third = len(ms) // 3
        parts = [ms[i * third:(i + 1) * third] for i in range(3)]
        slowest = sorted(range(cycles), key=lambda k: -ms[k])[:25]
        return dict(metrics={"cycle_ms_p50": percentile(ms, 50),
                             "cycle_ms_p99": percentile(ms, 99)},
                    attempted=cycles, failed=failed,
                    notes=dict(cycles=cycles, max_ms=max(ms), over_budget=sum(
                        x > self.period * 1e3 for x in ms),
                               p50_by_third=[percentile(p, 50) for p in parts],
                               p99_by_third=[percentile(p, 99) for p in parts],
                               slowest=[[k, ms[k]] for k in sorted(slowest)],
                               gc_by_generation=[sum(c[0] == g for c in collected)
                                                 for g in range(3)],
                               gc_over_1ms=[c for c in collected if c[1] > 1.0],
                               paths_sent=self.sent, sampled_cycles=len(self.samples)))

    def trace(self, ticks: int) -> dict:
        self.run(ticks, loop.clock() + self.period)
        return dict(ticks=ticks, groups={self.per_tick_label: (self.robot, 1)})

    def release(self) -> None:
        done = [s for s in self.samples if "post" in s]
        self.samples = adapter.concat(done) if done else None
        del self.node
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def outputs(self, prec, device) -> list:
        """[(reference's outputs and state in ``prec``, program's)] on the
        sampled cycles."""
        if self.samples is None:
            return []
        return [loop.node_pair(self.robot, prec, adapter.to_device(self.samples, device))]
