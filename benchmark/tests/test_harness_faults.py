"""A run whose timed path is broken underneath comes out not correct.

Each cell runs on the CPU at a tiny size (the harness's look for a card
skipped), once sound and once for each fault it can have: a tick that
returns its solver state unchanged, half of the batch left out (its lanes
keep their state and get the other half's mean command), and a command
altered where it is produced; for the node cells also a path stored other
than it was sent, and (the robot, whose tiny run gets far enough along its
path) a tick that leaves the path window and its parameter where they were.
One card, so no exchange between cards to leave out.
"""
from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.run import run_cell
from benchmark.tests.conftest import CELLS


def _unchanged(step):
    def broken(spec, data, state, *args, **kw):
        _, cmd, stats = step(spec, data, state, *args, **kw)
        return state, cmd, stats
    return broken


def _half_left_out(step):
    def broken(spec, data, state, *args, **kw):
        new, cmd, stats = step(spec, data, state, *args, **kw)
        B = cmd.v.shape[0]
        out = torch.arange(B) >= B // 2
        keep = lambda n, o: torch.where(out.reshape(-1, *[1] * (n.dim() - 1)), o, n)  # noqa: E731
        new = type(new)(*(keep(n, o) for n, o in zip(new, state)))
        cmd = type(cmd)(*(torch.where(out, c[~out].mean(), c) for c in cmd))
        return new, cmd, stats
    return broken


def _altered(step):
    def broken(*args, **kw):
        new, cmd, stats = step(*args, **kw)
        return new, cmd._replace(v=cmd.v + 1e-2), stats
    return broken


def _ingested_wrong(ingest):
    def broken(win, new_segs, *args, **kw):
        cx = new_segs.cx.clone()
        cx[:, 0, 0] += 1e-3
        return ingest(win, new_segs._replace(cx=cx), *args, **kw)
    return broken


def _window_unmoved(node_tick):
    def broken(spec, data, cfg, state, meas):
        new, out = node_tick(spec, data, cfg, state, meas)
        return new._replace(window=state.window, active_path_u=state.active_path_u), out
    return broken


STEP_FAULTS = {"state_unchanged": _unchanged, "half_left_out": _half_left_out,
               "altered": _altered}
NODE_FAULTS = {"path_ingested_wrong": _ingested_wrong, "window_unmoved": _window_unmoved}
CAN_HAVE = {"robot": ["state_unchanged", "altered", *NODE_FAULTS],     # by the cell's driver
            "fleet": [*STEP_FAULTS, "path_ingested_wrong"],
            "sweep": list(STEP_FAULTS)}


def _run(tiny, cell):
    c = harness.load_cell(tiny, cell, tiny)
    seconds = 1.0 if c.traffic["driver"] == "robot" else 2.0
    return run_cell(c, 20241017, seconds, False, device="cpu")


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_sound_run_is_correct(tiny, cell):
    res = _run(tiny, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("cell,fault", [(c, f) for c, d in CELLS.items() for f in CAN_HAVE[d]])
def test_a_broken_step_is_not_correct(tiny, cell, fault, monkeypatch):
    from nmpc_nav_control_tpu_torch.control import controllers, state_machine
    from nmpc_nav_control_tpu_torch.parallel import fleet
    from nmpc_nav_control_tpu_torch.runtime import node

    if fault in STEP_FAULTS:
        for mod in (controllers, state_machine):
            monkeypatch.setattr(mod, "controller_step",
                                STEP_FAULTS[fault](controllers.controller_step))
    elif fault == "path_ingested_wrong":
        monkeypatch.setattr(state_machine, "ingest", _ingested_wrong(state_machine.ingest))
    else:
        for mod in (state_machine, node, fleet):
            monkeypatch.setattr(mod, "node_tick", _window_unmoved(state_machine.node_tick))
    res = _run(tiny, cell)
    assert not res["correct"], res["checks"]
