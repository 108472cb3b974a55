"""What the benchmark reads of the program under test, in one place.

The drivers build the program's objects; this module turns its state and
outputs into the plain dicts of tensors that ``benchmark.reference`` takes,
so that the reference never imports the program.
"""
from __future__ import annotations

import torch


def _take(x, lanes):
    return x.index_select(0, lanes).clone()


def node_state(state, lanes) -> dict:
    """A ``NodeState``'s lanes as the reference's node state."""
    w, s, r = state.window, state.window.segs, state.rti
    leaves = dict(status=state.status, goal=state.goal_pose, cx=s.cx, cy=s.cy, ch=s.ch,
                  vel=s.velocity, frame=s.frame_id, head=w.head, active=w.active_count,
                  total=w.total_count, u=state.active_path_u, xs=r.xs, us=r.us,
                  carry=r.x0_carry)
    return {k: _take(v, lanes) for k, v in leaves.items()}


def rti_state(state, lanes) -> dict:
    """An ``RTIState``'s lanes as the reference's solver memory."""
    return dict(xs=_take(state.xs, lanes), us=_take(state.us, lanes),
                carry=_take(state.x0_carry, lanes))


def tick_outputs(out, lanes) -> dict:
    """A ``TickOutput``'s compared entries."""
    cmd = torch.stack([out.cmd.v, out.cmd.vn, out.cmd.w], -1)
    return dict(cmd=_take(cmd, lanes), publish=_take(out.publish_cmd, lanes),
                status_code=_take(out.status_code, lanes), solve_ok=_take(out.solve_ok, lanes))


def to_host(d: dict) -> dict:
    """Every tensor of a (nested) dict copied to the CPU."""
    return to_device(d, "cpu")


def to_device(d: dict, device) -> dict:
    """Every tensor of a (nested) dict copied to ``device``."""
    return {k: (to_device(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in d.items()}


def concat(parts: list) -> dict:
    """Samples of several ticks as one batch (nested dicts leaf by leaf)."""
    first = parts[0]
    return {k: (concat([p[k] for p in parts]) if isinstance(first[k], dict)
                else torch.cat([p[k] for p in parts])) for k in first}
