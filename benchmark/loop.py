"""The measured window's loops and the comparison of what they produced."""
from __future__ import annotations

import time

import torch

from benchmark.reference.navigation import follow

clock = time.perf_counter


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(tick, seconds: float, device, depth: int = 2, mark=None):
    """Ticks back to back for ``seconds``: ``tick(k)`` enqueues tick k, and
    at most ``depth`` ticks are in flight; ``mark(i)`` is called once each
    third i = 1, 2 of the window has passed.  Returns (ticks, t0, t1,
    done_at), t1 taken after the device finished the last tick."""
    on_card = torch.device(device).type == "cuda"
    sync(device)
    events, done_at = [], []
    t0 = clock()
    k, third = 0, 1
    while True:
        if mark is not None and third < 3 and clock() - t0 >= third * seconds / 3:
            mark(third)
            third += 1
        tick(k)
        k += 1
        if on_card:
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
            if len(events) > depth:
                events.pop(0).synchronize()
                done_at.append(clock())
        else:
            done_at.append(clock())
        if clock() - t0 >= seconds:
            break
    sync(device)
    t1 = clock()
    done_at += [t1] * (k - len(done_at))
    return k, t0, t1, done_at


def thirds(done_at, t0: float, t1: float, per_tick: int) -> list:
    """Work per second in each third of the window [t0, t1], from the host
    time at which each tick was seen complete."""
    span = (t1 - t0) / 3
    counts = [0, 0, 0]
    for t in done_at:
        counts[min(2, int((t - t0) / span))] += per_tick
    return [c / span for c in counts]


def sleep_until(t: float) -> None:
    """Sleep to within half a millisecond of ``t``, then spin."""
    left = t - clock()
    if left > 5e-4:
        time.sleep(left - 5e-4)
    while clock() < t:
        pass


def gaps(prog: dict, ref: dict) -> dict:
    """The compared numbers of a batch of samples: the widest command gap
    where both sides publish, the widest gap of the solved input trajectory,
    and the count of differing flags (publish, status, and the solver's flag
    where the program reports it).  Where both give the node's state after
    the cycle (``post``), also the widest gap of its other real leaves (state
    trajectory, carried initial state, path parameter), the same gap over
    1 + the reference's magnitude (``state_rel_gap``: a position tens of
    metres from the origin rounds in float32 to steps of 2e-6), and the count
    of differing window entries: status and cursors after the cycle, and the
    program's path store and goal against what the benchmark sent
    (``input_mismatches``, where the program's side gives it).  Where the
    program's side says in which samples a path was sent (``new_path``),
    the command, input and relative state gaps also apart for those
    samples (``*_new_path``: a solve that starts on a new path, where
    float32 rounding moves the answer tens of times further than elsewhere)
    and for the rest (``*_on_path``).  A cell compares the numbers its
    limits name."""
    both = prog["publish"] & ref["publish"]
    dcmd_all = (prog["cmd"].double() - ref["cmd"].double()).abs()
    dcmd = dcmd_all[both]
    dus = (prog["us"].double() - ref["us"].double()).abs()
    flags = sum((prog[k].long() != ref[k].long()).long()
                for k in ("publish", "status_code", "solve_ok") if k in prog)
    amax = lambda x: float(x.max()) if x.numel() else 0.0  # noqa: E731 (NaN propagates)
    out = dict(cmd_gap=amax(dcmd), us_gap=amax(dus), flag_mismatches=int(flags.sum()))
    if "post" in prog:
        p, r = prog["post"], ref["post"]
        leaves = [(p[k].double(), r[k].double()) for k in ("xs", "carry", "u")]
        out["state_gap"] = amax(torch.cat([(a - b).abs().flatten() for a, b in leaves]))
        rel = torch.cat([((a - b).abs() / (1 + b.abs())).reshape(len(a), -1)
                         for a, b in leaves], 1)
        out["state_rel_gap"] = amax(rel)
        if "new_path" in prog:
            per = dict(cmd_gap=torch.where(both[:, None], dcmd_all, 0.0),
                       us_gap=dus.reshape(len(dus), -1), state_rel_gap=rel)
            new = prog["new_path"].bool()
            for name, d in per.items():
                out[f"{name}_on_path"] = amax(d[~new])
                out[f"{name}_new_path"] = amax(d[new])
        window = sum(int((p[k].long() != r[k].long()).sum())
                     for k in ("status", "head", "active", "total"))
        sent = prog.get("input_mismatches")
        out["window_mismatches"] = window + (0 if sent is None else int(sent.sum()))
    return out


def sent_after(own: dict, event: dict) -> dict:
    """The path and goal each lane holds by what the benchmark sent, after
    this cycle's events (``own`` before them)."""
    def pick(mask, new, old):
        return torch.where(mask.bool().reshape(-1, *[1] * (old.dim() - 1)), new, old)

    out = {k: pick(event["path"], event[k], v) for k, v in own.items() if k != "goal"}
    return out | {"goal": pick(event["goal_set"], event["goal"], own["goal"])}


def input_mismatches(post: dict, sent: dict):
    """Per lane: the path-store rows and the goal in which the program's
    state differs from what the benchmark sent (in the program's dtype)."""
    dt, cap = post["cx"].dtype, post["vel"].shape[1]
    differ = lambda k: post[k] != sent[k].to(dt)  # noqa: E731
    rows = (differ("cx").any(-1) | differ("cy").any(-1) | differ("ch").any(-1) | differ("vel")
            | ((post["frame"] != 0) != (torch.arange(cap, device=post["vel"].device)[None]
                                        < sent["count"][:, None])))
    return rows.sum(1) + differ("goal").any(-1)


def node_pair(robot, prec, s: dict) -> tuple:
    """(reference's, program's) outputs and state after one batch of
    sampled node cycles (``pre``, ``own``, ``event``, ``inputs``, ``out``,
    ``post``): the reference follows the cycle from the program's carried
    state with the path store and goal of what the benchmark sent.  Both
    sides carry which samples had a path sent (``new_path``), so that a
    control put in the program's place is judged by the same numbers."""
    x = s["inputs"]
    new, out = follow(robot, prec, s["pre"], s["own"], s["event"], x["pose"], x["vel"],
                      x["steer"])
    path = s["event"]["path"]
    prog = dict(s["out"], us=s["post"]["us"], post=s["post"], new_path=path,
                input_mismatches=input_mismatches(s["post"], sent_after(s["own"], s["event"])))
    return dict(out, us=new["us"], post=new, new_path=path), prog


def worst(readings: list):
    """The worst of several sets of compared numbers, key by key (NaN
    wins); None for no set."""
    def worse(x, y):
        return x if x != x else y if y != y else max(x, y)

    out = None
    for r in readings:
        out = r if out is None else {k: worse(out[k], r[k]) for k in out}
    return out
