"""Phase breakdown of one controller tick on the card.

Port of ``tools/phase_probe.py``.  Times, by the chained-slope method
(``utils/profiling.py::steady_state_seconds_per_step``: CUDA events over
chains of ``BENCH_CHAIN_LO`` and ``BENCH_CHAIN_HI`` steps, best of
``BENCH_REPS``), the marginal cost of:

  1. ``full_tick``: the whole controller tick, replays of a
     ``GraphedController`` on ``bench.py``'s controller;
  2. ``qp_solve``: the box-QP solve alone (the fused IPM sweeps on the
     default route), chained through ``dx0``;
  3. ``linearize``: the packed RK4 linearization the tick runs
     (``ops/linearize_packed.py``), chained through the trajectory;
  4. ``yref_build``: the reference unwrap chain, chained through its seed.

Each phase other than the first is one step ``carry -> fn(carry)``
captured in a CUDA graph over static copies of its inputs, so that a phase
is timed as the graphed tick runs it, not as the host launches it.  The JAX
probe's fourth phase, ``tile_transpose``, has no counterpart: the port keeps
no 1024-lane tile layout (its sweeps take the batch-minor layout the
linearization writes), so no line is printed for it.  Each line carries
``per_batch_ms`` (the chained slope), ``per_solve_us`` and, on the card,
``device_ms`` and ``kernel_ms``: the device time of one step and of the
port's CUDA kernels in it, from ``torch.profiler`` (null where the trace
shows none, and with ``--device cpu``, where the steps run eagerly and are
timed on the host clock).

Usage: python -m nmpc_nav_control_tpu_torch.tools.phase_probe [geometry] [N] [B]
       [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np
import torch

from nmpc_nav_control_tpu_torch.control.graph import _GraphedTick
from nmpc_nav_control_tpu_torch.utils.profiling import steady_state_seconds_per_step

# The port's CUDA kernels as the profiler names them (csrc/*.cu).
PORT_KERNEL = re.compile(r"namespace\)::\w+_kernel<")


class _Phase(_GraphedTick):
    """``fn(*carry) -> carry`` over static copies of ``carry`` (a tuple of
    tensors), captured in a CUDA graph on ``data``'s device."""

    def __init__(self, data, fn, carry):
        self.data, self._fn = data, fn
        self.state = tuple(c.clone() for c in carry)

    def _tick(self):
        return self._fn(*self.state), ()


def chain_step(data, fn, carry):
    """``step(carry) -> carry`` for the chain ``carry -> fn(*carry)``: on a
    card, replays of ``fn`` captured in a CUDA graph (the carry argument is
    then unused: the graph reads and writes its own copy); elsewhere eager
    calls."""
    if data.p.device.type != "cuda":
        return lambda c: fn(*c)
    phase = _Phase(data, fn, carry)
    phase.capture()

    def replay(_):
        phase._replay()
        return phase.state

    return replay


def device_split(fn, reps=5):
    """(device ms, the port's kernels' device ms) per call of ``fn`` from
    ``torch.profiler``; (None, None) where the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = kernels = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total += e.self_device_time_total
            if PORT_KERNEL.search(e.key):
                kernels += e.self_device_time_total
    if total <= 0:
        return None, None
    return total / reps / 1000.0, kernels / reps / 1000.0


class Probe:
    """The command line and the printing shared by the probes: geometry,
    N, B, device, and ``BENCH_REPS`` / ``BENCH_CHAIN_LO`` / ``BENCH_CHAIN_HI``
    (10, 1 and 33, as the JAX probes)."""

    def __init__(self, prog, per_lane_key, argv=None):
        ap = argparse.ArgumentParser(prog=prog)
        ap.add_argument("geometry", nargs="?", default="diff",
                        choices=["diff", "omni4", "tric"])
        ap.add_argument("N", nargs="?", type=int, default=40)
        ap.add_argument("B", nargs="?", type=int, default=2048)
        ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
        args = ap.parse_args(argv)
        self.geometry, self.N, self.B = args.geometry, args.N, args.B
        self.device = torch.device(args.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{prog}: no CUDA device (pass --device cpu to run on the CPU)")
        self.reps = int(os.environ.get("BENCH_REPS", "10"))
        self.k_lo = int(os.environ.get("BENCH_CHAIN_LO", "1"))
        self.k_hi = int(os.environ.get("BENCH_CHAIN_HI", "33"))
        self.per_lane_key = per_lane_key
        from nmpc_nav_control_tpu_torch.bench import device_label

        self.label = device_label(self.device)

    def measure(self, name, step, carry):
        """Time the chain of ``step`` from ``carry`` and print its line.  An
        untimed chain of ``k_hi`` steps comes first, as the bench's check
        chain does, so that both time the same steady state."""
        for _ in range(self.k_hi):
            carry = step(carry)
        per_step = steady_state_seconds_per_step(step, carry, k_lo=self.k_lo, k_hi=self.k_hi,
                                                 reps=self.reps, device=self.device)
        dev_ms, kernel_ms = (device_split(lambda: step(carry))
                             if self.device.type == "cuda" else (None, None))
        rec = {"phase": name, "per_batch_ms": round(per_step * 1e3, 4),
               self.per_lane_key: round(per_step / self.B * 1e6, 4),
               "device_ms": dev_ms, "kernel_ms": kernel_ms,
               "config": {"geometry": self.geometry, "N": self.N, "batch": self.B,
                          "device": self.label}}
        print(json.dumps(rec), flush=True)
        return rec


def main(argv=None) -> int:
    from nmpc_nav_control_tpu_torch.bench import _build
    from nmpc_nav_control_tpu_torch.control import (
        GraphedController,
        controller_init,
        controller_step,
    )
    from nmpc_nav_control_tpu_torch.ops.ipm_fused import dense_sparsity
    from nmpc_nav_control_tpu_torch.ops.linearize_packed import linearize_packed
    from nmpc_nav_control_tpu_torch.qp.ipm import BoxQP, solve_box_qp, tiled_ipm_ok
    from nmpc_nav_control_tpu_torch.rti.step import build_yref

    probe = Probe("python -m nmpc_nav_control_tpu_torch.tools.phase_probe", "per_solve_us",
                  argv)
    N, B, dev = probe.N, probe.B, probe.device
    f32 = torch.float32
    spec, data = _build(probe.geometry, N, device=dev)
    m = spec.dims.model
    nx, nu = m.nx, m.nu
    rng = np.random.default_rng(0)

    def t(x):
        return torch.tensor(x, dtype=f32, device=dev)

    # ---------------- full tick ----------------
    poses = t(rng.normal(size=(B, 3)) * 0.1)
    vels = t(rng.normal(size=(B, 3)) * 0.1)
    trajs = torch.zeros(B, N + 1, 3, device=dev)
    trajs[:, 0, 0] = 1.0
    n_valids = torch.ones(B, dtype=torch.int32, device=dev)
    if dev.type == "cuda":
        graphed = GraphedController(spec, data, B)
        graphed.load_inputs(poses, vels, trajs, n_valids)
        graphed.capture()
        probe.measure("full_tick", lambda c: (graphed._replay(), graphed.state)[1],
                      graphed.state)
    else:
        probe.measure("full_tick",
                      lambda s: controller_step(spec, data, s, poses, vels, trajs, n_valids)[0],
                      controller_init(spec, B, f32, dev))

    # ---------------- shared QP data ----------------
    xs = t(rng.normal(size=(B, N + 1, nx)) * 0.1)
    us = t(rng.normal(size=(B, N, nu)) * 0.1)
    ps = data.p.expand(B, -1)
    spars = spec.rti.spars if tiled_ipm_ok() else dense_sparsity(nx, nu)
    A, Bm, x_next = linearize_packed(m.f, spec.dims.dt, xs, us, ps, *spars)
    c = x_next - xs[:, 1:].permute(1, 2, 0)
    q = torch.abs(t(rng.normal(size=(nx,)))) + 0.1
    r = torch.abs(t(rng.normal(size=(nu,)))) + 0.1
    qx = t(rng.normal(size=(B, N + 1, nx)) * 0.1)
    qu = t(rng.normal(size=(B, N, nu)) * 0.1)
    nbx, nbu = len(m.idxbx), len(m.idxbu)
    ones_x, ones_u = torch.ones(B, N, nbx, device=dev), torch.ones(B, N, nbu, device=dev)
    qp = BoxQP(A=None, B=None, c=None, Qd=q.expand(B, N + 1, nx), qx=qx,
               Rd=r.expand(B, N, nu), qu=qu, dx0=None, lbx=-ones_x, ubx=ones_x,
               lbu=-ones_u, ubu=ones_u)

    # ---------------- QP solve only (chained through dx0) ----------------
    def qp_step(dx0):
        sol = solve_box_qp(qp._replace(dx0=dx0), m.idxbx, m.idxbu, iters=spec.rti.ipm_iters,
                           reg=spec.rti.ipm_reg, spars=spars, packed_abc=(A, Bm, c))
        return (0.01 * torch.tanh(sol.dxs[:, 1]),)

    dx0 = (torch.zeros(B, nx, device=dev),)
    probe.measure("qp_solve", chain_step(data, qp_step, dx0), dx0)

    # ---------------- linearization only (chained through xs) ----------------
    def lin_step(xs):
        A_, B_, xn = linearize_packed(m.f, spec.dims.dt, xs, us, ps, *spars)
        s = 1e-9 * (A_.sum((0, 1)) + B_.sum((0, 1)))
        tail = 0.9 * xs[:, 1:] + 0.1 * xn.permute(2, 0, 1) + s[:, None, None]
        return (torch.cat([xs[:, :1], tail], 1),)

    probe.measure("linearize", chain_step(data, lin_step, (xs,)), (xs,))

    # ---------------- yref build only (chained through the seed) ----------------
    def yref_step(th):
        return (th + 1e-9 * build_yref(N, th, trajs, n_valids).sum((1, 2)),)

    thetas = (t(rng.normal(size=(B,)) * 0.1),)
    probe.measure("yref_build", chain_step(data, yref_step, thetas), thetas)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
