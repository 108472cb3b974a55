"""Command-line entry point: ``python -m nmpc_nav_control_tpu_torch <cmd>``.

Port of ``nmpc_nav_control_tpu/__main__.py``, the analog of the reference's
executables and launch files:

  prepare   — offline solver preparation from a models YAML; the
              ``scripts/generate_acados_libs.py`` +
              ``launch/run_nmpc_nav_control_generate_libs.launch`` analog
              (builds the CUDA kernels into ``build/kernels/``, captures
              one tick per geometry in a CUDA graph, then smoke-solves).
  run       — construct the node from a runtime YAML and drive it with the
              fixed-rate executor against a simulated robot; the
              ``src/main.cpp`` + ``launch/run_nmpc_nav_control.launch``
              analog (with the simulated plant standing in for ROS/TF I/O).
  bench     — the benchmark sweep (``bench.py``'s records, measured on the
              card: ``nmpc_nav_control_tpu_torch/bench.py``).
  export    — serialize the navigation tick to an AOT artifact
              (``runtime/aot.py``; the prebuilt-capsule analog), for the
              platforms ``--platform`` names (default cuda and cpu).

``prepare``, ``run`` and ``bench`` run on the card unless ``--device cpu``
asks for the CPU; with no card they raise, and so does ``export`` for its
``cuda`` platform.  The kernel build in ``build/kernels/`` is the port's cache across
processes (the JAX package's persistent compilation cache has no other
counterpart: a CUDA graph cannot be serialized).  On the card ``run`` also
prints the node's first tick, which captures its CUDA graph, and the cycles
after it.  ``run --spans PATH`` turns the port's tracing on
(``utils/telemetry.py``) and at exit writes what it recorded to PATH as one
Chrome-trace JSON: the host spans and the tick's phases on the host clock;
it also prints the card's time between graph replays by the host span open
there (``telemetry.outside_graphs_by_span``).
"""
from __future__ import annotations

import argparse
import math
import sys

import torch


def _check_device(device: str) -> None:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")


def cmd_prepare(args) -> int:
    from nmpc_nav_control_tpu_torch.runtime.models_config import prepare_solvers

    try:
        built = prepare_solvers(args.models_config, geometries=args.geometry,
                                device=args.device)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"prepared {len(built)} solver(s): {', '.join(sorted(built))}")
    return 0


def cmd_run(args) -> int:
    import logging

    from nmpc_nav_control_tpu_torch.utils import telemetry
    from nmpc_nav_control_tpu_torch.utils.telemetry import configure, metrics

    # Structured JSON-lines logs to stderr (the host opts in; the library
    # never configures logging on import).  --log-level debug turns on the
    # per-tick main_cycle/nmpc_solver channels.
    configure(level=getattr(logging, args.log_level.upper()))
    if args.spans:
        telemetry.enable_tracing()
    from nmpc_nav_control_tpu_torch.runtime import (
        NmpcNavControlNode,
        ParametricPath,
        ParametricPathSet2,
        PoseStamped,
        RealTimeExecutor,
        load_config,
    )
    from nmpc_nav_control_tpu_torch.runtime.simulation import SimulatedRobot

    config = load_config(args.config)
    node = NmpcNavControlNode(config, device=args.device)
    robot = SimulatedRobot(node, noise_sigma=args.noise,
                           start_pose=tuple(args.start))

    if args.path is not None:
        # --path x0 y0 x1 y1 ... : piecewise-linear segments at --path-vel.
        pts = [tuple(args.path[i:i + 2]) for i in range(0, len(args.path), 2)]
        paths = [
            ParametricPath(
                frame_id=config.global_frame_id,
                cx=[p0[0], p1[0] - p0[0]],
                cy=[p0[1], p1[1] - p0[1]],
                velocity=args.path_vel,
            )
            for p0, p1 in zip(pts[:-1], pts[1:])
        ]
        node.on_path_no_stack_up_2(ParametricPathSet2(paths=paths, request_id=1))
        mode = f"FollowPath ({len(paths)} segments)"
    else:
        goal = args.goal
        node.on_pose_goal(PoseStamped(frame_id=config.global_frame_id,
                                      x=goal[0], y=goal[1], theta=goal[2]))
        mode = f"GoToPose ({goal[0]}, {goal[1]}, {goal[2]})"

    print(f"{config.steering_geometry} node @ {config.control_freq} Hz, "
          f"N={config.horizon}: {mode}")
    executor = RealTimeExecutor(node, robot, robot,
                                use_native_timer=not args.no_rt)
    report_every = max(1, int(args.ticks / 10))
    ran = 0
    for start in range(0, args.ticks, report_every):
        n = min(report_every, args.ticks - start)
        executor.run(n)
        ran += n
        p = robot.pose
        st = robot.last_status
        print(f"t={ran * config.dt:6.2f}s pose=({p[0]:+.3f},{p[1]:+.3f},"
              f"{p[2]:+.3f}) status={st.status if st else '?'}")
        if st is not None and st.status == 0 and ran * config.dt > 0.5:
            print("goal reached -> Idle")
            break

    stats = node.timing_stats()
    if stats:
        print(f"cycles={stats['cycles']} p50={stats['p50_ms']:.1f}ms "
              f"p99={stats['p99_ms']:.1f}ms budget={stats['budget_ms']:.0f}ms "
              f"overruns={executor.overruns}")
    if node.capture_launches is not None:
        steady = executor.steady_latency_stats()
        print(f"capture cycle: {executor.first_cycle_s * 1e3:.3f}ms (the first tick captures "
              f"the node's CUDA graph; launches {node.capture_launches})")
        if steady["count"]:
            print(f"cycles after the capture: count={steady['count']} "
                  f"p50={steady['p50_ms']:.3f}ms p99={steady['p99_ms']:.3f}ms "
                  f"max={steady['max_ms']:.3f}ms violations={steady['violations']}")
    timer = executor.timer_stats()
    if timer:
        print(f"native timer: wakeup jitter p50={timer['p50_ns'] / 1e3:.1f}us "
              f"p99={timer['p99_ns'] / 1e3:.1f}us max={timer['max_ns'] / 1e3:.1f}us")
    if args.metrics:
        import json

        print("metrics: " + json.dumps(metrics().snapshot()))
    if args.goal is not None and args.path is None:
        err = math.hypot(robot.pose[0] - args.goal[0],
                         robot.pose[1] - args.goal[1])
        print(f"final position error: {err * 100:.2f} cm")
    if args.spans:
        recs = telemetry.records()
        telemetry.write_chrome_trace(args.spans, recs)
        print(f"spans: {len(recs.spans)} spans and {len(recs.marks)} phase marks -> {args.spans}")
        outside = telemetry.outside_graphs_by_span(recs)
        print("card time outside the graph replays (s, by host span):",
              {k: round(v, 6) for k, v in sorted(outside.items(), key=lambda kv: -kv[1])})
    return 0


def cmd_bench(args) -> int:
    from nmpc_nav_control_tpu_torch import bench

    return bench.main(["--device", args.device])


def cmd_export(args) -> int:
    from nmpc_nav_control_tpu_torch.runtime.aot import save_tick
    from nmpc_nav_control_tpu_torch.runtime.config import load_config

    config = load_config(args.config)
    platforms = tuple(args.platform) if args.platform else ("cuda", "cpu")
    meta = save_tick(config, args.output, batch=args.batch, platforms=platforms)
    print(f"exported {meta['geometry']} tick (N={meta['horizon']}, "
          f"batch={meta['batch']}, platforms={meta['platforms']}) "
          f"-> {args.output}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nmpc_nav_control_tpu_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("prepare", help="build, capture and smoke-test solvers "
                                       "from a models YAML (codegen analog)")
    p.add_argument("models_config", help="models YAML path "
                                         "(the *_params schema)")
    p.add_argument("--geometry", action="append",
                   choices=["diff", "omni4", "tric"],
                   help="restrict to specific geometries (repeatable)")
    p.set_defaults(fn=cmd_prepare)

    p = sub.add_parser("run", help="run the node against a simulated robot")
    p.add_argument("--config", required=True, help="runtime YAML path")
    p.add_argument("--ticks", type=int, default=400)
    p.add_argument("--goal", nargs=3, type=float, default=[1.0, 0.3, 0.5],
                   metavar=("X", "Y", "THETA"))
    p.add_argument("--path", nargs="+", type=float, default=None,
                   metavar="XY", help="waypoints x0 y0 x1 y1 ... (overrides "
                                      "--goal; piecewise-linear path)")
    p.add_argument("--path-vel", type=float, default=0.5)
    p.add_argument("--start", nargs=3, type=float, default=[0.0, 0.0, 0.0])
    p.add_argument("--noise", type=float, default=0.0,
                   help="actuation noise sigma")
    p.add_argument("--no-rt", action="store_true",
                   help="Python timer instead of the native RT timer")
    p.add_argument("--log-level", default="info",
                   choices=["debug", "info", "warning", "error"],
                   help="structured-log level (debug enables the per-tick "
                        "main_cycle/nmpc_solver channels)")
    p.add_argument("--metrics", action="store_true",
                   help="dump the metrics-registry snapshot at exit")
    p.add_argument("--spans", default=None, metavar="PATH",
                   help="trace the run and write its spans and tick phases to PATH "
                        "(Chrome-trace JSON) at exit")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("bench", help="run the benchmark sweep (BENCH_* variables as "
                                     "for bench.py)")
    p.set_defaults(fn=cmd_bench)

    for p in sub.choices.values():
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="run on the card (default) or on the CPU")

    p = sub.add_parser("export", help="serialize the tick to an AOT artifact "
                                      "(capsule analog)")
    p.add_argument("--config", required=True, help="runtime YAML path")
    p.add_argument("-o", "--output", required=True, help="artifact path")
    p.add_argument("--batch", type=int, default=None,
                   help="export the fleet tick over this many lanes")
    p.add_argument("--platform", action="append", default=None, choices=["cuda", "cpu"],
                   help="platform to trace for (repeatable; default cuda+cpu)")
    p.set_defaults(fn=cmd_export)

    args = ap.parse_args(argv)
    if args.cmd == "run" and args.path is not None and len(args.path) % 2:
        ap.error("--path needs an even number of values (x y pairs)")
    if args.cmd != "export":
        _check_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
