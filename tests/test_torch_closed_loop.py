"""The port's closed loop against the JAX package's, on the CPU in f64.

``RealTimeExecutor`` + ``SimulatedRobot`` + ``NmpcNavControlNode`` of both
packages, lock-stepped one cycle at a time with ``run(1)``, for diff, omni4
and tric: a goal to IDLE, then a two-segment path to IDLE.  Plant poses
agree within 1e-9 and statuses are equal at every tick.  The plant, the
executor's other parts and the rest of the host runtime are tested one by
one in ``test_torch_host_runtime.py``.
"""
import math
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmpc_nav_control_tpu.runtime as JR
import nmpc_nav_control_tpu.runtime.simulation as jsim
import nmpc_nav_control_tpu_torch.runtime as TR
import nmpc_nav_control_tpu_torch.runtime.simulation as tsim
from test_torch_runtime import DIFF_RAW, OMNI4_RAW, TRIC_RAW

torch.set_num_threads(1)

RAWS = {"diff": DIFF_RAW, "omni4": OMNI4_RAW, "tric": TRIC_RAW}
TOL = 1e-9
# Goals each geometry reaches at N=10 (tric's steering settles short of a
# goal with more lateral offset), from a start heading of 0.1 rad.
GOALS = {"diff": (0.3, 0.1, 0.2), "omni4": (0.3, 0.1, 0.2), "tric": (0.35, 0.05, 0.2)}


@pytest.mark.parametrize("geometry", ["diff", "omni4", "tric"])
def test_closed_loop_matches_jax(geometry, monkeypatch):
    """Both packages' executor, plant and node (f64, CPU) lock-stepped one
    cycle at a time: a goal to IDLE, then a two-segment path to IDLE.  The
    Python timer's sleeps are skipped: pacing is not what is compared."""
    monkeypatch.setattr(time, "sleep", lambda s: None)
    raw = RAWS[geometry]
    loops = []
    for mod, sim, dtype, kw in ((TR, tsim, torch.float64, dict(device="cpu")),
                                (JR, jsim, jnp.float64, {})):
        node = mod.NmpcNavControlNode(mod.from_dict(raw), dtype=dtype, **kw)
        robot = sim.SimulatedRobot(node, substeps=5, start_pose=(0.0, 0.0, 0.1))
        ex = mod.RealTimeExecutor(node, robot, robot, use_native_timer=False)
        loops.append((mod, node, robot, ex))

    def lock_step(what, ticks):
        for k in range(ticks):
            sts = []
            for _, _, robot, ex in loops:
                ex.run(1)
                sts.append(robot.last_status)
            (_, _, t_robot, _), (_, _, j_robot, _) = loops
            assert sts[0].status == sts[1].status and sts[0].request_id == sts[1].request_id, \
                (what, k, sts)
            assert abs(sts[0].path_remains - sts[1].path_remains) <= TOL, (what, k, sts)
            np.testing.assert_allclose(t_robot.pose, j_robot.pose, rtol=0, atol=TOL,
                                       err_msg=f"{what} tick {k}")
            assert sts[0].status != 2, (what, k)
            if sts[0].status == 0 and k > 0:
                return k + 1
        raise AssertionError(f"{what}: no IDLE in {ticks} ticks")

    for mod, node, _, _ in loops:
        node.on_pose_goal(mod.PoseStamped("map", *GOALS[geometry]))
    goal_ticks = lock_step("goal", 120)
    for mod, node, robot, _ in loops:
        x, y, th = robot.pose
        c, s = math.cos(th), math.sin(th)
        # Ahead of the robot, with its heading for omni4's heading polynomial.
        paths = [mod.ParametricPath("map", [x, 0.25 * c], [y, 0.25 * s], ch=[th], velocity=0.4),
                 mod.ParametricPath("map", [x + 0.25 * c, 0.2 * c - 0.05 * s],
                                    [y + 0.25 * s, 0.2 * s + 0.05 * c], ch=[th],
                                    velocity=0.4)]
        node.on_path_no_stack_up_2(mod.ParametricPathSet2(paths=paths, request_id=5))
    path_ticks = lock_step("path", 150)
    (_, _, _, t_ex), (_, _, _, j_ex) = loops
    assert t_ex.latency_stats()["count"] == j_ex.latency_stats()["count"] \
        == goal_ticks + path_ticks
    assert t_ex.first_cycle_s > 0 and t_ex.steady_latency_stats()["count"] == \
        goal_ticks + path_ticks - 1
    assert t_ex.timer_stats() == {} == j_ex.timer_stats()
