"""The port's host runtime (``runtime/``) against the JAX package's.

On the CPU (``device="cpu"``, f64): ``from_dict`` parses every geometry's
configuration into the same fields and raises the same errors; the port's
``NmpcNavControlNode`` and the JAX one take one message sequence side by
side (path sets, a goal, operator commands, a bad command, invalid
measurements, frame changes through a transformer, a tric steering angle),
both fed the same measured pose from one plant, and publish the same
Twist (None alike, values within 1e-9), the same ``ControlStatus``, the
same ``actual_path`` message and require the same frame at every tick.
Also: the port node alone reaches a goal, turns a missing transform into
ERROR, reports its timing, and raises without a card unless asked for
the CPU.
"""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmpc_nav_control_tpu.runtime as JR
import nmpc_nav_control_tpu_torch.runtime as TR

torch.set_num_threads(1)

TOL = 1e-9
DIFF_RAW = {
    "steering_geometry": "diff",
    "control_freq": 40,
    "tf_ini": 0.25,                   # N = 10
    "rob_dist_between_wh": 0.27,
    "rob_wh_vel_time_const": 0.1,
    "rob_wh_max_vel": 1.0,
    "rob_wh_max_ace": 2.0,
    # Position weights that move the robot within a few dozen ticks at N=10.
    "cost_matrix_weights_state_diag": [1000.0, 1000.0, 500.0, 0, 0, 0, 0],
    "cost_matrix_weights_input_diag": [1.0, 1.0],
    "final_position_error": 0.05,
    "final_orientation_error": 10.0,
    "path_capacity": 8,
}
OMNI4_RAW = {**DIFF_RAW, "steering_geometry": "omni4", "rob_dist_between_front_back_wh": 0.3,
             "rob_dist_between_left_right_wh": 0.235,
             "cost_matrix_weights_state_diag": [1000.0, 1000.0, 500.0] + [0.0] * 8,
             "cost_matrix_weights_input_diag": [1.0] * 4}
TRIC_RAW = {**DIFF_RAW, "steering_geometry": "tric", "steering_wheel_frame_id": "steer",
            "rob_dist_between_steering_back_wh": 1.05, "rob_steer_wh_angle_time_const": 0.1,
            "rob_steer_wh_min_angle": -60.0, "rob_steer_wh_max_angle": 60.0,
            "rob_steer_wh_max_angle_var": 90.0}


def _nodes(raw):
    jnode = JR.NmpcNavControlNode(JR.from_dict(raw), dtype=jnp.float64)
    tnode = TR.NmpcNavControlNode(TR.from_dict(raw), dtype=torch.float64, device="cpu")
    return jnode, tnode


def _path_msg(mod, paths, request_id):
    return mod.ParametricPathSet2(paths=[mod.ParametricPath(**p) for p in paths],
                                  request_id=request_id)


def _same(got, want, what):
    assert (got is None) == (want is None), (what, got, want)
    if got is None:
        return
    for f in ("linear_x", "linear_y", "angular_z"):
        assert abs(getattr(got, f) - getattr(want, f)) <= TOL, (what, f, got, want)


def _same_status(got, want, what):
    assert (got.status, got.request_id) == (want.status, want.request_id), (what, got, want)
    assert abs(got.path_remains - want.path_remains) <= TOL, (what, got, want)


def _same_actual(got, want, what):
    assert (got is None) == (want is None), what
    if got is not None:
        assert abs(got.aux_num0 - want.aux_num0) <= TOL, what
        for g, w in zip(got.paths, want.paths):
            assert (g.frame_id, len(g.cx)) == (w.frame_id, len(w.cx)), what
            np.testing.assert_allclose([*g.cx, *g.cy, *g.ch, g.velocity],
                                       [*w.cx, *w.cy, *w.ch, w.velocity], rtol=0, atol=TOL,
                                       err_msg=what)


class _Plant:
    """A first-order wheel plant in the map frame, Euler-integrated from the
    published Twist (diff/tric: v and w; omni4: v, vn and w)."""

    def __init__(self, pose=(0.0, 0.0, 0.0)):
        self.x = np.array([*pose, 0.0, 0.0, 0.0])     # x, y, theta, v, vn, w

    def meas(self):
        return tuple(self.x[:3]), tuple(self.x[3:])

    def step(self, twist):
        ref = np.zeros(3) if twist is None else np.array(
            [twist.linear_x, twist.linear_y, twist.angular_z])
        for _ in range(5):
            x, y, th, v, vn, w = self.x
            self.x[0] += (v * math.cos(th) - vn * math.sin(th)) * 0.005
            self.x[1] += (v * math.sin(th) + vn * math.cos(th)) * 0.005
            self.x[2] += w * 0.005
            self.x[3:] += (ref - self.x[3:]) / 0.1 * 0.005


def _run(raw, script, plant_pose=(0.0, 0.0, 0.0), transformer=None):
    """Drive both nodes through ``script`` (a list of events: ("tick", n)
    ticks n times; other entries call the callback of that name on both
    nodes with arguments built per package).  Returns the statuses seen."""
    jnode, tnode = _nodes(raw)
    if transformer is not None:
        jnode.frame_transformer = tnode.frame_transformer = transformer
    plant = _Plant(plant_pose)
    seen = []
    for k, (event, *args) in enumerate(script):
        if event != "tick":
            if event == "path":
                paths, rid = args
                jnode.on_path_no_stack_up_2(_path_msg(JR, paths, rid))
                tnode.on_path_no_stack_up_2(_path_msg(TR, paths, rid))
            elif event == "goal":
                jnode.on_pose_goal(JR.PoseStamped(*args))
                tnode.on_pose_goal(TR.PoseStamped(*args))
            elif event == "command":
                assert jnode.on_control_command(*args) == tnode.on_control_command(*args)
            elif event == "steer":
                jnode.set_steering_wheel_angle(*args)
                tnode.set_steering_wheel_angle(*args)
            continue
        n, kw = args[0], args[1] if len(args) > 1 else {}
        for i in range(n):
            pose, vel = plant.meas()
            jt, js = jnode.tick(pose, vel, **kw)
            tt, ts = tnode.tick(pose, vel, **kw)
            what = f"event {k} tick {i}"
            _same(tt, jt, what)
            _same_status(ts, js, what)
            _same_actual(tnode.last_actual_path, jnode.last_actual_path, what)
            assert tnode.required_frame() == jnode.required_frame(), what
            if tt is not None:
                np.testing.assert_allclose(tnode.last_cmd, jnode.last_cmd, rtol=0, atol=TOL)
            seen.append(ts.status)
            plant.step(tt)
    return seen, tnode


def test_config_matches_jax():
    for raw in (DIFF_RAW, OMNI4_RAW, TRIC_RAW):
        assert TR.from_dict(raw).__dict__.keys() == JR.from_dict(raw).__dict__.keys()
        got, want = TR.from_dict(raw), JR.from_dict(raw)
        for f, v in want.__dict__.items():
            g = getattr(got, f)
            assert (g.__dict__ if f == "nav" else g) == (v.__dict__ if f == "nav" else v), f
        assert got.controller_kwargs() == want.controller_kwargs()
    for bad in ({}, {"steering_geometry": "ackermann"},
                {k: v for k, v in DIFF_RAW.items() if k != "rob_dist_between_wh"},
                {**DIFF_RAW, "cost_matrix_weights_state_diag": [1.0, 2.0]},
                {**DIFF_RAW, "discretizer": "spline"}):
        with pytest.raises(ValueError) as jerr:
            JR.from_dict(bad)
        with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
            TR.from_dict(bad)


def test_node_follows_a_path_and_a_goal_as_the_jax_node():
    path = [dict(frame_id="map", cx=[0.0, 0.4, 0.05], cy=[0.0, 0.0], velocity=0.5),
            dict(frame_id="map", cx=[0.45, 0.4], cy=[0.0, 0.1], velocity=0.5)]
    script = [("tick", 2), ("path", path, 42), ("tick", 40), ("command", "go-faster"),
              ("tick", 2), ("command", "break"), ("tick", 2),
              ("goal", "map", 0.3, 0.15, 0.2), ("tick", 25),
              ("tick", 2, dict(vel_valid=False)), ("path", path[1:], 3), ("tick", 3),
              ("command", "idle"), ("tick", 2)]
    seen, tnode = _run(DIFF_RAW, script)
    assert {0, 1, 2} <= set(seen)
    stats = tnode.timing_stats()
    assert stats["cycles"] == len(seen) and stats["p50_ms"] > 0 and stats["budget_ms"] == 25.0


def test_node_frame_change_and_missing_transform_as_the_jax_node():
    """A second curve in another frame: the window rotates into it and both
    nodes require the new frame and re-express the pose alike; a pose in a
    frame with no transform is the tf2-exception path to ERROR."""
    offset = 10.0

    def transformer(pose, src, dst):
        if (src, dst) == ("map", "odom"):
            return (pose[0] + offset, pose[1], pose[2])
        return None

    path = [dict(frame_id="map", cx=[0.0, 0.2], cy=[0.0, 0.0], velocity=0.4),
            dict(frame_id="odom", cx=[10.2, 0.2], cy=[0.0, 0.0], velocity=0.4)]
    script = [("path", path, 1), ("tick", 45, dict(pose_frame="map")),
              ("tick", 2, dict(pose_frame="base"))]
    seen, tnode = _run(DIFF_RAW, script, transformer=transformer)
    assert tnode.required_frame() == "odom" and seen[-1] == 2


@pytest.mark.parametrize("raw", [OMNI4_RAW, TRIC_RAW], ids=["omni4", "tric"])
def test_node_twist_encoding_as_the_jax_node(raw):
    """omni4 publishes linear_y; tric's angular_z carries the measured
    steering angle, even on a stop command (the reference quirk)."""
    path = [dict(frame_id="map", cx=[0.0, 0.5], cy=[0.0, 0.1], velocity=0.4, ch=[0.0, 0.2])]
    script = [("steer", 0.17), ("goal", "map", 0.2, 0.1, 0.1), ("tick", 4),
              ("path", path, 2), ("tick", 4), ("command", "break"), ("tick", 1)]
    _, tnode = _run(raw, script)
    if raw is TRIC_RAW:
        assert tnode.last_cmd is not None


def test_node_reaches_a_goal():
    node = TR.NmpcNavControlNode(TR.from_dict(DIFF_RAW), dtype=torch.float64, device="cpu")
    twist, status = node.tick((0, 0, 0), (0, 0, 0))
    assert twist is None and status.status == 0
    node.on_pose_goal(TR.PoseStamped(frame_id="map", x=0.3, y=0.0, theta=0.0))
    plant = _Plant()
    for _ in range(200):
        twist, status = node.tick(*plant.meas())
        if twist is None:
            break
        plant.step(twist)
    assert status.status == 0 and abs(plant.x[0] - 0.3) < 0.06
    assert not node.on_control_command("go-faster") and node.on_control_command("break")


def test_node_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default works")
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.NmpcNavControlNode(TR.from_dict(DIFF_RAW))
    msg = TR.ParametricPathSet(paths=[TR.ParametricPath(frame_id="map", cx=[0, 1], cy=[0])])
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda|NVIDIA"):
        TR.decode_path_set(msg, TR.FrameTable(), 4)
