"""The port's ROS bridge converters against the JAX package's.

Neither machine has ROS, so the bridge's pure conversions are compared on
duck-typed messages (``SimpleNamespace`` and small classes with the
reference's wire field layout, ``NMPCNavControlROS.cpp:304-399``): the
quaternion helpers, the ``*_from_ros`` and ``*_to_ros`` converters with the
wire names ``PathSet``, ``AuxNum0`` and ``patch_remains``, and the
namespace resolution.  Each gives the same result through both packages.

The port's deploy entry points: the ROS wrapper scripts
``examples/ros/scripts/ros_bridge_torch_{main,prepare}`` hand their argv,
``--device`` included, to the port's ``main``/``main_prepare`` (stubbed, as
neither machine has a ROS master); the port's launch files name those
scripts and hand a ``device`` argument (default ``cuda``) to ``--device``;
the ``[project.scripts]`` of ``pyproject.toml`` resolve to the port's
callables beside the JAX package's three, whose wrappers stay as they are.
"""
import importlib
import math
import os
import runpy
import sys
import tomllib
import types
import warnings
import xml.etree.ElementTree as ET

import numpy as np
import pytest

import nmpc_nav_control_tpu.runtime.messages as jmsg
import nmpc_nav_control_tpu.runtime.ros_bridge as jrb
import nmpc_nav_control_tpu_torch.runtime.messages as tmsg
import nmpc_nav_control_tpu_torch.runtime.ros_bridge as trb

BRIDGES = ((trb, tmsg), (jrb, jmsg))


def _ns(**kw):
    return types.SimpleNamespace(**kw)


def _fields(x):
    """A message or dataclass as nested plain values, for comparison."""
    if isinstance(x, (list, tuple)):
        return [_fields(v) for v in x]
    if hasattr(x, "__dict__"):
        return {k: _fields(v) for k, v in vars(x).items()}
    return x


def test_quaternions_match_jax():
    rng = np.random.default_rng(0)
    for yaw in rng.uniform(-math.pi, math.pi, 50):
        assert trb.yaw_to_quat(yaw) == jrb.yaw_to_quat(yaw)
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        assert trb.quat_to_yaw(*q) == jrb.quat_to_yaw(*q)
        assert trb.quat_to_yaw(*trb.yaw_to_quat(yaw)) == pytest.approx(yaw, abs=1e-12)


def _wire_path(frame="odom", vel=-0.5, **kw):
    return _ns(cx=[0.0, 1.0], cy=[0.0, 0.5], ch=[0.1], velocity=vel, frame_id=frame, **kw)


def test_from_ros_matches_jax():
    qx, qy, qz, qw = trb.yaw_to_quat(0.7)
    goal = _ns(header=_ns(frame_id="map"),
               pose=_ns(position=_ns(x=1.5, y=-2.0, z=0.0),
                        orientation=_ns(x=qx, y=qy, z=qz, w=qw)))
    header_frame = _ns(cx=[1.0, 2.0], cy=[3.0], header=_ns(frame_id="base"))
    msg = _ns(PathSet=[_wire_path(), _wire_path("map", 1.0), header_frame], AuxNum0=0.25)
    msg2 = _ns(PathSet=[_wire_path()], AuxNum0=0.0, request_id=7)
    (t, _), (j, _) = BRIDGES
    assert _fields(t.pose_stamped_from_ros(goal)) == _fields(j.pose_stamped_from_ros(goal))
    got, want = t.path_set_from_ros(msg), j.path_set_from_ros(msg)
    assert _fields(got) == _fields(want)
    assert got.aux_num0 == 0.25 and got.paths[2].frame_id == "base"
    assert got.paths[2].ch == [0.0] and got.paths[2].velocity == 1.0
    assert _fields(t.path_set2_from_ros(msg2)) == _fields(j.path_set2_from_ros(msg2))
    assert t.path_set2_from_ros(msg2).request_id == 7


class _RosPathSet:
    def __init__(self):
        self.PathSet = []
        self.AuxNum0 = 0.0


class _RosPath:
    def __init__(self):
        self.frame_id, self.cx, self.cy, self.ch, self.velocity = "", [], [], [], 0.0


class _RosStatus:
    def __init__(self):
        self.status, self.request_id, self.patch_remains = 0, 0, 0.0


class _RosTwist:
    def __init__(self):
        self.linear = _ns(x=0.0, y=0.0, z=0.0)
        self.angular = _ns(x=0.0, y=0.0, z=0.0)


class _RosPosePath:
    def __init__(self):
        self.header = _ns(frame_id="", stamp=None)
        self.poses = []


class _RosPoseStamped:
    def __init__(self):
        self.header = _ns(frame_id="", stamp=None)
        self.pose = _ns(position=_ns(x=0.0, y=0.0, z=0.0),
                        orientation=_ns(x=0.0, y=0.0, z=0.0, w=1.0))


def test_to_ros_matches_jax():
    out = []
    for rb, msgs in BRIDGES:
        paths = [msgs.ParametricPath("map", [0, 1], [0, 2], 0.8, ch=[0.3]),
                 msgs.ParametricPath("odom", [1], [2], -0.4)]
        ps = msgs.ParametricPathSet(paths=paths, aux_num0=0.4)
        path_msg = rb.path_set_to_ros(ps, _RosPathSet, _RosPath)
        status = rb.status_to_ros(msgs.ControlStatus(status=1, request_id=3, path_remains=2.5),
                                  _RosStatus)
        twist = rb.twist_to_ros(msgs.Twist(linear_x=0.3, linear_y=-0.1, angular_z=0.9),
                                _RosTwist)
        poses = np.asarray([[0.0, 0.0, 0.0], [1.0, 2.0, math.pi / 2], [-1.0, 0.5, -3.0]])
        pose_path = rb.pose_path_to_ros("map", poses, _RosPosePath, _RosPoseStamped, stamp=123)
        out.append((_fields(path_msg), _fields(status), _fields(twist), _fields(pose_path),
                    _fields(rb.path_set_from_ros(path_msg))))
    assert out[0] == out[1]
    path_msg, status, _, pose_path, back = out[0]
    assert path_msg["AuxNum0"] == 0.4 and len(path_msg["PathSet"]) == 2
    assert status == {"status": 1, "request_id": 3, "patch_remains": 2.5}
    assert len(pose_path["poses"]) == 3 and back["paths"][1]["frame_id"] == "odom"


def test_namespace_matches_jax(monkeypatch):
    for explicit, env in (("", {}), ("", {"ROBOT_ID": "amr_07"}),
                          ("explicit", {"ROBOT_ID": "amr_07"}), ("", {"ROBOT_ID": ""})):
        assert trb.resolve_namespace(explicit, env=env) == jrb.resolve_namespace(explicit, env=env)
    assert trb.resolve_namespace("", env={}) == "unnamed_robot"
    for explicit in (False, True):
        seen = []
        for rb in (trb, jrb):
            monkeypatch.setenv("ROS_NAMESPACE", "pre_set")
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                rb._apply_namespace("amr_07", explicit=explicit)
            seen.append((os.environ["ROS_NAMESPACE"], [str(x.message) for x in w]))
        assert seen[0] == seen[1]
        assert seen[0][0] == ("amr_07" if explicit else "pre_set")
    monkeypatch.delenv("ROS_NAMESPACE")
    trb._apply_namespace("")
    assert "ROS_NAMESPACE" not in os.environ
    assert trb.available() is jrb.available() is False


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROS = os.path.join(ROOT, "examples", "ros")


@pytest.mark.parametrize("script,entry,argv", [
    ("ros_bridge_torch_main", "main",
     ["config/runtime_diff.yaml", "--namespace", "amr_07", "--device", "cpu"]),
    ("ros_bridge_torch_prepare", "main_prepare", ["config/models.yaml", "--device", "cpu"]),
])
def test_ros_wrapper_scripts_hand_over_their_argv(monkeypatch, script, entry, argv):
    seen = []

    def stub(argv=None):
        seen.append((argv, list(sys.argv)))
        return 0

    monkeypatch.setattr(trb, entry, stub)
    path = os.path.join(ROS, "scripts", script)
    monkeypatch.setattr(sys, "argv", [path] + argv)
    with pytest.raises(SystemExit) as done:
        runpy.run_path(path, run_name="__main__")
    assert done.value.code == 0
    assert seen == [(None, [path] + argv)]
    assert os.access(path, os.X_OK)
    assert "nmpc_nav_control_tpu.runtime" in open(os.path.join(ROS, "scripts",
                                                               script.replace("_torch", ""))).read()


@pytest.mark.parametrize("launch,script", [
    ("run_nmpc_nav_control_torch.launch", "ros_bridge_torch_main"),
    ("run_nmpc_nav_control_generate_libs_torch.launch", "ros_bridge_torch_prepare"),
])
def test_torch_launch_files_start_the_port(launch, script):
    root = ET.parse(os.path.join(ROS, "launch", launch)).getroot()
    args = {a.get("name"): a.get("default") for a in root.iter("arg")}
    assert args["device"] == "cuda"
    (node,) = root.iter("node")
    assert node.get("type") == script and node.get("pkg") == "nmpc_nav_control_tpu"
    assert node.get("args").endswith("--device $(arg device)")
    cmake = open(os.path.join(ROS, "CMakeLists.txt")).read()
    assert f"scripts/{script}" in cmake and "scripts/ros_bridge_main" in cmake
    jax_launch = ET.parse(os.path.join(ROS, "launch", launch.replace("_torch", ""))).getroot()
    assert next(jax_launch.iter("node")).get("type") == script.replace("_torch", "")


def test_console_scripts_resolve_to_the_port():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    want = {"nmpc-nav-control-tpu-torch": "nmpc_nav_control_tpu_torch.__main__:main",
            "nmpc-nav-control-tpu-torch-ros": "nmpc_nav_control_tpu_torch.runtime.ros_bridge:main",
            "nmpc-nav-control-tpu-torch-ros-prepare":
                "nmpc_nav_control_tpu_torch.runtime.ros_bridge:main_prepare"}
    for name, target in want.items():
        assert scripts[name] == target
        module, attr = target.split(":")
        fn = getattr(importlib.import_module(module), attr)
        assert callable(fn) and fn.__module__ == module
    for name in ("nmpc-nav-control-tpu", "nmpc-nav-control-tpu-ros",
                 "nmpc-nav-control-tpu-ros-prepare"):
        assert scripts[name].startswith("nmpc_nav_control_tpu.")
