"""Optional ROS1 bridge: the thin serialization shim over the host node.

The framework's runtime layer is ROS-free (``runtime/messages.py`` carries
ROS-shaped dataclasses; ``runtime/node.py`` is the ``NMPCNavControlROS``
equivalent).  This module is the actual bridge for deployments that DO run
ROS1: it maps wire messages <-> dataclasses and wires tf2-based state
acquisition, reproducing the reference node's topic surface
(reference ``src/nmpc_nav_control/NMPCNavControlROS.cpp:23-41``):

  subscribes  pose_goal (geometry_msgs/PoseStamped),
              path_no_stack_up (itrci_nav/ParametricPathSet),
              path_no_stack_up_2 (itrci_nav/ParametricPathSet2),
              control_command (std_msgs/String)
  publishes   cmd_vel (geometry_msgs/Twist),
              control_status (itrci_nav/parametric_trajectories_control_status),
              actual_path (itrci_nav/ParametricPathSet),
              debug_discretized_path (nav_msgs/Path)

Wire field names follow the reference exactly: ``PathSet`` + ``AuxNum0`` on
the path sets (``:322-323,396-397``), ``status`` / ``request_id`` /
``patch_remains`` (sic) on the status message (``:376-378``).

Everything ROS-specific is imported lazily so this module (and its pure
conversion helpers, unit-tested on CPU) imports cleanly in ROS-less
environments; ``available()`` gates the runtime pieces.  The itrci_nav
message classes only exist inside a catkin workspace — the bridge resolves
them at start-up and fails with a clear error otherwise.

Port of ``nmpc_nav_control_tpu/runtime/ros_bridge.py``: the same converters
and bridge, wired to the port's node (graphed on the card unless the
``--device cpu`` flag of ``main`` asks for the CPU) and solver preparation.
"""
from __future__ import annotations

import math
from typing import Optional

from nmpc_nav_control_tpu_torch.runtime.messages import (
    ControlStatus,
    ParametricPath,
    ParametricPathSet,
    ParametricPathSet2,
    PoseStamped,
    Twist,
)

__all__ = [
    "available",
    "quat_to_yaw",
    "yaw_to_quat",
    "pose_stamped_from_ros",
    "path_set_from_ros",
    "path_set2_from_ros",
    "path_set_to_ros",
    "status_to_ros",
    "twist_to_ros",
    "RosBridge",
    "resolve_namespace",
    "main",
    "main_prepare",
]


def available() -> bool:
    """True when rospy is importable (a sourced ROS1 environment)."""
    try:
        import rospy  # noqa: F401
        return True
    except Exception:
        return False


# --------------------------------------------------------------------------- #
# Pure conversions (duck-typed against the ROS message field layout, so they
# are unit-testable without rospy)
# --------------------------------------------------------------------------- #


def quat_to_yaw(x: float, y: float, z: float, w: float) -> float:
    """Planar yaw from a quaternion (the ``tf2::getYaw`` the reference uses
    on ``goal_pose_`` / TF transforms, ``NMPCNavControlROS.cpp:633,411``)."""
    return math.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def yaw_to_quat(yaw: float):
    """(x, y, z, w) quaternion for a planar yaw."""
    return (0.0, 0.0, math.sin(yaw / 2.0), math.cos(yaw / 2.0))


def pose_stamped_from_ros(msg) -> PoseStamped:
    """geometry_msgs/PoseStamped -> dataclass (quaternion -> yaw)."""
    q = msg.pose.orientation
    return PoseStamped(
        frame_id=msg.header.frame_id,
        x=msg.pose.position.x,
        y=msg.pose.position.y,
        theta=quat_to_yaw(q.x, q.y, q.z, q.w),
    )


def _path_from_ros(p) -> ParametricPath:
    """itrci_nav/ParametricPath -> dataclass.

    The wire curve is the polynomial-coefficient parameterization evaluated
    by ``parametric_trajectories_common::TPath`` (``PathDiscretizer.cpp:
    76-102`` uses GetX/GetY/GetTheta over u in [0,1]); the message carries
    the x/y(/heading) coefficient arrays, nominal signed velocity and frame.
    """
    return ParametricPath(
        frame_id=getattr(p, "frame_id", "") or getattr(
            getattr(p, "header", None), "frame_id", ""),
        cx=list(p.cx),
        cy=list(p.cy),
        ch=list(getattr(p, "ch", (0.0,)) or (0.0,)),
        velocity=float(getattr(p, "velocity", 1.0)),
    )


def path_set_from_ros(msg) -> ParametricPathSet:
    """itrci_nav/ParametricPathSet -> dataclass (``PathSet``/``AuxNum0``,
    field names per ``NMPCNavControlROS.cpp:322-323``)."""
    return ParametricPathSet(
        paths=[_path_from_ros(p) for p in msg.PathSet],
        aux_num0=float(getattr(msg, "AuxNum0", 0.0)),
    )


def path_set2_from_ros(msg) -> ParametricPathSet2:
    """itrci_nav/ParametricPathSet2 -> dataclass (adds ``request_id``,
    ``:324``)."""
    return ParametricPathSet2(
        paths=[_path_from_ros(p) for p in msg.PathSet],
        aux_num0=float(getattr(msg, "AuxNum0", 0.0)),
        request_id=int(msg.request_id),
    )


def path_set_to_ros(ps: ParametricPathSet, set_cls, path_cls):
    """dataclass -> itrci_nav/ParametricPathSet (the ``pubActualPath``
    payload: one curve + ``AuxNum0`` = u, ``:390-399``)."""
    msg = set_cls()
    for p in ps.paths:
        pm = path_cls()
        pm.frame_id = p.frame_id
        pm.cx = list(p.cx)
        pm.cy = list(p.cy)
        pm.ch = list(p.ch)
        pm.velocity = p.velocity
        msg.PathSet.append(pm)
    msg.AuxNum0 = ps.aux_num0
    return msg


def status_to_ros(st: ControlStatus, status_cls):
    """dataclass -> itrci_nav/parametric_trajectories_control_status.

    Field names per ``pubControlStatus`` (``:364-388``): ``status``,
    ``request_id``, ``patch_remains`` (sic — the reference's typo is the wire
    contract)."""
    msg = status_cls()
    msg.status = st.status
    msg.request_id = st.request_id
    msg.patch_remains = st.path_remains
    return msg


def twist_to_ros(tw: Twist, twist_cls):
    """dataclass -> geometry_msgs/Twist (``pubCmdVel``, ``:338-362``)."""
    msg = twist_cls()
    msg.linear.x = tw.linear_x
    msg.linear.y = tw.linear_y
    msg.angular.z = tw.angular_z
    return msg


def pose_path_to_ros(frame_id: str, poses, path_cls, pose_stamped_cls, stamp):
    """[n, 3] poses -> nav_msgs/Path (``pubDebugDiscretizedPath``,
    ``:722-738``)."""
    msg = path_cls()
    msg.header.frame_id = frame_id
    msg.header.stamp = stamp
    for x, y, theta in poses:
        pm = pose_stamped_cls()
        pm.header.frame_id = frame_id
        pm.header.stamp = stamp
        pm.pose.position.x = float(x)
        pm.pose.position.y = float(y)
        qx, qy, qz, qw = yaw_to_quat(float(theta))
        pm.pose.orientation.x = qx
        pm.pose.orientation.y = qy
        pm.pose.orientation.z = qz
        pm.pose.orientation.w = qw
        msg.poses.append(pm)
    return msg


# --------------------------------------------------------------------------- #
# Runtime bridge (requires rospy + itrci_nav at construction time)
# --------------------------------------------------------------------------- #


class RosBridge:
    """Wires a :class:`~nmpc_nav_control_tpu_torch.runtime.node.NmpcNavControlNode`
    to live ROS1 topics + tf2, mirroring the reference node's I/O surface.

    State acquisition follows ``getRobotPose``/``getRobotVel``
    (``:401-484``): the pose is the tf2 transform of ``base_frame_id`` in the
    tick's required frame (goal frame / front-active-curve frame), theta
    unwrapped against last tick; velocity is finite-differenced through
    ``TfStateProvider``; for tric, the steering angle is the yaw of
    ``steering_wheel_frame_id`` in the base frame (``:486-506``).
    """

    def __init__(self, node, queue_size: int = 10):
        import rospy
        import tf2_ros
        from geometry_msgs.msg import Twist as RosTwist
        from geometry_msgs.msg import PoseStamped as RosPoseStamped
        from nav_msgs.msg import Path as RosPath
        from std_msgs.msg import String
        try:
            from itrci_nav.msg import (
                ParametricPathSet as RosPathSet,
                ParametricPathSet2 as RosPathSet2,
                ParametricPath as RosPath1,
                parametric_trajectories_control_status as RosStatus,
            )
        except ImportError as e:  # pragma: no cover - needs catkin workspace
            raise ImportError(
                "itrci_nav messages not found: the bridge must run inside "
                "the robot's catkin workspace (see reference package.xml)"
            ) from e

        self._rospy = rospy
        self.node = node
        self._classes = dict(
            twist=RosTwist, path_set=RosPathSet, path=RosPath1,
            status=RosStatus, pose_path=RosPath,
            pose_stamped=RosPoseStamped,
        )
        cfg = node.config

        # tf2 state acquisition (2 s buffer fill like the reference ctor
        # sleep, ``:38-40``, happens naturally before the first timer tick).
        self._tf_buffer = tf2_ros.Buffer()
        self._tf_listener = tf2_ros.TransformListener(self._tf_buffer)
        node.frame_transformer = self._transform_pose

        from nmpc_nav_control_tpu_torch.runtime.ingest import (
            StampedPose, TfStateProvider,
        )
        self._StampedPose = StampedPose
        self._provider = TfStateProvider(
            self._lookup_pose,
            transform_timeout=cfg.transform_timeout,
            clock=lambda: rospy.Time.now().to_sec(),
        )

        # Publishers / subscribers (names + queue depths per ``:23-34``).
        self._pub_cmd = rospy.Publisher("cmd_vel", RosTwist,
                                        queue_size=queue_size)
        self._pub_status = rospy.Publisher("control_status", RosStatus,
                                           queue_size=queue_size)
        self._pub_actual = rospy.Publisher("actual_path", RosPathSet,
                                           queue_size=queue_size)
        self._pub_debug = rospy.Publisher("debug_discretized_path", RosPath,
                                          queue_size=queue_size)
        rospy.Subscriber("pose_goal", RosPoseStamped,
                         self._on_pose_goal, queue_size=queue_size)
        rospy.Subscriber("path_no_stack_up", RosPathSet,
                         self._on_path, queue_size=queue_size)
        rospy.Subscriber("path_no_stack_up_2", RosPathSet2,
                         self._on_path2, queue_size=queue_size)
        rospy.Subscriber("control_command", String,
                         self._on_command, queue_size=queue_size)
        self._timer = rospy.Timer(rospy.Duration(cfg.dt), self._on_timer)

    # ---- subscriber callbacks ---- #

    def _on_pose_goal(self, msg):
        self.node.on_pose_goal(pose_stamped_from_ros(msg))

    def _on_path(self, msg):
        self.node.on_path_no_stack_up(path_set_from_ros(msg))

    def _on_path2(self, msg):
        self.node.on_path_no_stack_up_2(path_set2_from_ros(msg))

    def _on_command(self, msg):
        self.node.on_control_command(msg.data)

    # ---- tf2 acquisition ---- #

    def _lookup_pose(self):
        """base_frame pose in the tick's required frame (``:401-436``)."""
        cfg = self.node.config
        frame = self.node.required_frame()
        tf = self._tf_buffer.lookup_transform(
            frame, cfg.base_frame_id, self._rospy.Time(0))
        q = tf.transform.rotation
        return self._StampedPose(
            t=tf.header.stamp.to_sec(),
            x=tf.transform.translation.x,
            y=tf.transform.translation.y,
            theta=quat_to_yaw(q.x, q.y, q.z, q.w),
        ), frame

    def _transform_pose(self, pose, from_frame: str, to_frame: str):
        """Re-express (x, y, theta) in another frame (static planar frames)."""
        try:
            tf = self._tf_buffer.lookup_transform(
                to_frame, from_frame, self._rospy.Time(0))
        except Exception:
            return None
        q = tf.transform.rotation
        yaw = quat_to_yaw(q.x, q.y, q.z, q.w)
        c, s = math.cos(yaw), math.sin(yaw)
        x = tf.transform.translation.x + c * pose[0] - s * pose[1]
        y = tf.transform.translation.y + s * pose[0] + c * pose[1]
        return (x, y, pose[2] + yaw)

    def _steering_angle(self) -> Optional[float]:
        """Yaw of the steering-wheel frame in the base frame (``:486-506``)."""
        cfg = self.node.config
        wheel = getattr(cfg, "steering_wheel_frame_id", "")
        if not wheel:
            return None
        try:
            tf = self._tf_buffer.lookup_transform(
                cfg.base_frame_id, wheel, self._rospy.Time(0))
        except Exception:
            return None
        q = tf.transform.rotation
        return quat_to_yaw(q.x, q.y, q.z, q.w)

    # ---- timer tick ---- #

    def _on_timer(self, _event):
        rospy = self._rospy
        try:
            out = self._provider.get_state()
        except Exception:
            out = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), False,
                   self.node.required_frame())
        pose, vel, valid, frame = out
        steer_valid = True
        if self.node.spec.geometry == "tric":
            angle = self._steering_angle()
            if angle is None:
                steer_valid = False
            else:
                self.node.set_steering_wheel_angle(angle)
        twist, status = self.node.tick(
            pose, vel, pose_valid=valid, vel_valid=valid,
            steer_valid=steer_valid, pose_frame=frame,
        )
        cls = self._classes
        if twist is not None:
            self._pub_cmd.publish(twist_to_ros(twist, cls["twist"]))
        self._pub_status.publish(status_to_ros(status, cls["status"]))
        if self.node.last_actual_path is not None:
            self._pub_actual.publish(path_set_to_ros(
                self.node.last_actual_path, cls["path_set"], cls["path"]))
        if self.node.debug_outputs and self.node.last_debug_path is not None:
            self._pub_debug.publish(pose_path_to_ros(
                self.node.required_frame(), self.node.last_debug_path,
                cls["pose_path"], cls["pose_stamped"], rospy.Time.now()))


def resolve_namespace(explicit: str = "", env=None) -> str:
    """Per-robot namespace resolution (``ROBOT_ID`` convention).

    The reference launch file namespaces every node under the ``ROBOT_ID``
    environment variable with an ``unnamed_robot`` fallback
    (``launch/run_nmpc_nav_control.launch:2-4``:
    ``$(optenv ROBOT_ID unnamed_robot)``) so several robots' controllers can
    coexist on one ROS master — and so two robots with UNSET ``ROBOT_ID``
    still collide visibly under ``unnamed_robot`` rather than silently on
    global topic names.  Mirrored here: an explicit ``--namespace`` wins,
    else ``$ROBOT_ID``, else ``unnamed_robot``.  The bridge applies it
    through ``ROS_NAMESPACE`` before ``init_node`` so all topic names
    (cmd_vel, control_status, ...) resolve under the robot's prefix.
    """
    import os

    env = os.environ if env is None else env
    return explicit or env.get("ROBOT_ID", "") or "unnamed_robot"


def _apply_namespace(ns: str, explicit: bool = False) -> None:
    """Set ``ROS_NAMESPACE`` to ``ns``.

    An explicit ``--namespace`` OVERWRITES a pre-existing ``ROS_NAMESPACE``
    (with a warning on conflict); otherwise a pre-set ``ROS_NAMESPACE``
    (e.g. from a launch-file ``<group ns=...>``) is left in charge.
    """
    import os

    if not ns:
        return
    current = os.environ.get("ROS_NAMESPACE")
    if current and current != ns:
        if not explicit:
            return
        import warnings

        warnings.warn(
            f"--namespace {ns!r} overrides pre-set ROS_NAMESPACE {current!r}",
            stacklevel=2)
    os.environ["ROS_NAMESPACE"] = ns


def main(argv=None):  # pragma: no cover - requires a live ROS master
    """``rosrun``-style entry: load the runtime YAML, spin the bridge."""
    import argparse

    from nmpc_nav_control_tpu_torch.runtime.config import load_config
    from nmpc_nav_control_tpu_torch.runtime.node import NmpcNavControlNode

    ap = argparse.ArgumentParser()
    ap.add_argument("config", help="runtime YAML (nmpc_nav_control.yaml schema)")
    ap.add_argument("--debug-outputs", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--namespace", default="",
                    help="per-robot namespace (defaults to $ROBOT_ID, the "
                         "reference launch convention)")
    args = ap.parse_args(argv)

    _apply_namespace(resolve_namespace(args.namespace),
                     explicit=bool(args.namespace))
    import rospy

    rospy.init_node("nmpc_nav_control_tpu_torch")
    node = NmpcNavControlNode(load_config(args.config), device=args.device,
                              debug_outputs=args.debug_outputs)
    RosBridge(node)
    rospy.spin()


def main_prepare(argv=None):  # pragma: no cover - requires a live ROS master
    """ROS-wrapped solver preparation (the ``generate_acados_libs_ros.py``
    analog, reference ``scripts/generate_acados_libs_ros.py:11-54`` +
    ``launch/run_nmpc_nav_control_generate_libs.launch:2-3``).

    Runs the same preparation as the CLI ``prepare`` subcommand — build each
    geometry's controller from the models YAML, build the kernels and
    capture one tick on the card, smoke-solve — inside a rospy node so
    deployments can trigger it from a launch file, with progress on the ROS
    log.  The YAML path comes from the ``~models_config`` private param or
    the first positional argument.
    """
    import argparse

    from nmpc_nav_control_tpu_torch.runtime.models_config import prepare_solvers

    ap = argparse.ArgumentParser()
    ap.add_argument("models_config", nargs="?", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--namespace", default="")
    args = ap.parse_args(argv)

    _apply_namespace(resolve_namespace(args.namespace),
                     explicit=bool(args.namespace))
    import rospy

    rospy.init_node("nmpc_nav_control_tpu_torch_generate_solvers")
    path = args.models_config or rospy.get_param("~models_config")
    rospy.loginfo("preparing solvers from %s", path)
    try:
        built = prepare_solvers(path, device=args.device, log=rospy.loginfo)
    except Exception as e:
        rospy.logerr("solver preparation failed: %s", e)
        raise
    rospy.loginfo("prepared %d solver(s): %s", len(built),
                  ", ".join(sorted(built)))


if __name__ == "__main__":  # pragma: no cover
    main()
