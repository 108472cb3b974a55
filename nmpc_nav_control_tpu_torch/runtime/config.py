"""Configuration schema and loader.

One YAML schema covering both of the reference's files — the runtime params
(``config/nmpc_nav_control.yaml``, read imperatively in ``readParam``,
``NMPCNavControlROS.cpp:44-302``) and the offline codegen params
(``config/nmpc_nav_control_acados_models.yaml``, read by
``scripts/*/common.py``).  No codegen step exists here, so the two collapse
into a single runtime config; keys keep the reference names.

Validation mirrors ``readParam``: required keys per geometry, Q/R diagonal
length checks, deg->rad conversions at load time
(``NMPCNavControlROS.cpp:59,65,243-245``).

Port of ``nmpc_nav_control_tpu/runtime/config.py`` (JAX-free itself, but
importing it would run the JAX package's ``__init__``), with ``NavConfig``
from the port's state machine.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

from nmpc_nav_control_tpu_torch.control.state_machine import NavConfig

__all__ = ["RobotConfig", "load_config", "from_dict"]

_GEOMETRY_KEYS = {
    "diff": ["rob_dist_between_wh", "rob_wh_vel_time_const", "rob_wh_max_vel",
             "rob_wh_max_ace", "cost_matrix_weights_state_diag",
             "cost_matrix_weights_input_diag"],
    "omni4": ["rob_dist_between_front_back_wh", "rob_dist_between_left_right_wh",
              "rob_wh_vel_time_const", "rob_wh_max_vel", "rob_wh_max_ace",
              "cost_matrix_weights_state_diag", "cost_matrix_weights_input_diag"],
    "tric": ["steering_wheel_frame_id", "rob_dist_between_steering_back_wh",
             "rob_wh_vel_time_const", "rob_steer_wh_angle_time_const",
             "rob_wh_max_vel", "rob_wh_max_ace", "rob_steer_wh_min_angle",
             "rob_steer_wh_max_angle", "rob_steer_wh_max_angle_var",
             "cost_matrix_weights_state_diag", "cost_matrix_weights_input_diag"],
}
_Q_LEN = {"diff": 7, "omni4": 11, "tric": 7}
_R_LEN = {"diff": 2, "omni4": 4, "tric": 2}


@dataclasses.dataclass(frozen=True)
class RobotConfig:
    """Full parsed configuration for one controller instance."""

    steering_geometry: str
    global_frame_id: str = "map"
    base_frame_id: str = "base_footprint"
    steering_wheel_frame_id: str = ""
    control_freq: int = 40
    transform_timeout: float = 0.1
    tf_ini: float = 2.0                      # prediction horizon seconds
    nav: NavConfig = dataclasses.field(default_factory=NavConfig)
    # Geometry-dependent physics (radians after load).
    dist_b: float | None = None
    l1_plus_l2: float | None = None
    dist_d: float | None = None
    tau_v: float = 0.1
    tau_a: float = 0.5
    v_max: float = 1.0
    a_max: float = 1.0
    alpha_min: float | None = None
    alpha_max: float | None = None
    dalpha_max: float | None = None
    q_diag: Sequence[float] = ()
    r_diag: Sequence[float] = ()

    @property
    def dt(self) -> float:
        return 1.0 / float(self.control_freq)

    @property
    def horizon(self) -> int:
        """N = ceil(tf_ini / dt) (``scripts/*/common.py:5-10``)."""
        return int(math.ceil(self.tf_ini / self.dt))

    def controller_kwargs(self) -> dict:
        """kwargs for ``control.make_controller``."""
        kw: dict[str, Any] = dict(
            tau_v=self.tau_v, v_max=self.v_max, a_max=self.a_max,
            q_diag=list(self.q_diag), r_diag=list(self.r_diag),
        )
        if self.steering_geometry == "diff":
            kw["dist_b"] = self.dist_b
        elif self.steering_geometry == "omni4":
            kw["l1_plus_l2"] = self.l1_plus_l2
        else:
            kw.update(
                dist_d=self.dist_d, tau_a=self.tau_a,
                alpha_min=self.alpha_min, alpha_max=self.alpha_max,
                dalpha_max=self.dalpha_max,
            )
        return kw


def from_dict(raw: Mapping[str, Any]) -> RobotConfig:
    """Parse + validate a config mapping (the ``readParam`` analog)."""
    if "steering_geometry" not in raw:
        raise ValueError(
            "The nmpc_nav_control configuration requires the definition of the "
            "steering_geometry parameter"
        )
    geom = str(raw["steering_geometry"])
    if geom not in _GEOMETRY_KEYS:
        raise ValueError(
            f"Invalid steering_geometry {geom!r} (supported: diff, omni4, tric)"
        )
    missing = [k for k in _GEOMETRY_KEYS[geom] if k not in raw]
    if missing:
        raise ValueError(
            f"The steering geometry {geom} requires the definition of the "
            f"following parameters: {', '.join(missing)}"
        )

    q = [float(v) for v in raw["cost_matrix_weights_state_diag"]]
    r = [float(v) for v in raw["cost_matrix_weights_input_diag"]]
    if len(q) != _Q_LEN[geom]:
        raise ValueError(
            f"Parameter 'cost_matrix_weights_state_diag' must be an array of "
            f"{_Q_LEN[geom]} numeric values."
        )
    if len(r) != _R_LEN[geom]:
        raise ValueError(
            f"Parameter 'cost_matrix_weights_input_diag' must be an array of "
            f"{_R_LEN[geom]} numeric values."
        )

    deg = math.pi / 180.0
    nav = NavConfig(
        final_position_error=float(raw.get("final_position_error", 0.01)),
        final_orientation_error=float(raw.get("final_orientation_error", 1.0)) * deg,
        enable_safe_conditions=bool(raw.get("enable_safe_conditions", True)),
        max_goal_pose_dist=float(raw.get("max_goal_pose_dist", 2.0)),
        max_pos_error_to_path=float(raw.get("max_pos_error_to_path", 0.5)),
        max_ori_error_to_path=float(raw.get("max_ori_error_to_path", 60.0)) * deg,
        max_active_path_length=float(raw.get("max_active_path_length", 5.0)),
        path_capacity=int(raw.get("path_capacity", 16)),
        discretizer=str(raw.get("discretizer", "fast")),
    )
    if nav.discretizer not in ("fast", "march"):
        raise ValueError(
            f"Invalid discretizer {nav.discretizer!r} (supported: fast, march)"
        )

    kw: dict[str, Any] = dict(
        steering_geometry=geom,
        global_frame_id=str(raw.get("global_frame_id", "map")),
        base_frame_id=str(raw.get("base_frame_id", "base_footprint")),
        control_freq=int(raw.get("control_freq", 40)),
        transform_timeout=float(raw.get("transform_timeout", 0.1)),
        tf_ini=float(raw.get("tf_ini", 2.0)),
        nav=nav,
        tau_v=float(raw["rob_wh_vel_time_const"]),
        v_max=float(raw["rob_wh_max_vel"]),
        a_max=float(raw["rob_wh_max_ace"]),
        q_diag=tuple(q),
        r_diag=tuple(r),
    )
    if geom == "diff":
        kw["dist_b"] = float(raw["rob_dist_between_wh"])
    elif geom == "omni4":
        kw["l1_plus_l2"] = (
            float(raw["rob_dist_between_front_back_wh"])
            + float(raw["rob_dist_between_left_right_wh"])
        )
    else:
        kw.update(
            steering_wheel_frame_id=str(raw["steering_wheel_frame_id"]),
            dist_d=float(raw["rob_dist_between_steering_back_wh"]),
            tau_a=float(raw["rob_steer_wh_angle_time_const"]),
            alpha_min=float(raw["rob_steer_wh_min_angle"]) * deg,
            alpha_max=float(raw["rob_steer_wh_max_angle"]) * deg,
            dalpha_max=float(raw["rob_steer_wh_max_angle_var"]) * deg,
        )
    return RobotConfig(**kw)


def load_config(path: str) -> RobotConfig:
    """Load a YAML config file."""
    import yaml

    with open(path) as fh:
        raw = yaml.safe_load(fh)
    return from_dict(raw)
