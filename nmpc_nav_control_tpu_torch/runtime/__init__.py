"""Host runtime of the port: config, messages and the single-robot node.

The JAX package's ``executor``, ``ingest``, ``simulation``, ``checkpoint``,
``native``, ``models_config``, ``ros_bridge`` and ``aot`` are not ported
yet (``ROADMAP.md``)."""
from nmpc_nav_control_tpu_torch.runtime.config import RobotConfig, from_dict, load_config
from nmpc_nav_control_tpu_torch.runtime.messages import (
    ControlStatus,
    FrameTable,
    ParametricPath,
    ParametricPathSet,
    ParametricPathSet2,
    PoseStamped,
    PosePath,
    Twist,
    decode_path_set,
    encode_path,
    encode_path_set,
)
from nmpc_nav_control_tpu_torch.runtime.node import NmpcNavControlNode

__all__ = [
    "ControlStatus",
    "FrameTable",
    "NmpcNavControlNode",
    "ParametricPath",
    "ParametricPathSet",
    "ParametricPathSet2",
    "PoseStamped",
    "PosePath",
    "RobotConfig",
    "Twist",
    "decode_path_set",
    "encode_path",
    "encode_path_set",
    "from_dict",
    "load_config",
]
