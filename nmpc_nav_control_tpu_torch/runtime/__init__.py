"""Host runtime of the port: config, messages, the single-robot node, the
fixed-rate executor, the models config and solver preparation.

The modules ``ingest``, ``simulation``, ``checkpoint``, ``native`` and
``ros_bridge`` are imported by name.  The JAX package's ``aot`` is not
ported yet (``ROADMAP.md``)."""
from nmpc_nav_control_tpu_torch.runtime.config import RobotConfig, from_dict, load_config
from nmpc_nav_control_tpu_torch.runtime.executor import RealTimeExecutor
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
from nmpc_nav_control_tpu_torch.runtime.models_config import (
    controller_from_models_params,
    load_models_config,
    prepare_solvers,
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
    "RealTimeExecutor",
    "RobotConfig",
    "Twist",
    "controller_from_models_params",
    "decode_path_set",
    "encode_path",
    "encode_path_set",
    "from_dict",
    "load_config",
    "load_models_config",
    "prepare_solvers",
]
