"""Host runtime of the port: config, messages, the single-robot node, the
fixed-rate executor, the models config, solver preparation and the tick
artifacts (``aot``).

The names below are imported on first use (PEP 562), so that importing
one module of this package, ``runtime.aot`` on a serving host above all,
does not import the others and the model code behind them.  The modules
``ingest``, ``simulation``, ``checkpoint``, ``native`` and ``ros_bridge``
are imported by name."""
import importlib

_MODULE_OF = {
    "AotTick": "aot",
    "ControlStatus": "messages",
    "FrameTable": "messages",
    "NmpcNavControlNode": "node",
    "ParametricPath": "messages",
    "ParametricPathSet": "messages",
    "ParametricPathSet2": "messages",
    "PoseStamped": "messages",
    "PosePath": "messages",
    "RealTimeExecutor": "executor",
    "RobotConfig": "config",
    "Twist": "messages",
    "controller_from_models_params": "models_config",
    "decode_path_set": "messages",
    "encode_path": "messages",
    "encode_path_set": "messages",
    "export_tick": "aot",
    "from_dict": "config",
    "load_config": "config",
    "load_models_config": "models_config",
    "load_tick": "aot",
    "prepare_solvers": "models_config",
    "save_tick": "aot",
}

__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_MODULE_OF[name]}"), name)
