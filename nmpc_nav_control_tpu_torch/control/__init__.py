from nmpc_nav_control_tpu_torch.control.controllers import (
    CmdVel,
    ControllerSpec,
    controller_init,
    controller_reset,
    controller_step,
    make_controller,
)
from nmpc_nav_control_tpu_torch.control.graph import GraphedController, GraphedNavigator

__all__ = [
    "CmdVel",
    "ControllerSpec",
    "GraphedController",
    "GraphedNavigator",
    "controller_init",
    "controller_reset",
    "controller_step",
    "make_controller",
]
