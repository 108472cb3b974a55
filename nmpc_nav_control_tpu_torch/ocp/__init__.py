from nmpc_nav_control_tpu_torch.ocp.integrator import (
    linearize_trajectory,
    make_discrete_dynamics,
    rk4_step,
    rollout,
)
from nmpc_nav_control_tpu_torch.ocp.spec import OCPData, OCPDims

__all__ = [
    "OCPData",
    "OCPDims",
    "linearize_trajectory",
    "make_discrete_dynamics",
    "rk4_step",
    "rollout",
]
