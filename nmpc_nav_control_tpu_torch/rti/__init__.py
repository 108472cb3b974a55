from nmpc_nav_control_tpu_torch.rti.step import (
    RTIConfig,
    RTIState,
    RTIStats,
    build_yref,
    rti_init,
    rti_reset,
    rti_step,
)

__all__ = [
    "RTIConfig",
    "RTIState",
    "RTIStats",
    "build_yref",
    "rti_init",
    "rti_reset",
    "rti_step",
]
