from nmpc_nav_control_tpu_torch.utils.angles import (
    dist,
    norm_ang_deg,
    norm_ang_rad,
    unwrap_angle,
)
from nmpc_nav_control_tpu_torch.utils.telemetry import (
    MetricsRegistry,
    channel,
    configure,
    metrics,
)

__all__ = [
    "MetricsRegistry",
    "channel",
    "configure",
    "dist",
    "metrics",
    "norm_ang_deg",
    "norm_ang_rad",
    "unwrap_angle",
]
