from nmpc_nav_control_tpu_torch.models import diff
from nmpc_nav_control_tpu_torch.models.base import ModelSpec

SPECS = {"diff": diff.SPEC}

__all__ = ["ModelSpec", "SPECS", "diff"]
