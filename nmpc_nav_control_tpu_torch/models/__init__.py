from nmpc_nav_control_tpu_torch.models import diff, omni4, tric
from nmpc_nav_control_tpu_torch.models.base import ModelSpec

SPECS = {"diff": diff.SPEC, "omni4": omni4.SPEC, "tric": tric.SPEC,
         "tric_bug_compat": tric.SPEC_BUG_COMPAT}

__all__ = ["ModelSpec", "SPECS", "diff", "omni4", "tric"]
