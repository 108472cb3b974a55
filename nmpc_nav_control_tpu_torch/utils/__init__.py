from nmpc_nav_control_tpu_torch.utils.angles import dist, norm_ang_rad, unwrap_angle

__all__ = ["dist", "norm_ang_rad", "unwrap_angle"]
