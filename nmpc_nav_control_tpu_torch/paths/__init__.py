from nmpc_nav_control_tpu_torch.paths.discretizer import (
    get_next_n_poses,
    get_next_n_poses_fast,
)
from nmpc_nav_control_tpu_torch.paths.pathlist import (
    PathList,
    make_path_list,
    pose_sample,
    vel_sample,
)
from nmpc_nav_control_tpu_torch.paths.projection import MinDistResult, project_to_path
from nmpc_nav_control_tpu_torch.paths.segment import (
    PathSegment,
    make_cubic_segment,
    make_line_segment,
)
from nmpc_nav_control_tpu_torch.paths.windowing import (
    PathWindow,
    active_length,
    active_path_list,
    ingest,
    path_remains,
    pop_completed,
    rotate_end_of_curve,
    top_up,
    window_init,
)

__all__ = [
    "MinDistResult",
    "PathList",
    "PathSegment",
    "PathWindow",
    "active_length",
    "active_path_list",
    "get_next_n_poses",
    "get_next_n_poses_fast",
    "ingest",
    "make_cubic_segment",
    "make_line_segment",
    "make_path_list",
    "path_remains",
    "pop_completed",
    "pose_sample",
    "project_to_path",
    "rotate_end_of_curve",
    "top_up",
    "vel_sample",
    "window_init",
]
