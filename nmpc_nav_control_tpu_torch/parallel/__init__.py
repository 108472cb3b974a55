from nmpc_nav_control_tpu_torch.parallel.mesh2d import qp_2d_shardings, solve_box_qp_2d
from nmpc_nav_control_tpu_torch.parallel.multihost import (
    global_data_mesh,
    global_to_local,
    init_distributed,
    local_batch,
    local_to_global,
)
from nmpc_nav_control_tpu_torch.parallel.sharding import (
    Mesh,
    Sharded,
    gather,
    make_mesh,
    replicate,
    shard_leading_axis,
)

__all__ = [
    "Mesh",
    "Sharded",
    "gather",
    "make_mesh",
    "replicate",
    "shard_leading_axis",
    "solve_box_qp_2d",
    "qp_2d_shardings",
    "init_distributed",
    "global_data_mesh",
    "local_batch",
    "local_to_global",
    "global_to_local",
]
