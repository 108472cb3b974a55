"""One process of the port's two-process fleet test (``test_torch_multihost.py``).

Every process runs this script, the loop of ``parallel/multihost.py``:
``init_distributed`` on gloo with a real coordinator, the process-major
``global_data_mesh`` over four ``cpu`` devices a process, this process's
robots ingested with ``local_to_global``, a fleet tick, and its lanes read
back with ``global_to_local``.

Usage: python torch_distributed_worker.py <process_id> <num_processes> <port> <out.npz>
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from nmpc_nav_control_tpu_torch.control import make_controller  # noqa: E402
from nmpc_nav_control_tpu_torch.control import state_machine as sm  # noqa: E402
from nmpc_nav_control_tpu_torch.parallel import (  # noqa: E402
    global_data_mesh,
    global_to_local,
    init_distributed,
    local_batch,
    local_to_global,
)
from nmpc_nav_control_tpu_torch.parallel.fleet import Fleet, FleetGroup  # noqa: E402

GLOBAL_B, N, DT, TICKS = 16, 10, 0.025, 4
DIFF = dict(dist_b=0.27, tau_v=0.1, v_max=1.0, a_max=2.0, q_diag=[10, 10, 5, 0, 0, 0, 0],
            r_diag=[1, 1], ipm_iters=6)


def goals():
    """Each robot's goal by global lane."""
    return np.stack([np.linspace(0.2, 0.9, GLOBAL_B), np.linspace(-0.2, 0.2, GLOBAL_B),
                     np.linspace(-0.5, 0.5, GLOBAL_B)], axis=-1)


def run(fleet, lanes, goals_local, ingest):
    """Set the goals, tick ``TICKS`` times; v, w, kkt_res [T, lanes] and the
    last statuses."""
    states = sm.on_goal_pose(fleet.groups["diff"].init_states(torch.float64),
                             torch.as_tensor(goals_local))
    fleet.set_states("diff", states)
    meas = sm.Measurements(pose=np.zeros((lanes, 3)), vel=np.zeros((lanes, 3)),
                           steer_angle=np.zeros(lanes), pose_valid=np.ones(lanes, bool),
                           vel_valid=np.ones(lanes, bool), steer_valid=np.ones(lanes, bool))
    rows = []
    for _ in range(TICKS):
        out = global_to_local(fleet.tick({"diff": ingest(meas)})["diff"])
        rows.append((out.cmd.v, out.cmd.w, out.kkt_res))
    v, w, kkt = (np.stack(x) for x in zip(*rows))
    return dict(v=v, w=w, kkt=kkt, status=out.status_code)


def group(lanes):
    spec, data = make_controller("diff", DT, N, dtype=torch.float64, device="cpu", **DIFF)
    return FleetGroup(spec=spec, data=data, cfg=sm.NavConfig(path_capacity=4), batch=lanes)


if __name__ == "__main__":
    PID, NPROCS, PORT, OUT = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    init_distributed(f"127.0.0.1:{PORT}", NPROCS, PID, device="cpu")
    import torch.distributed as dist

    assert dist.get_world_size() == NPROCS and dist.get_backend() == "gloo"
    mesh = global_data_mesh(devices=["cpu"] * 4)
    assert mesh.size == 4 * NPROCS and list(mesh.process_index) == sorted(mesh.process_index)
    assert len(mesh.local_devices()) == 4
    B = local_batch(GLOBAL_B)
    fleet = Fleet({"diff": group(B)}, mesh=mesh, dtype=torch.float64)
    out = run(fleet, B, goals()[PID * B:(PID + 1) * B], lambda m: local_to_global(mesh, m))
    np.savez(OUT, **out)
    dist.destroy_process_group()
    print(f"[proc {PID}] wrote {OUT}", flush=True)
