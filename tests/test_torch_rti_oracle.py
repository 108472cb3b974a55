"""u-trajectory parity of the torch port vs the NumPy f64 RTI oracle.

Replays the committed ``diff_pose_N40`` golden closed loop
(``tests/goldens/``) through the port's batched ``controller_step`` (one
lane, f32, plain sweeps on the CPU) against the same f64 plant, and holds
it to the bounds ``tests/test_rti_oracle.py`` holds the JAX production path
to.  ``chip_smoke.py`` runs the same replay on the card.
"""
import torch

import torch_golden

torch.set_num_threads(1)


def test_port_f32_tracks_diff_pose_N40_golden():
    err = torch_golden.track("diff_pose_N40", torch.float32, "cpu")
    assert torch_golden.within_tolerance(err), err
