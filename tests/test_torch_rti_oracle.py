"""u-trajectory parity of the torch port vs the NumPy f64 RTI oracle.

Replays the committed golden closed loops (``tests/goldens/``) through the
port's batched ``controller_step`` (one lane, f32, plain versions of the
kernels on the CPU) against the same f64 plant, and holds them to the
bounds ``tests/test_rti_oracle.py`` holds the JAX production path to:
``diff_pose_N40`` on the default route (the fused IPM sweeps), and every
golden on the Riccati route (``NMPC_TPU_TILED_IPM=0``), of which
``omni4_pose_N40`` and ``tric_bug_pose_N40`` are in the fast tier and the
rest, the N=80 ones among them, are marked slow as in that file.
``gpu``: the three N=80 goldens on the card through the graphed tick, on
both routes (skip without a card).  ``chip_smoke.py`` runs replays on the
card.
"""
import pytest
import torch

import torch_golden

torch.set_num_threads(1)

FAST_GOLDENS = {"omni4_pose_N40", "tric_bug_pose_N40"}
ALL_GOLDENS = [
    name if name in FAST_GOLDENS else pytest.param(name, marks=pytest.mark.slow)
    for name in ("diff_pose_N40", "diff_pose_N80", "diff_tight_N40", "diff_arc_N40",
                 "omni4_pose_N40", "omni4_pose_N80", "tric_pose_N40", "tric_pose_N80",
                 "tric_bug_pose_N40")
]


def test_port_f32_tracks_diff_pose_N40_golden():
    err = torch_golden.track("diff_pose_N40", torch.float32, "cpu")
    assert torch_golden.within_tolerance(err), err


@pytest.mark.parametrize("name", ALL_GOLDENS)
def test_port_f32_riccati_route_tracks_golden(name, monkeypatch):
    monkeypatch.setenv("NMPC_TPU_TILED_IPM", "0")
    err = torch_golden.track(name, torch.float32, "cpu")
    assert torch_golden.within_tolerance(err), err


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["1", "0"])
@pytest.mark.parametrize("name", ["diff_pose_N80", "omni4_pose_N80", "tric_pose_N80"])
def test_port_tracks_N80_goldens_on_the_card(name, route, monkeypatch):
    """The N=80 goldens on the card, each tick a replay of the graphed
    controller, on both routes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphed tick has no CPU mode")
    monkeypatch.setenv("NMPC_TPU_TILED_IPM", route)
    err = torch_golden.track(name, torch.float32, "cuda", graphed=True)
    assert torch_golden.within_tolerance(err), err
