"""The traffic, the plants and the sampled ticks are made from the seed."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness, traffic

MIX = dict(segments=[8, 16], segment_m=[1, 5], turn_deg=[15, 90], line_share=0.5,
           path_speed=[0.3, 0.8], goal_m=[0.5, 2.0], goal_heading_deg=45)
SEED = 2 ** 31 + 12345


def test_generators_repeat_a_seed_and_differ_across_seeds():
    a = traffic.paths(traffic.rng(SEED, 1), 5, MIX)
    b = traffic.paths(traffic.rng(SEED, 1), 5, MIX)
    c = traffic.paths(traffic.rng(SEED + 1, 1), 5, MIX)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["cx"], c["cx"])
    g1 = traffic.goal_offsets(traffic.rng(SEED, 2), (4, 3), MIX)
    g2 = traffic.goal_offsets(traffic.rng(SEED, 2), (4, 3), MIX)
    assert np.array_equal(g1, g2)
    r = np.hypot(g1[..., 0], g1[..., 1])
    assert (r >= 0.5).all() and (r <= 2.0).all()
    assert traffic.ticks(traffic.rng(SEED, 3), 100, 5) == traffic.ticks(traffic.rng(SEED, 3),
                                                                        100, 5)


def test_paths_are_continuous_and_within_the_node_capacity():
    p = traffic.paths(traffic.rng(7, 1), 20, MIX)
    assert (p["count"] >= 8).all() and (p["count"] <= traffic.CAP).all()
    for i in range(20):
        for j in range(p["count"][i] - 1):
            end = [np.polynomial.polynomial.polyval(1.0, p[k][i, j]) for k in ("cx", "cy")]
            assert np.allclose(end, [p["cx"][i, j + 1, 0], p["cy"][i, j + 1, 0]], atol=1e-9)


def test_place_moves_a_path_to_a_pose():
    p = traffic.paths(traffic.rng(3, 1), 2, MIX)
    t = {k: torch.as_tensor(v) for k, v in p.items() if k != "count"}
    pose = torch.tensor([[1.0, -2.0, 0.5], [0.0, 0.0, 0.0]], dtype=torch.float64)
    q = traffic.place(t, pose)
    assert torch.allclose(q["cx"][:, 0, 0], pose[:, 0]) and torch.allclose(q["cy"][:, 0, 0],
                                                                             pose[:, 1])
    assert torch.allclose(q["cx"][1], t["cx"][1])


@pytest.mark.parametrize("cell", ["sweep_diff_n80_b4096", "fleet_mixed_n80_moving"])
def test_a_drivers_plants_and_goals_follow_the_seed(tiny, cell):
    c = harness.load_cell(tiny, cell, tiny)

    def first(seed):
        d = c.driver.Driver(c, seed, "cpu")
        if hasattr(d, "groups"):
            return torch.cat([g.plants[:, :3] for g in d.groups]), torch.cat(
                [g.offsets.flatten() for g in d.groups])
        return d.plants, d.offsets

    a, b, other = first(SEED), first(SEED), first(SEED + 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], other[0])
