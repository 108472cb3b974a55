"""The port's simulation demos against the JAX package's scripts.

``nmpc_nav_control_tpu_torch.examples.sim_pose_goal`` (diff, omni4, tric)
and ``sim_follow_path`` run on the CPU at ``--noise 0`` for 20 ticks at
N=10, and the JAX scripts ``examples/sim_pose_goal.py`` and
``examples/sim_follow_path.py`` run with the same arguments.  The scripts
fix f32 and N; here both sides run in f64 (the JAX script's ``jnp.float32``
read as float64, the node built in f64) and the follow-path node's
``tf_ini`` is cut to 0.25 s (N=10).  The JAX scripts' trajectories are read
from their ``--plot`` branch, with a stand-in matplotlib that records the
plotted points.  The robots' positions agree within 1e-9 at every tick.
"""
import functools
import importlib.util
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_nav_control_tpu.runtime import NmpcNavControlNode as JNode
from nmpc_nav_control_tpu.runtime import from_dict as jfrom_dict
from nmpc_nav_control_tpu_torch.examples import sim_follow_path, sim_pose_goal
from nmpc_nav_control_tpu_torch.runtime import from_dict

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TICKS, TOL = 20, 1e-9


class _F64:
    """jax.numpy with ``float32`` read as float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _jax_script(name, monkeypatch, argv):
    """Run ``examples/<name>.py``'s main (its compile-cache settings
    skipped); return the (xs, ys) it plots and the loaded module."""
    plotted = []
    plt = types.ModuleType("matplotlib.pyplot")
    plt.plot = lambda x, y, *a, **k: plotted.append((list(x), list(y)))
    plt.axis = plt.savefig = plt.legend = lambda *a, **k: None
    mpl = types.ModuleType("matplotlib")
    mpl.use, mpl.pyplot = (lambda *a, **k: None), plt
    monkeypatch.setitem(sys.modules, "matplotlib", mpl)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", plt)
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    with monkeypatch.context() as m:
        m.setattr(jax.config, "update", lambda *a, **k: None)
        spec.loader.exec_module(mod)
    return mod, lambda: _run(mod, monkeypatch, argv, plotted)


def _run(mod, monkeypatch, argv, plotted):
    monkeypatch.setattr(sys, "argv", [mod.__name__] + argv + ["--plot"])
    mod.main()
    return plotted[0]


@pytest.mark.parametrize("geometry", ["diff", "omni4", "tric"])
def test_sim_pose_goal_matches_jax(geometry, monkeypatch):
    argv = [geometry, "--noise", "0", "--ticks", str(TICKS), "--horizon", "10"]
    mod, run = _jax_script("sim_pose_goal", monkeypatch, argv)
    monkeypatch.setattr(mod, "jnp", _F64())
    want = run()
    monkeypatch.setattr(sim_pose_goal, "DTYPE", torch.float64)
    got = sim_pose_goal.main(argv + ["--device", "cpu"])
    assert len(got["xs"]) == TICKS
    np.testing.assert_allclose(got["xs"], want[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(got["ys"], want[1], rtol=0, atol=TOL)
    assert got["xs"][-1] > 0.0            # the robot moves toward the goal


def test_sim_follow_path_matches_jax(monkeypatch):
    argv = ["--ticks", str(TICKS)]
    mod, run = _jax_script("sim_follow_path", monkeypatch, argv)
    monkeypatch.setattr(mod, "NmpcNavControlNode", functools.partial(JNode, dtype=jnp.float64))
    monkeypatch.setattr(mod, "from_dict", lambda d: jfrom_dict({**d, "tf_ini": 0.25}))
    want = run()
    monkeypatch.setattr(sim_follow_path, "DTYPE", torch.float64)
    monkeypatch.setattr(sim_follow_path, "from_dict", lambda d: from_dict({**d, "tf_ini": 0.25}))
    got = sim_follow_path.main(argv + ["--device", "cpu"])
    assert len(got["xs"]) == TICKS
    np.testing.assert_allclose(got["xs"], want[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(got["ys"], want[1], rtol=0, atol=TOL)
    assert got["xs"][-1] > 0.0
