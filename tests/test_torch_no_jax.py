"""The torch port runs where JAX is not installed.

In a subprocess where ``import jax`` fails, the port is imported and one
batched controller tick runs for each geometry on each IPM route (the fused
sweeps and the Riccati solve, which between them import every module of the
package); and no module of the package names JAX in an import.
"""
import ast
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "nmpc_nav_control_tpu_torch")

torch.set_num_threads(1)

SCRIPT = """
import os
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from nmpc_nav_control_tpu_torch.control import controller_init, controller_step, make_controller
import nmpc_nav_control_tpu_torch.convert
import nmpc_nav_control_tpu_torch.qp.riccati
for route in ("1", "0"):
    os.environ["NMPC_TPU_TILED_IPM"] = route
    for geometry, kw in (("diff", dict(dist_b=0.27, q_diag=[1.0] * 7, r_diag=[1.0] * 2)),
                         ("omni4", dict(l1_plus_l2=0.535, q_diag=[1.0] * 11, r_diag=[1.0] * 4)),
                         ("tric", dict(dist_d=1.05, alpha_min=-1.0, alpha_max=1.0,
                                       dalpha_max=1.5, q_diag=[1.0] * 7, r_diag=[1.0] * 2))):
        spec, data = make_controller(geometry, 0.025, 10, v_max=1.0, a_max=2.0, device="cpu", **kw)
        state = controller_init(spec, 2, device="cpu")
        traj = torch.zeros(2, 11, 3)
        traj[:, 0, 0] = 1.0
        state, cmd, stats = controller_step(spec, data, state, torch.zeros(2, 3),
                                            torch.zeros(2, 3), traj,
                                            torch.ones(2, dtype=torch.int32))
        assert bool(stats.ok.all()), (geometry, route, stats)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules if sys.modules[m] is not None)
print("ok", float(cmd.v[0]))
"""


def test_port_imports_and_ticks_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT.format(root=ROOT)],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok"), proc.stdout


def test_no_module_of_the_port_imports_jax():
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    mods = [node.module or ""]
                else:
                    continue
                for m in mods:
                    assert m.split(".")[0] not in ("jax", "jaxlib", "nmpc_nav_control_tpu"), (
                        f"{path} imports {m}")
