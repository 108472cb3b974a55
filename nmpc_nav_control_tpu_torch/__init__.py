"""nmpc_nav_control_tpu_torch — the NMPC engine in PyTorch, with CUDA kernels
written by hand for the NVIDIA H100 (``sm_90a``).

A port of ``nmpc_nav_control_tpu`` (the JAX package, which stays the
reference).  The subpackages and names mirror the JAX package so that the
counterpart of a module is easy to find; inside, the code is plain PyTorch:
functions on tensors with an explicit leading batch axis where JAX used
``vmap``, NamedTuples and frozen dataclasses where JAX used pytrees, and an
explicit ``device=`` argument.

What runs: the batched ``controller_step`` for the diff, omni4 and tric
robots (RK4 linearization in torch, then the Mehrotra box-IPM on either
route: the five fused IPM sweeps or the Riccati solve, as CUDA kernels on
f32 CUDA tensors and as their plain torch versions otherwise), replayed as
a CUDA graph by ``control.GraphedController``; the path subsystem
(``paths/``) and the navigation state machine's batched ``node_tick``
(``control/state_machine.py``), replayed by ``control.GraphedNavigator``;
and the single-robot host node ``runtime.NmpcNavControlNode`` with its
config, messages and telemetry.

The package never imports JAX.
"""
import torch

# Full f32 everywhere: the Riccati recursion under barrier diagonals up to
# 1e10 loses the solution in TF32 (the JAX package needs
# ``precision="highest"`` for the same reason).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
