"""nmpc_nav_control_tpu_torch — the NMPC engine in PyTorch, with CUDA kernels
written by hand for the NVIDIA H100 (``sm_90a``).

A port of ``nmpc_nav_control_tpu`` (the JAX package, which stays the
reference).  The subpackages and names mirror the JAX package so that the
counterpart of a module is easy to find; inside, the code is plain PyTorch:
functions on tensors with an explicit leading batch axis where JAX used
``vmap``, NamedTuples and frozen dataclasses where JAX used pytrees, and an
explicit ``device=`` argument.

This slice runs the batched diff-drive ``controller_step``: batched RK4
linearization in torch, then the Mehrotra box-IPM whose five sweeps run as
CUDA kernels on a CUDA tensor and as their plain torch versions on a CPU
tensor (``ops/ipm_fused.py``).

The package never imports JAX.
"""
import torch

# Full f32 everywhere: the Riccati recursion under barrier diagonals up to
# 1e10 loses the solution in TF32 (the JAX package needs
# ``precision="highest"`` for the same reason).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
