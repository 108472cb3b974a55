"""Sweep 2: the affine forward rollout, step length and corrector products."""
from benchmark.kernels import F32

PATTERN = r"::fwd_kernel<[^>]*false>"


def moved_bytes(d, N, B):
    nx, nu, G = d.nx, d.nu, N * d.groups
    ins = N * (d.nnzA + d.nnzB) + N * nu * nx + N * nu + N * nx + nx + 3 * G
    outs = G + 1 + 2
    return F32 * B * (ins + outs)


def flops(d, N, B):
    return N * B * (2 * d.nu * d.nx + 2 * (d.nnzA + d.nnzB) + 12 * d.groups)
