"""Sweep 1 of an IPM iteration: factorization, residuals, affine backward."""
from benchmark.kernels import vec_bwd

PATTERN = r"::bwd_fused_kernel<"


def entries(d, N, B):
    nx, nu, G = d.nx, d.nu, N * d.groups
    ins = N * (d.nnzA + d.nnzB) + 3 * (N + 1) * nx + 3 * N * nu + N * nx + 3 * G
    outs = N * nu * nx + N * nu * (nu + 1) // 2 + 2 * N * nx + N * nu + G + 1
    return B * (ins + outs - 2 * nx)   # Qd and qx are read from stage 1


def flops(d, N, B):
    nx, nu, a, b = d.nx, d.nu, d.nnzA, d.nnzB
    return N * B * (2 * nx * nx + 3 * a * nx + 4 * b * nx + b * nu + 2 * nu * nu * nx
                    + nu * nx * (nx + 1) + 2 * (a + b) + vec_bwd(d) + 12 * d.groups)
