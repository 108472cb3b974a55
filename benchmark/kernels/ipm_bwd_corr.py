"""Sweep 3: the corrector's backward recursion."""
from benchmark.kernels import vec_bwd

PATTERN = r"::bwd_corr_kernel<"


def entries(d, N, B):
    nx, nu, G = d.nx, d.nu, N * d.groups
    ins = (N * (d.nnzA + d.nnzB) + N * nu * nx + N * nu * (nu + 1) // 2 + N * nx
           + 3 * (N + 1) * nx + 3 * N * nu + 4 * G + 1)
    return B * (ins + N * nu - 3 * nx)   # Qd, qx, dx are read from stage 1


def flops(d, N, B):
    return N * B * (vec_bwd(d) + 2 * d.nx + 10 * d.groups)
