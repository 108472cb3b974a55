"""Sweep 2: the affine forward rollout, step length and corrector products."""

PATTERN = r"::fwd_kernel<[^(]*\bfalse\b"


def entries(d, N, B):
    nx, nu, G = d.nx, d.nu, N * d.groups
    ins = N * (d.nnzA + d.nnzB) + N * nu * nx + N * nu + N * nx + nx + 3 * G
    outs = G + 1 + 2
    return B * (ins + outs)


def flops(d, N, B):
    return N * B * (2 * d.nu * d.nx + 2 * (d.nnzA + d.nnzB) + 12 * d.groups)
