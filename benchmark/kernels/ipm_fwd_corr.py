"""Sweep 4: the corrector's forward rollout, deltas and step length."""

PATTERN = r"::fwd_kernel<[^(]*\btrue\b"


def entries(d, N, B):
    nx, nu, G = d.nx, d.nu, N * d.groups
    ins = N * (d.nnzA + d.nnzB) + N * nu * nx + N * nu + N * nx + nx + 4 * G + 1
    outs = N * nx + N * nu + nx + 2 * G + 2
    return B * (ins + outs)


def flops(d, N, B):
    return N * B * (2 * d.nu * d.nx + 2 * (d.nnzA + d.nnzB) + 14 * d.groups)
