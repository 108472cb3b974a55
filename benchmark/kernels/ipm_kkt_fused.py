"""The solve's closing sweep: stationarity residual and complementarity."""

PATTERN = r"::kkt_kernel<"


def entries(d, N, B):
    nx, nu, G = d.nx, d.nu, N * d.groups
    ins = N * (d.nnzA + d.nnzB) + 3 * (N + 1) * nx + 3 * N * nu + 2 * G
    return B * (ins + 2 - 3 * nx)   # Qd, qx, dx are read from stage 1


def flops(d, N, B):
    return N * B * (2 * (d.nnzA + d.nnzB) + 4 * d.nx + 6 * d.groups)
