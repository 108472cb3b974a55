"""Random valid inputs for the five IPM sweeps and the three Riccati
kernels, in the port's batch-minor layout ([rows, entries, B] numpy f32
arrays), made with numpy from a seed.

Shared by ``tests/test_torch_ipm_kernels.py`` and
``tests/test_torch_riccati.py`` (plain versions vs the JAX Pallas kernels in
interpret mode, CUDA kernels vs plain versions) and ``chip_smoke.py`` (CUDA
kernels vs plain versions on the card).
"""
from __future__ import annotations

import numpy as np

from nmpc_nav_control_tpu_torch.ops.linearize_packed import nz_positions


def random_sweep_inputs(nx, nu, nbx, nbu, asp, bsp, N, B, seed=0):
    """One IPM iterate and QP in the sweeps' layout.

    A is near the identity and B moderate so the Riccati recursion is well
    conditioned; slacks and multipliers are strictly positive; A/B are packed
    to ``asp``/``bsp``.  Returns a dict of float32 arrays; the bound groups
    are 4-tuples (x lower, x upper, u lower, u upper).
    """
    rng = np.random.default_rng(seed)

    def uni(lo, hi, *shape):
        return rng.uniform(lo, hi, size=shape).astype(np.float32)

    def nrm(scale, *shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    A_dense = np.eye(nx)[None, :, :, None] * 0.95 + rng.normal(size=(N, nx, nx, B)) * 0.2
    B_dense = rng.normal(size=(N, nx, nu, B)) * 0.4
    pa, pb = nz_positions(asp), nz_positions(bsp)
    nb = (nbx, nbx, nbu, nbu)
    return dict(
        A=A_dense[:, [i for i, _ in pa], [j for _, j in pa]].astype(np.float32),
        Bm=B_dense[:, [i for i, _ in pb], [j for _, j in pb]].astype(np.float32),
        Qd=uni(0.5, 2.0, N + 1, nx, B), Rd=uni(0.5, 2.0, N, nu, B),
        qx=nrm(0.5, N + 1, nx, B), qu=nrm(0.5, N, nu, B),
        c=nrm(0.05, N, nx, B), dx=nrm(0.1, N + 1, nx, B), du=nrm(0.1, N, nu, B),
        s=tuple(uni(0.05, 1.5, N, n, B) for n in nb),
        lam=tuple(uni(0.05, 1.5, N, n, B) for n in nb),
        bnd=(-uni(0.5, 1.5, N, nbx, B), uni(0.5, 1.5, N, nbx, B),
             -uni(1.0, 2.0, N, nbu, B), uni(1.0, 2.0, N, nbu, B)),
        r_init=nrm(0.1, nx, B),
        sigma_mu=uni(0.01, 0.3, B),
    )


def random_riccati_inputs(nx, nu, N, B, seed=0):
    """One LQR per lane for the Riccati kernels, dense and batch-minor:
    A [N, nx*nx, B] near the identity, Bm [N, nx*nu, B], Qd [N+1, nx, B],
    Rd [N, nu, B] positive (a few barrier-sized entries in Qd), qx, qu, c,
    and dx0 [nx, B].  Returns a dict of float32 arrays."""
    rng = np.random.default_rng(seed)

    def f32(x):
        return np.ascontiguousarray(x, dtype=np.float32)

    Qd = np.abs(rng.normal(size=(N + 1, nx, B))) + 0.1
    Qd[:, -1] += rng.uniform(0.0, 1e3, size=(N + 1, B)) * (rng.uniform(size=(N + 1, B)) < 0.1)
    return dict(
        A=f32((np.eye(nx)[None, :, :, None] + rng.normal(size=(N, nx, nx, B)) * 0.1)
              .reshape(N, nx * nx, B)),
        Bm=f32(rng.normal(size=(N, nx * nu, B)) * 0.3),
        Qd=f32(Qd), Rd=f32(rng.uniform(0.5, 2.0, size=(N, nu, B))),
        qx=f32(rng.normal(size=(N + 1, nx, B))), qu=f32(rng.normal(size=(N, nu, B))),
        c=f32(rng.normal(size=(N, nx, B)) * 0.1), dx0=f32(rng.normal(size=(nx, B)) * 0.1),
    )
