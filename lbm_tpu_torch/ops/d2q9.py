"""Core D2Q9 operators in plain PyTorch (the reference the CUDA kernels match).

Counterpart of lbm_tpu/ops/d2q9.py, same layout: populations are planes,
``f.shape == (9, R, C)`` with the population index outermost; rho is
(R, C); u is (2, R, C) with component 0 = x/rows.  Every contraction over
the 9 directions is written as explicit per-direction sums with the
lattice's integer velocities, so nothing goes through a matmul (TF32).
"""

from __future__ import annotations

import torch

from ..core import lattice as lat

CX, CY, WQ, Q = lat.CX, lat.CY, lat.WQ, lat.Q


# ---------------------------------------------------------------------------
# Moments
# ---------------------------------------------------------------------------

def calc_rho(f: torch.Tensor) -> torch.Tensor:
    """Zeroth moment.  cites reference src/solver.cpp:23-26"""
    rho = f[0]
    for k in range(1, Q):
        rho = rho + f[k]
    return rho


def calc_momentum(f: torch.Tensor) -> torch.Tensor:
    """First moment sum_k c_k f_k, shape (2, R, C).
    cites reference src/solver.cpp:28-31 (calc_incomp_u)"""
    mx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8]
    my = f[2] - f[4] + f[5] + f[6] - f[7] - f[8]
    return torch.stack((mx, my))


def calc_u(f: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Velocity = first moment / density.  cites reference src/solver.cpp:34-37"""
    return calc_momentum(f) / rho


# ---------------------------------------------------------------------------
# Equilibria
# ---------------------------------------------------------------------------

def _cu(ux, uy) -> list:
    """The 9 projections c_k . u (integer velocities, so each is exact up to
    the one addition)."""
    return [CX[k] * ux + CY[k] * uy for k in range(Q)]


def equilibrium(u: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Standard second-order equilibrium.
    cites reference src/solver.cpp:51-62"""
    cu = _cu(u[0], u[1])
    uu = u[0] * u[0] + u[1] * u[1]
    return torch.stack([
        rho * (1.0 + 3.0 * cu[k] + 4.5 * cu[k] * cu[k] - 1.5 * uu) * WQ[k]
        for k in range(Q)])


def incomp_equilibrium(u: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Incompressible (linearised) equilibrium.
    cites reference src/solver.cpp:39-49"""
    cu = _cu(u[0], u[1])
    return torch.stack([(rho + 3.0 * cu[k]) * WQ[k] for k in range(Q)])


# ---------------------------------------------------------------------------
# Collision
# ---------------------------------------------------------------------------

def bgk_collision(f: torch.Tensor, f_eq: torch.Tensor, omega) -> torch.Tensor:
    """BGK relaxation.  cites reference src/solver.cpp:65-74"""
    return (1.0 - omega) * f + omega * f_eq


def guo_source(u: torch.Tensor, force, omega,
               ics2: float = lat.ICS2, ics4: float = lat.ICS4) -> torch.Tensor:
    """Guo body-force source term S, shape (9, R, C).

    S_k = (1 - omega/2) * ((ics2 + ics4 (u.c_k)) F.c_k - ics2 (u.F)) * W_k

    ``force`` is (2,) (uniform) or (2, R, C); the defaults are the
    standard coefficients, and the reference's gravity and cylinder
    test programs use the weak (1/3, 1/9) pair (see lbm_tpu.ops.d2q9.guo_source).
    """
    force = torch.as_tensor(force, dtype=u.dtype, device=u.device)
    cu = _cu(u[0], u[1])
    if force.ndim == u.ndim:
        cf = _cu(force[0], force[1])
        uf = u[0] * force[0] + u[1] * force[1]
    else:
        cf = [CX[k] * force[0] + CY[k] * force[1] for k in range(Q)]
        uf = force[0] * u[0] + force[1] * u[1]
    return torch.stack([
        (1.0 - 0.5 * omega) * ((ics2 + ics4 * cu[k]) * cf[k] - ics2 * uf) * WQ[k]
        for k in range(Q)])


# ---------------------------------------------------------------------------
# Streaming
# ---------------------------------------------------------------------------

# Python-int shift table (row, col) per direction.
SHIFTS = tuple((CX[k], CY[k]) for k in range(Q))


def stream(f: torch.Tensor) -> torch.Tensor:
    """Fully periodic push streaming: g[k, r+cx, c+cy] = f[k, r, c], one roll
    per plane (reference src/solver.cpp:76-131); boundary conditions
    later overwrite the wrapped edge populations."""
    return torch.stack([torch.roll(f[k], shifts=SHIFTS[k], dims=(0, 1))
                        for k in range(Q)])


def abb_coefficient(u_w: torch.Tensor) -> torch.Tensor:
    """Anti-bounce-back wall coefficient (2 + 9 (u_w.c)^2 - 3 u_w.u_w) W.

    ``u_w`` has shape (2,) or (2, N); returns (9,) or (9, N).
    cites reference test/free_stream_test.cpp:106."""
    cu = _cu(u_w[0], u_w[1])
    uu = u_w[0] * u_w[0] + u_w[1] * u_w[1]
    return torch.stack([(2.0 + 9.0 * cu[k] * cu[k] - 3.0 * uu) * WQ[k]
                        for k in range(Q)])
