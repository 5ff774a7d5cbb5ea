"""D3Q19 lattice and operators in plain PyTorch (counterpart of
lbm_tpu/ops/d3q19.py; beyond the reference, which is strictly 2-D).

The standard D3Q19 lattice: rest, 6 axis and 12 face-diagonal velocities,
weights [1/3, 1/18 x6, 1/36 x12], cs^2 = 1/3.  Populations are planes with
the direction outermost, ``f.shape == (19, X, Y, Z)``; grid axes (0, 1, 2)
are (x, y, z); rho is (X, Y, Z) and u (3, X, Y, Z).  The constants are the
port's own copies of lbm_tpu's (the CPU tests hold them equal), and every
contraction over the 19 directions is an explicit sum over k with the
integer velocities, where lbm_tpu takes a ``tdot``.
"""

from __future__ import annotations

import numpy as np
import torch

Q = 19

# velocity set: rest, 6 axis, 12 face diagonals (xy, xz, yz)
C3 = np.array([
    [0, 0, 0],
    [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
    [1, 1, 0], [-1, -1, 0], [1, -1, 0], [-1, 1, 0],
    [1, 0, 1], [-1, 0, -1], [1, 0, -1], [-1, 0, 1],
    [0, 1, 1], [0, -1, -1], [0, 1, -1], [0, -1, 1],
], dtype=np.int64).T                                  # (3, 19)

W3 = np.array([1.0 / 3.0] + [1.0 / 18.0] * 6 + [1.0 / 36.0] * 12)

# opposite directions: c_OPP3[k] = -c_k
OPP3 = np.array([0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15, 18, 17],
                dtype=np.int64)

ICS2 = 3.0
ICS4 = 9.0

CX, CY, CZ = (tuple(int(v) for v in C3[a]) for a in range(3))
WQ = tuple(float(v) for v in W3)
OPP = tuple(int(v) for v in OPP3)


def wall_ks(axis: int, side: str) -> tuple[int, ...]:
    """Outgoing directions through the ``axis`` = -1/2 ('lo') or N-1/2
    ('hi') face."""
    sign = -1 if side == "lo" else 1
    return tuple(k for k in range(Q) if int(C3[axis, k]) * sign > 0)


# outgoing directions through the x = -1/2 wall (cx < 0) and the x = X-1/2
# wall (cx > 0)
X_OUT_LO = wall_ks(0, "lo")
X_OUT_HI = wall_ks(0, "hi")


def _dot(c, v) -> list:
    """The 19 projections sum_a c[a][k] v[a] (integer velocities), each
    accumulated over the axes in order."""
    out = []
    for k in range(Q):
        acc = c[0][k] * v[0]
        for a in (1, 2):
            acc = acc + c[a][k] * v[a]
        out.append(acc)
    return out


def calc_rho(f: torch.Tensor) -> torch.Tensor:
    rho = f[0]
    for k in range(1, Q):
        rho = rho + f[k]
    return rho


def calc_momentum(f: torch.Tensor) -> torch.Tensor:
    """First moment sum_k c_k f_k, shape (3, X, Y, Z)."""
    comps = []
    for c in (CX, CY, CZ):
        m = c[0] * f[0]
        for k in range(1, Q):
            m = m + c[k] * f[k]
        comps.append(m)
    return torch.stack(comps)


def calc_u(f: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    return calc_momentum(f) / rho[None]


def equilibrium(u: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Standard second-order D3Q19 equilibrium (solver.cpp:51-62 form
    generalised to 3-D)."""
    cu = _dot((CX, CY, CZ), u)
    uu = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
    return torch.stack([rho * (1.0 + 3.0 * cu[k] + 4.5 * cu[k] * cu[k] - 1.5 * uu) * WQ[k]
                        for k in range(Q)])


def bgk_collision(f: torch.Tensor, f_eq: torch.Tensor, omega) -> torch.Tensor:
    return (1.0 - omega) * f + omega * f_eq


def guo_source(u: torch.Tensor, force: torch.Tensor, omega) -> torch.Tensor:
    """Guo body-force source (standard coefficients), (19, X, Y, Z)."""
    cu = _dot((CX, CY, CZ), u)
    cF = _dot((CX, CY, CZ), force)
    uF = u[0] * force[0] + u[1] * force[1] + u[2] * force[2]
    return torch.stack([(1.0 - 0.5 * omega) * ((ICS2 + ICS4 * cu[k]) * cF[k] - ICS2 * uF)
                        * WQ[k] for k in range(Q)])


def stream(f: torch.Tensor) -> torch.Tensor:
    """Fully periodic push streaming (the 3-D analog of the reference's
    advect, src/solver.cpp:76-131)."""
    return torch.stack([torch.roll(f[k], (CX[k], CY[k], CZ[k]), dims=(0, 1, 2))
                        for k in range(Q)])


def bounce_back_x(f_adve: torch.Tensor, f_coll: torch.Tensor, side: str) -> torch.Tensor:
    """Halfway no-slip on the x = -1/2 ('lo') or x = X-1/2 ('hi') plane:
    f_adve[opp(k), wall] = f_coll[k, wall], from the same cell."""
    idx = 0 if side == "lo" else -1
    out = f_adve.clone()
    for k in (X_OUT_LO if side == "lo" else X_OUT_HI):
        out[OPP[k], idx] = f_coll[k, idx]
    return out


def bounce_back(f_adve: torch.Tensor, f_coll: torch.Tensor, axis: int, side: str,
                u_wall=None, rho_w: float = 1.0) -> torch.Tensor:
    """Halfway bounce-back on any grid face, optionally moving.

    Static: f_adve[opp(k), wall] = f_coll[k, wall] for every outgoing k.
    With ``u_wall`` (a 3-tuple, the tangential wall velocity) the standard
    moving-wall correction applies, f_opp = f_coll - 6 w_k rho_w (c_k . u_w)
    (the 3-D analog of the 2-D ABB lid)."""
    idx = 0 if side == "lo" else -1
    out = f_adve.clone()
    for k in wall_ks(axis, side):
        at = [slice(None)] * 3
        at[axis] = idx
        val = f_coll[k][tuple(at)]
        if u_wall is not None:
            cu = sum(float(C3[a, k]) * float(u_wall[a]) for a in range(3))
            if cu:
                val = val - (6.0 * WQ[k] * rho_w * cu)
        out[OPP[k]][tuple(at)] = val
    return out
