"""Smagorinsky large-eddy BGK (counterpart of lbm_tpu/models/les.py).

Per-cell effective relaxation from the non-equilibrium stress (Hou et al.
1996; beyond the reference, whose only stabiliser is the entropic KBC
operator):

    Q_ab    = sum_k c_ka c_kb (f_k - f_k^eq)
    |Q|     = sqrt(Q_ab Q_ab)
    tau_eff = (tau0 + sqrt(tau0^2 + 18 sqrt(2) Cs^2 |Q| / rho)) / 2

Cs = 0 reduces exactly to BGK.  The fused paired-direction form that CUDA
kernel 5 computes is kernels/les.py::les_collide_fn.
"""

from __future__ import annotations

import torch

from ..core import lattice as lat
from ..ops import d2q9

SQRT2_18 = 18.0 * 2.0 ** 0.5  # the 18 sqrt(2) of tau_eff


def smagorinsky_tau(f: torch.Tensor, f_eq: torch.Tensor, rho: torch.Tensor,
                    tau0: float, cs_smag: float) -> torch.Tensor:
    """Per-cell effective relaxation time (R, C); ``f``/``f_eq`` are
    (9, R, C) population planes.  The stress sums are explicit 9-term sums
    with the lattice's integer velocities (no contraction)."""
    dq = f - f_eq
    qxx = sum(lat.CX[k] * lat.CX[k] * dq[k] for k in range(lat.Q))
    qxy = sum(lat.CX[k] * lat.CY[k] * dq[k] for k in range(lat.Q))
    qyy = sum(lat.CY[k] * lat.CY[k] * dq[k] for k in range(lat.Q))
    qn = torch.sqrt(qxx * qxx + 2.0 * qxy * qxy + qyy * qyy)
    disc = tau0 * tau0 + SQRT2_18 * cs_smag * cs_smag * qn / rho
    return 0.5 * (tau0 + torch.sqrt(disc))


def les_collide(f: torch.Tensor, u: torch.Tensor, rho: torch.Tensor,
                tau0: float, cs_smag: float) -> torch.Tensor:
    """One Smagorinsky-BGK collision: standard equilibrium (solver.cpp:51-62
    form), per-cell omega = 1/tau_eff."""
    f_eq = d2q9.equilibrium(u, rho)
    tau_eff = smagorinsky_tau(f, f_eq, rho, tau0, cs_smag)
    return d2q9.bgk_collision(f, f_eq, 1.0 / tau_eff)
