"""Truncated power-law / Herschel-Bulkley BGK (counterpart of
lbm_tpu/models/power_law.py).

A per-cell apparent viscosity

    nu(gdot) = K gdot^(n-1)  (+ sigma_y (1 - exp(-m_pap gdot)) / gdot)

with the shear rate from the non-equilibrium stress the collision already
has, Q_ab = sum_k c_ka c_kb (f_k - feq_k), gdot = sqrt(2)*3 |Q| / (2 rho tau).
Because gdot contains tau, tau = 1/2 + 3 nu(gdot) is solved per cell:
Steffensen-accelerated Picard sweeps with nu clipped to [nu(tau_min),
nu(tau_max)] (the truncated model), or, with a yield stress, bracket-clamped
Newton on the monotone F(gdot) = gdot/2 + 3 sigma(gdot) = gdot tau.  The
floors keep every shear rate a normal float.  The fused periodic form is
kernels/power_law.py (CUDA kernel 11).
"""

from __future__ import annotations

import math

import torch

from ..core import lattice as lat
from ..ops import d2q9

# gdot = _SQ32 * |Q| / (rho * tau)   with cs^2 = 1/3
_SQ32 = 3.0 / 2.0 ** 0.5


def tiny_floor(dtype: torch.dtype) -> float:
    """The smallest |Q|-derived shear measure kept, chosen so that
    tiny / tau_max stays a normal float of ``dtype`` (flushed subnormals
    would make a 0/0 below)."""
    return 1e-250 if dtype == torch.float64 else 1e-30


def nonequilibrium_stress_norm(f: torch.Tensor, f_eq: torch.Tensor) -> torch.Tensor:
    """|Q| = sqrt(Q_ab Q_ab), shape (R, C), from (9, R, C) planes."""
    cx = lat.tensor(lat.C[0], device=f.device, dtype=f.dtype)[:, None, None]
    cy = lat.tensor(lat.C[1], device=f.device, dtype=f.dtype)[:, None, None]
    dq = f - f_eq
    qxx = (cx * cx * dq).sum(0)
    qxy = (cx * cy * dq).sum(0)
    qyy = (cy * cy * dq).sum(0)
    return torch.sqrt(qxx * qxx + 2.0 * qxy * qxy + qyy * qyy)


def apparent_tau(f: torch.Tensor, f_eq: torch.Tensor, rho: torch.Tensor,
                 cons_K: float, n: float, tau_min: float = 0.52,
                 tau_max: float = 50.0, iters: int = 8, sigma_y: float = 0.0,
                 m_pap: float = 1e4) -> torch.Tensor:
    """Per-cell relaxation time (R, C) of the truncated power law (plus the
    Papanastasiou yield term when ``sigma_y > 0``).  ``iters`` counts Picard
    sweeps, every second one followed by a clipped Aitken update; with a
    yield stress, ``iters`` Newton steps.  ``n == 1`` with no yield stress
    is the exact Newtonian tau = 1/2 + 3K (clipped)."""
    dtype = f.dtype
    yielded = float(sigma_y) > 0.0
    if float(n) == 1.0 and not yielded:
        t = min(max(0.5 + 3.0 * cons_K, tau_min), tau_max)
        return torch.full_like(rho, t)

    qn = nonequilibrium_stress_norm(f, f_eq)
    # gdot * tau with a finite log: |Q| == 0 maps to a huge negative log,
    # whose clipped nu lands on the truncation plateau
    a = (_SQ32 * qn / rho).clamp_min(tiny_floor(dtype))
    log_a = torch.log(a)
    log_k = math.log(cons_K)
    nu_lo = (tau_min - 0.5) / 3.0
    nu_hi = (tau_max - 0.5) / 3.0
    nm1 = n - 1.0

    if yielded:
        sy = torch.tensor(sigma_y, dtype=dtype)
        mp = torch.tensor(m_pap, dtype=dtype)
        sy_mp = (sy * mp).item()  # the product in the state's dtype
        gd_lo, gd_hi = a / tau_max, a / tau_min
        gd = gd_lo
        for _ in range(iters):
            q = torch.exp(log_k + nm1 * torch.log(gd))   # K gdot^(n-1)
            e = torch.exp(-m_pap * gd)
            h = 0.5 * gd + 3.0 * (sigma_y * (1.0 - e) + q * gd) - a
            hp = 0.5 + 3.0 * (sy_mp * e + n * q)
            gd = torch.clamp(gd - h / hp, gd_lo, gd_hi)
        nu = torch.exp(log_k + nm1 * torch.log(gd)) \
            + sigma_y * (-torch.expm1(-m_pap * gd)) / gd
        return 0.5 + 3.0 * torch.clamp(nu, nu_lo, nu_hi)

    def picard(t):
        lg = log_a - torch.log(t)          # log gdot
        nu = torch.exp(log_k + nm1 * lg)
        return 0.5 + 3.0 * torch.clamp(nu, nu_lo, nu_hi)

    tau = torch.full_like(rho, tau_max if n < 1.0 else tau_min)
    for i in range(iters):
        t1 = picard(tau)
        if i % 2 == 0:
            t0 = tau
            tau = t1
            continue
        # Aitken delta-squared on (t0, tau, t1); exact for a geometric
        # sequence, a guarded no-op on the clipped plateaus (den == 0)
        den = t1 - 2.0 * tau + t0
        accel = t1 - (t1 - tau) * (t1 - tau) / torch.where(den == 0.0, 1.0, den)
        tau = torch.where(den == 0.0, t1, torch.clamp(accel, tau_min, tau_max))
    return tau


def power_law_collide(f: torch.Tensor, u: torch.Tensor, rho: torch.Tensor,
                      cons_K: float, n: float, tau_min: float = 0.52,
                      tau_max: float = 50.0, iters: int = 8, sigma_y: float = 0.0,
                      m_pap: float = 1e4) -> torch.Tensor:
    """One generalized-Newtonian BGK collision: the standard equilibrium
    (src/solver.cpp:51-62), per-cell omega = 1/tau(gdot)."""
    f_eq = d2q9.equilibrium(u, rho)
    tau = apparent_tau(f, f_eq, rho, cons_K, n, tau_min, tau_max, iters,
                       sigma_y, m_pap)
    return d2q9.bgk_collision(f, f_eq, 1.0 / tau)
