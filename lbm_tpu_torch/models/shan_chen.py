"""Shan-Chen pseudopotential multiphase: single-component liquid-vapour
(counterpart of lbm_tpu/models/shan_chen.py).

Beyond the reference, whose multiphase models are colour-gradient only.  A
density-dependent interaction force

    F(x) = -G psi(x) sum_k w_k psi(x + c_k) c_k,   psi(rho) = 1 - e^-rho

gives the non-ideal equation of state P = rho/3 + (G/6) psi^2, with a van
der Waals loop below G_c = -4: the fluid separates into liquid and vapour
whose densities come from the EOS.  The Carnahan-Starling EOS enters
through psi = sqrt(6 (rho/3 - P_cs)) at G = -1 (Yuan & Schaefer 2006).
Forcing is Guo's with the half-force velocity shift, or for the stiff CS
EOS the original velocity-shift scheme.  Neighbour access is periodic.

This is the model oracle; the scenes run the fused paired form of
kernels/shan_chen.py (plain version and CUDA kernel 14).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import lattice as lat
from ..ops import d2q9

CX, CY, WQ = lat.CX, lat.CY, lat.WQ

G_CRITICAL = -4.0  # for psi = 1 - e^-rho at cs^2 = 1/3
RHO_CRITICAL = 0.6931471805599453  # ln 2, where psi * psi' peaks

# Carnahan-Starling EOS constants (Yuan & Schaefer 2006 lattice convention
# a = 1, b = 4, R = 1): critical point T_c = 0.0943, rho_c = 0.1304
CS_A = 1.0
CS_B = 4.0
CS_TC = 0.094330
CS_RHOC = 0.13044


def psi(rho: torch.Tensor) -> torch.Tensor:
    """The Shan-Chen pseudopotential psi(rho) = 1 - exp(-rho)."""
    return 1.0 - torch.exp(-rho)


def cs_eos_pressure(rho, T: float, a: float = CS_A, b: float = CS_B):
    """Carnahan-Starling equation of state
    P = rho T (1 + eta + eta^2 - eta^3)/(1 - eta)^3 - a rho^2, eta = b rho/4."""
    eta = 0.25 * b * rho
    e2 = eta * eta
    return rho * T * (1.0 + eta + e2 - e2 * eta) / (1.0 - eta) ** 3 - a * rho * rho


def cs_psi(rho, T: float, a: float = CS_A, b: float = CS_B):
    """The pseudopotential that realises the CS EOS at G = -1,
    psi = sqrt(6 (rho/3 - P_cs)); a negative radicand (transient overshoots
    on the stiff liquid branch) is clamped to psi = 0, and a NaN stays a NaN."""
    rad = 6.0 * (rho / 3.0 - cs_eos_pressure(rho, T, a, b))
    return torch.sqrt(torch.where(rad < 0.0, 0.0, rad))


def make_psi(eos: str = "sc", T: float | None = None):
    """(psi_fn, G) for an EOS family: ``'sc'`` the exponential
    pseudopotential (the caller supplies G < -4), ``'cs'`` Carnahan-Starling
    at temperature ``T`` (G fixed at -1)."""
    if eos == "sc":
        return psi, None
    if eos == "cs":
        if T is None:
            raise ValueError("eos='cs' needs a temperature T")
        return (lambda rho: cs_psi(rho, T)), -1.0
    raise ValueError(f"unknown eos {eos!r} (want 'sc' or 'cs')")


def pressure(rho, G: float):
    """Bulk EOS of the exponential pseudopotential, P = rho/3 + G psi^2 / 6
    (a Python float is taken as float64)."""
    if not isinstance(rho, torch.Tensor):
        rho = torch.tensor(rho, dtype=torch.float64)
    p = psi(rho)
    return rho / 3.0 + (G / 6.0) * p * p


def sc_force(rho: torch.Tensor, G: float, psi_fn=psi) -> torch.Tensor:
    """Interaction force (2, R, C) on the periodic grid,
    F_a(x) = -G psi(x) sum_k w_k psi(x + c_k) c_ka; opposite directions pair
    into differences, so global momentum is conserved exactly."""
    p = psi_fn(rho)
    fx = torch.zeros_like(p)
    fy = torch.zeros_like(p)
    for kp in (1, 2, 5, 8):
        shift = (-CX[kp], -CY[kp])
        diff = torch.roll(p, shift, (0, 1)) - torch.roll(p, (-shift[0], -shift[1]), (0, 1))
        fx = fx + WQ[kp] * CX[kp] * diff
        fy = fy + WQ[kp] * CY[kp] * diff
    return torch.stack([-G * p * fx, -G * p * fy])


def macroscopics(f: torch.Tensor, G: float, psi_fn=psi):
    """(rho, u, F) with the Guo half-force velocity shift."""
    rho = d2q9.calc_rho(f)
    F = sc_force(rho, G, psi_fn)
    u = (d2q9.calc_momentum(f) + 0.5 * F) / rho
    return rho, u, F


def collide(f: torch.Tensor, omega: float, G: float, psi_fn=psi,
            forcing: str = "guo") -> torch.Tensor:
    """One Shan-Chen BGK collision (before streaming).  ``forcing='guo'``:
    the equilibrium at the half-force-shifted velocity plus the standard
    Guo source.  ``forcing='shift'`` (Shan & Chen 1993, needed for the stiff
    CS EOS): u_eq = u_bare + F/(omega rho), no source."""
    rho = d2q9.calc_rho(f)
    F = sc_force(rho, G, psi_fn)
    if forcing == "shift":
        u_eq = (d2q9.calc_momentum(f) + (1.0 / omega) * F) / rho
        return d2q9.bgk_collision(f, d2q9.equilibrium(u_eq, rho), omega)
    if forcing != "guo":
        raise ValueError(f"unknown forcing {forcing!r}")
    u = (d2q9.calc_momentum(f) + 0.5 * F) / rho
    f_eq = d2q9.equilibrium(u, rho)
    return d2q9.bgk_collision(f, f_eq, omega) + d2q9.guo_source(u, F, omega)


def step(f: torch.Tensor, omega: float, G: float, psi_fn=psi,
         forcing: str = "guo") -> torch.Tensor:
    """One full periodic collide-stream step (the model oracle of kernel 14)."""
    return d2q9.stream(collide(f, omega, G, psi_fn, forcing))


def _trapezoid(y, x):
    """numpy's trapezoid rule (np.trapezoid, np.trapz before numpy 2)."""
    fn = getattr(np, "trapezoid", None) or getattr(np, "trapz")
    return fn(y, x)


def maxwell_coexistence(T: float, a: float = CS_A, b: float = CS_B):
    """(rho_v, rho_l) from the Maxwell equal-area construction on the
    Carnahan-Starling EOS at temperature ``T`` (numpy bisection on the
    saturation pressure; the consistent target the discrete model
    approximates)."""

    def P(rho):
        eta = 0.25 * b * rho
        return rho * T * (1.0 + eta + eta * eta - eta ** 3) / (1.0 - eta) ** 3 - a * rho * rho

    # spinodal bracket: dP/drho = 0 has two roots below T_c
    rho = np.linspace(1e-6, 0.999 * 4.0 / b, 200001)
    p = P(rho)
    dp = np.gradient(p, rho)
    sp = np.where(np.diff(np.sign(dp)) != 0)[0]
    if len(sp) < 2:
        raise ValueError(f"T={T} is above the critical point")
    p_min, p_max = p[sp[1]], p[sp[0]]  # local min (liquid side), max (vapour)
    # the vapour branch only reaches P = ps for ps > 0 (P(0) = 0, rising)
    lo = max(p_min, 1e-12)

    def branches(ps):
        """Outermost intersections of P = ps (vapour and liquid bulk)."""
        idx = np.where(np.diff(np.sign(p - ps)) != 0)[0]
        return rho[idx[0]], rho[idx[-1]]

    def area(ps):
        rv, rl = branches(ps)
        m = (rho >= rv) & (rho <= rl)
        # integral of (P - ps) dv with v = 1/rho: dv = -drho/rho^2
        return _trapezoid((p[m] - ps) / rho[m] ** 2, rho[m])

    hi = p_max
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if area(mid) > 0.0:
            lo = mid
        else:
            hi = mid
    rv, rl = branches(0.5 * (lo + hi))
    return float(rv), float(rl)
