"""Rothman-Keller / Reis-Phillips colour-gradient model, the second
multiphase family (counterpart of lbm_tpu/models/rk_cg.py).

Two formulations, as in the reference:

  * the per-colour BGK + Reis perturbation (recolouring disabled) of the
    self-contained test/rk_static_droplet_test.cpp:110-285, the
    ``RKDroplet*`` classes below;
  * the colour-blind BGK + perturbation + recolouring split with per-cell
    mixture relaxation of src/rk.cpp:5-238, driven by
    test/rk_rayleigh_taylor_test.cpp:75-177, ``RKMixtureModel`` below
    (src/rk.cpp does not compile in the reference; this follows its algebra
    with the 5x5 isotropic gradient of src/differential.cpp).

Every contraction over the 9 directions is an explicit sum.  This is the
model oracle of the RK slice: the step the RT scene runs is the fused
one-pass form of kernels/rk.py (plain version and CUDA kernel 12).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core import lattice as lat
from ..ops import d2q9, gradients
from ..utils.xmath import default_device, default_float
from .mrt_cg import RelaxationFunction, _dot_c


@functools.lru_cache(maxsize=None)
def _planes(device: torch.device, dtype: torch.dtype) -> tuple:
    """(cx, cy, W, B) as (9, 1, 1) tensors on ``device``: the per-direction
    constants of the vectorised equilibrium and perturbation (one launch
    per operation for all 9 directions; the elementwise arithmetic is that
    of the per-direction sums)."""
    return tuple(lat.tensor(a, device=device, dtype=dtype)[:, None, None]
                 for a in (lat.C[0], lat.C[1], lat.W, lat.B_CG))


def rk_phi(alpha) -> np.ndarray:
    """Rest-fraction vector [alpha, 0.2(1-a) x4, 0.05(1-a) x4].
    cites reference test/rk_static_droplet_test.cpp:270-275"""
    a = 0.2 * (1.0 - alpha)
    b = 0.05 * (1.0 - alpha)
    return np.array([alpha, a, a, a, a, b, b, b, b])


def rk_equilibrium(rho_k, u, phi):
    """f_eq = rho_k (phi + W (3 E.u + 4.5 (E.u)^2 - 1.5 u.u)).
    cites reference test/rk_static_droplet_test.cpp:183-199.
    ``phi`` is a (9,) vector or a (9, R, C) field (src/rk.cpp:139-154)."""
    cx, cy, w, _ = _planes(u.device, u.dtype)
    cu = cx * u[0] + cy * u[1]
    uu = u[0] * u[0] + u[1] * u[1]
    if not (isinstance(phi, torch.Tensor) and phi.ndim == 3):
        phi = lat.tensor(phi, device=u.device, dtype=u.dtype)[:, None, None]
    return rho_k[None] * (phi + w * (3.0 * cu + 4.5 * cu * cu - 1.5 * uu[None]))


def reis_perturbation(F, F_norm, A, prefactor=0.5):
    """Reis-Phillips perturbation
    omega2 = prefactor * A * |F| (W (F.c)^2/(eps + |F|^2) - B).
    cites reference test/rk_static_droplet_test.cpp:239-245 (prefactor 0.5,
    A scalar) and src/rk.cpp:19-30 (prefactor 1, A per cell, (R, C) or
    lbm_tpu's broadcastable (1, R, C))."""
    if isinstance(A, torch.Tensor) and A.ndim == F_norm.ndim + 1:
        A = A[0]
    cx, cy, w, b = _planes(F.device, F.dtype)
    Fc = cx * F[0] + cy * F[1]
    den = 1e-20 + F_norm * F_norm
    amp = prefactor * A * F_norm
    return amp[None] * (w * Fc * Fc / den[None] - b)


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Per-colour formulation (rk_static_droplet_test)
# ---------------------------------------------------------------------------

class RKColourFields(NamedTuple):
    f: torch.Tensor
    rho: torch.Tensor


class RKDropletState(NamedTuple):
    red: RKColourFields
    blue: RKColourFields
    u: torch.Tensor


@dataclass(frozen=True)
class RKDropletColour:
    """Constants of the droplet-test colour class.
    cites reference test/rk_static_droplet_test.cpp:110-155"""

    rho_0: float
    alpha: float
    A: float
    nu: float
    beta: float

    @property
    def omega(self) -> float:
        return 1.0 / (0.5 + self.nu / lat.CS2)

    @property
    def cks2(self) -> float:
        return 0.6 * (1.0 - self.alpha)

    def phi(self):
        return rk_phi(self.alpha)


def _phase(r_rho, r0, b_rho, b0):
    return (r_rho / r0 - b_rho / b0) / (r_rho / r0 + b_rho / b0)


@dataclass(frozen=True)
class RKDropletModel:
    """The self-contained static-droplet RK step: per colour
    omega3 = relax (feq - f) + Reis perturbation, periodic streaming.
    cites reference test/rk_static_droplet_test.cpp:475-615.

    ``exact_periodic`` False (the default) reproduces the driver's boundary
    block (:204-211), which copies ALL NINE populations of each edge line
    from the opposite edge's post-collision values, not only the periodic
    repair of the directions that cross it; True selects plain periodic
    streaming."""

    red: RKDropletColour
    blue: RKDropletColour
    sigma: float = 5e-3
    delta: float = 0.98
    exact_periodic: bool = False

    def relax(self) -> RelaxationFunction:
        # the driver interpolates relaxation *times*, then inverts
        # (rk_static_droplet_test.cpp:517, 587-588)
        return RelaxationFunction.from_values(1.0 / self.red.omega, 1.0 / self.blue.omega,
                                              self.delta)

    def init_state(self, r_rho, b_rho, u0=None, dtype=None, device=None) -> RKDropletState:
        """Equilibria of both colours at ``u0`` (rest by default).
        ``device`` defaults to cuda (``default_device``)."""
        dtype, device = default_float(dtype), default_device(device)
        r_rho = _tensor(r_rho, dtype, device)
        b_rho = _tensor(b_rho, dtype, device)
        u = (torch.zeros((2,) + tuple(r_rho.shape), dtype=dtype, device=device)
             if u0 is None else _tensor(u0, dtype, device))
        rf = rk_equilibrium(r_rho, u, self.red.phi())
        bf = rk_equilibrium(b_rho, u, self.blue.phi())
        return RKDropletState(RKColourFields(rf, d2q9.calc_rho(rf)),
                              RKColourFields(bf, d2q9.calc_rho(bf)), u)

    def step(self, state: RKDropletState) -> RKDropletState:
        r, b, u = state
        psi = _phase(r.rho, self.red.rho_0, b.rho, self.blue.rho_0)
        grad = gradients.grad3(psi)  # the reference-swapped 3x3 stencil
        grad_norm = torch.sqrt(grad[0] ** 2 + grad[1] ** 2)
        # The driver also computes the CSF force 0.5 sigma K grad(psi), but
        # only as a snapshot diagnostic (rk_static_droplet_test.cpp:232-236,
        # 610): see ``curvature_diagnostics``.
        relax = 1.0 / self.relax()(psi)

        def colour_step(col: RKColourFields, params: RKDropletColour):
            feq = rk_equilibrium(col.rho, u, params.phi())
            omega1 = relax[None] * (feq - col.f)
            omega2 = reis_perturbation(grad, grad_norm, params.A, prefactor=0.5)
            f_col = col.f + omega1 + omega2
            f_adv = d2q9.stream(f_col)
            if not self.exact_periodic:
                # the driver's full-edge wrap copy of all 9 populations
                f_adv[:, 1:-1, 0] = f_col[:, 1:-1, -1]
                f_adv[:, 1:-1, -1] = f_col[:, 1:-1, 0]
                f_adv[:, 0, :] = f_col[:, -1, :]
                f_adv[:, -1, :] = f_col[:, 0, :]
            return RKColourFields(f_adv, d2q9.calc_rho(f_adv))

        r_new = colour_step(r, self.red)
        b_new = colour_step(b, self.blue)
        u_new = d2q9.calc_u(r_new.f + b_new.f, r_new.rho + b_new.rho)
        return RKDropletState(r_new, b_new, u_new)

    def curvature_diagnostics(self, state: RKDropletState):
        """Unit normal, curvature and CSF force as the reference snapshots
        them (rk_static_droplet_test.cpp:544-576); not part of the dynamics."""
        r, b, _ = state
        psi = _phase(r.rho, self.red.rho_0, b.rho, self.blue.rho_0)
        grad = gradients.grad3(psi)
        grad_norm = torch.sqrt(grad[0] ** 2 + grad[1] ** 2)
        masked = torch.where(grad_norm[None] <= 0.1 * grad_norm.max(), 0.0, grad)
        mnorm = torch.sqrt(masked[0] ** 2 + masked[1] ** 2)
        n = -masked / torch.where(mnorm == 0.0, 1.0, mnorm)[None]
        K = (n[0] * n[1] * (gradients.dy3(n[0]) + gradients.dx3(n[1]))
             - n[0] ** 2 * gradients.dy3(n[1])
             - n[1] ** 2 * gradients.dx3(n[0]))
        Fs = 0.5 * self.sigma * K[None] * grad
        return n, K, Fs


# ---------------------------------------------------------------------------
# Colour-blind mixture formulation (src/rk.cpp + rk_rayleigh_taylor_test)
# ---------------------------------------------------------------------------

class RKMixtureState(NamedTuple):
    f: torch.Tensor       # colour-blind populations (9, R, C)
    r_rho: torch.Tensor
    b_rho: torch.Tensor
    u: torch.Tensor


@dataclass(frozen=True)
class RKMixtureModel:
    """Colour-blind RK step with per-cell mixture relaxation and
    recolouring, following src/rk.cpp's algebra and the
    rk_rayleigh_taylor_test.cpp loop (:133-177)."""

    r_alpha: float
    r_rho_0: float
    r_nu: float
    b_alpha: float
    b_rho_0: float
    b_nu: float
    sigma: float
    beta: float = 0.7
    gravity: tuple[float, float] = (0.0, 0.0)
    # post-stream boundary rule fn(f_adve, f_coll) applied per colour
    boundary: object = None

    def omega_rp(self, r_rho, b_rho, rho):
        """Mixture relaxation rate.  cites src/rk.cpp:184-194"""
        return rho / (3.0 * r_rho * self.r_nu + 3.0 * b_rho * self.b_nu + 0.5 * rho)

    def alpha_field(self, r_rho, b_rho, rho):
        """cites src/rk.cpp:127-137"""
        return (self.r_alpha * r_rho + self.b_alpha * b_rho) / rho

    def phi_field(self, alpha):
        """(9, R, C) rest-fraction field.  cites src/rk.cpp:139-154"""
        return torch.stack([alpha] + [0.2 - 0.2 * alpha] * 4 + [0.05 - 0.05 * alpha] * 4)

    def colour_gradient(self, r_rho, b_rho, rho):
        """F_kl = b grad(r/rho)/rho - r grad(b/rho)/rho (5x5 stencil), the
        two-pass form.  cites src/rk.cpp:94-125"""
        F = (b_rho[None] * gradients.grad5(r_rho / rho)
             - r_rho[None] * gradients.grad5(b_rho / rho)) / rho[None]
        F_norm = torch.sqrt(F[0] ** 2 + F[1] ** 2)
        return F, F_norm

    def init_state(self, r_rho, b_rho, dtype=None, device=None) -> RKMixtureState:
        """The mixture equilibrium at rest.  ``device`` defaults to cuda."""
        dtype, device = default_float(dtype), default_device(device)
        r_rho = _tensor(r_rho, dtype, device)
        b_rho = _tensor(b_rho, dtype, device)
        rho = r_rho + b_rho
        u = torch.zeros((2,) + tuple(r_rho.shape), dtype=dtype, device=device)
        alpha = self.alpha_field(r_rho, b_rho, rho)
        f = rk_equilibrium(rho, u, self.phi_field(alpha))
        return RKMixtureState(f, r_rho, b_rho, u)

    def step(self, state: RKMixtureState) -> RKMixtureState:
        f, r_rho, b_rho, u = state
        rho = r_rho + b_rho
        omega = self.omega_rp(r_rho, b_rho, rho)
        alpha = self.alpha_field(r_rho, b_rho, rho)
        phi = self.phi_field(alpha)
        F, F_norm = self.colour_gradient(r_rho, b_rho, rho)

        feq = rk_equilibrium(rho, u, phi)
        omega1 = (1.0 - omega)[None] * f + omega[None] * feq
        src = d2q9.guo_source(u, self.gravity, omega)

        # perturbation with the interface concentration factor C_kl
        # (src/rk.cpp:166-182) and A_kl = 4.5 sigma omega (:156-164)
        C_kl = 1.0 - torch.abs((r_rho - b_rho) / (r_rho + b_rho))
        A_kl = 4.5 * self.sigma * omega
        omega2 = reis_perturbation(F, F_norm, (A_kl * C_kl)[None], prefactor=1.0)
        post = omega1 + src + omega2

        # recolouring flux (src/rk.cpp:82-92): the normalised colour
        # gradient dotted with the unit velocity set, scaled by phi
        Fn = F / (F_norm + 1e-20)[None]
        ucx = tuple(float(v) for v in lat.UNIT_C[0])
        ucy = tuple(float(v) for v in lat.UNIT_C[1])
        rb = (r_rho * b_rho / rho)
        kappa = torch.stack([rb * dot * phi[k] for k, dot in
                             enumerate(_dot_c(Fn[0], Fn[1], ucx, ucy))])

        def colour_advect(k_rho, beta):
            omega3 = (k_rho / rho)[None] * post + beta * kappa
            adv = d2q9.stream(omega3)
            if self.boundary is not None:
                adv = self.boundary(adv, omega3)
            return adv

        r_adv = colour_advect(r_rho, self.beta)
        b_adv = colour_advect(b_rho, -self.beta)
        r_rho_new = d2q9.calc_rho(r_adv)
        b_rho_new = d2q9.calc_rho(b_adv)
        f_new = r_adv + b_adv
        u_new = d2q9.calc_u(f_new, r_rho_new + b_rho_new)
        return RKMixtureState(f_new, r_rho_new, b_rho_new, u_new)
