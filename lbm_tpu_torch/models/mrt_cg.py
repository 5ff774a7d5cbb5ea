"""MRT colour-gradient two-phase model, the reference's flagship
(counterpart of lbm_tpu/models/mrt_cg.py).

Pure functions over planes-layout fields, reproducing
test/mrtcg_static_droplet.cpp, test/mrtcg_rayleigh_taylor.cpp and the CSF
variant test/mrt_rayleigh_taylor.cpp.  The MRT relaxation matrix is
diagonal, so the operator is Mi (s * (M (feq - f)) + C) with s a per-cell
vector; every contraction over the 9 directions is an explicit sum.

This is the model oracle of the slice.  The step the scenes run is the
fused colour-summed form in kernels/mrtcg.py (plain version and CUDA
kernels), held to ``MRTCGModel.step`` by the tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core import lattice as lat
from ..core.params import ColourParams
from ..ops import d2q9, gradients
from ..utils.xmath import default_device, default_float

Q = lat.Q


class ColourFields(NamedTuple):
    """Dynamic per-colour state (static constants live in ColourParams)."""

    f: torch.Tensor    # (9, R, C) populations
    rho: torch.Tensor  # (R, C)


class TwoPhaseState(NamedTuple):
    red: ColourFields
    blue: ColourFields
    u: torch.Tensor    # (2, R, C) mixture velocity


def _dot_c(vx, vy, cx=lat.CX, cy=lat.CY) -> list:
    """The 9 projections c_k . v with ``v`` given by its components."""
    return [cx[k] * vx + cy[k] * vy for k in range(Q)]


def _matvec(m: np.ndarray, planes) -> list:
    """sum_j m[i, j] planes[j] for each row i, as explicit sums."""
    return [sum(float(m[i, j]) * planes[j] for j in range(Q)) for i in range(Q)]


# ---------------------------------------------------------------------------
# Scalar fields
# ---------------------------------------------------------------------------

def phase_field(r_rho, r_rho_0, b_rho, b_rho_0):
    """psi = (r/r0 - b/b0)/(r/r0 + b/b0).
    cites reference test/mrtcg_static_droplet.cpp:264-277"""
    a = r_rho / r_rho_0
    b = b_rho / b_rho_0
    return (a - b) / (a + b)


@dataclass(frozen=True)
class RelaxationFunction:
    """Quadratic interface interpolation of the relaxation rate s_nu(psi).
    cites reference test/mrtcg_static_droplet.cpp:34-101"""

    delta: float
    r_val: float
    b_val: float
    s1: float
    s2: float
    s3: float
    t2: float
    t3: float

    @classmethod
    def from_values(cls, r_val: float, b_val: float, delta: float):
        s1 = 2.0 * r_val * b_val / (r_val + b_val)
        s2 = 2.0 * (r_val - s1) / delta
        s3 = -s2 / (2.0 * delta)
        t2 = 2.0 * (s1 - b_val) / delta
        t3 = t2 / (2.0 * delta)
        return cls(delta, r_val, b_val, s1, s2, s3, t2, t3)

    @classmethod
    def from_omegas(cls, red: ColourParams, blue: ColourParams, delta: float):
        return cls.from_values(red.rlx, blue.rlx, delta)

    def __call__(self, psi: torch.Tensor) -> torch.Tensor:
        # three selects in lbm_tpu's order: they fix the value at psi == 0
        # and psi == +/-delta, and a NaN stays a NaN
        pos = self.s1 + self.s2 * psi + self.s3 * psi * psi
        neg = self.s1 + self.t2 * psi + self.t3 * psi * psi
        out = torch.where(psi > self.delta, self.r_val, pos)
        out = torch.where(psi <= 0.0, neg, out)
        return torch.where(psi < -self.delta, self.b_val, out)


# ---------------------------------------------------------------------------
# Collision operators
# ---------------------------------------------------------------------------

def cg_equilibrium(rho_k, phi, eta, u):
    """Colour-gradient equilibrium
    f_eq = rho_k (phi_k + W (3 (u.c) eta_k + 9 (u.c)^2 - 3 u.u)).
    cites reference test/mrtcg_static_droplet.cpp:285-299"""
    cu = _dot_c(u[0], u[1])
    uu = u[0] * u[0] + u[1] * u[1]
    return torch.stack([
        rho_k * (float(phi[k]) + lat.WQ[k] * (3.0 * cu[k] * float(eta[k])
                                              + 9.0 * cu[k] * cu[k] - 3.0 * uu))
        for k in range(Q)])


def s_vector(s_nu, dtype):
    """Diagonal of the MRT relaxation matrix as a (9, R, C) stack:
    diag(0, 1.25, 1.14, 0, 1.6, 0, 1.6, s_nu, s_nu).
    cites reference test/mrtcg_static_droplet.cpp:432-435 + 279-283"""
    base = (0.0, 1.25, 1.14, 0.0, 1.6, 0.0, 1.6)
    rows = [torch.full_like(s_nu, v) for v in base]
    return torch.stack(rows + [s_nu, s_nu]).to(dtype)


def mrt_omega1(f, f_eq, corr_C, s_nu):
    """omega1 = Mi (s * M (feq - f) + C).
    cites reference test/mrtcg_static_droplet.cpp:301-313"""
    dm = _matvec(lat.M_MRT, f_eq - f)
    s = s_vector(s_nu, f.dtype)
    return torch.stack(_matvec(lat.MI_MRT, [dm[j] * s[j] + corr_C[j] for j in range(Q)]))


def correction_C(alpha, rho_k, u, s_nu):
    """Correction moments for the quartic-term error: only moments 1 and 7
    are nonzero.  cites reference test/mrtcg_static_droplet.cpp:372-388"""
    q = (1.8 * alpha - 0.8) * rho_k
    dxqx = gradients.dx5(q * u[0])
    dyqy = gradients.dy5(q * u[1])
    zeros = torch.zeros_like(dxqx)
    c1 = 3.0 * (1.0 - 0.5 * 1.25) * (dxqx + dyqy)
    c7 = (1.0 - 0.5 * s_nu) * (dxqx - dyqy)
    return torch.stack([zeros, c1] + [zeros] * 5 + [c7, zeros])


def xi_perturbation(grad, grad_norm):
    """xi = 0.5 |grad| (W ((grad.c)/(eps+|grad|))^2 - B).
    cites reference test/mrtcg_static_droplet.cpp:342-352"""
    gc = _dot_c(grad[0], grad[1])
    inv = 1e-20 + grad_norm
    return torch.stack([
        0.5 * grad_norm * (lat.WQ[k] * (gc[k] / inv) * (gc[k] / inv) - float(lat.B_CG[k]))
        for k in range(Q)])


def kappa_recolour(r_rho, b_rho, rho, grad, grad_norm, r_phi, b_phi,
                   unit_e: bool = True):
    """Recolouring flux kappa.
    cites reference test/mrtcg_static_droplet.cpp:354-370 and
    mrtcg_rayleigh_taylor.cpp:302-318 (grad . unit_E, the default); the CSF
    driver dots grad with the PLAIN E set, no 1/sqrt(2) on the diagonals
    (mrt_rayleigh_taylor.cpp:304-320), ``unit_e=False``."""
    uc = lat.UNIT_C if unit_e else lat.C
    guc = _dot_c(grad[0], grad[1], tuple(float(v) for v in uc[0]),
                 tuple(float(v) for v in uc[1]))
    den = (rho * rho) * (1e-20 + grad_norm)
    rb = r_rho * b_rho
    return torch.stack([
        rb * guc[k] * (r_rho * float(r_phi[k]) + b_rho * float(b_phi[k])) / den
        for k in range(Q)])


def recolour(total_f, rho_k, rho, beta_k, kappa):
    """omega3 = rho_k f/rho + beta_k kappa.
    cites reference test/mrtcg_static_droplet.cpp:327-340"""
    return (rho_k / rho)[None] * total_f + beta_k * kappa


# --- CSF (continuum surface force) variant pieces --------------------------

def local_curvature(n):
    """K = nx ny (dy nx + dx ny) - nx^2 dy ny - ny^2 dx nx, 5x5 stencil.
    cites reference test/mrt_rayleigh_taylor.cpp:355-363"""
    nx, ny = n[0], n[1]
    return (nx * ny * (gradients.dy5(nx) + gradients.dx5(ny))
            - nx * nx * gradients.dy5(ny)
            - ny * ny * gradients.dx5(nx))


def csf_eta(u, fs):
    """Colour-independent perturbation of the CSF forcing:
    eta_k = W_k (3 (c_k - u).F + 9 (u.c_k)(c_k.F)).
    cites reference test/mrt_rayleigh_taylor.cpp:365-384"""
    cu = _dot_c(u[0], u[1])
    cF = _dot_c(fs[0], fs[1])
    uF = u[0] * fs[0] + u[1] * fs[1]
    return torch.stack([lat.WQ[k] * (3.0 * cF[k] - 3.0 * uF + 9.0 * cu[k] * cF[k])
                        for k in range(Q)])


# ---------------------------------------------------------------------------
# Full step
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MRTCGModel:
    """One MRT-CG two-phase step with either the perturbation-operator
    surface tension ('perturbation', mrtcg_* drivers) or the CSF curvature
    force ('csf', mrt_rayleigh_taylor.cpp)."""

    red: ColourParams
    blue: ColourParams
    sigma: float
    gravity: tuple[float, float] = (0.0, 0.0)
    delta: float = 0.1
    surface_tension: str = "perturbation"  # or "csf"
    apply_gravity_source: bool = True
    # post-stream boundary rule applied to each colour: fn(f_adve, f_coll)
    boundary: object = None

    def relax(self) -> RelaxationFunction:
        return RelaxationFunction.from_omegas(self.red, self.blue, self.delta)

    def init_state(self, r_rho, b_rho, dtype=None, u_init_gravity_shift: bool = False,
                   u0=None, device=None) -> TwoPhaseState:
        """Equilibria of both colours at velocity ``u0`` (broadcastable to
        (2, R, C); the CSF RT driver starts at the scalar shift 0.5 Fg /
        red.rho_0, mrt_rayleigh_taylor.cpp:464-467), plus 0.5 Fg / rho with
        ``u_init_gravity_shift`` (mrtcg_static_droplet.cpp:452-457).
        ``device`` defaults to cuda (``default_device``)."""
        dtype = default_float(dtype)
        device = default_device(device)
        r_rho = torch.as_tensor(np.asarray(r_rho), dtype=dtype, device=device)
        b_rho = torch.as_tensor(np.asarray(b_rho), dtype=dtype, device=device)
        rho = r_rho + b_rho
        u = torch.zeros((2,) + tuple(r_rho.shape), dtype=dtype, device=device)
        if u0 is not None:
            u = u + torch.as_tensor(np.asarray(u0), dtype=dtype, device=device)
        if u_init_gravity_shift:
            fg = torch.as_tensor(self.gravity, dtype=dtype, device=device)
            u = u + 0.5 * fg[:, None, None] / rho[None]
        rf = cg_equilibrium(r_rho, self.red.phi(), self.red.eta(), u)
        bf = cg_equilibrium(b_rho, self.blue.phi(), self.blue.eta(), u)
        return TwoPhaseState(ColourFields(rf, r_rho), ColourFields(bf, b_rho), u)

    def step(self, state: TwoPhaseState) -> TwoPhaseState:
        r, b, u = state
        dtype = u.dtype
        fg = torch.as_tensor(self.gravity, dtype=dtype, device=u.device)

        r_eq = cg_equilibrium(r.rho, self.red.phi(), self.red.eta(), u)
        b_eq = cg_equilibrium(b.rho, self.blue.phi(), self.blue.eta(), u)

        psi = phase_field(r.rho, self.red.rho_0, b.rho, self.blue.rho_0)
        s_nu = self.relax()(psi)
        rho = r.rho + b.rho

        r_C = correction_C(self.red.alpha, r.rho, u, s_nu)
        b_C = correction_C(self.blue.alpha, b.rho, u, s_nu)
        r_o1 = mrt_omega1(r.f, r_eq, r_C, s_nu)
        b_o1 = mrt_omega1(b.f, b_eq, b_C, s_nu)

        grad = gradients.grad5(psi)
        grad_norm = torch.sqrt(grad[0] ** 2 + grad[1] ** 2)

        fst = None
        if self.surface_tension == "perturbation":
            xi = xi_perturbation(grad, grad_norm)
            A = 4.5 * self.sigma * s_nu
            r_o2 = A[None] * xi
            b_o2 = A[None] * xi
        else:  # CSF
            n = -grad / (1e-20 + grad_norm[None])
            K = local_curvature(n)
            fst = -0.5 * self.sigma * K[None] * grad
            eta_f = csf_eta(u, fst)
            r_o2 = self.red.A * (1.0 - 0.5 * self.red.rlx) * eta_f
            b_o2 = self.blue.A * (1.0 - 0.5 * self.blue.rlx) * eta_f

        kap = kappa_recolour(r.rho, b.rho, rho, grad, grad_norm,
                             self.red.phi(), self.blue.phi(),
                             unit_e=self.surface_tension != "csf")
        total = r.f + r_o1 + r_o2 + b.f + b_o1 + b_o2
        r_o3 = recolour(total, r.rho, rho, self.red.beta, kap)
        b_o3 = recolour(total, b.rho, rho, self.blue.beta, kap)

        if self.apply_gravity_source:
            src = d2q9.guo_source(u, fg, s_nu)
            r_col = r_o3 + src
            b_col = b_o3 + src
        else:
            r_col = r_o3
            b_col = b_o3

        r_adv = d2q9.stream(r_col)
        b_adv = d2q9.stream(b_col)
        if self.boundary is not None:
            r_adv = self.boundary(r_adv, r_col)
            b_adv = self.boundary(b_adv, b_col)

        r_rho = d2q9.calc_rho(r_adv)
        b_rho = d2q9.calc_rho(b_adv)
        rho = r_rho + b_rho
        u_new = d2q9.calc_u(r_adv + b_adv, rho)
        shift = fg[:, None, None]
        if fst is not None:
            shift = shift + fst
        u_new = u_new + 0.5 * shift / rho[None]
        return TwoPhaseState(ColourFields(r_adv, r_rho), ColourFields(b_adv, b_rho), u_new)
