"""Moment-space MRT + CSF static-droplet formulation (counterpart of
lbm_tpu/models/mrt_csf_droplet.py; the reference's
test/static_droplet_test.cpp:520-633).

Distinct from models/mrt_cg.py in three ways, all per the reference driver:
  * the MRT collision is written in moment space with an explicit
    alpha-dependent equilibrium moment vector m_eq (:363-378);
  * the CSF surface force enters in moment space,
    F_m = M (W ((3(c-u) + 9(c.u)c) . Fs)), scaled per colour by
    A (1 - omega/2) (build_F :598-624, mrtp_operator :312-344);
  * gradients and curvature use the driver-local 3x3 stencil with the
    reference's swapped axes (:79-139), and the recolouring term is
    beta (rho_k/rho) rho_other W (n.c) (:295-310).

lbm_tpu documents where it departs from the work-in-progress driver (the
standard basis m = M f where the driver multiplies by the untransposed
matrices, relaxation toward equilibrium, the de-mixing recolouring
direction); the port follows lbm_tpu.  This is the model oracle; the scene
runs the fused form of kernels/csf_droplet.py (plain version and CUDA
kernel 13).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core import lattice as lat
from ..ops import d2q9, gradients
from ..utils.xmath import default_device, default_float
from .mrt_cg import RelaxationFunction, _dot_c, _matvec
from .rk_cg import _tensor, rk_phi

Q = lat.Q
BASE_S = (0.0, 1.25, 1.14, 0.0, 1.6, 0.0, 1.6)  # rates of moments 0-6 (:232-234)


class CSFColourFields(NamedTuple):
    f: torch.Tensor
    rho: torch.Tensor


class CSFState(NamedTuple):
    red: CSFColourFields
    blue: CSFColourFields
    u: torch.Tensor


@dataclass(frozen=True)
class CSFColour:
    """Per-colour constants.  cites static_droplet_test.cpp:215-435:
    cs2 = 0.6 (1 - alpha) (:434), omega = 1/(0.5 + nu/cs2) (:411; the driver
    names it omega but builds tau, and the relaxation function then inverts,
    :554-555), s_e = 1.25, s_zeta = 1.14, s_q = 1.6 (:232-234)."""

    rho_0: float
    alpha: float
    nu: float
    A: float
    beta: float

    @property
    def cs2(self) -> float:
        return 0.6 * (1.0 - self.alpha)

    @property
    def tau(self) -> float:
        return 0.5 + self.nu / self.cs2

    @property
    def omega(self) -> float:
        return 1.0 / self.tau

    def phi(self):
        return rk_phi(self.alpha)

    def equ_factor(self):
        c_sq = (lat.C.astype(np.float64) ** 2).sum(axis=0)
        return 1.0 + 0.5 * (3.0 * self.cs2 - 1.0) * (3.0 * c_sq - 4.0)


def csf_equilibrium(rho_k, u, phi, equ_factor):
    """f_eq = rho_k (phi + W (3 (c.u) eta + 4.5 (c.u)^2 - 1.5 u.u)).
    cites static_droplet_test.cpp:380-388 (4.5, not the CG drivers' 9)."""
    cu = _dot_c(u[0], u[1])
    uu = u[0] * u[0] + u[1] * u[1]
    return torch.stack([
        rho_k * (float(phi[k]) + lat.WQ[k] * (3.0 * cu[k] * float(equ_factor[k])
                                              + 4.5 * cu[k] * cu[k] - 1.5 * uu))
        for k in range(Q)])


def m_eq(rho_k, u, alpha):
    """Equilibrium moment vector (9, R, C).  cites static_droplet_test.cpp:363-378"""
    ux, uy = u[0], u[1]
    uu = ux * ux + uy * uy
    a2 = -1.8 * alpha - 0.2
    rows = [torch.ones_like(ux), -3.6 * alpha - 0.4 + 3.0 * uu, 5.4 * alpha - 1.4 - 3.0 * uu,
            ux, a2 * ux, uy, a2 * uy, ux * ux - uy * uy, ux * uy]
    return rho_k[None] * torch.stack(rows)


def force_moments(u, fs):
    """CSF force in moment space: M (W ((3(c-u) + 9(c.u)c) . Fs)).
    cites static_droplet_test.cpp:598-624 (build_F)"""
    cu = _dot_c(u[0], u[1])
    cF = _dot_c(fs[0], fs[1])
    uF = u[0] * fs[0] + u[1] * fs[1]
    Fq = [lat.WQ[k] * (3.0 * cF[k] - 3.0 * uF + 9.0 * cu[k] * cF[k]) for k in range(Q)]
    return torch.stack(_matvec(lat.M_MRT, Fq))


@dataclass(frozen=True)
class CSFDropletModel:
    """Full step per static_droplet_test.cpp:520-576: phase field, 3x3
    gradient, thresholded unit normal, curvature, Fs = 0.5 sigma K grad,
    per-colour moment-space MRT with CSF forcing, recolouring, fully
    periodic streaming (:449-456), macroscopics with u += 0.5 Fs/rho."""

    red: CSFColour
    blue: CSFColour
    sigma: float = 0.1
    delta: float = 0.1

    def relax(self) -> RelaxationFunction:
        # interpolates taus, inverted to rates per cell (:486, 554-555)
        return RelaxationFunction.from_values(self.red.tau, self.blue.tau, self.delta)

    def init_state(self, r_rho, b_rho, dtype=None, device=None) -> CSFState:
        """Equilibria at rest.  ``device`` defaults to cuda."""
        dtype, device = default_float(dtype), default_device(device)
        r_rho = _tensor(r_rho, dtype, device)
        b_rho = _tensor(b_rho, dtype, device)
        u = torch.zeros((2,) + tuple(r_rho.shape), dtype=dtype, device=device)
        rf = csf_equilibrium(r_rho, u, self.red.phi(), self.red.equ_factor())
        bf = csf_equilibrium(b_rho, u, self.blue.phi(), self.blue.equ_factor())
        return CSFState(CSFColourFields(rf, d2q9.calc_rho(rf)),
                        CSFColourFields(bf, d2q9.calc_rho(bf)), u)

    def step(self, state: CSFState) -> CSFState:
        r, b, u = state
        rho_mix = r.rho + b.rho
        psi = (r.rho / self.red.rho_0 - b.rho / self.blue.rho_0) / (
            r.rho / self.red.rho_0 + b.rho / self.blue.rho_0)
        grad = gradients.grad3(psi)  # reference-swapped axes
        gn = torch.sqrt(grad[0] ** 2 + grad[1] ** 2)
        # thresholded, normalised inward normal (:540-544)
        n = -torch.where(gn[None] >= 1e-1, grad / torch.where(gn == 0.0, 1.0, gn)[None], 0.0)
        K = (n[0] * n[1] * (gradients.dy3(n[0]) + gradients.dx3(n[1]))
             - n[0] ** 2 * gradients.dy3(n[1])
             - n[1] ** 2 * gradients.dx3(n[0]))
        fs = 0.5 * self.sigma * K[None] * grad  # (:548-550, K from -n)

        s_nu = 1.0 / self.relax()(psi)  # tau field -> rate (:554-555)
        F_m = force_moments(u, fs)
        nc = _dot_c(n[0], n[1])

        def colour_step(col: CSFColourFields, other_rho, params: CSFColour):
            # moment-space MRT with per-cell s_nu on rows 7, 8 (:346-350)
            m = _matvec(lat.M_MRT, col.f)
            dm = m_eq(col.rho, u, params.alpha) - torch.stack(m)
            forcing = params.A * (1.0 - 0.5 * params.omega) * F_m
            relaxed = [BASE_S[i] * (dm[i] + forcing[i]) for i in range(7)]
            relaxed += [s_nu * (dm[7] + forcing[7]), s_nu * (dm[8] + forcing[8])]
            # correction moments C1, C7 from the 3x3 gradient of Q (:352-361)
            a = 1.8 * params.alpha - 0.8
            qx = a * col.rho * u[0]
            qy = a * col.rho * u[1]
            relaxed[1] = relaxed[1] + 3.0 * (1.0 - 0.5 * 1.25) * (
                gradients.dx3(qx) + gradients.dy3(qy))
            relaxed[7] = relaxed[7] + (1.0 - 0.5 * s_nu) * (gradients.dx3(qx) - gradients.dy3(qy))
            mrtp = _matvec(lat.MI_MRT, relaxed)
            # recolouring (:295-310) along -n, the de-mixing direction
            # lbm_tpu takes (its model's notes)
            ratio = col.rho / rho_mix
            f_coll = torch.stack([
                col.f[k] + (ratio * mrtp[k]
                            + params.beta * ratio * other_rho * lat.WQ[k] * (-nc[k]))
                for k in range(Q)])
            f_adv = d2q9.stream(f_coll)  # fully periodic (:449-456)
            return CSFColourFields(f_adv, d2q9.calc_rho(f_adv))

        r_new = colour_step(r, b.rho, self.red)
        b_new = colour_step(b, r.rho, self.blue)
        rho_new = r_new.rho + b_new.rho
        u_new = d2q9.calc_u(r_new.f + b_new.f, rho_new) + 0.5 * fs / rho_new[None]
        return CSFState(r_new, b_new, u_new)
