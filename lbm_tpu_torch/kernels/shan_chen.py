"""The fused Shan-Chen pseudopotential step: plain version and CUDA kernel 14
(counterpart of lbm_tpu/kernels/shan_chen_pallas.py).

State ``f (9, R, C)``, fully periodic.  One step computes psi(rho) (the
exponential EOS, or Carnahan-Starling with its sqrt and clamp), the paired
neighbour force F = -G psi sum_k w_k (psi(x + c_k) - psi(x - c_k)) c_k over
the pair leaders, the forced BGK collision (``guo``: half-force velocity
shift plus the paired Guo source; ``shift``: u_eq = u + F/(omega rho)),
and the periodic stream.

``make_plain_step`` is the arithmetic of lbm_tpu's ``_collide_sc`` /
``_sc_force`` / ``_bgk9`` term for term; csrc/shan_chen.cu does the same in
the same order, with eos in {sc, cs} x forcing in {guo, shift} as template
instances.  One departure from lbm_tpu's arithmetic, in both: the CS EOS
takes rho * (1/3) where lbm_tpu divides rho by 3, because PyTorch on a
CUDA tensor divides by a Python scalar as a multiplication by its
reciprocal; written as the product, the plain version is the same on both
devices (one ulp from lbm_tpu's quotient).

lbm_tpu fuses up to 4 steps per launch (``substeps``, shan_chen_pallas.py
:148-151, a bound from its halo rows); the port runs ``substeps`` launches
per call, one per step, so any ``substeps >= 1`` goes.  ``make_sc_fused_step`` runs kernel 14 on a CUDA state
and the plain version on a CPU state.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import lattice as lat
from ..models import shan_chen as sc
from ..ops import d2q9
from ..utils.xmath import resolve_fused
from . import _build
from .collide_stream import check_step_state, d2q9_pairs, launch_steps
from .mrtcg import _check_substeps

CX, CY, WQ = lat.CX, lat.CY, lat.WQ
EOS = ("sc", "cs")
FORCING = ("guo", "shift")


def resolve_eos(eos: str, G: float | None, T: float | None, forcing: str | None):
    """(psi_of, G, forcing) with the model's defaults: the exponential EOS
    runs Guo forcing at the caller's G; Carnahan-Starling fixes G = -1 and
    takes the velocity-shift scheme (Guo forcing NaNs on the stiff EOS,
    models.shan_chen.collide).  ``psi_of`` is the plain version's psi."""
    if forcing is not None and forcing not in FORCING:
        raise ValueError(f"unknown forcing {forcing!r} (want one of {FORCING})")
    if eos == "sc":
        if G is None:
            raise ValueError("eos='sc' needs the coupling G")
        return (lambda rho: 1.0 - torch.exp(-rho)), float(G), forcing or "guo"
    if eos == "cs":
        if T is None:
            raise ValueError("eos='cs' needs a temperature T")
        Tf, a, b = float(T), sc.CS_A, sc.CS_B

        def psi_of(rho):
            eta = (0.25 * b) * rho
            e2 = eta * eta
            om = 1.0 - eta
            P = rho * Tf * (1.0 + eta + e2 - e2 * eta) / (om * om * om) - a * rho * rho
            rad = 6.0 * (rho * (1.0 / 3.0) - P)
            return torch.sqrt(torch.where(rad < 0.0, 0.0, rad))

        return psi_of, -1.0, forcing or "shift"
    raise ValueError(f"unknown eos {eos!r} (want one of {EOS})")


def sc_force_pairs(psi_p: torch.Tensor, G: float):
    """(Fx, Fy) = -G psi sum over the pair leaders of w (psi(x + c) -
    psi(x - c)) c, periodic (lbm_tpu shan_chen_pallas.py:44-68)."""
    fx = fy = None
    for kp in (1, 2, 5, 8):
        pos = torch.roll(psi_p, (-CX[kp], -CY[kp]), (0, 1))
        neg = torch.roll(psi_p, (CX[kp], CY[kp]), (0, 1))
        d = WQ[kp] * (pos - neg)
        if CX[kp] != 0:
            t = CX[kp] * d
            fx = t if fx is None else fx + t
        if CY[kp] != 0:
            t = CY[kp] * d
            fy = t if fy is None else fy + t
    mg = -G * psi_p
    return mg * fx, mg * fy


def _bgk9(f, ux, uy, rho, omega: float):
    """(1 - omega) f + omega feq, the paired compressible equilibrium
    (lbm_tpu sediment_pallas.py:49-64)."""
    t0, pairs = d2q9_pairs(ux, uy)
    out = [None] * 9
    out[0] = (1.0 - omega) * f[0] + omega * (WQ[0] * rho * t0)
    for kp, km, w, cu, cc in pairs:
        wr = w * rho
        even = omega * (wr * (t0 + 4.5 * cc))
        odd = omega * (wr * (3.0 * cu))
        out[kp] = (1.0 - omega) * f[kp] + (even + odd)
        out[km] = (1.0 - omega) * f[km] + (even - odd)
    return out


def make_collide(omega: float, G: float | None = None, eos: str = "sc",
                 T: float | None = None, forcing: str | None = None):
    """The Shan-Chen collision of a (9, R, C) state as a list of 9 planes
    (lbm_tpu shan_chen_pallas.py:71-106)."""
    psi_of, G, forcing = resolve_eos(eos, G, T, forcing)

    def collide(f):
        rho = f[0]
        for k in range(1, 9):
            rho = rho + f[k]
        Fx, Fy = sc_force_pairs(psi_of(rho), G)
        inv_rho = 1.0 / rho
        mx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8]
        my = f[2] - f[4] + f[5] + f[6] - f[7] - f[8]
        if forcing == "shift":
            inv_om = 1.0 / omega
            return _bgk9(f, (mx + inv_om * Fx) * inv_rho, (my + inv_om * Fy) * inv_rho, rho,
                         omega)
        ux = (mx + 0.5 * Fx) * inv_rho
        uy = (my + 0.5 * Fy) * inv_rho
        out = _bgk9(f, ux, uy, rho, omega)
        pref = 1.0 - 0.5 * omega
        uF3 = 3.0 * (ux * Fx + uy * Fy)
        out[0] = out[0] - pref * WQ[0] * uF3
        _, pairs = d2q9_pairs(ux, uy)
        cf = {1: Fx, 2: Fy, 5: Fx + Fy, 8: Fx - Fy}
        for kp, km, w, cu, _cc in pairs:
            cF = cf[kp]
            even = pref * w * (9.0 * cu * cF - uF3)
            odd = pref * w * (3.0 * cF)
            out[kp] = out[kp] + (even + odd)
            out[km] = out[km] + (even - odd)
        return out

    return collide


def make_plain_step(omega: float, G: float | None = None, eos: str = "sc",
                    T: float | None = None, forcing: str | None = None):
    """The plain version of one step: stream(collide(f)), fully periodic."""
    collide = make_collide(omega, G, eos, T, forcing)
    return lambda f: d2q9.stream(torch.stack(collide(f)))


def kernel_params(omega: float, G: float | None = None, eos: str = "sc",
                  T: float | None = None, forcing: str | None = None):
    """(eos index, forcing index, the doubles csrc/shan_chen.cu ``P`` reads):
    omega, 1 - omega, 1/omega, -G, the Guo source's pref w for the rest,
    axis and diagonal directions, and the CS EOS's b/4, T and a."""
    _, G, forcing = resolve_eos(eos, G, T, forcing)
    pref = 1.0 - 0.5 * omega
    params = (omega, 1.0 - omega, 1.0 / omega, -G, pref * WQ[0], pref * WQ[1], pref * WQ[5],
              0.25 * sc.CS_B, float(T) if eos == "cs" else 0.0, sc.CS_A)
    return EOS.index(eos), FORCING.index(forcing), tuple(float(v) for v in params)


SHAN_CHEN = _build.CudaKernel(
    "lbm_shan_chen",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p])


def make_sc_fused_step(R: int, C: int, *, omega: float, G: float | None = None,
                       substeps: int = 1, eos: str = "sc", T: float | None = None,
                       forcing: str | None = None, dtype: torch.dtype = torch.float32):
    """Fused periodic Shan-Chen step f (9, R, C) -> (9, R, C), ``substeps``
    steps per call: kernel 14 on a CUDA state (one launch per step),
    the plain version on a CPU state.  ``eos='cs'`` runs the
    Carnahan-Starling pseudopotential at temperature ``T`` (G fixed at -1,
    velocity-shift forcing unless ``forcing`` says otherwise)."""
    substeps = _check_substeps(substeps)
    eos_i, forcing_i, params = kernel_params(omega, G, eos, T, forcing)
    c_params = _build.c_doubles(params)
    plain = make_plain_step(omega, G, eos, T, forcing)

    def step(f: torch.Tensor) -> torch.Tensor:
        check_step_state(f, R, C, dtype)
        if resolve_fused(f):
            return launch_steps(SHAN_CHEN, f, substeps, c_params, eos_i, forcing_i)
        for _ in range(substeps):
            f = plain(f)
        return f

    return step
