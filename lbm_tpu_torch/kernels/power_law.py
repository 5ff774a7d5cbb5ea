"""Fused periodic truncated power-law collide-stream (counterpart of
lbm_tpu/kernels/power_law_pallas.py).

``power_law_collide_fn`` is the plain paired-direction collision with the
per-cell apparent tau of models/power_law.py (three branches: Newtonian
constant omega, Steffensen-Picard, and yield-stress Newton);
``make_power_law_fused_step`` returns a step that runs CUDA kernel 11
(csrc/collide_stream_power_law.cu) on a CUDA state and the plain
stream(power_law_collide_fn(f)) on a CPU state.  The branch is chosen on
the host; the kernel takes ``iters`` at run time.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..models.power_law import _SQ32, tiny_floor
from ..utils.xmath import resolve_fused, rounded
from . import _build, collide_stream

WQ = collide_stream.WQ
NEWTONIAN, PICARD, NEWTON = 0, 1, 2

# the order of the constants array the kernel takes
_CONSTANTS = ("om_const", "log_k", "nu_lo", "nu_hi", "nm1", "nn", "tau0", "tiny",
              "sq32", "sy", "mp", "neg_mp", "sy_mp", "tmin", "tmax")


def _branch(n: float, sigma_y: float) -> int:
    if float(sigma_y) > 0.0:
        return NEWTON
    return NEWTONIAN if float(n) == 1.0 else PICARD


def power_law_constants(cons_K: float, n: float, tau_min: float, tau_max: float,
                        dtype: torch.dtype, sigma_y: float = 0.0,
                        m_pap: float = 1e4) -> dict:
    """The collision's scalars rounded to ``dtype`` as lbm_tpu's ``dt(...)``
    are (power_law_pallas.py:48-66); sigma_y * m_pap is the product taken
    in ``dtype``.  The plain version and kernel 11 use these numbers."""
    r = lambda x: rounded(x, dtype)  # noqa: E731
    sy, mp = r(sigma_y), r(m_pap)
    return {
        "om_const": r(1.0 / min(max(0.5 + 3.0 * cons_K, tau_min), tau_max)),
        "log_k": r(math.log(cons_K)), "nu_lo": r((tau_min - 0.5) / 3.0),
        "nu_hi": r((tau_max - 0.5) / 3.0), "nm1": r(n - 1.0), "nn": r(n),
        "tau0": r(tau_max if n < 1.0 else tau_min), "tiny": r(tiny_floor(dtype)),
        "sq32": r(_SQ32), "sy": sy, "mp": mp, "neg_mp": -mp, "sy_mp": r(sy * mp),
        "tmin": r(tau_min), "tmax": r(tau_max),
    }


def power_law_collide_fn(cons_K: float, n: float, tau_min: float, tau_max: float,
                         iters: int, dtype: torch.dtype, sigma_y: float = 0.0,
                         m_pap: float = 1e4):
    """Truncated power-law / Herschel-Bulkley collision on a (9, R, C) state
    (lbm_tpu.kernels.power_law_pallas.power_law_collide_fn, in its order):
    the paired-direction compressible equilibrium, |Q|, the apparent tau of
    the host-chosen branch, coll_k = f_k - dq_k / tau.  The plain version of
    kernel 11."""
    branch = _branch(n, sigma_y)
    c = power_law_constants(cons_K, n, tau_min, tau_max, dtype, sigma_y, m_pap)

    def fn(f: torch.Tensor) -> torch.Tensor:
        rho = f[0]
        for k in range(1, 9):
            rho = rho + f[k]
        mx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8]
        my = f[2] - f[4] + f[5] + f[6] - f[7] - f[8]
        inv_rho = 1.0 / rho
        ux = mx * inv_rho
        uy = my * inv_rho

        t0, pairs = collide_stream.d2q9_pairs(ux, uy)
        feq = [None] * 9
        feq[0] = WQ[0] * rho * t0
        for kp, km, w, cu, cc in pairs:
            wr = w * rho
            even = wr * (t0 + 4.5 * cc)
            odd = wr * (3.0 * cu)
            feq[kp] = even + odd
            feq[km] = even - odd
        dq = [f[k] - feq[k] for k in range(9)]

        if branch == NEWTONIAN:
            om = c["om_const"]
        else:
            # |Q|: cx^2 = 1 on {1,3,5,6,7,8}, cy^2 = 1 on {2,4,5,6,7,8},
            # cx*cy = +1 on {5,7}, -1 on {6,8}
            qxx = dq[1] + dq[3] + dq[5] + dq[6] + dq[7] + dq[8]
            qyy = dq[2] + dq[4] + dq[5] + dq[6] + dq[7] + dq[8]
            qxy = dq[5] - dq[6] + dq[7] - dq[8]
            qn = torch.sqrt(qxx * qxx + 2.0 * qxy * qxy + qyy * qyy)
            a = (c["sq32"] * qn * inv_rho).clamp_min(c["tiny"])
            log_a = torch.log(a)
            om = _newton_omega(a, iters, c) if branch == NEWTON \
                else 1.0 / _picard_tau(log_a, rho, iters, c)
        return torch.stack([f[k] - om * dq[k] for k in range(9)])

    # the kind, constants, branch and iterations of kernel 27's power-law
    # instance (kernels/sharded.py)
    fn.halo_kernel = ("power_law", tuple(c[k] for k in _CONSTANTS), (branch, int(iters)))
    return fn


def _newton_omega(a, iters, c):
    """Bracket-clamped Newton on F(gdot) = gdot/2 + 3 sigma(gdot) = a."""
    gd_lo, gd_hi = a / c["tmax"], a / c["tmin"]
    gd = gd_lo
    for _ in range(iters):
        q = torch.exp(c["log_k"] + c["nm1"] * torch.log(gd))
        e = torch.exp(c["neg_mp"] * gd)
        h = 0.5 * gd + 3.0 * (c["sy"] * (1.0 - e) + q * gd) - a
        hp = 0.5 + 3.0 * (c["sy_mp"] * e + c["nn"] * q)
        gd = torch.clamp(gd - h / hp, gd_lo, gd_hi)
    nu = torch.exp(c["log_k"] + c["nm1"] * torch.log(gd)) \
        + c["sy"] * (-torch.expm1(c["neg_mp"] * gd)) / gd
    return 1.0 / (0.5 + 3.0 * torch.clamp(nu, c["nu_lo"], c["nu_hi"]))


def _picard_tau(log_a, rho, iters, c):
    """Steffensen: two Picard sweeps and one clipped Aitken update per
    round, from tau0."""

    def picard(t):
        lg = log_a - torch.log(t)          # log gdot
        nu = torch.exp(c["log_k"] + c["nm1"] * lg)
        return 0.5 + 3.0 * torch.clamp(nu, c["nu_lo"], c["nu_hi"])

    tau = torch.full_like(rho, c["tau0"])
    for i in range(iters):
        t1 = picard(tau)
        if i % 2 == 0:
            tprev = tau
            tau = t1
            continue
        den = t1 - 2.0 * tau + tprev
        accel = t1 - (t1 - tau) * (t1 - tau) / torch.where(den == 0.0, 1.0, den)
        tau = torch.where(den == 0.0, t1, torch.clamp(accel, c["tmin"], c["tmax"]))
    return tau


COLLIDE_STREAM_POWER_LAW = _build.CudaKernel(
    "lbm_collide_stream_power_law",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p])


def collide_stream_power_law(f: torch.Tensor, cons_K: float, n: float,
                             tau_min: float = 0.52, tau_max: float = 50.0,
                             iters: int = 8, sigma_y: float = 0.0,
                             m_pap: float = 1e4, substeps: int = 1) -> torch.Tensor:
    """``substeps`` periodic power-law collide-stream steps on the card
    (kernel 11)."""
    consts = _kernel_constants(cons_K, n, tau_min, tau_max, f.dtype, sigma_y, m_pap)
    return collide_stream.launch_steps(COLLIDE_STREAM_POWER_LAW, f, substeps,
                                          consts, _branch(n, sigma_y), int(iters))


@functools.cache
def _kernel_constants(cons_K, n, tau_min, tau_max, dtype, sigma_y, m_pap):
    """power_law_constants as the C array kernel 11 takes, made once per
    configuration (a launch would otherwise spend ~15 tensor ops on them)."""
    c = power_law_constants(cons_K, n, tau_min, tau_max, dtype, sigma_y, m_pap)
    return (ctypes.c_double * len(_CONSTANTS))(*(c[k] for k in _CONSTANTS))


def make_power_law_fused_step(R: int, C: int, *, cons_K: float, n: float,
                              tau_min: float = 0.52, tau_max: float = 50.0,
                              iters: int = 8, sigma_y: float = 0.0,
                              m_pap: float = 1e4, substeps: int = 1,
                              dtype: torch.dtype):
    """Power-law / Herschel-Bulkley step f (9, R, C) -> (9, R, C),
    ``substeps`` steps per call: kernel 11 on a CUDA state (one launch per
    step), the plain version on a CPU state."""
    plain = collide_stream.make_fused_step(
        R, C, power_law_collide_fn(cons_K, n, tau_min, tau_max, iters, dtype,
                                   sigma_y, m_pap), dtype, substeps)

    def step(f: torch.Tensor) -> torch.Tensor:
        if resolve_fused(f):
            collide_stream.check_step_state(f, R, C, dtype)
            return collide_stream_power_law(f, cons_K, n, tau_min, tau_max, iters,
                                            sigma_y, m_pap, substeps)
        return plain(f)

    return step
