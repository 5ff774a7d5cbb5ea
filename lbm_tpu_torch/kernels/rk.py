"""The fused RK colour-gradient mixture step: plain version and CUDA kernel 12
(counterpart of lbm_tpu/kernels/rk_pallas.py).

State ``S (11, R, C) = [f (9), r_rho, b_rho]``: the colour-blind
populations and the two colour densities.  One step computes the mixture
relaxation rate omega_rp, the alpha/phi fields, the 5x5 replicate-padded
colour gradient, BGK + Guo gravity + the Reis perturbation in
opposite-pair even/odd parts, the +/-beta recolouring, per-colour streaming
with the multiphase walls (kernels/mrtcg.py ``stream_with_bcs``, the rule
of kernel 6), and the colour sums.

The colour gradient is taken ONCE, on r_rho/rho, as lbm_tpu's kernel does
(rk_pallas.py:54-64): a_frac + b_frac == 1 and the stencil annihilates
constants, so (b grad(r/rho) - r grad(b/rho))/rho == grad(r/rho) up to
round-off.  lbm_tpu's jnp model (models/rk_cg.py ``colour_gradient``)
keeps the two-pass form; the tests hold this step to it at a measured
tolerance.

``make_plain_step`` is the arithmetic of lbm_tpu's ``_make_collide`` term
for term; csrc/rk_cg.cu does the same in the same order.
``make_rk_fused_step`` runs kernel 12 on a CUDA state (one launch per
step) and the plain version on a CPU state.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import lattice as lat
from ..ops import gradients
from ..utils.xmath import resolve_fused
from . import _build
from .collide_stream import PAIR_KS, check_step_state, launch_steps, pair_cu
from .mrtcg import _check_substeps, stream_with_bcs

CX, CY, WQ = lat.CX, lat.CY, lat.WQ
BQ = tuple(float(v) for v in lat.B_CG)
NCX = tuple(float(v) for v in lat.UNIT_C[0])
NCY = tuple(float(v) for v in lat.UNIT_C[1])
PLANES = 11


def kernel_params(r_alpha, b_alpha, r_nu, b_nu, sigma, beta, gravity) -> tuple[float, ...]:
    """Every scalar of the step as the Python doubles the plain version
    multiplies by, in the order csrc/rk_cg.cu ``P`` reads them: the four
    colour constants, 4.5 sigma, beta, the gravity flag and (gx, gy), then
    per pair leader c.g and 3 c.g."""
    gx, gy = float(gravity[0]), float(gravity[1])
    cF = [CX[kp] * gx + CY[kp] * gy for kp, _ in PAIR_KS]
    return tuple(float(v) for v in (
        r_alpha, b_alpha, r_nu, b_nu, 4.5 * sigma, beta, float(bool(gx or gy)), gx, gy,
        *cF, *(3.0 * c for c in cF)))


def make_collide(r_alpha, b_alpha, r_nu, b_nu, sigma, beta=0.7, gravity=(0.0, 0.0)):
    """``collide(planes) -> (coll_r, coll_b)``: the recoloured per-colour
    post-collision populations of the 11-plane state (lbm_tpu
    rk_pallas.py:31-127, written term for term); ``rows``/``grid_rows``
    and ``cols``/``grid_cols`` make the planes a block of a larger grid
    (ops/gradients.py dx5)."""
    (r_alpha, b_alpha, r_nu, b_nu, a_sigma, beta, source, gx, gy,
     *cF3) = kernel_params(r_alpha, b_alpha, r_nu, b_nu, sigma, beta, gravity)
    cF, cF3 = cF3[:4], cF3[4:]

    def collide(planes, rows=None, grid_rows=None, cols=None, grid_cols=None):
        f = [planes[k] for k in range(9)]
        r_rho, b_rho = planes[9], planes[10]
        rho = r_rho + b_rho
        inv_rho = 1.0 / rho
        mx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8]
        my = f[2] - f[4] + f[5] + f[6] - f[7] - f[8]
        ux = mx * inv_rho
        uy = my * inv_rho
        uu = ux * ux + uy * uy

        # mixture relaxation rate (src/rk.cpp:184-194), alpha/phi (:127-154)
        omega = rho / (3.0 * (r_rho * r_nu + b_rho * b_nu) + 0.5 * rho)
        alpha = (r_alpha * r_rho + b_alpha * b_rho) * inv_rho
        phi_ax = 0.2 - 0.2 * alpha
        phi_di = 0.05 - 0.05 * alpha

        # the colour gradient, one pass on r_rho / rho (see module docstring)
        a_frac = r_rho * inv_rho
        Fx = gradients.dx5(a_frac, rows, grid_rows, cols, grid_cols)
        Fy = gradients.dy5(a_frac, rows, grid_rows, cols, grid_cols)
        Fn = torch.sqrt(Fx * Fx + Fy * Fy)
        inv_Fn = 1.0 / (Fn + 1e-20)

        C_kl = 1.0 - torch.abs((r_rho - b_rho) * inv_rho)
        A_kl = a_sigma * omega
        AC = A_kl * C_kl * Fn
        inv_F2 = 1.0 / (1e-20 + Fn * Fn)

        rb = r_rho * b_rho * inv_rho
        ratio_r = r_rho * inv_rho
        ratio_b = b_rho * inv_rho
        cu_p = pair_cu(ux, uy)
        Fc_p = pair_cu(Fx, Fy)
        one_m = 1.0 - omega
        pref = 1.0 - 0.5 * omega
        uF3 = 3.0 * (ux * gx + uy * gy) if source else None
        uu15 = 1.5 * uu

        coll_r, coll_b = [None] * 9, [None] * 9

        def emit(k, post, kap):
            coll_r[k] = ratio_r * post if kap is None else ratio_r * post + beta * kap
            coll_b[k] = ratio_b * post if kap is None else ratio_b * post - beta * kap

        post0 = one_m * f[0] + omega * (rho * (alpha - WQ[0] * uu15)) + AC * (-BQ[0])
        if source:
            post0 = post0 + pref * (-uF3) * WQ[0]
        emit(0, post0, None)
        for i, (kp, km) in enumerate(PAIR_KS):
            phi = phi_ax if kp < 5 else phi_di
            w = WQ[kp]
            cu = cu_p[kp]
            even_f = omega * (rho * (phi + w * (4.5 * cu * cu - uu15)))
            odd_f = omega * (rho * ((3.0 * w) * cu))
            Fc = Fc_p[kp]
            omega2 = AC * (w * Fc * Fc * inv_F2 - BQ[kp])
            base_p = one_m * f[kp] + (even_f + odd_f) + omega2
            base_m = one_m * f[km] + (even_f - odd_f) + omega2
            if source:
                pw = pref * w
                even_s = pw * (9.0 * cu * cF[i] - uF3)
                odd_s = pw * cF3[i]
                base_p = base_p + (even_s + odd_s)
                base_m = base_m + (even_s - odd_s)
            # recolouring (src/rk.cpp:82-92) along the unit velocity set
            kap = rb * (NCX[kp] * Fx + NCY[kp] * Fy) * inv_Fn * phi
            emit(kp, base_p, kap)
            emit(km, base_m, -kap)
        return coll_r, coll_b

    return collide


def make_plain_step(r_alpha, b_alpha, r_nu, b_nu, sigma, beta=0.7, gravity=(0.0, 0.0)):
    """The plain version of one step on the 11-plane state: collide, stream
    each colour with the multiphase walls, add the colours.  ``step(S, rows,
    grid_rows, cols, grid_cols)`` steps a block of a larger grid
    (kernels/mrtcg.py make_plain_step)."""
    collide = make_collide(r_alpha, b_alpha, r_nu, b_nu, sigma, beta, gravity)

    def step(S: torch.Tensor, rows=None, grid_rows=None, cols=None,
             grid_cols=None) -> torch.Tensor:
        block = (rows, grid_rows, cols, grid_cols)
        coll_r, coll_b = collide(S, *block)
        new_r = stream_with_bcs(coll_r, *block)
        new_b = stream_with_bcs(coll_b, *block)
        r_rho, b_rho = new_r[0], new_b[0]
        for k in range(1, 9):
            r_rho = r_rho + new_r[k]
            b_rho = b_rho + new_b[k]
        return torch.stack([new_r[k] + new_b[k] for k in range(9)] + [r_rho, b_rho])

    return step


RK_CG = _build.CudaKernel(
    "lbm_rk_cg",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_void_p])


def launch_rk(S: torch.Tensor, c_params: ctypes.Array, substeps: int = 1) -> torch.Tensor:
    """``substeps`` launches of kernel 12 (``collide_stream.launch_steps``);
    ``c_params`` are ``kernel_params``' doubles as ``_build.c_doubles`` gives
    them.  The tile engine of kernel 6
    needs R >= 4 and C >= 3 (two wall rows, the seam columns)."""
    R, C = _build.check_state(S, PLANES)
    if R < 4 or C < 3:
        raise ValueError(f"kernel 12 takes R >= 4 and C >= 3, got {R}x{C}")
    return launch_steps(RK_CG, S, substeps, c_params, planes=PLANES)


def make_rk_fused_step(R: int, C: int, *, r_alpha: float, b_alpha: float, r_nu: float,
                       b_nu: float, sigma: float, beta: float = 0.7, gravity=(0.0, 0.0),
                       dtype: torch.dtype = torch.float32, substeps: int = 1):
    """Fused RK mixture step S (11, R, C) -> (11, R, C) with S = [f (9),
    r_rho, b_rho], ``substeps`` steps per call: kernel 12 on a CUDA state
    (one launch per step), the plain version on a CPU state."""
    substeps = _check_substeps(substeps)
    c_params = _build.c_doubles(kernel_params(r_alpha, b_alpha, r_nu, b_nu, sigma, beta,
                                              gravity))
    plain = make_plain_step(r_alpha, b_alpha, r_nu, b_nu, sigma, beta, gravity)

    def step(S: torch.Tensor) -> torch.Tensor:
        check_step_state(S, R, C, dtype, PLANES)
        if resolve_fused(S):
            return launch_rk(S, c_params, substeps)
        for _ in range(substeps):
            S = plain(S)
        return S

    return step
