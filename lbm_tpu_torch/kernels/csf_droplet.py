"""The fused moment-space MRT + CSF static-droplet step: plain version and
CUDA kernel 13 (counterpart of lbm_tpu/kernels/csf_droplet_pallas.py).

State ``S (20, R, C) = [red f (9), blue f (9), fs (2)]``: the surface force
is carried, so the step derives the model's velocity exactly,
u = (momentum + 0.5 fs_prev) / rho (at the start fs = 0 and u = 0).  One
step computes psi; the reference-swapped 3x3 gradient with replicate
edges; the THRESHOLDED inward normal (|grad| >= 0.1); the curvature from a
second 3x3 pass; fs = sigma/2 K grad; the CSF force moments; per-colour
moment-space MRT with the 3x3 correction moments; the recolouring along
-n; and a fully periodic stream, carrying fs.  The stencils clamp at the
global edges while the stream wraps.

``make_plain_step`` is the arithmetic of lbm_tpu's kernel body
(csf_droplet_pallas.py:102-220) term for term, its stencils those of
ops/gradients.py; csrc/csf_droplet.cu does the same in the same order.
The threshold is a discontinuous select: an operation order that moved
|grad| by one ulp would flip a normal, so the kernel keeps this order
exactly.  ``make_csf_droplet_fused_step`` runs kernel 13 on a CUDA state
(one launch per step) and the plain version on a CPU state.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import lattice as lat
from ..models.mrt_cg import RelaxationFunction
from ..ops import d2q9, gradients
from ..utils.xmath import resolve_fused
from . import _build
from .collide_stream import PAIR_KS, check_step_state, launch_steps, pair_cu
from .mrtcg import M_ROWS, MI_ROWS, _check_substeps

WQ = lat.WQ
BASE_S = (0.0, 1.25, 1.14, 0.0, 1.6, 0.0, 1.6)  # rows 7, 8 take s_nu
PLANES = 20


def _mmul(rows_tbl, vec):
    """Unrolled scalar-coefficient matmul, zero weights and absent (None)
    entries skipped (lbm_tpu csf_droplet_pallas.py:51-63)."""
    out = []
    for r in range(9):
        acc = None
        for q in range(9):
            w = rows_tbl[r][q]
            if w == 0.0 or vec[q] is None:
                continue
            term = vec[q] if w == 1.0 else w * vec[q]
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


def kernel_params(red, blue, sigma: float, delta: float = 0.1) -> tuple[float, ...]:
    """Every scalar of the step as the Python doubles the plain version
    multiplies by, in the order csrc/csf_droplet.cu ``P`` reads them:
    1/rho_0 per colour, the relaxation function of the taus, sigma/2, then
    per colour (red, blue) the m_eq constants, the correction factor, the
    force prefactor A (1 - omega/2) and beta.  ``red``/``blue`` are
    models.mrt_csf_droplet.CSFColour."""
    relax = RelaxationFunction.from_values(red.tau, blue.tau, delta)
    colour = []
    for c in (red, blue):
        colour += [-3.6 * c.alpha - 0.4, 5.4 * c.alpha - 1.4, -1.8 * c.alpha - 0.2,
                   1.8 * c.alpha - 0.8, c.A * (1.0 - 0.5 * c.omega), c.beta]
    return tuple(float(v) for v in (
        1.0 / red.rho_0, 1.0 / blue.rho_0, relax.delta, relax.r_val, relax.b_val,
        relax.s1, relax.s2, relax.s3, relax.t2, relax.t3, 0.5 * sigma, *colour))


def make_plain_step(red, blue, sigma: float, delta: float = 0.1):
    """The plain version of one step on the 20-plane state."""
    params = kernel_params(red, blue, sigma, delta)
    inv_r0, inv_b0, half_sigma, colours = params[0], params[1], params[10], params[11:]
    relax = RelaxationFunction.from_values(red.tau, blue.tau, delta)

    def step(S: torch.Tensor) -> torch.Tensor:
        rf = [S[k] for k in range(9)]
        bf = [S[9 + k] for k in range(9)]
        fsx_prev, fsy_prev = S[18], S[19]
        r_rho, b_rho = rf[0], bf[0]
        for k in range(1, 9):
            r_rho = r_rho + rf[k]
            b_rho = b_rho + bf[k]
        rho = r_rho + b_rho
        inv_rho = 1.0 / rho
        f_tot = [rf[k] + bf[k] for k in range(9)]
        mom_x = f_tot[1] - f_tot[3] + f_tot[5] - f_tot[6] - f_tot[7] + f_tot[8]
        mom_y = f_tot[2] - f_tot[4] + f_tot[5] + f_tot[6] - f_tot[7] - f_tot[8]
        # the model's carried u = calc_u + 0.5 fs_prev / rho
        ux = (mom_x + 0.5 * fsx_prev) * inv_rho
        uy = (mom_y + 0.5 * fsy_prev) * inv_rho
        uu = ux * ux + uy * uy

        a = r_rho * inv_r0
        b = b_rho * inv_b0
        psi = (a - b) / (a + b)
        s_nu = 1.0 / relax(psi)

        # reference-swapped 3x3 gradients, replicate edges
        g0, g1 = gradients.dx3(psi), gradients.dy3(psi)
        gn = torch.sqrt(g0 * g0 + g1 * g1)
        inv_safe = 1.0 / torch.where(gn == 0.0, 1.0, gn)
        thr = gn >= 1e-1
        n0 = -torch.where(thr, g0 * inv_safe, 0.0)
        n1 = -torch.where(thr, g1 * inv_safe, 0.0)
        d0n0, d1n0 = gradients.dx3(n0), gradients.dy3(n0)
        d0n1, d1n1 = gradients.dx3(n1), gradients.dy3(n1)
        K = n0 * n1 * (d1n0 + d0n1) - n0 * n0 * d1n1 - n1 * n1 * d0n0
        fsx = half_sigma * (K * g0)
        fsy = half_sigma * (K * g1)

        # the CSF force per direction, then in moment space (build_F :598-624)
        cu_p = pair_cu(ux, uy)
        cF_p = pair_cu(fsx, fsy)
        uF3 = 3.0 * (ux * fsx + uy * fsy)
        Fq = [None] * 9
        Fq[0] = WQ[0] * (-uF3)
        for kp, km in PAIR_KS:
            even = WQ[kp] * (9.0 * cu_p[kp] * cF_p[kp] - uF3)
            odd = WQ[kp] * (3.0 * cF_p[kp])
            Fq[kp] = even + odd
            Fq[km] = even - odd
        F_m = _mmul(M_ROWS, Fq)
        nc_p = pair_cu(n0, n1)

        def colour(f, rho_k, other_rho, ratio, consts):
            c1, c2, a2, acorr, pref, beta = consts
            m = _mmul(M_ROWS, f)
            meq = [None, rho_k * (c1 + 3.0 * uu), rho_k * (c2 - 3.0 * uu), None,
                   rho_k * (a2 * ux), None, rho_k * (a2 * uy), rho_k * (ux * ux - uy * uy),
                   rho_k * (ux * uy)]
            relaxed = [None] * 9
            for i in (1, 2, 4, 6):
                relaxed[i] = BASE_S[i] * (meq[i] - m[i] + pref * F_m[i])
            for i in (7, 8):
                relaxed[i] = s_nu * (meq[i] - m[i] + pref * F_m[i])
            # 3x3 correction moments
            qx = acorr * rho_k * ux
            qy = acorr * rho_k * uy
            dqx, dqy = gradients.dx3(qx), gradients.dy3(qy)
            relaxed[1] = relaxed[1] + 3.0 * (1.0 - 0.5 * 1.25) * (dqx + dqy)
            relaxed[7] = relaxed[7] + (1.0 - 0.5 * s_nu) * (dqx - dqy)
            mrtp = _mmul(MI_ROWS, relaxed)
            # recolouring along -n
            br = beta * ratio * other_rho
            coll = [None] * 9
            coll[0] = f[0] + ratio * mrtp[0]
            for kp, km in PAIR_KS:
                reco_odd = br * (WQ[kp] * (-nc_p[kp]))
                coll[kp] = f[kp] + ratio * mrtp[kp] + reco_odd
                coll[km] = f[km] + ratio * mrtp[km] - reco_odd
            return coll

        coll_r = colour(rf, r_rho, b_rho, r_rho * inv_rho, colours[:6])
        coll_b = colour(bf, b_rho, r_rho, b_rho * inv_rho, colours[6:])
        # fully periodic streaming (static_droplet_test.cpp:449-456); fs is
        # carried, not streamed
        return torch.cat([d2q9.stream(torch.stack(coll_r)), d2q9.stream(torch.stack(coll_b)),
                          torch.stack([fsx, fsy])])

    return step


CSF_DROPLET = _build.CudaKernel(
    "lbm_csf_droplet",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_void_p])


def make_csf_droplet_fused_step(R: int, C: int, red, blue, sigma: float, delta: float = 0.1,
                                dtype: torch.dtype = torch.float32, substeps: int = 1):
    """Fused CSF droplet step S (20, R, C) -> (20, R, C), ``substeps`` steps
    per call: kernel 13 on a CUDA state (one launch per step), the plain
    version on a CPU state.  ``red``/``blue`` are
    models.mrt_csf_droplet.CSFColour."""
    substeps = _check_substeps(substeps)
    c_params = _build.c_doubles(kernel_params(red, blue, sigma, delta))
    plain = make_plain_step(red, blue, sigma, delta)

    def step(S: torch.Tensor) -> torch.Tensor:
        check_step_state(S, R, C, dtype, PLANES)
        if resolve_fused(S):
            return launch_steps(CSF_DROPLET, S, substeps, c_params, planes=PLANES)
        for _ in range(substeps):
            S = plain(S)
        return S

    return step
