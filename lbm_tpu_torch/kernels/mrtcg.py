"""The fused MRT colour-gradient two-phase step: plain versions and CUDA kernels
(counterpart of lbm_tpu/kernels/mrtcg_pallas.py).

One step: macroscopics, phase field psi and the interface relaxation
s_nu(psi), 5x5 replicate-padded gradients, MRT omega1 with the correction
moments, omega2 (the perturbation operator, or the CSF curvature force),
recolouring, the Guo gravity source, and streaming with the multiphase
drivers' walls (mrtcg_rayleigh_taylor.cpp:495-533).  The collision is
colour-summed: the per-colour populations enter only through their sum
and the two densities, so the step also runs on the REDUCED state

    (10, R, C) = [9 colour-summed populations, red density]
    (12, R, C) in CSF mode, + the surface force fst carried in planes 10-11

and the per-colour populations come back exactly in one split step.

Plain versions (the arithmetic of lbm_tpu's ``_make_collide`` term for
term; the CUDA kernels do the same in the same order):
  * ``make_collide``, ``mrt_omega1_pairs``, ``stream_with_bcs``,
    ``stream_sum_with_bcs``, ``reduced_planes``, ``reduce_mrtcg_state``.

Factories with lbm_tpu's signatures (no ``block_rows``/``interpret``):
each returns a step that runs its CUDA kernel on a CUDA state and the
plain version on a CPU state (``xmath.resolve_fused``):
  * ``make_mrtcg_reduced_step``  kernel 6, csrc/mrtcg_reduced.cu
  * ``make_mrtcg_split_step``    kernel 7, csrc/mrtcg_split.cu
  * ``make_mrtcg_fused_step`` / ``make_csf_fused_step``
                                 kernel 8, csrc/mrtcg_full.cu
  * ``make_mrtcg_reduced_lanes_step``
                                 kernel 39, csrc/mrtcg_reduced.cu: the reduced
                                 step over lane blocks of one grid

The lanes step (lbm_tpu mrtcg_pallas.py:1033, the lane-blocking experiment)
advances ``substeps`` steps per call, lane block by lane block: block j of
``lane_block`` = LB columns runs the plain step on its window [j LB - m,
(j + 1) LB + m) of wrapped global columns and keeps the middle LB.  The
margin is the step's reach, m = substeps rps (rps = 3, CSF 5: the columns a
step's stencils and stream consume, lbm_tpu's rows_per_sweep), not lbm_tpu's
128-lane Mosaic tiles; ``lane_overhead`` counts the cells computed per cell
kept, (LB + 2 m) / LB, exactly.  lbm_tpu's lanes step crashes at trace time
when LB + 256 > C (mrtcg_pallas.py:1110) and floor-divides its overhead
factor (:1125); the port takes every argument lbm_tpu's guards take, less
the calls whose window, LB + 2 m columns, is wider than 2C: those have m >
128, past lbm_tpu's own margin-validity rule (substeps rps <= 128,
:1060-1062).
"""

from __future__ import annotations

import ctypes

import torch

from ..core import lattice as lat
from ..core.params import ColourParams
from ..models.mrt_cg import RelaxationFunction
from ..ops import gradients
from ..utils.xmath import resolve_fused
from . import _build
from .collide_stream import PAIR_KS, pair_cu

CX, CY, WQ = lat.CX, lat.CY, lat.WQ
BQ = tuple(float(v) for v in lat.B_CG)
UCX5 = float(lat.UNIT_C[0, 5])
M_ROWS = tuple(tuple(float(v) for v in row) for row in lat.M_MRT)
MI_ROWS = tuple(tuple(float(v) for v in row) for row in lat.MI_MRT)

# base MRT relaxation diagonal (rows 7, 8 are s_nu per cell)
S_BASE = (0.0, 1.25, 1.14, 0.0, 1.6, 0.0, 1.6, None, None)
MODES = ("perturbation", "csf")


def _check_mode(surface_tension: str) -> bool:
    if surface_tension not in MODES:
        raise ValueError(f"surface_tension must be one of {MODES}, got {surface_tension!r}")
    return surface_tension == "csf"


def _check_substeps(substeps) -> int:
    if isinstance(substeps, str):
        raise ValueError(
            "substeps='auto' picks lbm_tpu's _WIDE_OPT (mrtcg_pallas.py:807), a "
            "TPU v5e measurement that does not carry to this card; pass an int")
    if int(substeps) != substeps or substeps < 1:
        raise ValueError(f"substeps must be an int >= 1, got {substeps!r}")
    return int(substeps)


def rows_per_sweep(surface_tension: str = "perturbation") -> int:
    """The lines one step's stencils and stream consume at a block's edge:
    3 (two 5x5 stencils deep plus the stream), 5 in CSF mode (the
    curvature chains two more) (lbm_tpu mrtcg_pallas.py:1066)."""
    return 5 if _check_mode(surface_tension) else 3


def reduced_planes(surface_tension: str = "perturbation") -> int:
    """Planes of the reduced state: 9 colour-summed populations + the red
    density (+ 2 surface-force carries in CSF mode)."""
    return 12 if _check_mode(surface_tension) else 10


def full_planes(surface_tension: str = "perturbation") -> int:
    """Planes of the full state: 9 red + 9 blue populations (+ fst)."""
    return 20 if _check_mode(surface_tension) else 18


def reduce_mrtcg_state(F: torch.Tensor, surface_tension: str = "perturbation") -> torch.Tensor:
    """Full state -> reduced state, exactly (sums of the carried planes).
    Perturbation: F (2, 9, R, C) -> (10, R, C); CSF: S (20, R, C) -> (12, R, C)."""
    if _check_mode(surface_tension):
        return torch.cat([F[:9] + F[9:18], F[:9].sum(0)[None], F[18:]]).contiguous()
    return torch.cat([F[0] + F[1], F[0].sum(0)[None]]).contiguous()


def mrt_omega1_pairs(f0, fs_p, fd_p, m_eq, c1, c7, s_nu):
    """Mi (s (m_eq - M f) + C) in moment space, pair-factored
    (lbm_tpu mrtcg_pallas.py:221-286): only moments 1, 2, 4, 6, 7, 8 relax;
    rows 1, 2, 7, 8 of M are even under k -> opp(k) and ride the pair sums
    ``fs_p`` (+ the rest plane ``f0``), rows 4, 6 are odd and ride the pair
    differences ``fd_p``; the back map shares each pair's even part."""
    even_rows, odd_rows = (1, 2, 7, 8), (4, 6)

    def mrow(row, parts, with_k0):
        acc = None
        if with_k0:
            w0 = M_ROWS[row][0]
            if w0 == 1.0:
                acc = f0
            elif w0 != 0.0:
                acc = w0 * f0
        for i, (kp, _) in enumerate(PAIR_KS):
            w = M_ROWS[row][kp]
            if w == 0.0:
                continue
            term = parts[i] if w == 1.0 else w * parts[i]
            acc = term if acc is None else acc + term
        return acc

    v = {}
    for rows, parts, with_k0 in ((even_rows, fs_p, True), (odd_rows, fd_p, False)):
        for row in rows:
            s = S_BASE[row]
            m = m_eq[row] - mrow(row, parts, with_k0)
            v[row] = m * s_nu if s is None else m * s
    v[1] = v[1] + c1
    v[7] = v[7] + c7

    def midot(k, rows):
        acc = None
        for j in rows:
            w = MI_ROWS[k][j]
            if w == 0.0:
                continue
            term = v[j] if w == 1.0 else w * v[j]
            acc = term if acc is None else acc + term
        return acc

    o1 = [None] * 9
    o1[0] = midot(0, even_rows)
    for kp, km in PAIR_KS:
        even = midot(kp, even_rows)
        odd = midot(kp, odd_rows)
        o1[kp] = even + odd
        o1[km] = even - odd
    return o1


def kernel_params(red: ColourParams, blue: ColourParams, sigma: float, gravity,
                  delta: float, apply_gravity_source: bool) -> tuple[float, ...]:
    """Every scalar of the step, as the Python doubles the plain version
    multiplies by, in the order csrc/mrtcg.cuh ``Params`` reads them."""
    relax = RelaxationFunction.from_omegas(red, blue, delta)
    r_phi, b_phi = red.phi(), blue.phi()
    r_eta, b_eta = red.eta(), blue.eta()
    gx, gy = float(gravity[0]), float(gravity[1])
    source = bool(apply_gravity_source and (gx or gy))
    cF = [CX[kp] * gx + CY[kp] * gy for kp, _ in PAIR_KS]
    return tuple(float(v) for v in (
        1.0 / red.rho_0, 1.0 / blue.rho_0,
        relax.delta, relax.r_val, relax.b_val, relax.s1, relax.s2, relax.s3,
        relax.t2, relax.t3,
        r_phi[0], r_phi[1], r_phi[5], b_phi[0], b_phi[1], b_phi[5],
        r_eta[1], r_eta[5], b_eta[1], b_eta[5],
        gx, gy, 0.5 * gx, 0.5 * gy,
        1.8 * red.alpha - 0.8, 1.8 * blue.alpha - 0.8,
        red.beta, blue.beta, red.beta + blue.beta,
        4.5 * sigma, -0.5 * sigma,
        red.A * (1.0 - 0.5 * red.rlx) + blue.A * (1.0 - 0.5 * blue.rlx),
        float(source), *cF, *(3.0 * c for c in cF)))


def make_collide(red: ColourParams, blue: ColourParams, sigma: float, gravity,
                 delta: float, apply_gravity_source: bool,
                 surface_tension: str = "perturbation"):
    """The colour-summed, pair-factored MRT-CG collision on whole-grid
    planes (lbm_tpu mrtcg_pallas.py:289-549, written term for term).

    ``collide(fsum, rho, r_rho, b_rho, fst=None, reduced=False)`` returns
    (coll_r, coll_b), the recoloured per-colour post-collision
    populations, or with ``reduced`` (coll_sum, coll_r); in CSF mode a
    third item, the new surface force (fstx, fsty).  ``fst`` is the
    previous step's force (CSF mode only); ``rows``/``grid_rows`` make the
    planes a block of a taller grid, ``cols``/``grid_cols`` of a wider one
    (ops/gradients.py dx5)."""
    csf = _check_mode(surface_tension)
    (inv_r0, inv_b0, _, _, _, _, _, _, _, _,
     r_phi0, r_phi1, r_phi5, b_phi0, b_phi1, b_phi5,
     r_eta1, r_eta5, b_eta1, b_eta5, gx, gy, half_gx, half_gy,
     r_alpha_c, b_alpha_c, beta_r, beta_b, beta_s, a_sigma, m_half_sigma,
     s_A_pref, source, *cF3) = kernel_params(red, blue, sigma, gravity, delta,
                                            apply_gravity_source)
    cF, cF3 = cF3[:4], cF3[4:]
    relax = RelaxationFunction.from_omegas(red, blue, delta)
    r_phi = {0: r_phi0, 1: r_phi1, 5: r_phi5}
    b_phi = {0: b_phi0, 1: b_phi1, 5: b_phi5}
    r_eta = {1: r_eta1, 5: r_eta5}
    b_eta = {1: b_eta1, 5: b_eta5}

    def collide(fsum, rho, r_rho, b_rho, fst=None, reduced=False, rows=None, grid_rows=None,
                cols=None, grid_cols=None):
        dx5 = lambda x: gradients.dx5(x, rows, grid_rows, cols, grid_cols)  # noqa: E731
        dy5 = lambda x: gradients.dy5(x, rows, grid_rows, cols, grid_cols)  # noqa: E731
        inv_rho = 1.0 / rho
        fs_p = [fsum[kp] + fsum[km] for kp, km in PAIR_KS]
        fd_p = [fsum[kp] - fsum[km] for kp, km in PAIR_KS]
        mom_x = fd_p[0] + fd_p[2] + fd_p[3]   # pairs (1,3),(5,7),(8,6)
        mom_y = fd_p[1] + fd_p[2] - fd_p[3]
        if csf:
            # the carried-u shift includes the previous step's surface force
            ux = (mom_x + 0.5 * (gx + fst[0])) * inv_rho
            uy = (mom_y + 0.5 * (gy + fst[1])) * inv_rho
        else:
            ux = (mom_x + half_gx) * inv_rho
            uy = (mom_y + half_gy) * inv_rho
        x2, y2 = ux * ux, uy * uy
        uu = x2 + y2
        cu_p = pair_cu(ux, uy)

        a = r_rho * inv_r0
        b = b_rho * inv_b0
        psi = (a - b) / (a + b)
        s_nu = relax(psi)
        gpx, gpy = dx5(psi), dy5(psi)
        gn = torch.sqrt(gpx * gpx + gpy * gpy)
        inv_gn = 1.0 / (1e-20 + gn)

        # class fields: phi/eta take one value per |c| class (rest, axis, diagonal)
        ab = {cls: r_phi[cls] * r_rho + b_phi[cls] * b_rho for cls in (0, 1, 5)}
        ee = {cls: r_eta[cls] * r_rho + b_eta[cls] * b_rho for cls in (1, 5)}
        # closed-form relaxed moments of the summed CG equilibrium
        uu_rho6 = 6.0 * (uu * rho)
        rho2 = rho + rho
        gq = (1.0 / 3.0) * ee[5] - (4.0 / 3.0) * ee[1]
        m_eq = {
            1: 8.0 * ab[5] - 4.0 * (ab[0] + ab[1]) + uu_rho6,
            2: 4.0 * (ab[0] + ab[5]) - 8.0 * ab[1] - uu_rho6,
            4: ux * gq,
            6: uy * gq,
            7: rho2 * (x2 - y2),
            8: rho2 * (ux * uy),
        }
        q_c = r_alpha_c * r_rho + b_alpha_c * b_rho
        dxqx = dx5(q_c * ux)
        dyqy = dy5(q_c * uy)
        c1 = 3.0 * (1.0 - 0.5 * 1.25) * (dxqx + dyqy)
        c7 = (1.0 - 0.5 * s_nu) * (dxqx - dyqy)
        o1s = mrt_omega1_pairs(fsum[0], fs_p, fd_p, m_eq, c1, c7, s_nu)

        gc_p = pair_cu(gpx, gpy)
        fst_new = None
        o2s = [None] * 9
        if not csf:
            # perturbation omega2 summed over colours (o2r == o2b)
            A_gn = (a_sigma * s_nu) * gn
            o2s[0] = A_gn * (-BQ[0])
            for kp, km in PAIR_KS:
                unit = gc_p[kp] * inv_gn
                o2s[kp] = o2s[km] = A_gn * (WQ[kp] * unit * unit - BQ[kp])
        else:
            # CSF: inward normal, curvature from 5x5 stencils of the normal,
            # fst = -sigma/2 K grad(psi), colour-summed eta perturbation
            nx = -(gpx * inv_gn)
            ny = -(gpy * inv_gn)
            dxnx, dynx = dx5(nx), dy5(nx)
            dxny, dyny = dx5(ny), dy5(ny)
            K = nx * ny * (dynx + dxny) - nx * nx * dyny - ny * ny * dxnx
            fstx = m_half_sigma * (K * gpx)
            fsty = m_half_sigma * (K * gpy)
            fst_new = (fstx, fsty)
            uFs3 = 3.0 * (ux * fstx + uy * fsty)
            Fc_p = pair_cu(fstx, fsty)
            o2s[0] = s_A_pref * (WQ[0] * (-uFs3))
            for kp, km in PAIR_KS:
                even = WQ[kp] * (9.0 * cu_p[kp] * Fc_p[kp] - uFs3)
                odd = WQ[kp] * (3.0 * Fc_p[kp])
                o2s[kp] = s_A_pref * (even + odd)
                o2s[km] = s_A_pref * (even - odd)

        # recolouring: kap(opp(k)) = -kap(k); the Guo source splits even/odd
        rb_gn = (r_rho * b_rho) * (inv_rho * inv_rho) * inv_gn
        r_frac = r_rho * inv_rho
        b_frac = b_rho * inv_rho
        pref = (1.0 - 0.5 * s_nu) if source else None
        uF3 = 3.0 * (ux * gx + uy * gy) if source else None
        coll_a = [None] * 9   # red (full) / colour sum (reduced)
        coll_b = [None] * 9   # blue (full) / red (reduced)

        def o3(k, total, kap, src):
            if reduced:
                cs = total if kap is None else total + beta_s * kap
                cr = r_frac * total if kap is None else r_frac * total + beta_r * kap
                if src is not None:
                    cs = cs + 2.0 * src
                    cr = cr + src
                coll_a[k], coll_b[k] = cs, cr
            else:
                o3r = r_frac * total if kap is None else r_frac * total + beta_r * kap
                o3b = b_frac * total if kap is None else b_frac * total + beta_b * kap
                if src is not None:
                    o3r = o3r + src
                    o3b = o3b + src
                coll_a[k], coll_b[k] = o3r, o3b

        total0 = fsum[0] + o1s[0] + o2s[0]
        o3(0, total0, None, pref * (-uF3) * WQ[0] if source else None)
        for i, (kp, km) in enumerate(PAIR_KS):
            # diagonals carry 1/sqrt(2) in perturbation mode only (the CSF
            # driver dots the plain E set, mrt_rayleigh_taylor.cpp:304-320)
            cls = 1 if kp in (1, 2) else 5
            unit_scale = 1.0 if (csf or kp in (1, 2)) else UCX5
            kap = (rb_gn * (unit_scale * gc_p[kp])) * ab[cls]
            src_p = src_m = None
            if source:
                even_s = (pref * WQ[kp]) * (9.0 * cu_p[kp] * cF[i] - uF3)
                odd_s = (pref * WQ[kp]) * cF3[i]
                src_p = even_s + odd_s
                src_m = even_s - odd_s
            o3(kp, fsum[kp] + o1s[kp] + o2s[kp], kap, src_p)
            o3(km, fsum[km] + o1s[km] + o2s[km], -kap, src_m)
        if csf:
            return coll_a, coll_b, fst_new
        return coll_a, coll_b

    return collide


def stream_with_bcs(coll, rows=None, grid_rows=None, cols=None, grid_cols=None) -> list:
    """Periodic push streaming plus the multiphase drivers' walls
    (lbm_tpu mrtcg_pallas.py:552-595): columns periodic WITHOUT the
    diagonal offset on rows 1..R-2, then bounce-back on row R-1, then on
    row 0 (the corners are written last).  With ``rows`` (the global
    indices of the planes' rows) and ``grid_rows``, the planes are a block
    of a taller grid: the walls sit at its global rows 0 and R-1; with
    ``cols`` (the wrapped global indices of their columns) and
    ``grid_cols``, of a wider one: the column repair sits at its global
    columns 0 and C-1."""
    R, C = coll[0].shape
    dev = coll[0].device
    rows = torch.arange(R, device=dev)[:, None] if rows is None else rows[:, None]
    R = R if grid_rows is None else grid_rows
    cols = torch.arange(C, device=dev)[None, :] if cols is None else cols[None, :]
    C = C if grid_cols is None else grid_cols
    interior = (rows >= 1) & (rows <= R - 2)
    out, col_rolled = [], []
    for k in range(9):
        t = coll[k]
        if CY[k]:
            t = torch.roll(t, CY[k], 1)
        col_rolled.append(t)
        if CX[k]:
            t = torch.roll(t, CX[k], 0)
        out.append(t)
    for k in (2, 5, 6):  # entering through col 0
        out[k] = torch.where((cols == 0) & interior, col_rolled[k], out[k])
    for k in (4, 7, 8):  # entering through col C-1
        out[k] = torch.where((cols == C - 1) & interior, col_rolled[k], out[k])
    for rows_mask, ks in ((rows == R - 1, (1, 5, 8)), (rows == 0, (3, 6, 7))):
        for k in ks:
            out[lat.OPPQ[k]] = torch.where(rows_mask, coll[k], out[lat.OPPQ[k]])
    return out


def stream_sum_with_bcs(coll, rows=None, grid_rows=None, cols=None,
                        grid_cols=None) -> torch.Tensor:
    """``sum_k stream_with_bcs(coll)[k]`` in ascending k: the next red
    density of the reduced state (lbm_tpu mrtcg_pallas.py:598-635)."""
    out = stream_with_bcs(coll, rows, grid_rows, cols, grid_cols)
    acc = out[0]
    for k in range(1, 9):
        acc = acc + out[k]
    return acc


def _macros(S: torch.Tensor, reduced_in: bool, csf: bool):
    """(fsum, rho, r_rho, b_rho, fst) from either state layout
    (lbm_tpu mrtcg_pallas.py:698-718)."""
    if reduced_in:
        fsum = [S[k] for k in range(9)]
        rho = fsum[0]
        for k in range(1, 9):
            rho = rho + fsum[k]
        r_rho = S[9]
        return fsum, rho, r_rho, rho - r_rho, (S[10], S[11]) if csf else None
    r_rho, b_rho = S[0], S[9]
    for k in range(1, 9):
        r_rho = r_rho + S[k]
        b_rho = b_rho + S[9 + k]
    fsum = [S[k] + S[9 + k] for k in range(9)]
    return fsum, r_rho + b_rho, r_rho, b_rho, (S[18], S[19]) if csf else None


def make_plain_step(red, blue, sigma, gravity=(0.0, 0.0), delta=0.1,
                    apply_gravity_source=True, surface_tension="perturbation",
                    reduced_in=True, reduced_out=True):
    """The plain version of one step on flat planes: reduced -> reduced
    (kernel 6), reduced -> full (kernel 7) or full -> full (kernel 8).
    ``step(S, rows, grid_rows)`` steps a block of consecutive global rows
    ``rows`` of a taller grid (the walls and the gradients' replicate
    padding at its global rows 0 and R-1); its edge rows are then stale.
    ``cols``/``grid_cols`` make it a block of a wider grid too (the
    gradients' replicate padding and the column repair at its global
    columns 0 and C-1; its edge columns are then stale)."""
    csf = _check_mode(surface_tension)
    collide = make_collide(red, blue, sigma, gravity, delta, apply_gravity_source,
                           surface_tension)

    def step(S: torch.Tensor, rows=None, grid_rows=None, cols=None,
             grid_cols=None) -> torch.Tensor:
        fsum, rho, r_rho, b_rho, fst = _macros(S, reduced_in, csf)
        block = (rows, grid_rows, cols, grid_cols)
        out = collide(fsum, rho, r_rho, b_rho, fst, reduced_out, *block)
        planes = stream_with_bcs(out[0], *block)
        if reduced_out:
            planes.append(stream_sum_with_bcs(out[1], *block))
        else:
            planes += stream_with_bcs(out[1], *block)
        if csf:
            planes += list(out[2])  # carried, not streamed
        return torch.stack(planes)

    return step


def lane_overhead(lane_block: int, margin: int) -> float:
    """Cells a lane block's window holds per cell it keeps, (LB + 2 margin)
    / LB, in exact arithmetic: 1.5 for lbm_tpu's 128-lane margins at LB =
    512, where its ``1 + 2 * CHALO // LB`` reads 1 (mrtcg_pallas.py:1125)."""
    return (lane_block + 2 * margin) / lane_block


def check_lane_window(C: int, lane_block: int, substeps: int, rps: int) -> int:
    """The margin m = substeps rps of a lanes call; raises if its window,
    LB + 2 m columns, is wider than 2C (kernel 39's wrap takes a window
    column to its global column with selects, not a division)."""
    m = substeps * rps
    if lane_block + 2 * m > 2 * C:
        raise ValueError(f"a lane block of {lane_block} columns with margins of {m} "
                         f"({substeps} steps of {rps}) leaves a window wider than 2C = {2 * C}")
    return m


def plain_mrtcg_reduced_lanes_step(S: torch.Tensor, step, lane_block: int, substeps: int,
                                   rps: int) -> torch.Tensor:
    """The plain version of kernel 39: for each lane block j, ``substeps``
    runs of the plain reduced ``step`` (``make_plain_step``) on the window
    [j LB - m, (j + 1) LB + m) of wrapped global columns, m = substeps rps,
    given its global columns (the stencils' replicate clamp and the column
    repair at the grid's columns 0 and C-1); the middle LB columns kept.
    Each step leaves rps more columns stale at the window's edges."""
    C, m = S.shape[-1], substeps * rps
    blocks = []
    for j in range(C // lane_block):
        cols = torch.arange(j * lane_block - m, (j + 1) * lane_block + m, device=S.device) % C
        W = S[:, :, cols]
        for _ in range(substeps):
            W = step(W, cols=cols, grid_cols=C)
        blocks.append(W[:, :, m:m + lane_block])
    return torch.cat(blocks, dim=2)


# --- the CUDA kernels ----------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]
MRTCG_REDUCED = _build.CudaKernel("lbm_mrtcg_reduced", _ARGTYPES)
MRTCG_SPLIT = _build.CudaKernel("lbm_mrtcg_split", _ARGTYPES)
MRTCG_FULL = _build.CudaKernel("lbm_mrtcg_full", _ARGTYPES)
MRTCG_REDUCED_LANES = _build.CudaKernel(
    "lbm_mrtcg_reduced_lanes",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def launch_mrtcg(kernel: _build.CudaKernel, S: torch.Tensor, params, csf: bool,
                 planes_in: int, planes_out: int, substeps: int = 1) -> torch.Tensor:
    """``substeps`` launches of one MRT-CG kernel whose C entry point takes
    (in, out, R, C, params, csf, is_f64, stream), ``params`` the doubles of
    ``kernel_params`` (or a ctypes array of them), ping-ponging two fresh
    buffers (``S`` itself is never written).  Raises on a tensor the kernel
    does not take and on a refused launch."""
    substeps = _check_substeps(substeps)
    R, C = _build.check_state(S, planes_in)
    if R < 4 or C < 3:
        raise ValueError(f"the MRT-CG kernels take R >= 4 and C >= 3, got {R}x{C}")
    if substeps > 1 and planes_out != planes_in:
        raise ValueError("a layout-changing step runs one step per call")
    c_params = _build.c_doubles(params)
    bufs = [torch.empty((planes_out, R, C), dtype=S.dtype, device=S.device)]
    if substeps > 1:
        bufs.append(torch.empty_like(bufs[0]))
    with torch.cuda.device(S.device):
        stream = _build.stream_handle(S)
        src = S
        for i in range(substeps):
            dst = bufs[i % 2]
            kernel.launch(src.data_ptr(), dst.data_ptr(), R, C, c_params, int(csf),
                          int(S.dtype == torch.float64), stream)
            src = dst
    return src


def launch_mrtcg_lanes(S: torch.Tensor, params, csf: bool, lane_block: int,
                       substeps: int) -> torch.Tensor:
    """Kernel 39: ``substeps`` sweeps of the reduced step over the C / LB
    lane blocks of the state ``S``, one launch each, into a fresh state
    (``S`` is never written).  Sweep k reads margin m - (k-1) rps of each
    block's window and writes margin m - k rps, m = substeps rps: the first
    reads its input state in place, the middle ones ping-pong two window
    buffers (C / LB, planes, R, LB + 2 (m - k rps)), the last writes the
    output state.  Raises on a tensor the kernel does not take, on a window
    wider than 2C (``check_lane_window``) and on a refused launch."""
    substeps = _check_substeps(substeps)
    mode = "csf" if csf else "perturbation"
    planes, rps = reduced_planes(mode), rows_per_sweep(mode)
    R, C = _build.check_state(S, planes)
    if R < 4 or C < 3 or C % lane_block:
        raise ValueError(f"the lanes kernel takes R >= 4, C >= 3 and lane blocks dividing "
                         f"C, got {R}x{C}, lane_block={lane_block}")
    m = check_lane_window(C, lane_block, substeps, rps)
    lanes = C // lane_block
    c_params = _build.c_doubles(params)
    out = torch.empty_like(S)
    bufs = [torch.empty(lanes * planes * R * (lane_block + 2 * (m - k * rps)),
                        dtype=S.dtype, device=S.device) for k in (1, 2) if k < substeps]
    with torch.cuda.device(S.device):
        stream = _build.stream_handle(S)
        src = S
        for k in range(1, substeps + 1):
            dst = out if k == substeps else bufs[(k - 1) % 2]
            MRTCG_REDUCED_LANES.launch(src.data_ptr(), dst.data_ptr(), R, C, lane_block,
                                       m - (k - 1) * rps, int(k == 1), int(k == substeps),
                                       c_params, int(csf), int(S.dtype == torch.float64),
                                       stream)
            src = dst
    return out


def _factory(R, C, red, blue, sigma, gravity, delta, apply_gravity_source, dtype,
             surface_tension, substeps, kernel, reduced_in, reduced_out):
    csf = _check_mode(surface_tension)
    substeps = _check_substeps(substeps)
    p_in = reduced_planes(surface_tension) if reduced_in else full_planes(surface_tension)
    p_out = reduced_planes(surface_tension) if reduced_out else full_planes(surface_tension)
    c_params = _build.c_doubles(kernel_params(red, blue, sigma, gravity, delta,
                                              apply_gravity_source))
    plain = make_plain_step(red, blue, sigma, gravity, delta, apply_gravity_source,
                            surface_tension, reduced_in, reduced_out)

    def step(S: torch.Tensor) -> torch.Tensor:
        if tuple(S.shape) != (p_in, R, C) or S.dtype != dtype:
            raise ValueError(f"state {tuple(S.shape)} {S.dtype}, step built for "
                             f"({p_in}, {R}, {C}) {dtype}")
        if resolve_fused(S):
            return launch_mrtcg(kernel, S, c_params, csf, p_in, p_out, substeps)
        for _ in range(substeps):
            S = plain(S)
        return S

    return step


def make_mrtcg_reduced_step(R: int, C: int, red: ColourParams, blue: ColourParams,
                            sigma: float, gravity=(0.0, 0.0), delta: float = 0.1,
                            apply_gravity_source: bool = True,
                            dtype: torch.dtype = torch.float32,
                            surface_tension: str = "perturbation", substeps: int = 1):
    """Reduced-state MRT-CG step G (10, R, C) -> (10, R, C) ((12, R, C) in
    CSF mode), ``substeps`` steps per call: kernel 6 on a CUDA state (one
    launch per step), the plain version on a CPU state."""
    return _factory(R, C, red, blue, sigma, gravity, delta, apply_gravity_source,
                    dtype, surface_tension, substeps, MRTCG_REDUCED, True, True)


def make_mrtcg_split_step(R: int, C: int, red: ColourParams, blue: ColourParams,
                          sigma: float, gravity=(0.0, 0.0), delta: float = 0.1,
                          apply_gravity_source: bool = True,
                          dtype: torch.dtype = torch.float32,
                          surface_tension: str = "perturbation"):
    """One step that takes the reduced state and writes the per-colour
    populations: G (10, R, C) -> F (2, 9, R, C) ((12, R, C) -> (20, R, C)
    in CSF mode, fst last).  Kernel 7 on a CUDA state.  The reduced step
    T-1 times, then this once, equals the full step T times."""
    step = _factory(R, C, red, blue, sigma, gravity, delta, apply_gravity_source,
                    dtype, surface_tension, 1, MRTCG_SPLIT, True, False)
    if _check_mode(surface_tension):
        return step
    return lambda G: step(G).reshape(2, 9, R, C)


def make_mrtcg_fused_step(R: int, C: int, red: ColourParams, blue: ColourParams,
                          sigma: float, gravity=(0.0, 0.0), delta: float = 0.1,
                          apply_gravity_source: bool = True,
                          dtype: torch.dtype = torch.float32, substeps: int = 1):
    """Full-state MRT-CG step F (2, 9, R, C) -> (2, 9, R, C) (0 = red,
    1 = blue), ``substeps`` steps per call: kernel 8 on a CUDA state."""
    step = _factory(R, C, red, blue, sigma, gravity, delta, apply_gravity_source,
                    dtype, "perturbation", substeps, MRTCG_FULL, False, False)
    return lambda F: step(F.reshape(18, R, C)).reshape(2, 9, R, C)


def make_csf_fused_step(R: int, C: int, red: ColourParams, blue: ColourParams,
                        sigma: float, gravity=(0.0, 0.0), delta: float = 0.1,
                        apply_gravity_source: bool = True,
                        dtype: torch.dtype = torch.float32, substeps: int = 1):
    """Full-state MRT-CSF step S (20, R, C) -> (20, R, C) with S = [red f,
    blue f, fst]: kernel 8 in CSF mode on a CUDA state."""
    return _factory(R, C, red, blue, sigma, gravity, delta, apply_gravity_source,
                    dtype, "csf", substeps, MRTCG_FULL, False, False)


def make_mrtcg_reduced_lanes_step(R: int, C: int, red: ColourParams, blue: ColourParams,
                                  sigma: float, gravity=(0.0, 0.0), delta: float = 0.1,
                                  apply_gravity_source: bool = True,
                                  dtype: torch.dtype = torch.float32,
                                  surface_tension: str = "perturbation", substeps: int = 1,
                                  lane_block: int = 256):
    """The lane-blocked reduced MRT-CG step (lbm_tpu mrtcg_pallas.py:1033):
    G (10, R, C) -> (10, R, C) ((12, R, C) in CSF mode), ``substeps`` steps
    per call, lane block by lane block over windows with margins of
    ``substeps * rows_per_sweep`` columns.  Kernel 39 on a CUDA state (one
    launch per step), ``plain_mrtcg_reduced_lanes_step`` on a CPU state;
    either equals the reduced step run ``substeps`` times.  Takes exactly
    the arguments lbm_tpu's guards take (mrtcg_pallas.py:1070-1078: LB a
    multiple of 128 dividing C, LB + 256 <= 2C; the same ValueErrors), LB +
    256 > C included, though the port's margins are not 128-lane tiles;
    refuses as well a window LB + 2 m wider than 2C (``check_lane_window``:
    m > 128, where lbm_tpu's margins are not valid either, :1060-1062).
    ``step.margin`` is m = substeps rps and ``step.overhead`` the window's
    cells per cell kept, ``lane_overhead``."""
    csf = _check_mode(surface_tension)
    substeps = _check_substeps(substeps)
    if lane_block % 128 or C % lane_block:
        raise ValueError(f"lane_block must be a 128-multiple dividing C "
                         f"(lane_block={lane_block}, C={C})")
    if lane_block + 256 > 2 * C:
        raise ValueError(f"lane_block + 256 must be <= 2C ({lane_block + 256} > {2 * C})")
    p = reduced_planes(surface_tension)
    rps = rows_per_sweep(surface_tension)
    margin = check_lane_window(C, lane_block, substeps, rps)
    c_params = _build.c_doubles(kernel_params(red, blue, sigma, gravity, delta,
                                              apply_gravity_source))
    plain = make_plain_step(red, blue, sigma, gravity, delta, apply_gravity_source,
                            surface_tension)

    def step(G: torch.Tensor) -> torch.Tensor:
        if tuple(G.shape) != (p, R, C) or G.dtype != dtype:
            raise ValueError(f"state {tuple(G.shape)} {G.dtype}, step built for "
                             f"({p}, {R}, {C}) {dtype}")
        if resolve_fused(G):
            return launch_mrtcg_lanes(G, c_params, csf, lane_block, substeps)
        return plain_mrtcg_reduced_lanes_step(G, plain, lane_block, substeps, rps)

    step.margin = margin
    step.overhead = lane_overhead(lane_block, margin)
    return step
