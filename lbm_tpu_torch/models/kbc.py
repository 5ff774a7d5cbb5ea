"""Cascaded central-moment KBC (entropic-stabilised) collision, the
reference's "ULBM" family (counterpart of lbm_tpu/models/kbc.py).

Pure functions over the planes layout f (9, R, C), transcribed term for
term from lbm_tpu, which re-implements ulbm::d2q9::kbc (reference
src/ulbm.cpp:32-320).  Kept on purpose:

  * the reference's ``x2 + uy`` terms in delta_h directions 5-8
    (ulbm.cpp:217-226; a sum where a product looks meant);
  * the dtype-dependent ``eps`` of the gamma ratio (1e-28 in float32,
    1e-200 in float64);
  * the clip of gamma to [0, 2/s2] (``torch.clamp`` keeps a NaN, as
    ``jnp.clip`` does, so a cell that blows up stays visible).

Structure of one collide (ulbm.cpp:91-126):
  1. central moments cT of f about u                       (:265-320)
  2. per-cell entropic gamma from delta_s/delta_h/1/feq    (:138-148)
  3. subtract equilibrium central moments (k = 0, 3, 8)    (:98-100)
  4. scale by S = diag(1,1,1, s2,s2,s2, g*s2,g*s2,g*s2)    (:46-49,:128-136)
  5. back-map with inv(N) (explicit algebra)               (:104-112)
  6. f_post = f - inv(M) @ icf                             (:114-125)

csrc/kbc.cuh writes ``collide`` (both gamma implementations) in C++ with
the same operations in the same order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import lattice as lat
from ..ops import d2q9

CS2 = 1.0 / 3.0
CS4 = 1.0 / 9.0

# inv(M) of the cascaded basis (reference src/ulbm.hpp:29-40)
INV_M = np.array(
    [
        [1.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0, 1.0],
        [0.0, 0.5, 0.0, 0.25, 0.25, 0.0, 0.0, -0.5, -0.5],
        [0.0, 0.0, 0.5, 0.25, -0.25, 0.0, -0.5, 0.0, -0.5],
        [0.0, -0.5, 0.0, 0.25, 0.25, 0.0, 0.0, 0.5, -0.5],
        [0.0, 0.0, -0.5, 0.25, -0.25, 0.0, 0.5, 0.0, -0.5],
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.25, 0.25, 0.25, 0.25],
        [0.0, 0.0, 0.0, 0.0, 0.0, -0.25, 0.25, -0.25, 0.25],
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.25, -0.25, -0.25, 0.25],
        [0.0, 0.0, 0.0, 0.0, 0.0, -0.25, -0.25, 0.25, 0.25],
    ]
)

GAMMA_IMPLS = ("factored", "direct")


def check_gamma_impl(gamma_impl: str) -> None:
    if gamma_impl not in GAMMA_IMPLS:
        raise ValueError(f"gamma_impl must be one of {GAMMA_IMPLS}, "
                         f"got {gamma_impl!r}")


def central_moments(f: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(9, R, C) central moments (1, cx, cy, cx2+cy2, cx2-cy2, cxcy,
    cx2cy, cxcy2, cx2cy2) of f about u (ulbm.cpp:265-320), through the
    nine raw moments and the binomial shift about u, as lbm_tpu."""
    ux, uy = u[0], u[1]
    f0, f1, f2, f3, f4, f5, f6, f7, f8 = (f[k] for k in range(9))
    diag = f5 + f6 + f7 + f8
    m00 = f0 + f1 + f2 + f3 + f4 + diag
    m10 = f1 - f3 + f5 - f6 - f7 + f8
    m01 = f2 - f4 + f5 + f6 - f7 - f8
    m20 = f1 + f3 + diag
    m02 = f2 + f4 + diag
    m11 = f5 - f6 + f7 - f8
    m21 = f5 + f6 - f7 - f8
    m12 = f5 - f6 - f7 + f8
    m22 = diag
    x2, y2, xy = ux * ux, uy * uy, ux * uy
    k10 = m10 - ux * m00
    k01 = m01 - uy * m00
    mu20 = m20 - 2.0 * ux * m10 + x2 * m00
    mu02 = m02 - 2.0 * uy * m01 + y2 * m00
    mu11 = m11 - ux * m01 - uy * m10 + xy * m00
    mu21 = m21 - uy * m20 - 2.0 * ux * m11 + 2.0 * xy * m10 \
        + x2 * m01 - x2 * uy * m00
    mu12 = m12 - ux * m02 - 2.0 * uy * m11 + 2.0 * xy * m01 \
        + y2 * m10 - y2 * ux * m00
    mu22 = m22 - 2.0 * uy * m21 + y2 * m20 - 2.0 * ux * m12 \
        + 4.0 * xy * m11 - 2.0 * ux * y2 * m10 \
        + x2 * m02 - 2.0 * x2 * uy * m01 + x2 * y2 * m00
    return torch.stack(
        [m00, k10, k01, mu20 + mu02, mu20 - mu02, mu11, mu21, mu12, mu22])


def delta_s(cT: torch.Tensor, u: torch.Tensor, m0: torch.Tensor,
            feq: torch.Tensor | None = None) -> torch.Tensor:
    """Shear-part deviation polynomials (ulbm.cpp:157-192), in lbm_tpu's
    paired-direction form: S_k(T3, T4, T5; u) - feq_k."""
    ux, uy = u[0], u[1]
    x2, y2 = ux * ux, uy * uy
    if feq is None:
        feq = equilibrium(m0, u)
    T3, T4, T5 = cT[3], cT[4], cT[5]
    xy = ux * uy
    r2 = x2 + y2
    d2 = x2 - y2
    P = T3 * r2 - T4 * d2
    T5xy = T5 * xy
    sd = ux + uy
    dd = ux - uy
    ev_ax = -0.25 * P - 2.0 * T5xy                # axis pairs' shared core
    ev_di = 0.125 * P + T5xy                      # diagonal pairs' core
    even13 = ev_ax + 0.25 * (T3 + T4)
    even24 = ev_ax + 0.25 * (T3 - T4)
    even57 = ev_di + 0.25 * T5
    even86 = ev_di - 0.25 * T5
    odd13 = 0.25 * ((T4 - T3) * ux) - T5 * uy
    odd24 = -0.25 * ((T3 + T4) * uy) - T5 * ux
    odd57 = 0.125 * (T3 * sd - T4 * dd) + 0.5 * (T5 * sd)
    odd86 = 0.125 * (T3 * dd - T4 * sd) - 0.5 * (T5 * dd)
    return torch.stack([
        T3 * (0.5 * r2 - 1.0) - 0.5 * T4 * d2 + 4.0 * T5xy - feq[0],
        even13 + odd13 - feq[1],
        even24 + odd24 - feq[2],
        even13 - odd13 - feq[3],
        even24 - odd24 - feq[4],
        even57 + odd57 - feq[5],
        even86 - odd86 - feq[6],
        even57 - odd57 - feq[7],
        even86 + odd86 - feq[8],
    ])


def delta_h(cT: torch.Tensor, u: torch.Tensor, m0: torch.Tensor,
            feq: torch.Tensor | None = None) -> torch.Tensor:
    """High-order-part deviation polynomials (ulbm.cpp:194-228):
    H_k(T6, T7, T8; u) - feq_k, plus on directions 5-8 the correction that
    reproduces the reference's ``x2 + uy`` terms exactly."""
    ux, uy = u[0], u[1]
    x2 = ux * ux
    if feq is None:
        feq = equilibrium(m0, u)
    T6, T7, T8 = cT[6], cT[7], cT[8]
    x2uy = x2 * uy
    c56 = -0.25 * m0 * (x2 + uy - x2uy)
    c78 = -0.25 * m0 * (uy - x2 + x2uy)
    h6p = T6 * (0.5 * uy + 0.25)
    h6m = T6 * (0.5 * uy - 0.25)
    h7p = T7 * (0.5 * ux + 0.25)
    h7m = T7 * (0.5 * ux - 0.25)
    T6uy = T6 * uy
    T7ux = T7 * ux
    ev_ax = -T6uy - T7ux - 0.5 * T8  # shared even part of rows 1-4
    return torch.stack([
        2.0 * T6uy + 2.0 * T7ux + T8 - feq[0],
        ev_ax - 0.5 * T7 - feq[1],
        ev_ax - 0.5 * T6 - feq[2],
        ev_ax + 0.5 * T7 - feq[3],
        ev_ax + 0.5 * T6 - feq[4],
        h6p + h7p + 0.25 * T8 - feq[5] + c56,
        h6p + h7m + 0.25 * T8 - feq[6] + c56,
        h6m + h7m + 0.25 * T8 - feq[7] + c78,
        h6m + h7p + 0.25 * T8 - feq[8] + c78,
    ])


def _eq_factor_pairs(u: torch.Tensor):
    """Per-axis product-form equilibrium factors: 3-tuples over cx/cy in
    {0, +1, -1} with Phi_0 = 1 - (cs2 + u^2) and Phi_{+-1} =
    (cs2 + u^2 +- u)/2 (ulbm.cpp:248-263)."""
    ux, uy = u[0], u[1]
    x2, y2 = ux * ux, uy * uy
    ax, ay = CS2 + x2, CS2 + y2
    px = (1.0 - ax, 0.5 * (ax + ux), 0.5 * (ax - ux))   # cx = 0, +1, -1
    py = (1.0 - ay, 0.5 * (ay + uy), 0.5 * (ay - uy))   # cy = 0, +1, -1
    return px, py


_CX3 = [v % 3 for v in lat.CX]
_CY3 = [v % 3 for v in lat.CY]


def _eq_factors(u: torch.Tensor) -> torch.Tensor:
    """Product-form equilibrium per unit density (9, R, C), kept factored:
    eqf_k = Phi_{cx_k}(ux) * Phi_{cy_k}(uy) (ulbm.cpp:248-263)."""
    px, py = _eq_factor_pairs(u)
    return torch.stack([px[_CX3[k]] * py[_CY3[k]] for k in range(9)])


def equilibrium(m0: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """f_eq = m0 * product-form factors (ulbm.cpp:248-263)."""
    return m0[None] * _eq_factors(u)


def _eps(t: torch.Tensor) -> float:
    """The gamma ratio's regulariser: 1e-28 in float32, 1e-200 in float64."""
    return 1e-28 if t.dtype == torch.float32 else 1e-200


def gamma(cT: torch.Tensor, u: torch.Tensor, m0: torch.Tensor, s2: float,
          feq: torch.Tensor | None = None) -> torch.Tensor:
    """Per-cell entropic stabiliser, the direct two-reduction form
    (ulbm.cpp:138-148).  Near equilibrium num/den is 0/0; ``eps`` and the
    clip to [0, 2/s2] regularise it, as in lbm_tpu."""
    if feq is None:
        feq = equilibrium(m0, u)
    ds = delta_s(cT, u, m0, feq)
    dh = delta_h(cT, u, m0, feq)
    # 1/feq_k = (1/m0) ipx[cx_k] ipy[cy_k]; the 1/m0 cancels between num
    # and den
    px, py = _eq_factor_pairs(u)
    ipx = tuple(1.0 / p for p in px)
    ipy = tuple(1.0 / p for p in py)
    is2 = 1.0 / s2
    num = None
    den = None
    for k in range(9):
        w = ipx[_CX3[k]] * ipy[_CY3[k]]
        dhw = dh[k] * w
        nk = ds[k] * dhw
        dk = dh[k] * dhw
        num = nk if num is None else num + nk
        den = dk if den is None else den + dk
    g = is2 - (1.0 - is2) * num / (den + _eps(num))
    return torch.clamp(g, 0.0, 2.0 * is2)


def gamma_factored(cT: torch.Tensor, u: torch.Tensor, m0: torch.Tensor,
                   s2: float) -> torch.Tensor:
    """The entropic stabiliser through the separable-basis identity: the two
    9-direction reductions of ``gamma`` as bilinear forms over 9 monomial
    coefficient planes and the per-axis reciprocal sums (lbm_tpu's
    ``gamma_factored``; equal to ``gamma`` up to round-off)."""
    ux, uy = u[0], u[1]
    x2, y2 = ux * ux, uy * uy
    T3, T4, T5, T6, T7, T8 = (cT[k] for k in range(3, 9))
    # u-shifted back-map coefficients (the inv(N) rows of slots 3-5 / 6-8)
    A6 = 0.5 * (T3 + T4) * uy + 2.0 * T5 * ux
    A7 = 0.5 * (T3 - T4) * ux + 2.0 * T5 * uy
    A8 = 0.5 * T3 * (x2 + y2) - 0.5 * T4 * (x2 - y2) + 4.0 * T5 * (ux * uy)
    B8 = 2.0 * T6 * uy + 2.0 * T7 * ux + T8
    # the reference's x2+uy quirk rows, in monomial form
    x2uy = x2 * uy
    c56 = -0.25 * m0 * (x2 + uy - x2uy)
    c78 = -0.25 * m0 * (uy - x2 + x2uy)
    g0 = 0.5 * (c56 + c78)
    g1 = 0.5 * (c56 - c78)
    # per-axis reciprocal sums of the product-form factors
    px, py = _eq_factor_pairs(u)
    ipx = tuple(1.0 / p for p in px)
    ipy = tuple(1.0 / p for p in py)
    Sx0 = ipx[0] + ipx[1] + ipx[2]
    SxE = ipx[1] + ipx[2]
    SxO = ipx[1] - ipx[2]
    Sy0 = ipy[0] + ipy[1] + ipy[2]
    SyE = ipy[1] + ipy[2]
    SyO = ipy[1] - ipy[2]
    # sigma: monomial coefficients of S = inv(M) icfS
    s00 = A8 - T3
    s02 = 1.25 * T3 - 0.25 * T4 - 1.5 * A8
    s20 = 1.25 * T3 + 0.25 * T4 - 1.5 * A8
    s22 = 2.25 * A8 - 1.5 * T3
    s11 = 0.25 * T5
    s01 = -0.5 * A6
    s21 = 0.75 * A6
    s10 = -0.5 * A7
    s12 = 0.75 * A7
    # tau: monomial coefficients of H + c = inv(M) icfH + quirk
    t00 = B8
    t02 = -1.5 * B8
    t20 = t02
    t22 = 2.25 * B8 + g0
    t01 = -0.5 * T6
    t21 = 0.75 * T6 + g1
    t10 = -0.5 * T7
    t12 = 0.75 * T7
    # stage 1: x-contraction  ttilde_{p,s} = sum_r Gx_{p+r} tau_{r,s}
    tt00 = Sx0 * t00 + SxO * t10 + SxE * t20
    tt10 = SxO * (t00 + t20) + SxE * t10
    tt20 = SxE * (t00 + t20) + SxO * t10
    tt01 = Sx0 * t01 + SxE * t21
    tt11 = SxO * (t01 + t21)
    tt21 = SxE * (t01 + t21)
    tt02 = Sx0 * t02 + SxO * t12 + SxE * t22
    tt12 = SxO * (t02 + t22) + SxE * t12
    tt22 = SxE * (t02 + t22) + SxO * t12

    # stage 2: y-contraction  V_{p,q} = sum_s Gy_{q+s} ttilde_{p,s}
    def vrow(tt0, tt1, tt2):
        v0 = Sy0 * tt0 + SyO * tt1 + SyE * tt2
        v1 = SyO * (tt0 + tt2) + SyE * tt1
        v2 = SyE * (tt0 + tt2) + SyO * tt1
        return v0, v1, v2

    v00, v01, v02 = vrow(tt00, tt01, tt02)
    v10, v11, v12 = vrow(tt10, tt11, tt12)
    v20, v21, v22 = vrow(tt20, tt21, tt22)
    m2 = m0 * m0
    num = (s00 * v00 + s01 * v01 + s02 * v02
           + s10 * v10 + s11 * v11 + s12 * v12
           + s20 * v20 + s21 * v21 + s22 * v22) + m2 * (1.0 + uy)
    den = (t00 * v00 + t01 * v01 + t02 * v02
           + t10 * v10 + t12 * v12
           + t20 * v20 + t21 * v21 + t22 * v22) + m2 * (1.0 + 2.0 * uy)
    is2 = 1.0 / s2
    g = is2 - (1.0 - is2) * num / (den + _eps(num))
    return torch.clamp(g, 0.0, 2.0 * is2)


def collide(f: torch.Tensor, m0: torch.Tensor, u: torch.Tensor, s2: float,
            gamma_impl: str = "factored") -> torch.Tensor:
    """One KBC collision; returns the post-collision populations
    (ulbm.cpp:91-126).  ``gamma_impl`` is "factored" (the separable-basis
    identity, the default of every scene) or "direct" (``gamma``)."""
    check_gamma_impl(gamma_impl)
    cT = central_moments(f, u)
    if gamma_impl == "factored":
        g = gamma_factored(cT, u, m0, s2)
    else:
        g = gamma(cT, u, m0, s2, equilibrium(m0, u))

    # subtract the equilibrium central moments (only k = 0, 3, 8 nonzero)
    # and relax: rows 0-2 at unit rate, 3-5 at s2, 6-8 at the per-cell g*s2
    gs2 = g * s2
    T = torch.stack(
        [cT[0] - m0, cT[1], cT[2],
         s2 * (cT[3] - 2.0 * CS2 * m0), s2 * cT[4], s2 * cT[5],
         gs2 * cT[6], gs2 * cT[7], gs2 * (cT[8] - CS4 * m0)])

    # inv(N) back-map (explicit algebra, ulbm.cpp:104-112)
    ux, uy = u[0], u[1]
    x2, y2 = ux * ux, uy * uy
    icf = torch.stack([
        T[0],
        T[0] * ux + T[1],
        T[0] * uy + T[2],
        T[0] * (x2 + y2) + 2.0 * T[1] * ux + 2.0 * T[2] * uy + T[3],
        T[0] * (x2 - y2) + 2.0 * T[1] * ux - 2.0 * T[2] * uy + T[4],
        T[0] * ux * uy + T[1] * uy + T[2] * ux + T[5],
        T[0] * x2 * uy + 2.0 * T[1] * ux * uy + T[2] * x2
        + 0.5 * T[3] * uy + 0.5 * T[4] * uy + 2.0 * T[5] * ux + T[6],
        T[0] * ux * y2 + T[1] * y2 + 2.0 * T[2] * ux * uy
        + 0.5 * T[3] * ux - 0.5 * T[4] * ux + 2.0 * T[5] * uy + T[7],
        T[0] * x2 * y2 + 2.0 * T[1] * ux * y2 + 2.0 * T[2] * x2 * uy
        + 0.5 * T[3] * (x2 + y2) - 0.5 * T[4] * (x2 - y2)
        + 4.0 * T[5] * ux * uy + 2.0 * T[6] * uy + 2.0 * T[7] * ux + T[8],
    ])

    # inv(M) applied as an unrolled sparse sum (ulbm.cpp:114-123)
    rows = []
    for m in range(9):
        acc = None
        for j in range(9):
            w = float(INV_M[m, j])
            if w == 0.0:
                continue
            term = icf[j] if w == 1.0 else w * icf[j]
            acc = term if acc is None else acc + term
        rows.append(f[m] - acc)
    return torch.stack(rows)


@dataclass(frozen=True)
class KBCModel:
    """KBC state machine: collide -> advect -> recompute macroscopics,
    mirroring the loops of the reference's ulbm_* tests.  A frozen dataclass
    like ``SinglePhaseModel``: it holds the configuration, no tensors."""

    s2: float  # shear relaxation rate (the reference tests' "omega")

    def macroscopics(self, f: torch.Tensor):
        m0 = d2q9.calc_rho(f)
        m1 = d2q9.calc_momentum(f) / m0
        return m0, m1

    def collide(self, f, m0, u):
        return collide(f, m0, u, self.s2)

    def equilibrium(self, m0, u):
        return equilibrium(m0, u)
