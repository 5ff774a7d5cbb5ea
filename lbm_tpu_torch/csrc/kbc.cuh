// The cascaded central-moment KBC collision of one D2Q9 cell, shared by
// kernel 3 (csrc/collide_stream_kbc.cu) and kernel 4 (csrc/channel_kbc.cu).
//
// A transcription of the plain PyTorch version, lbm_tpu_torch/models/kbc.py
// (itself lbm_tpu/models/kbc.py, the reference's src/ulbm.cpp:32-320): the
// same operations, grouped in the same order, on registers instead of
// planes.  Templated on the float type and on the gamma implementation
// (kFactored: gamma_factored, the default of every scene; else the direct
// two-reduction gamma).
//
// Kept on purpose, as the plain version keeps them:
//  * the reference's `x2 + uy` terms in delta_h rows 5-8 (ulbm.cpp:217-226);
//  * eps of the gamma ratio from the float type: 1e-28 in float, 1e-200 in
//    double;
//  * the clip of gamma to [0, 2/s2] written with comparisons, so a NaN
//    stays a NaN (fminf/fmaxf would drop it; torch.clamp keeps it), and a
//    cell that blows up is seen by the NaN watchdog on both devices.
//
// Python evaluates `a * b * c` as (a * b) * c and `a + b - c` as
// (a + b) - c; C++ parses both the same way, so each line below keeps the
// plain version's grouping.  Scalars that the plain version computes in
// double on the host (1/s2, 1 - 1/s2, 2/s2, 2 cs2) arrive precomputed in
// Params and are rounded to T once, as PyTorch rounds a Python scalar.
#pragma once

#include "d2q9.cuh"

namespace lbm {
namespace kbc {

constexpr double kCS2 = 1.0 / 3.0;
constexpr double kCS4 = 1.0 / 9.0;

// (the double 1e-28 rounded to float, as PyTorch rounds the Python scalar)
template <typename T>
struct Eps;
template <>
struct Eps<float> {
  static constexpr float value = static_cast<float>(1e-28);
};
template <>
struct Eps<double> {
  static constexpr double value = 1e-200;
};

// Relaxation constants, each rounded to T once on the host.
template <typename T>
struct Params {
  T s2;         // shear relaxation rate (the reference tests' omega)
  T is2;        // 1 / s2
  T one_m_is2;  // 1 - 1/s2
  T two_is2;    // 2 / s2, the upper clip of gamma
};

template <typename T>
Params<T> make_params(double s2) {
  const double is2 = 1.0 / s2;
  return Params<T>{static_cast<T>(s2), static_cast<T>(is2),
                   static_cast<T>(1.0 - is2), static_cast<T>(2.0 * is2)};
}

// cx, cy in {0, +1, -1} -> index 0, 1, 2 of the per-axis factor triples.
__host__ __device__ constexpr int cx3(int k) { return (cx(k) + 3) % 3; }
__host__ __device__ constexpr int cy3(int k) { return (cy(k) + 3) % 3; }

// Per-axis product-form equilibrium factors (models/kbc.py _eq_factor_pairs):
// p[0] = 1 - (cs2 + u^2), p[1] = (cs2 + u^2 + u)/2, p[2] = (cs2 + u^2 - u)/2.
template <typename T>
__device__ __forceinline__ void eq_factor_pairs(T ux, T uy, T px[3], T py[3]) {
  const T x2 = ux * ux;
  const T y2 = uy * uy;
  const T ax = T(kCS2) + x2;
  const T ay = T(kCS2) + y2;
  px[0] = T(1.0) - ax;
  px[1] = T(0.5) * (ax + ux);
  px[2] = T(0.5) * (ax - ux);
  py[0] = T(1.0) - ay;
  py[1] = T(0.5) * (ay + uy);
  py[2] = T(0.5) * (ay - uy);
}

// Product-form equilibrium m0 * Phi_cx(ux) Phi_cy(uy) (models/kbc.py
// equilibrium).
template <typename T>
__device__ __forceinline__ void equilibrium(T m0, T ux, T uy, T feq[9]) {
  T px[3], py[3];
  eq_factor_pairs(ux, uy, px, py);
#pragma unroll
  for (int k = 0; k < 9; ++k) feq[k] = m0 * (px[cx3(k)] * py[cy3(k)]);
}

// Central moments (1, cx, cy, cx2+cy2, cx2-cy2, cxcy, cx2cy, cxcy2, cx2cy2)
// of f about u, through the raw moments and the binomial shift
// (models/kbc.py central_moments).
template <typename T>
__device__ __forceinline__ void central_moments(const T f[9], T ux, T uy, T cT[9]) {
  const T diag = f[5] + f[6] + f[7] + f[8];
  const T m00 = f[0] + f[1] + f[2] + f[3] + f[4] + diag;
  const T m10 = f[1] - f[3] + f[5] - f[6] - f[7] + f[8];
  const T m01 = f[2] - f[4] + f[5] + f[6] - f[7] - f[8];
  const T m20 = f[1] + f[3] + diag;
  const T m02 = f[2] + f[4] + diag;
  const T m11 = f[5] - f[6] + f[7] - f[8];
  const T m21 = f[5] + f[6] - f[7] - f[8];
  const T m12 = f[5] - f[6] - f[7] + f[8];
  const T m22 = diag;
  const T x2 = ux * ux, y2 = uy * uy, xy = ux * uy;
  const T k10 = m10 - ux * m00;
  const T k01 = m01 - uy * m00;
  const T mu20 = m20 - T(2.0) * ux * m10 + x2 * m00;
  const T mu02 = m02 - T(2.0) * uy * m01 + y2 * m00;
  const T mu11 = m11 - ux * m01 - uy * m10 + xy * m00;
  const T mu21 = m21 - uy * m20 - T(2.0) * ux * m11 + T(2.0) * xy * m10 +
                 x2 * m01 - x2 * uy * m00;
  const T mu12 = m12 - ux * m02 - T(2.0) * uy * m11 + T(2.0) * xy * m01 +
                 y2 * m10 - y2 * ux * m00;
  const T mu22 = m22 - T(2.0) * uy * m21 + y2 * m20 - T(2.0) * ux * m12 +
                 T(4.0) * xy * m11 - T(2.0) * ux * y2 * m10 + x2 * m02 -
                 T(2.0) * x2 * uy * m01 + x2 * y2 * m00;
  cT[0] = m00;
  cT[1] = k10;
  cT[2] = k01;
  cT[3] = mu20 + mu02;
  cT[4] = mu20 - mu02;
  cT[5] = mu11;
  cT[6] = mu21;
  cT[7] = mu12;
  cT[8] = mu22;
}

// is2 - (1 - is2) num / (den + eps), clipped to [0, 2 is2] by comparisons
// (a NaN fails both and passes through).
template <typename T>
__device__ __forceinline__ T gamma_from_ratio(T num, T den, const Params<T>& p) {
  T g = p.is2 - p.one_m_is2 * num / (den + Eps<T>::value);
  g = g < T(0.0) ? T(0.0) : g;
  g = g > p.two_is2 ? p.two_is2 : g;
  return g;
}

// The direct two-reduction gamma (models/kbc.py gamma, with delta_s and
// delta_h in their paired-direction forms).
template <typename T>
__device__ __forceinline__ T gamma_direct(const T cT[9], T m0, T ux, T uy,
                                          const Params<T>& p) {
  T feq[9];
  equilibrium(m0, ux, uy, feq);
  const T x2 = ux * ux, y2 = uy * uy;

  // delta_s
  T ds[9];
  {
    const T T3 = cT[3], T4 = cT[4], T5 = cT[5];
    const T xy = ux * uy;
    const T r2 = x2 + y2;
    const T d2 = x2 - y2;
    const T P = T3 * r2 - T4 * d2;
    const T T5xy = T5 * xy;
    const T sd = ux + uy;
    const T dd = ux - uy;
    const T ev_ax = T(-0.25) * P - T(2.0) * T5xy;
    const T ev_di = T(0.125) * P + T5xy;
    const T even13 = ev_ax + T(0.25) * (T3 + T4);
    const T even24 = ev_ax + T(0.25) * (T3 - T4);
    const T even57 = ev_di + T(0.25) * T5;
    const T even86 = ev_di - T(0.25) * T5;
    const T odd13 = T(0.25) * ((T4 - T3) * ux) - T5 * uy;
    const T odd24 = T(-0.25) * ((T3 + T4) * uy) - T5 * ux;
    const T odd57 = T(0.125) * (T3 * sd - T4 * dd) + T(0.5) * (T5 * sd);
    const T odd86 = T(0.125) * (T3 * dd - T4 * sd) - T(0.5) * (T5 * dd);
    ds[0] = T3 * (T(0.5) * r2 - T(1.0)) - T(0.5) * T4 * d2 + T(4.0) * T5xy - feq[0];
    ds[1] = even13 + odd13 - feq[1];
    ds[2] = even24 + odd24 - feq[2];
    ds[3] = even13 - odd13 - feq[3];
    ds[4] = even24 - odd24 - feq[4];
    ds[5] = even57 + odd57 - feq[5];
    ds[6] = even86 - odd86 - feq[6];
    ds[7] = even57 - odd57 - feq[7];
    ds[8] = even86 + odd86 - feq[8];
  }

  // delta_h, with the reference's x2 + uy rows
  T dh[9];
  {
    const T T6 = cT[6], T7 = cT[7], T8 = cT[8];
    const T x2uy = x2 * uy;
    const T c56 = T(-0.25) * m0 * (x2 + uy - x2uy);
    const T c78 = T(-0.25) * m0 * (uy - x2 + x2uy);
    const T h6p = T6 * (T(0.5) * uy + T(0.25));
    const T h6m = T6 * (T(0.5) * uy - T(0.25));
    const T h7p = T7 * (T(0.5) * ux + T(0.25));
    const T h7m = T7 * (T(0.5) * ux - T(0.25));
    const T T6uy = T6 * uy;
    const T T7ux = T7 * ux;
    const T ev_ax = -T6uy - T7ux - T(0.5) * T8;
    dh[0] = T(2.0) * T6uy + T(2.0) * T7ux + T8 - feq[0];
    dh[1] = ev_ax - T(0.5) * T7 - feq[1];
    dh[2] = ev_ax - T(0.5) * T6 - feq[2];
    dh[3] = ev_ax + T(0.5) * T7 - feq[3];
    dh[4] = ev_ax + T(0.5) * T6 - feq[4];
    dh[5] = h6p + h7p + T(0.25) * T8 - feq[5] + c56;
    dh[6] = h6p + h7m + T(0.25) * T8 - feq[6] + c56;
    dh[7] = h6m + h7m + T(0.25) * T8 - feq[7] + c78;
    dh[8] = h6m + h7p + T(0.25) * T8 - feq[8] + c78;
  }

  // 1/feq_k = (1/m0) ipx[cx_k] ipy[cy_k]; the 1/m0 cancels in num/den
  T px[3], py[3], ipx[3], ipy[3];
  eq_factor_pairs(ux, uy, px, py);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ipx[i] = T(1.0) / px[i];
    ipy[i] = T(1.0) / py[i];
  }
  T num = T(0.0), den = T(0.0);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const T w = ipx[cx3(k)] * ipy[cy3(k)];
    const T dhw = dh[k] * w;
    const T nk = ds[k] * dhw;
    const T dk = dh[k] * dhw;
    num = (k == 0) ? nk : num + nk;
    den = (k == 0) ? dk : den + dk;
  }
  return gamma_from_ratio(num, den, p);
}

// gamma through the separable-basis identity (models/kbc.py gamma_factored).
template <typename T>
__device__ __forceinline__ T gamma_factored(const T cT[9], T m0, T ux, T uy,
                                            const Params<T>& p) {
  const T x2 = ux * ux, y2 = uy * uy;
  const T T3 = cT[3], T4 = cT[4], T5 = cT[5], T6 = cT[6], T7 = cT[7], T8 = cT[8];
  const T A6 = T(0.5) * (T3 + T4) * uy + T(2.0) * T5 * ux;
  const T A7 = T(0.5) * (T3 - T4) * ux + T(2.0) * T5 * uy;
  const T A8 = T(0.5) * T3 * (x2 + y2) - T(0.5) * T4 * (x2 - y2) +
               T(4.0) * T5 * (ux * uy);
  const T B8 = T(2.0) * T6 * uy + T(2.0) * T7 * ux + T8;
  const T x2uy = x2 * uy;
  const T c56 = T(-0.25) * m0 * (x2 + uy - x2uy);
  const T c78 = T(-0.25) * m0 * (uy - x2 + x2uy);
  const T g0 = T(0.5) * (c56 + c78);
  const T g1 = T(0.5) * (c56 - c78);

  T px[3], py[3];
  eq_factor_pairs(ux, uy, px, py);
  const T ipx0 = T(1.0) / px[0], ipx1 = T(1.0) / px[1], ipx2 = T(1.0) / px[2];
  const T ipy0 = T(1.0) / py[0], ipy1 = T(1.0) / py[1], ipy2 = T(1.0) / py[2];
  const T Sx0 = ipx0 + ipx1 + ipx2;
  const T SxE = ipx1 + ipx2;
  const T SxO = ipx1 - ipx2;
  const T Sy0 = ipy0 + ipy1 + ipy2;
  const T SyE = ipy1 + ipy2;
  const T SyO = ipy1 - ipy2;

  // sigma: monomial coefficients of S = inv(M) icfS
  const T s00 = A8 - T3;
  const T s02 = T(1.25) * T3 - T(0.25) * T4 - T(1.5) * A8;
  const T s20 = T(1.25) * T3 + T(0.25) * T4 - T(1.5) * A8;
  const T s22 = T(2.25) * A8 - T(1.5) * T3;
  const T s11 = T(0.25) * T5;
  const T s01 = T(-0.5) * A6;
  const T s21 = T(0.75) * A6;
  const T s10 = T(-0.5) * A7;
  const T s12 = T(0.75) * A7;
  // tau: monomial coefficients of H + c = inv(M) icfH + quirk
  const T t00 = B8;
  const T t02 = T(-1.5) * B8;
  const T t20 = t02;
  const T t22 = T(2.25) * B8 + g0;
  const T t01 = T(-0.5) * T6;
  const T t21 = T(0.75) * T6 + g1;
  const T t10 = T(-0.5) * T7;
  const T t12 = T(0.75) * T7;
  // stage 1: x-contraction
  const T tt00 = Sx0 * t00 + SxO * t10 + SxE * t20;
  const T tt10 = SxO * (t00 + t20) + SxE * t10;
  const T tt20 = SxE * (t00 + t20) + SxO * t10;
  const T tt01 = Sx0 * t01 + SxE * t21;
  const T tt11 = SxO * (t01 + t21);
  const T tt21 = SxE * (t01 + t21);
  const T tt02 = Sx0 * t02 + SxO * t12 + SxE * t22;
  const T tt12 = SxO * (t02 + t22) + SxE * t12;
  const T tt22 = SxE * (t02 + t22) + SxO * t12;
  // stage 2: y-contraction, V_{p,q} = sum_s Gy_{q+s} ttilde_{p,s}
  const T v00 = Sy0 * tt00 + SyO * tt01 + SyE * tt02;
  const T v01 = SyO * (tt00 + tt02) + SyE * tt01;
  const T v02 = SyE * (tt00 + tt02) + SyO * tt01;
  const T v10 = Sy0 * tt10 + SyO * tt11 + SyE * tt12;
  const T v11 = SyO * (tt10 + tt12) + SyE * tt11;
  const T v12 = SyE * (tt10 + tt12) + SyO * tt11;
  const T v20 = Sy0 * tt20 + SyO * tt21 + SyE * tt22;
  const T v21 = SyO * (tt20 + tt22) + SyE * tt21;
  const T v22 = SyE * (tt20 + tt22) + SyO * tt21;
  const T m2 = m0 * m0;
  const T num = (s00 * v00 + s01 * v01 + s02 * v02 + s10 * v10 + s11 * v11 +
                 s12 * v12 + s20 * v20 + s21 * v21 + s22 * v22) +
                m2 * (T(1.0) + uy);
  const T den = (t00 * v00 + t01 * v01 + t02 * v02 + t10 * v10 + t12 * v12 +
                 t20 * v20 + t21 * v21 + t22 * v22) +
                m2 * (T(1.0) + T(2.0) * uy);
  return gamma_from_ratio(num, den, p);
}

// One KBC collision (models/kbc.py collide): f, m0 and u = m1/m0 of one
// cell -> post-collision populations.
template <typename T, bool kFactored>
__device__ __forceinline__ void collide(const T f[9], T m0, T ux, T uy,
                                        const Params<T>& p, T out[9]) {
  T cT[9];
  central_moments(f, ux, uy, cT);
  const T g = kFactored ? gamma_factored(cT, m0, ux, uy, p)
                        : gamma_direct(cT, m0, ux, uy, p);

  // subtract the equilibrium central moments (k = 0, 3, 8) and relax
  const T gs2 = g * p.s2;
  const T T0 = cT[0] - m0;
  const T T1 = cT[1];
  const T T2 = cT[2];
  const T T3 = p.s2 * (cT[3] - T(2.0 * kCS2) * m0);
  const T T4 = p.s2 * cT[4];
  const T T5 = p.s2 * cT[5];
  const T T6 = gs2 * cT[6];
  const T T7 = gs2 * cT[7];
  const T T8 = gs2 * (cT[8] - T(kCS4) * m0);

  // inv(N) back-map (ulbm.cpp:104-112)
  const T x2 = ux * ux, y2 = uy * uy;
  T icf[9];
  icf[0] = T0;
  icf[1] = T0 * ux + T1;
  icf[2] = T0 * uy + T2;
  icf[3] = T0 * (x2 + y2) + T(2.0) * T1 * ux + T(2.0) * T2 * uy + T3;
  icf[4] = T0 * (x2 - y2) + T(2.0) * T1 * ux - T(2.0) * T2 * uy + T4;
  icf[5] = T0 * ux * uy + T1 * uy + T2 * ux + T5;
  icf[6] = T0 * x2 * uy + T(2.0) * T1 * ux * uy + T2 * x2 + T(0.5) * T3 * uy +
           T(0.5) * T4 * uy + T(2.0) * T5 * ux + T6;
  icf[7] = T0 * ux * y2 + T1 * y2 + T(2.0) * T2 * ux * uy + T(0.5) * T3 * ux -
           T(0.5) * T4 * ux + T(2.0) * T5 * uy + T7;
  icf[8] = T0 * x2 * y2 + T(2.0) * T1 * ux * y2 + T(2.0) * T2 * x2 * uy +
           T(0.5) * T3 * (x2 + y2) - T(0.5) * T4 * (x2 - y2) +
           T(4.0) * T5 * ux * uy + T(2.0) * T6 * uy + T(2.0) * T7 * ux + T8;

  // f - inv(M) icf, inv(M) (src/ulbm.hpp:29-40) as the plain version's
  // sparse sums: its zero entries skipped, terms added left to right
  out[0] = f[0] - (icf[0] + T(-1.0) * icf[3] + icf[8]);
  out[1] = f[1] - (T(0.5) * icf[1] + T(0.25) * icf[3] + T(0.25) * icf[4] +
                   T(-0.5) * icf[7] + T(-0.5) * icf[8]);
  out[2] = f[2] - (T(0.5) * icf[2] + T(0.25) * icf[3] + T(-0.25) * icf[4] +
                   T(-0.5) * icf[6] + T(-0.5) * icf[8]);
  out[3] = f[3] - (T(-0.5) * icf[1] + T(0.25) * icf[3] + T(0.25) * icf[4] +
                   T(0.5) * icf[7] + T(-0.5) * icf[8]);
  out[4] = f[4] - (T(-0.5) * icf[2] + T(0.25) * icf[3] + T(-0.25) * icf[4] +
                   T(0.5) * icf[6] + T(-0.5) * icf[8]);
  out[5] = f[5] - (T(0.25) * icf[5] + T(0.25) * icf[6] + T(0.25) * icf[7] +
                   T(0.25) * icf[8]);
  out[6] = f[6] - (T(-0.25) * icf[5] + T(0.25) * icf[6] + T(-0.25) * icf[7] +
                   T(0.25) * icf[8]);
  out[7] = f[7] - (T(0.25) * icf[5] + T(-0.25) * icf[6] + T(-0.25) * icf[7] +
                   T(0.25) * icf[8]);
  out[8] = f[8] - (T(-0.25) * icf[5] + T(-0.25) * icf[6] + T(0.25) * icf[7] +
                   T(0.25) * icf[8]);
}

// m0 = sum f, u = m1 / m0 (the plain steps' macroscopics: calc_rho's
// left-to-right sum, calc_momentum / m0 as a true division).
template <typename T>
__device__ __forceinline__ void macroscopics(const T f[9], T& m0, T& ux, T& uy) {
  T mx, my;
  moments(f, m0, mx, my);
  ux = mx / m0;
  uy = my / m0;
}

}  // namespace kbc
}  // namespace lbm
