// Kernel 11: one periodic D2Q9 collide-stream step with the truncated
// power-law / Herschel-Bulkley collision (a per-cell apparent tau).
//
// Replaces the TPU kernel lbm_tpu/kernels/power_law_pallas.py:144
// make_power_law_fused_step (power_law_collide_fn :41 on
// collide_stream.py:91 make_fused_step).  Kernel 1's design with another
// local collision, transcribed from the plain version
// kernels/power_law.py::power_law_collide_fn in the same order:
//   the paired-direction compressible equilibrium, dq = f - feq;
//   |Q| = sqrt(qxx^2 + 2 qxy^2 + qyy^2), a = max(sqrt(9/2) |Q| / rho, tiny);
//   then one of three branches, chosen on the host (template MODE):
//     NEWTONIAN  omega = the clipped 1/(1/2 + 3K), a constant;
//     PICARD     `iters` sweeps tau <- 1/2 + 3 clip(exp(log K + (n-1)
//                (log a - log tau))), every second one followed by a clipped
//                Aitken update (kept at t1 where its denominator is 0);
//     NEWTON     `iters` bracket-clamped Newton steps on
//                gdot/2 + 3 (sigma_y (1 - e^{-m gdot}) + K gdot^n) = a;
//   coll_k = f_k - omega dq_k, pushed to (r + cx_k mod R, c + cy_k mod C).
// The scalars come from the host already rounded to T
// (kernels/power_law.py::power_law_constants).  Libdevice exp, log, expm1
// and IEEE sqrt and division; no fast math (it would flush the subnormals
// the `tiny` floor keeps away), and -fmad=false (_build.UNIT_FLAGS): each
// operation rounds once, as the plain version's elementwise ops do.  The
// clips keep a NaN, as torch.clamp does.
//
// Bound: device-memory bytes, 72 B/cell in float32, against ~100 flops plus
// 2 transcendentals per Picard sweep (8 sweeps by default) per cell; the
// count is chip_smoke.py's.  Left on the table: temporal blocking, vector
// loads, a cheaper pow for the Picard map.
//
// The collision is a functor shared by this step and kernel 27's power-law
// instance, lbm_halo_power_law, and kernel 34's, lbm_halo2d_power_law: the same
// device code in the sharded call of csrc/collide_stream.cuh
// (block::launch_shards: a call's s steps on up to 8 row or rows x cols
// shards of a card in one launch), built with this source's flags, so an
// n-shard run equals this kernel run s times bit for bit.

#include <cuda_runtime.h>

#include <cmath>

#include "collide_stream.cuh"

namespace {

enum Mode { NEWTONIAN = 0, PICARD = 1, NEWTON = 2 };

// The order of kernels/power_law.py::_CONSTANTS.
template <typename T>
struct Consts {
  T om_const, log_k, nu_lo, nu_hi, nm1, nn, tau0, tiny, sq32, sy, mp, neg_mp,
      sy_mp, tmin, tmax;
};

// clip(x, lo, hi) that keeps a NaN (torch.clamp)
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T>
__device__ __forceinline__ T picard(T log_a, T t, const Consts<T>& k) {
  const T lg = log_a - log(t);
  const T nu = exp(k.log_k + k.nm1 * lg);
  return T(0.5) + T(3.0) * clip(nu, k.nu_lo, k.nu_hi);
}

// The power-law collision of one cell in the host-chosen branch MODE
// (kernels/power_law.py::power_law_collide_fn).
template <typename T, int MODE>
struct PowerLaw {
  // a long collision for the sharded call's tile engine (csrc/collide_stream.cuh Box)
  static constexpr bool HEAVY = true;
  Consts<T> k;
  int iters;

  __device__ __forceinline__ void operator()(const T f[9], T coll[9]) const {
    T rho, mx, my;
    lbm::moments(f, rho, mx, my);
    const T inv_rho = T(1.0) / rho;
    const T ux = mx * inv_rho;
    const T uy = my * inv_rho;

    const lbm::Pairs<T> p = lbm::d2q9_pairs(ux, uy);
    T dq[9];
    dq[0] = f[0] - T(lbm::weight(0)) * rho * p.t0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const T wr = T(lbm::weight(lbm::pair_kp(i))) * rho;
      const T even = wr * (p.t0 + T(4.5) * p.cc[i]);
      const T odd = wr * (T(3.0) * p.cu[i]);
      dq[lbm::pair_kp(i)] = f[lbm::pair_kp(i)] - (even + odd);
      dq[lbm::pair_km(i)] = f[lbm::pair_km(i)] - (even - odd);
    }

    T om;
    if (MODE == NEWTONIAN) {
      om = k.om_const;
    } else {
      const T qxx = dq[1] + dq[3] + dq[5] + dq[6] + dq[7] + dq[8];
      const T qyy = dq[2] + dq[4] + dq[5] + dq[6] + dq[7] + dq[8];
      const T qxy = dq[5] - dq[6] + dq[7] - dq[8];
      const T qn = sqrt(qxx * qxx + T(2.0) * qxy * qxy + qyy * qyy);
      T a = k.sq32 * qn * inv_rho;
      a = a < k.tiny ? k.tiny : a;  // maximum(a, tiny), NaN kept
      if (MODE == NEWTON) {
        const T gd_lo = a / k.tmax;
        const T gd_hi = a / k.tmin;
        T gd = gd_lo;
        for (int it = 0; it < iters; ++it) {
          const T q = exp(k.log_k + k.nm1 * log(gd));
          const T e = exp(k.neg_mp * gd);
          const T h = T(0.5) * gd + T(3.0) * (k.sy * (T(1.0) - e) + q * gd) - a;
          const T hp = T(0.5) + T(3.0) * (k.sy_mp * e + k.nn * q);
          gd = clip(gd - h / hp, gd_lo, gd_hi);
        }
        const T nu = exp(k.log_k + k.nm1 * log(gd)) + k.sy * (-expm1(k.neg_mp * gd)) / gd;
        om = T(1.0) / (T(0.5) + T(3.0) * clip(nu, k.nu_lo, k.nu_hi));
      } else {
        const T log_a = log(a);
        T tau = k.tau0;
        T tprev = tau;
        for (int it = 0; it < iters; ++it) {
          const T t1 = picard(log_a, tau, k);
          if (it % 2 == 0) {
            tprev = tau;
            tau = t1;
            continue;
          }
          const T den = t1 - T(2.0) * tau + tprev;
          const T accel = t1 - (t1 - tau) * (t1 - tau) / (den == T(0.0) ? T(1.0) : den);
          tau = den == T(0.0) ? t1 : clip(accel, k.tmin, k.tmax);
        }
        om = T(1.0) / tau;
      }
    }
#pragma unroll
    for (int q = 0; q < 9; ++q) coll[q] = f[q] - om * dq[q];
  }
};

template <typename T>
Consts<T> consts(const double* d) {
  return {T(d[0]), T(d[1]), T(d[2]),  T(d[3]),  T(d[4]),  T(d[5]),  T(d[6]), T(d[7]),
          T(d[8]), T(d[9]), T(d[10]), T(d[11]), T(d[12]), T(d[13]), T(d[14])};
}

// The forms of the step: kernel 11 (periodic) and the sharded call of
// kernels 27 and 34 (`steps` steps on each of `n` shards with the
// geometries `geoms`).
template <typename T, bool SHARDS, typename Op>
int run(const Op& op, const void* fin, void* fout, long long R, long long C,
        const long long* geoms, int n, int steps, cudaStream_t s) {
  if constexpr (SHARDS)
    return lbm::block::launch_shards<T>(geoms, n, steps, op, s);
  else
    return lbm::launch_periodic<T>(fin, fout, R, C, op, s);
}

// The step in the form SHARDS and the branch `mode`.
template <typename T, bool SHARDS>
int dispatch(const void* fin, void* fout, long long R, long long C, const long long* geoms,
             int n, int steps, const double* d, int mode, int iters, cudaStream_t s) {
  const Consts<T> k = consts<T>(d);
  switch (mode) {
    case NEWTONIAN:
      return run<T, SHARDS>(PowerLaw<T, NEWTONIAN>{k, iters}, fin, fout, R, C, geoms, n, steps,
                            s);
    case PICARD:
      return run<T, SHARDS>(PowerLaw<T, PICARD>{k, iters}, fin, fout, R, C, geoms, n, steps, s);
    case NEWTON:
      return run<T, SHARDS>(PowerLaw<T, NEWTON>{k, iters}, fin, fout, R, C, geoms, n, steps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One step f_in -> f_out (distinct buffers) on `stream`.  `consts` holds the
// 15 scalars of kernels/power_law.py::_CONSTANTS, already rounded to the
// state's type; `mode` is 0 (Newtonian), 1 (Picard) or 2 (Newton).  Returns
// the cudaError_t of the launch (0 = accepted).
extern "C" int lbm_collide_stream_power_law(const void* fin, void* fout, long long R,
                                            long long C, const double* consts,
                                            int mode, int iters, int is_f64,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64
             ? dispatch<double, false>(fin, fout, R, C, nullptr, 0, 1, consts, mode, iters, s)
             : dispatch<float, false>(fin, fout, R, C, nullptr, 0, 1, consts, mode, iters, s);
}

// Kernel 27, power-law instance: a call of `steps` steps on each of
// `n_shards` row shards of the device, `geoms` their geometry arrays back to
// back (csrc/collide_stream.cuh block::Geom; the columns wrap); params = the
// 15 constants, mode = the branch, iters its iterations.
extern "C" int lbm_halo_power_law(const long long* geoms, const double* params, int n_shards,
                                  int steps, int mode, int iters, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? dispatch<double, true>(nullptr, nullptr, 0, 0, geoms, n_shards, steps, params,
                                         mode, iters, s)
                : dispatch<float, true>(nullptr, nullptr, 0, 0, geoms, n_shards, steps, params,
                                        mode, iters, s);
}

// Kernel 34, power-law instance: the same call on rows x cols shards (their
// 3 x 3 parts hold the neighbours' lines; no column wraps).
extern "C" int lbm_halo2d_power_law(const long long* geoms, const double* params, int n_shards,
                                    int steps, int mode, int iters, int is_f64, void* stream) {
  return lbm_halo_power_law(geoms, params, n_shards, steps, mode, iters, is_f64, stream);
}
