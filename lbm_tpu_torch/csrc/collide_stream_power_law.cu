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

#include <cuda_runtime.h>

#include <cmath>

#include "d2q9.cuh"

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

template <typename T, int MODE>
__global__ void collide_stream_power_law_kernel(const T* __restrict__ fin,
                                                T* __restrict__ fout, int64_t R,
                                                int64_t C, Consts<T> k, int iters) {
  const int64_t n = R * C;
  const int64_t cell = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  const int64_t r = cell / C;
  const int64_t c = cell - r * C;

  T f[9];
  lbm::load9(fin, n, cell, f);
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
  for (int q = 0; q < 9; ++q) {
    const T coll = f[q] - om * dq[q];
    const int64_t rr = lbm::wrap(r + lbm::cx(q), R);
    const int64_t cc = lbm::wrap(c + lbm::cy(q), C);
    fout[q * n + rr * C + cc] = coll;
  }
}

template <typename T, int MODE>
int launch(const void* fin, void* fout, long long R, long long C, const double* d,
           int iters, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(R) * C;
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  const Consts<T> k = {T(d[0]), T(d[1]), T(d[2]),  T(d[3]),  T(d[4]),
                       T(d[5]), T(d[6]), T(d[7]),  T(d[8]),  T(d[9]),
                       T(d[10]), T(d[11]), T(d[12]), T(d[13]), T(d[14])};
  collide_stream_power_law_kernel<T, MODE>
      <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
          static_cast<const T*>(fin), static_cast<T*>(fout), R, C, k, iters);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* fin, void* fout, long long R, long long C, const double* d,
             int mode, int iters, cudaStream_t s) {
  switch (mode) {
    case NEWTONIAN: return launch<T, NEWTONIAN>(fin, fout, R, C, d, iters, s);
    case PICARD: return launch<T, PICARD>(fin, fout, R, C, d, iters, s);
    case NEWTON: return launch<T, NEWTON>(fin, fout, R, C, d, iters, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
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
  return is_f64 ? dispatch<double>(fin, fout, R, C, consts, mode, iters, s)
                : dispatch<float>(fin, fout, R, C, consts, mode, iters, s);
}
