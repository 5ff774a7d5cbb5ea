// Kernel 5: one periodic D2Q9 collide-stream step with the Smagorinsky-BGK
// collision (per-cell omega from the non-equilibrium stress).
//
// Replaces the TPU kernel lbm_tpu/kernels/les_pallas.py:78
// make_les_fused_step (les_collide_fn :34 on collide_stream.py:91
// make_fused_step).  Kernel 1's
// design with another local collision, transcribed from the plain version
// kernels/les.py::les_collide_fn in the same order: the paired-direction
// compressible equilibrium, dq = f - feq, the three stress sums
//   qxx = sum over {1,3,5,6,7,8}, qyy over {2,4,5,6,7,8},
//   qxy = dq5 - dq6 + dq7 - dq8,
// |Q| = sqrt(qxx^2 + 2 qxy^2 + qyy^2),
// tau = (tau0 + sqrt(tau0^2 + 18 sqrt(2) Cs^2 |Q| / rho)) / 2, omega = 1/tau,
// coll_k = f_k - omega dq_k, pushed to (r + cx_k mod R, c + cy_k mod C) of
// a separate output buffer.  IEEE sqrt and division (no fast math).
//
// Bound: device-memory bytes, as kernel 1: 72 B/cell in float32 against
// ~100 flops, two square roots and two divides per cell.  Measured on an
// H100 80GB HBM3 (700 W) at 4096x2048: 0.23 ms/step in float32, 0.87 of a
// device-to-device copy's bandwidth; 0.44 ms in float64.  Left on the
// table: temporal blocking, vector loads.
//
// The collision is a functor shared by this step and kernel 27's LES
// instance, lbm_halo_les, and kernel 34's, lbm_halo2d_les: the same
// device code in the sharded call of csrc/collide_stream.cuh
// (block::launch_shards: a call's s steps on up to 8 row or rows x cols
// shards of a card in one launch), built with this source's flags, so an
// n-shard run equals this kernel run s times bit for bit.

#include <cuda_runtime.h>

#include <cmath>

#include "collide_stream.cuh"

namespace {

// The Smagorinsky-BGK collision of one cell (kernels/les.py::les_collide_fn).
template <typename T>
struct Les {
  T tau0, tau0_sq, a_cs;

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

    const T qxx = dq[1] + dq[3] + dq[5] + dq[6] + dq[7] + dq[8];
    const T qyy = dq[2] + dq[4] + dq[5] + dq[6] + dq[7] + dq[8];
    const T qxy = dq[5] - dq[6] + dq[7] - dq[8];
    const T qn = sqrt(qxx * qxx + T(2.0) * qxy * qxy + qyy * qyy);
    const T tau = T(0.5) * (tau0 + sqrt(tau0_sq + a_cs * qn * inv_rho));
    const T om = T(1.0) / tau;
#pragma unroll
    for (int k = 0; k < 9; ++k) coll[k] = f[k] - om * dq[k];
  }
};

// The constants rounded to T as the plain version rounds them: tau0, its
// square taken in T, and 18 sqrt(2) Cs^2 taken in double.
template <typename T>
Les<T> les(double tau0, double cs_smag) {
  const T t00 = static_cast<T>(tau0);
  return {t00, t00 * t00, static_cast<T>(18.0 * std::sqrt(2.0) * (cs_smag * cs_smag))};
}

}  // namespace

// One step f_in -> f_out (distinct buffers) on `stream`; returns the
// cudaError_t of the launch (0 = accepted).
extern "C" int lbm_collide_stream_les(const void* fin, void* fout, long long R,
                                      long long C, double tau0, double cs_smag,
                                      int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? lbm::launch_periodic<double>(fin, fout, R, C, les<double>(tau0, cs_smag), s)
                : lbm::launch_periodic<float>(fin, fout, R, C, les<float>(tau0, cs_smag), s);
}

// Kernel 27, LES instance: a call of `steps` steps on each of `n_shards`
// row shards of the device, `geoms` their geometry arrays back to back
// (csrc/collide_stream.cuh block::Geom; the columns wrap); params =
// {tau0, cs_smag}.
extern "C" int lbm_halo_les(const long long* geoms, const double* params, int n_shards,
                            int steps, int i0, int i1, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto op64 = les<double>(params[0], params[1]);
  const auto op32 = les<float>(params[0], params[1]);
  return is_f64 ? lbm::block::launch_shards<double>(geoms, n_shards, steps, op64, s)
                : lbm::block::launch_shards<float>(geoms, n_shards, steps, op32, s);
}

// Kernel 34, LES instance: the same call on rows x cols shards (their 3 x 3
// parts hold the neighbours' lines; no column wraps).
extern "C" int lbm_halo2d_les(const long long* geoms, const double* params, int n_shards,
                              int steps, int i0, int i1, int is_f64, void* stream) {
  return lbm_halo_les(geoms, params, n_shards, steps, i0, i1, is_f64, stream);
}
