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

#include <cuda_runtime.h>

#include <cmath>

#include "d2q9.cuh"

namespace {

template <typename T>
__global__ void collide_stream_les_kernel(const T* __restrict__ fin,
                                          T* __restrict__ fout, int64_t R,
                                          int64_t C, T tau0, T tau0_sq, T a_cs) {
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

  const T qxx = dq[1] + dq[3] + dq[5] + dq[6] + dq[7] + dq[8];
  const T qyy = dq[2] + dq[4] + dq[5] + dq[6] + dq[7] + dq[8];
  const T qxy = dq[5] - dq[6] + dq[7] - dq[8];
  const T qn = sqrt(qxx * qxx + T(2.0) * qxy * qxy + qyy * qyy);
  const T tau = T(0.5) * (tau0 + sqrt(tau0_sq + a_cs * qn * inv_rho));
  const T om = T(1.0) / tau;

#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const T coll = f[k] - om * dq[k];
    const int64_t rr = lbm::wrap(r + lbm::cx(k), R);
    const int64_t cc = lbm::wrap(c + lbm::cy(k), C);
    fout[k * n + rr * C + cc] = coll;
  }
}

template <typename T>
int launch(const void* fin, void* fout, long long R, long long C, double tau0,
           double cs_smag, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(R) * C;
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  // constants rounded to T as the plain version rounds them: tau0, its
  // square taken in T, and 18 sqrt(2) Cs^2 taken in double
  const T t00 = static_cast<T>(tau0);
  const T a_cs = static_cast<T>(18.0 * std::sqrt(2.0) * (cs_smag * cs_smag));
  collide_stream_les_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(fin), static_cast<T*>(fout), R, C, t00, t00 * t00, a_cs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One step f_in -> f_out (distinct buffers) on `stream`; returns the
// cudaError_t of the launch (0 = accepted).
extern "C" int lbm_collide_stream_les(const void* fin, void* fout, long long R,
                                      long long C, double tau0, double cs_smag,
                                      int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(fin, fout, R, C, tau0, cs_smag, s)
                : launch<float>(fin, fout, R, C, tau0, cs_smag, s);
}
