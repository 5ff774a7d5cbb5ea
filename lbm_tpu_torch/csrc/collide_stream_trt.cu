// Kernel 10: one periodic D2Q9 collide-stream step with the two-relaxation-
// time (TRT) collision.
//
// Replaces the TPU kernel lbm_tpu/kernels/trt_pallas.py:74
// make_trt_fused_step (trt_collide_fn :36 on collide_stream.py:91
// make_fused_step).  Kernel 1's design with another local collision,
// transcribed from the plain version kernels/trt.py::trt_collide_fn in the
// same order: the paired-direction compressible equilibrium, then per
// opposite pair (kp, km)
//   ne_even = (f_kp + f_km)/2 - even_eq,  ne_odd = (f_kp - f_km)/2 - odd_eq,
//   coll_kp = f_kp - (w+ ne_even + w- ne_odd),
//   coll_km = f_km - (w+ ne_even - w- ne_odd),
// and coll_0 = f_0 - w+ (f_0 - feq_0), pushed to (r + cx_k mod R,
// c + cy_k mod C) of a separate output buffer.  Built with -fmad=false
// (_build.UNIT_FLAGS): each operation rounds once, as the plain version's
// elementwise ops do.
//
// Bound: device-memory bytes, as kernel 1: 72 B/cell in float32 against
// ~70 flops per cell.  Left on the table: temporal blocking, vector loads.

#include <cuda_runtime.h>

#include "d2q9.cuh"

namespace {

template <typename T>
__global__ void collide_stream_trt_kernel(const T* __restrict__ fin,
                                          T* __restrict__ fout, int64_t R,
                                          int64_t C, T w_plus, T w_minus) {
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
  T coll[9];
  const T feq0 = T(lbm::weight(0)) * rho * p.t0;
  coll[0] = f[0] - w_plus * (f[0] - feq0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = lbm::pair_kp(i);
    const int km = lbm::pair_km(i);
    const T wr = T(lbm::weight(kp)) * rho;
    const T even_eq = wr * (p.t0 + T(4.5) * p.cc[i]);
    const T odd_eq = wr * (T(3.0) * p.cu[i]);
    const T ne_even = T(0.5) * (f[kp] + f[km]) - even_eq;
    const T ne_odd = T(0.5) * (f[kp] - f[km]) - odd_eq;
    const T d_even = w_plus * ne_even;
    const T d_odd = w_minus * ne_odd;
    coll[kp] = f[kp] - (d_even + d_odd);
    coll[km] = f[km] - (d_even - d_odd);
  }

#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int64_t rr = lbm::wrap(r + lbm::cx(k), R);
    const int64_t cc = lbm::wrap(c + lbm::cy(k), C);
    fout[k * n + rr * C + cc] = coll[k];
  }
}

template <typename T>
int launch(const void* fin, void* fout, long long R, long long C,
           double omega_plus, double omega_minus, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(R) * C;
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  collide_stream_trt_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(fin), static_cast<T*>(fout), R, C,
      static_cast<T>(omega_plus), static_cast<T>(omega_minus));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One step f_in -> f_out (distinct buffers) on `stream`; returns the
// cudaError_t of the launch (0 = accepted).
extern "C" int lbm_collide_stream_trt(const void* fin, void* fout, long long R,
                                      long long C, double omega_plus,
                                      double omega_minus, int is_f64,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(fin, fout, R, C, omega_plus, omega_minus, s)
                : launch<float>(fin, fout, R, C, omega_plus, omega_minus, s);
}
