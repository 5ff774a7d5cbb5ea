// Kernel 1: one periodic D2Q9 BGK collide-stream step.
//
// Replaces the TPU kernel lbm_tpu/kernels/bgk_pallas.py::make_fused_step
// (bgk_collide_fn on kernels/collide_stream.py::make_fused_step, which
// runs on kernels/pipeline.py::make_block_pipeline).  The Pallas kernel
// streams row blocks with 8-row halos through VMEM; here there is no
// pipeline: each thread owns one cell and indexes device memory directly.
//
// Step: stream(collide(f)), as lbm_tpu's step is (collide_stream.py:116-117):
// a thread loads its 9 populations, forms rho, m as explicit sums and
// u = m / rho, relaxes towards the paired-direction compressible
// equilibrium, and PUSHES coll_k to (r + cx_k mod R, c + cy_k mod C) of the
// separate output buffer.  (A pull kernel that gathers and then collides
// would compute collide(stream(f)), a different state.)  Threads along a
// warp take neighbouring columns, so every plane load and store is
// coalesced.  Several steps per call are several launches: the Python
// wrapper ping-pongs two buffers (kernels/collide_stream.py).
//
// Bound: device-memory bytes.  A float32 step reads and writes 9 values per
// cell, 72 B/cell, against ~60 flops/cell.  Left on the table by this
// simple design: temporal blocking (several steps per pass through a
// shared-memory tile with halos, which cuts the bytes per step), 16-byte
// vector loads, and in-place (single-buffer) streaming schemes.

#include <cuda_runtime.h>

#include "d2q9.cuh"

namespace {

template <typename T>
__global__ void collide_stream_bgk_kernel(const T* __restrict__ fin,
                                          T* __restrict__ fout, int64_t R,
                                          int64_t C, T omega, T one_m_omega) {
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

  // paired-direction compressible equilibrium (kernels/bgk.py::bgk_collide_fn)
  const lbm::Pairs<T> p = lbm::d2q9_pairs(ux, uy);
  T feq[9];
  feq[0] = T(lbm::weight(0)) * rho * p.t0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T wr = T(lbm::weight(lbm::pair_kp(i))) * rho;
    const T even = wr * (p.t0 + T(4.5) * p.cc[i]);
    const T odd = wr * (T(3.0) * p.cu[i]);
    feq[lbm::pair_kp(i)] = even + odd;
    feq[lbm::pair_km(i)] = even - odd;
  }

#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const T coll = one_m_omega * f[k] + omega * feq[k];
    const int64_t rr = lbm::wrap(r + lbm::cx(k), R);
    const int64_t cc = lbm::wrap(c + lbm::cy(k), C);
    fout[k * n + rr * C + cc] = coll;
  }
}

template <typename T>
int launch(const void* fin, void* fout, long long R, long long C,
           double omega, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(R) * C;
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  collide_stream_bgk_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(fin), static_cast<T*>(fout), R, C,
      static_cast<T>(omega), static_cast<T>(1.0 - omega));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One step f_in -> f_out (distinct buffers) on `stream`; returns the
// cudaError_t of the launch (0 = accepted).
extern "C" int lbm_collide_stream_bgk(const void* fin, void* fout, long long R,
                                      long long C, double omega, int is_f64,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(fin, fout, R, C, omega, s)
                : launch<float>(fin, fout, R, C, omega, s);
}
