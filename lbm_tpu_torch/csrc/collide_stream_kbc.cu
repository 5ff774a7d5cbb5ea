// Kernel 3: one periodic D2Q9 collide-stream step with the cascaded
// entropic KBC collision.
//
// Replaces the TPU kernel lbm_tpu/kernels/collide_stream.py:154
// make_kbc_fused_step (kbc_collide_fn :133 on collide_stream.py:91
// make_fused_step and kernels/pipeline.py:228).  Kernel 1's design with
// another local collision: each thread owns one cell, forms m0 and
// u = m1 / m0, runs the KBC collision of csrc/kbc.cuh and PUSHES coll_k to
// (r + cx_k mod R, c + cy_k mod C) of a separate output buffer, so the step
// is stream(collide(f)) as in lbm_tpu.  Neighbouring columns along a warp:
// every plane load and store is coalesced.  Several steps per call are
// several launches (the wrapper ping-pongs two buffers).
//
// Bound: the bytes are kernel 1's, 72 B/cell in float32, but the
// collision costs some 400-550 flops per cell with seven IEEE divides (1/p
// for the six per-axis factors, the gamma ratio) and two for u, and keeps
// ~40 values live (9 f, 9 central moments, the Gram coefficients).  The
// design keeps every temporary in registers (no spills) and touches device
// memory only for the 9 loads and 9 stores.  Measured on an H100 80GB HBM3
// (700 W) at 4096x2048: 0.26 ms/step in float32, 0.77 of a device-to-device
// copy's bandwidth (kernel 1: 0.88); 0.46 ms in float64, 0.88 of it.  As
// float64 does the same work at half the FP rate in less than twice the
// time, float32 is not arithmetic-bound: it is load latency, with 64
// (factored) or 72 (direct) registers leaving 1024 or 768 threads per SM
// to cover the loads while the collision runs.  Left on the table: two
// cells per thread or launch bounds for more loads in flight, temporal
// blocking, cheaper divides (not taken: they change the results the
// tolerances assume).

#include <cuda_runtime.h>

#include "d2q9.cuh"
#include "kbc.cuh"

namespace {

template <typename T, bool kFactored>
__global__ void collide_stream_kbc_kernel(const T* __restrict__ fin,
                                          T* __restrict__ fout, int64_t R,
                                          int64_t C, lbm::kbc::Params<T> p) {
  const int64_t n = R * C;
  const int64_t cell = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  const int64_t r = cell / C;
  const int64_t c = cell - r * C;

  T f[9];
  lbm::load9(fin, n, cell, f);
  T m0, ux, uy;
  lbm::kbc::macroscopics(f, m0, ux, uy);
  T coll[9];
  lbm::kbc::collide<T, kFactored>(f, m0, ux, uy, p, coll);

#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int64_t rr = lbm::wrap(r + lbm::cx(k), R);
    const int64_t cc = lbm::wrap(c + lbm::cy(k), C);
    fout[k * n + rr * C + cc] = coll[k];
  }
}

template <typename T>
int launch(const void* fin, void* fout, long long R, long long C, double s2,
           int factored, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(R) * C;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  const lbm::kbc::Params<T> p = lbm::kbc::make_params<T>(s2);
  const T* src = static_cast<const T*>(fin);
  T* dst = static_cast<T*>(fout);
  if (factored) {
    collide_stream_kbc_kernel<T, true><<<blocks, threads, 0, stream>>>(src, dst, R, C, p);
  } else {
    collide_stream_kbc_kernel<T, false><<<blocks, threads, 0, stream>>>(src, dst, R, C, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One step f_in -> f_out (distinct buffers) on `stream`, with the factored
// (factored != 0) or the direct gamma; returns the cudaError_t of the
// launch (0 = accepted).
extern "C" int lbm_collide_stream_kbc(const void* fin, void* fout, long long R,
                                      long long C, double s2, int factored,
                                      int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(fin, fout, R, C, s2, factored, s)
                : launch<float>(fin, fout, R, C, s2, factored, s);
}
