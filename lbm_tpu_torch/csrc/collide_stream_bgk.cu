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
//
// The collision is a functor shared by this step and kernel 27's BGK
// instance, lbm_halo_bgk, and kernel 34's, lbm_halo2d_bgk: the same
// device code in the sharded call of csrc/collide_stream.cuh
// (block::launch_shards: a call's s steps on up to 8 row or rows x cols
// shards of a card in one launch), built with this source's flags, so an
// n-shard run equals this kernel run s times bit for bit.

#include <cuda_runtime.h>

#include "collide_stream.cuh"

namespace {

// The BGK collision of one cell: rho, m as explicit sums, u = m / rho, the
// paired-direction compressible equilibrium (kernels/bgk.py::bgk_collide_fn).
template <typename T>
struct Bgk {
  T omega, one_m_omega;

  __device__ __forceinline__ void operator()(const T f[9], T coll[9]) const {
    T rho, mx, my;
    lbm::moments(f, rho, mx, my);
    const T inv_rho = T(1.0) / rho;
    const T ux = mx * inv_rho;
    const T uy = my * inv_rho;
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
    for (int k = 0; k < 9; ++k) coll[k] = one_m_omega * f[k] + omega * feq[k];
  }
};

template <typename T>
Bgk<T> bgk(double omega) {
  return {static_cast<T>(omega), static_cast<T>(1.0 - omega)};
}

}  // namespace

// One step f_in -> f_out (distinct buffers) on `stream`; returns the
// cudaError_t of the launch (0 = accepted).
extern "C" int lbm_collide_stream_bgk(const void* fin, void* fout, long long R,
                                      long long C, double omega, int is_f64,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? lbm::launch_periodic<double>(fin, fout, R, C, bgk<double>(omega), s)
                : lbm::launch_periodic<float>(fin, fout, R, C, bgk<float>(omega), s);
}

// Kernel 27, BGK instance: a call of `steps` steps on each of `n_shards`
// row shards of the device, `geoms` their geometry arrays back to back
// (csrc/collide_stream.cuh block::Geom; the columns wrap); params = {omega}.
extern "C" int lbm_halo_bgk(const long long* geoms, const double* params, int n_shards,
                            int steps, int i0, int i1, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? lbm::block::launch_shards<double>(geoms, n_shards, steps, bgk<double>(params[0]), s)
                : lbm::block::launch_shards<float>(geoms, n_shards, steps, bgk<float>(params[0]), s);
}

// Kernel 34, BGK instance: the same call on rows x cols shards (their 3 x 3
// parts hold the neighbours' lines; no column wraps).
extern "C" int lbm_halo2d_bgk(const long long* geoms, const double* params, int n_shards,
                              int steps, int i0, int i1, int is_f64, void* stream) {
  return lbm_halo_bgk(geoms, params, n_shards, steps, i0, i1, is_f64, stream);
}
