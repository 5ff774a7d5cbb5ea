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
//
// The collision is a functor shared by this step and kernel 27's KBC
// instance, lbm_halo_kbc, and kernel 34's, lbm_halo2d_kbc: the same
// device code in the sharded call of csrc/collide_stream.cuh
// (block::launch_shards: a call's s steps on up to 8 row or rows x cols
// shards of a card in one launch), built with this source's flags, so an
// n-shard run equals this kernel run s times bit for bit.

#include <cuda_runtime.h>

#include "collide_stream.cuh"
#include "kbc.cuh"

namespace {

// The KBC collision of one cell: m0, u = m1 / m0, csrc/kbc.cuh's collide.
template <typename T, bool kFactored>
struct Kbc {
  // the sharded call's tile engine (csrc/collide_stream.cuh Box): a long
  // collision, and 118-128 registers in float64 (512 threads a block there)
  static constexpr bool HEAVY = true;
  static constexpr bool WIDE = true;
  lbm::kbc::Params<T> p;

  __device__ __forceinline__ void operator()(const T f[9], T coll[9]) const {
    T m0, ux, uy;
    lbm::kbc::macroscopics(f, m0, ux, uy);
    lbm::kbc::collide<T, kFactored>(f, m0, ux, uy, p, coll);
  }
};

template <typename T>
int periodic(const void* fin, void* fout, long long R, long long C, double s2, int factored,
             cudaStream_t s) {
  const lbm::kbc::Params<T> p = lbm::kbc::make_params<T>(s2);
  return factored ? lbm::launch_periodic<T>(fin, fout, R, C, Kbc<T, true>{p}, s)
                  : lbm::launch_periodic<T>(fin, fout, R, C, Kbc<T, false>{p}, s);
}

// A call of kernels 27 and 34 (csrc/collide_stream.cuh block::launch_shards).
template <typename T>
int shards(const long long* geoms, int n, int steps, double s2, int factored, cudaStream_t s) {
  const lbm::kbc::Params<T> p = lbm::kbc::make_params<T>(s2);
  return factored ? lbm::block::launch_shards<T>(geoms, n, steps, Kbc<T, true>{p}, s)
                  : lbm::block::launch_shards<T>(geoms, n, steps, Kbc<T, false>{p}, s);
}

}  // namespace

// One step f_in -> f_out (distinct buffers) on `stream`, with the factored
// (factored != 0) or the direct gamma; returns the cudaError_t of the
// launch (0 = accepted).
extern "C" int lbm_collide_stream_kbc(const void* fin, void* fout, long long R,
                                      long long C, double s2, int factored,
                                      int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? periodic<double>(fin, fout, R, C, s2, factored, s)
                : periodic<float>(fin, fout, R, C, s2, factored, s);
}

// Kernel 27, KBC instance: a call of `steps` steps on each of `n_shards` row
// shards of the device, `geoms` their geometry arrays back to back
// (csrc/collide_stream.cuh block::Geom; the columns wrap); params = {s2},
// factored = the gamma implementation.
extern "C" int lbm_halo_kbc(const long long* geoms, const double* params, int n_shards,
                            int steps, int factored, int, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? shards<double>(geoms, n_shards, steps, params[0], factored, s)
                : shards<float>(geoms, n_shards, steps, params[0], factored, s);
}

// Kernel 34, KBC instance: the same call on rows x cols shards (their 3 x 3
// parts hold the neighbours' lines; no column wraps).
extern "C" int lbm_halo2d_kbc(const long long* geoms, const double* params, int n_shards,
                              int steps, int factored, int i1, int is_f64, void* stream) {
  return lbm_halo_kbc(geoms, params, n_shards, steps, factored, i1, is_f64, stream);
}
