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
//
// The collision is a functor shared by this step and kernel 27's TRT
// instance, lbm_halo_trt, and kernel 34's, lbm_halo2d_trt: the same
// device code in the sharded call of csrc/collide_stream.cuh
// (block::launch_shards: a call's s steps on up to 8 row or rows x cols
// shards of a card in one launch), built with this source's flags, so an
// n-shard run equals this kernel run s times bit for bit.

#include <cuda_runtime.h>

#include "collide_stream.cuh"

namespace {

// The TRT collision of one cell (kernels/trt.py::trt_collide_fn).
template <typename T>
struct Trt {
  T w_plus, w_minus;

  __device__ __forceinline__ void operator()(const T f[9], T coll[9]) const {
    T rho, mx, my;
    lbm::moments(f, rho, mx, my);
    const T inv_rho = T(1.0) / rho;
    const T ux = mx * inv_rho;
    const T uy = my * inv_rho;

    const lbm::Pairs<T> p = lbm::d2q9_pairs(ux, uy);
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
  }
};

template <typename T>
Trt<T> trt(double omega_plus, double omega_minus) {
  return {static_cast<T>(omega_plus), static_cast<T>(omega_minus)};
}

}  // namespace

// One step f_in -> f_out (distinct buffers) on `stream`; returns the
// cudaError_t of the launch (0 = accepted).
extern "C" int lbm_collide_stream_trt(const void* fin, void* fout, long long R,
                                      long long C, double omega_plus,
                                      double omega_minus, int is_f64,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64
             ? lbm::launch_periodic<double>(fin, fout, R, C, trt<double>(omega_plus, omega_minus), s)
             : lbm::launch_periodic<float>(fin, fout, R, C, trt<float>(omega_plus, omega_minus), s);
}

// Kernel 27, TRT instance: a call of `steps` steps on each of `n_shards`
// row shards of the device, `geoms` their geometry arrays back to back
// (csrc/collide_stream.cuh block::Geom; the columns wrap); params =
// {omega_plus, omega_minus}.
extern "C" int lbm_halo_trt(const long long* geoms, const double* params, int n_shards,
                            int steps, int i0, int i1, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto op64 = trt<double>(params[0], params[1]);
  const auto op32 = trt<float>(params[0], params[1]);
  return is_f64 ? lbm::block::launch_shards<double>(geoms, n_shards, steps, op64, s)
                : lbm::block::launch_shards<float>(geoms, n_shards, steps, op32, s);
}

// Kernel 34, TRT instance: the same call on rows x cols shards (their 3 x 3
// parts hold the neighbours' lines; no column wraps).
extern "C" int lbm_halo2d_trt(const long long* geoms, const double* params, int n_shards,
                              int steps, int i0, int i1, int is_f64, void* stream) {
  return lbm_halo_trt(geoms, params, n_shards, steps, i0, i1, is_f64, stream);
}
