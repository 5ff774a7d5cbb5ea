// The periodic D2Q9 collide-stream step around a local collision, in its
// three forms: the single-device step of kernels 1, 3, 5, 10 and 11, the
// row-sharded halo-input step of kernel 27 (kernels/sharded.py) and the
// rows x cols one of kernel 34 (kernels/sharded2d.py).  Each family's
// source defines its collision once, as a functor `op(f, coll)` on one
// cell's 9 populations, and instantiates every form with it, so the
// sharded steps compute with the same device code and the same compiler
// flags as the single-device one, and an n-shard run equals it bit for bit.
//
// Step: stream(collide(f)), as lbm_tpu's step is (collide_stream.py:116-117):
// a thread loads its cell's 9 populations, collides, and PUSHES coll_k to
// (r + cx_k, c + cy_k) of a separate output buffer.  (A pull kernel that
// gathers and then collides would compute collide(stream(f)), a different
// state.)  Threads along a warp take neighbouring columns, so every plane
// load and store is coalesced.  Several steps per call are several
// launches.
//
// Kernel 27 (halo_step) replaces lbm_tpu/kernels/sharded_pallas.py:171
// make_local_halo_step (sharded_pallas.py:528 make_sharded_fused_step on
// the halo-body kernel :202).  One thread per cell of the padded rows
// [in_lo, in_hi) (csrc/halo.cuh): it reads its cell from the shard or a
// halo, and pushes into the rows [out_lo, out_hi) only; columns wrap.
//
// Kernel 34 (halo2d_step) replaces lbm_tpu/kernels/sharded2d_pallas.py:223
// make_local_2d_step (its pallas_call at :240; :290
// make_sharded_fused_step_2d): the same step on a shard of an (nx, ny) mesh
// with row and column halo inputs (csrc/halo2d.cuh).  One thread per cell
// of the padded band [in_r_lo, in_r_hi) x [in_c_lo, in_c_hi); it pushes
// into the output band only, and nothing wraps (the strips hold the
// neighbours' columns).
//
// Bound: device-memory bytes, 72 B/cell in float32 (9 planes in, 9 out)
// over the cells each sweep computes, plus the halo rows read; kernel 27's
// sweeps beyond the first of an exchange add 2 (s - j) rows per shard,
// kernel 34's as many rows and columns.
#pragma once

#include <cuda_runtime.h>

#include "d2q9.cuh"
#include "halo.cuh"
#include "halo2d.cuh"

namespace lbm {

template <typename T, typename Op>
__global__ void periodic_step(const T* __restrict__ fin, T* __restrict__ fout, int64_t R,
                              int64_t C, Op op) {
  const int64_t n = R * C;
  const int64_t cell = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  const int64_t r = cell / C;
  const int64_t c = cell - r * C;

  T f[9];
  load9(fin, n, cell, f);
  T coll[9];
  op(f, coll);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int64_t rr = wrap(r + cx(k), R);
    const int64_t cc = wrap(c + cy(k), C);
    fout[k * n + rr * C + cc] = coll[k];
  }
}

template <typename T, typename Op>
__global__ void halo_step(halo::View<T> in, halo::Out<T> out, int64_t in_lo,
                          int64_t n_cells, Op op) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_cells) return;
  const int64_t C = in.C;
  const int64_t row = i / C;
  const int64_t p = in_lo + row;
  const int64_t c = i - row * C;

  int64_t plane;
  const T* src = in.locate(p, c, plane);
  T f[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = src[k * plane];
  T coll[9];
  op(f, coll);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int64_t pd = p + cx(k);
    if (out.has(pd)) out.at(pd, wrap(c + cy(k), C))[k * out.plane] = coll[k];
  }
}

template <typename T, typename Op>
__global__ void halo2d_step(halo2d::View<T> in, halo2d::Out<T> out, int64_t r_lo,
                            int64_t c_lo, int64_t width, int64_t n_cells, Op op) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_cells) return;
  const int64_t row = i / width;
  const int64_t p = r_lo + row;
  const int64_t q = c_lo + (i - row * width);

  int64_t plane;
  const T* src = in.locate(p, q, plane);
  T f[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = src[k * plane];
  T coll[9];
  op(f, coll);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int64_t pd = p + cx(k), qd = q + cy(k);
    if (out.has(pd, qd)) out.at(pd, qd)[k * out.plane] = coll[k];
  }
}

// One periodic step f_in -> f_out (distinct buffers); returns the
// cudaError_t of the launch (0 = accepted).
template <typename T, typename Op>
int launch_periodic(const void* fin, void* fout, long long R, long long C, const Op& op,
                    cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(R) * C;
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  periodic_step<T, Op><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(fin), static_cast<T*>(fout), R, C, op);
  return static_cast<int>(cudaGetLastError());
}

// One sweep of kernel 27 with the geometry `g` (csrc/halo.cuh).
template <typename T, typename Op>
int launch_halo(const long long* g, const Op& op, cudaStream_t stream) {
  const halo::Launch<T> L = halo::parse<T>(g);
  const int64_t n = (L.in_hi - L.in_lo) * L.in.C;
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  halo_step<T, Op><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(L.in, L.out,
                                                                          L.in_lo, n, op);
  return static_cast<int>(cudaGetLastError());
}

// One sweep of kernel 34 with the geometry `g` (csrc/halo2d.cuh).
template <typename T, typename Op>
int launch_halo2d(const long long* g, const Op& op, cudaStream_t stream) {
  const halo2d::Launch<T> L = halo2d::parse<T>(g);
  const int64_t width = L.c_hi - L.c_lo;
  const int64_t n = (L.r_hi - L.r_lo) * width;
  if (n <= 0 || width <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  halo2d_step<T, Op><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      L.in, L.out, L.r_lo, L.c_lo, width, n, op);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lbm
