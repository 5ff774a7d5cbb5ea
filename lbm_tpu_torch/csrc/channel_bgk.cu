// Kernel 2: one step of the pressure-driven channel, BGK family.
//
// Replaces the TPU kernel lbm_tpu/kernels/channel_pallas.py::
// make_channel_fused_step (family "bgk", body _make_body, on
// kernels/pipeline.py::make_block_pipeline).  Order of the reference
// (test/horizontal_poiseuille_test.cpp:128-152), as channel_pallas.py:5-9:
//   macroscopics -> incompressible equilibrium -> BGK
//   -> pressure-periodic rewrite of post-collision rows 0 / R-1 from rows
//      R-2 / 1 (virtual inlet / outlet) -> periodic stream
//   -> halfway bounce-back on columns 0 / C-1.
//
// Incompressible physics: the advected "velocity" is the momentum
// (ux, uy = mx, my), and feq_k = W_k (rho + 3 c_k.m) with no quadratic term.
//
// One thread per cell, neighbouring columns along a warp.  A thread on row 0
// (R-1) collides only row R-2 (1) of its own column from f_in, its source,
// whose collision the rewrite takes whole: so every thread makes one round
// of loads, and none depends on another's result.  One inlined `collide`
// serves both rows, so its multiply-adds contract alike on both.
//
// Walls: the bounce-back overwrites exactly the populations that a periodic
// push would wrap across the columns (planes 2, 5, 6 landing on column 0 and
// planes 4, 7, 8 landing on column C-1).  So this kernel never wraps
// columns: a push that would leave [0, C) is dropped, and the wall thread
// writes its reflected coll_k into plane opp(k) of its own cell instead.
// Every output entry has exactly one writer.  At the four corners the wall
// reflects the pressure-rewritten coll, as lbm_tpu does.
//
// Shapes: any R >= 4 and C >= 2 (no tiling limits).
//
// Launch: lbm::launch_cells (d2q9.cuh), as kernel 4: blocks sized to the
// card and a programmatic dependent launch where the grid fits the card in
// one wave (the validation runs' 128x128 is 256 blocks of 64 threads).
// lbm::grid_wait comes before the first load or store: the caching
// allocator may hand step n+1's output the buffer step n still reads.
//
// Bound: device-memory bytes, 72 B/cell per float32 step; at 128x128 the
// launch and the dependent loads, not the bytes.  Left on the table:
// shared-memory tiling, vector loads.

#include <cuda_runtime.h>

#include "d2q9.cuh"

namespace {

// Post-collision populations and the equilibrium of one cell, and its
// momentum; the cell's loads are issued before the dependent launch of the
// next step is released.
template <typename T>
__device__ __forceinline__ void collide(const T* __restrict__ fin, int64_t n,
                                        int64_t cell, T omega, T one_m_omega,
                                        T coll[9], T feq[9], T& ux, T& uy) {
  T f[9];
  lbm::load9(fin, n, cell, f);
  lbm::grid_release();
  T rho;
  lbm::moments(f, rho, ux, uy);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    feq[k] = (rho + T(3.0) * lbm::cu(k, ux, uy)) * T(lbm::weight(k));
    coll[k] = one_m_omega * f[k] + omega * feq[k];
  }
}

template <typename T>
__global__ void channel_bgk_kernel(const T* __restrict__ fin,
                                   T* __restrict__ fout, int64_t R, int64_t C,
                                   T omega, T one_m_omega, T rho_in, T rho_out) {
  const int64_t n = R * C;
  const int64_t cell = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  const int64_t r = cell / C;
  const int64_t c = cell - r * C;
  // virtual inlet (row 0) from the outlet row R-2; virtual outlet (row R-1)
  // from the inlet row 1: eq(u[src], rho_bc) + (coll - feq)[src]
  const bool virtual_row = r == 0 || r == R - 1;
  const int64_t src = virtual_row ? ((r == 0) ? R - 2 : 1) * C + c : cell;
  lbm::grid_wait();

  T coll[9], feq[9], ux, uy;
  collide(fin, n, src, omega, one_m_omega, coll, feq, ux, uy);
  if (virtual_row) {
    const T rho_bc = (r == 0) ? rho_in : rho_out;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const T e = (rho_bc + T(3.0) * lbm::cu(k, ux, uy)) * T(lbm::weight(k));
      coll[k] = e + coll[k] - feq[k];
    }
  }

#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int64_t cc = c + lbm::cy(k);
    if (cc < 0 || cc >= C) continue;  // replaced by the wall below
    const int64_t rr = lbm::wrap(r + lbm::cx(k), R);
    fout[k * n + rr * C + cc] = coll[k];
  }
  if (c == C - 1) {
    fout[lbm::opp(2) * n + cell] = coll[2];
    fout[lbm::opp(5) * n + cell] = coll[5];
    fout[lbm::opp(6) * n + cell] = coll[6];
  }
  if (c == 0) {
    fout[lbm::opp(4) * n + cell] = coll[4];
    fout[lbm::opp(7) * n + cell] = coll[7];
    fout[lbm::opp(8) * n + cell] = coll[8];
  }
}

template <typename T>
int launch(const void* fin, void* fout, long long R, long long C, double omega,
           double rho_in, double rho_out, cudaStream_t stream) {
  return static_cast<int>(lbm::launch_cells<channel_bgk_kernel<T>>(
      static_cast<int64_t>(R) * C, stream, static_cast<const T*>(fin), static_cast<T*>(fout),
      static_cast<int64_t>(R), static_cast<int64_t>(C), static_cast<T>(omega),
      static_cast<T>(1.0 - omega), static_cast<T>(rho_in), static_cast<T>(rho_out)));
}

}  // namespace

// One channel step f_in -> f_out (distinct buffers) on `stream`; returns the
// cudaError_t of the launch (0 = accepted).
extern "C" int lbm_channel_bgk(const void* fin, void* fout, long long R,
                               long long C, double omega, double rho_in,
                               double rho_out, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(fin, fout, R, C, omega, rho_in, rho_out, s)
                : launch<float>(fin, fout, R, C, omega, rho_in, rho_out, s);
}
