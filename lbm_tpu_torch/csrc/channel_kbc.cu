// Kernel 4: one step of the pressure-driven channel, KBC family (the
// ulbm_poiseuille step).
//
// Replaces the TPU kernel lbm_tpu/kernels/channel_pallas.py:128
// make_channel_fused_step, family "kbc" (body lines 71-84).  The plain
// version is kernels/channel.py::kbc_channel_step, the jnp step of
// lbm_tpu/scenes/ulbm.py:117-130 (reference test/ulbm_poiseuille.cpp:
// 119-130):
//   m0, u = m1/m0 -> KBC collide (csrc/kbc.cuh, factored gamma)
//   -> pressure-periodic rewrite of post-collision rows 0 / R-1 from rows
//      R-2 / 1 -> periodic stream -> halfway bounce-back on columns C-1, 0.
//
// The pressure rewrite differs from kernel 2's BGK family in two places:
// the line velocity is the true velocity m1/m0 (not the momentum), and the
// feq subtracted from coll is the KBC product-form equilibrium.  The
// virtual-line equilibrium is still the incompressible
// W_k (rho_bc + 3 c_k.u) (bc.pressure_periodic with incomp_equilibrium).
//
// Kernel 2's structure otherwise: one thread per cell, neighbouring columns
// along a warp.  A thread on row 0 (R-1) collides row R-2 (1) of its own
// column from f_in instead of its own cell, whose collision the rewrite
// replaces whole.  Walls never wrap columns: a push that would leave
// [0, C) is dropped and the wall thread writes its reflected coll_k into
// plane opp(k) of its own cell, so every output entry has one writer.  The
// corners reflect the pressure-rewritten coll, as lbm_tpu does.
//
// Shapes: any R >= 4 and C >= 2.
//
// Bound: as kernel 3, load latency under a long collision (the same
// collision and the same 72 B/cell in float32).  The pressure-row branch
// inlines a second collision, so the kernel takes 72 registers (768
// threads per SM) where kernel 3's factored variant takes 64.  Measured on
// an H100 80GB HBM3 (700 W) at 4096x2048: 0.30 ms/step in float32, 0.68 of
// a device-to-device copy's bandwidth; 0.47 ms in float64.  Left on the
// table: the pressure rows in a launch of their own (fewer registers here),
// more loads in flight per thread.
//
// Launch, sized to the card (lbm::launch_cells in d2q9.cuh, shared with
// kernels 2 and 9): the validation run (ulbm_poiseuille, 128x128 in float64, 300k steps) is 16,384
// cells, which 256-thread blocks spread over 64 of an H100's 132 SMs.
// Blocks of 64 threads give every SM two, and the grid, one wave, is a
// programmatic dependent launch (lbm::grid_wait before the first load of
// f_in, lbm::grid_release once a thread's loads are issued), so step n+1's
// launch and ramp overlap step n's tail; its threads still wait for the
// whole of step n and its stores.  The arithmetic is untouched: the same
// bits as 256-thread blocks.

#include <cuda_runtime.h>

#include "d2q9.cuh"
#include "kbc.cuh"

namespace {

template <typename T>
__global__ void channel_kbc_kernel(const T* __restrict__ fin,
                                   T* __restrict__ fout, int64_t R, int64_t C,
                                   lbm::kbc::Params<T> p, T rho_in, T rho_out) {
  const int64_t n = R * C;
  const int64_t cell = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  const int64_t r = cell / C;
  const int64_t c = cell - r * C;
  lbm::grid_wait();

  T coll[9];
  if (r == 0 || r == R - 1) {
    // virtual inlet (row 0) from the outlet row R-2; virtual outlet (row
    // R-1) from the inlet row 1: incomp_eq(u[src], rho_bc) + coll[src] - feq[src]
    const int64_t src = ((r == 0) ? R - 2 : 1) * C + c;
    const T rho_bc = (r == 0) ? rho_in : rho_out;
    T f[9], coll_s[9], feq_s[9], m0, ux, uy;
    lbm::load9(fin, n, src, f);
    lbm::grid_release();
    lbm::kbc::macroscopics(f, m0, ux, uy);
    lbm::kbc::collide<T, true>(f, m0, ux, uy, p, coll_s);
    lbm::kbc::equilibrium(m0, ux, uy, feq_s);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const T e = (rho_bc + T(3.0) * lbm::cu(k, ux, uy)) * T(lbm::weight(k));
      coll[k] = e + coll_s[k] - feq_s[k];
    }
  } else {
    T f[9], m0, ux, uy;
    lbm::load9(fin, n, cell, f);
    lbm::grid_release();
    lbm::kbc::macroscopics(f, m0, ux, uy);
    lbm::kbc::collide<T, true>(f, m0, ux, uy, p, coll);
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
int launch(const void* fin, void* fout, long long R, long long C, double s2,
           double rho_in, double rho_out, cudaStream_t stream) {
  return static_cast<int>(lbm::launch_cells<channel_kbc_kernel<T>>(
      static_cast<int64_t>(R) * C, stream, static_cast<const T*>(fin), static_cast<T*>(fout),
      static_cast<int64_t>(R), static_cast<int64_t>(C), lbm::kbc::make_params<T>(s2),
      static_cast<T>(rho_in), static_cast<T>(rho_out)));
}

}  // namespace

// One KBC channel step f_in -> f_out (distinct buffers) on `stream`;
// returns the cudaError_t of the launch (0 = accepted).
extern "C" int lbm_channel_kbc(const void* fin, void* fout, long long R,
                               long long C, double s2, double rho_in,
                               double rho_out, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(fin, fout, R, C, s2, rho_in, rho_out, s)
                : launch<float>(fin, fout, R, C, s2, rho_in, rho_out, s);
}
