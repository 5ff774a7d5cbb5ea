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
// Launch, sized to the card: the validation run (ulbm_poiseuille, 128x128
// in float64, 300k steps) is 16,384 cells, 64 blocks of 256 threads, which
// left 68 of an H100's 132 SMs idle.  A block takes the most of 256, 128
// and 64 threads that still gives every SM two blocks (64 at 128x128: 256
// blocks), from the SM count of the device it launches on (lbm::sm_count);
// 4096x2048 keeps 256.  A grid that fits the card in one wave (every block
// resident at once) is a programmatic dependent launch (lbm::grid_wait
// before the first load of f_in, lbm::grid_release once a thread's loads
// are issued), so step n+1's launch and ramp overlap step n's tail; its
// threads still wait for the whole of step n and its stores.  A grid of
// many waves launches plainly: there the dependent launch cost 3.5% at
// 4096x2048 in float64 (H100, chip_smoke.py k4_k33_times).  The arithmetic
// is untouched: the same bits as 256-thread blocks.

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

// Threads a block: the most of 256, 128 and 64 that gives each of `sms` SMs
// at least two blocks of the `n` cells, else 64.
int block_threads(int64_t n, int sms) {
  for (int t = 256; t > 64; t /= 2)
    if ((n + t - 1) / t >= 2 * static_cast<int64_t>(sms)) return t;
  return 64;
}

// Whether `blocks` blocks of `threads` fit the current device in one wave:
// the kernel's resident blocks per SM (read once per device, type and block
// size) times `sms`.
template <typename T>
cudaError_t one_wave(int threads, int64_t blocks, int sms, bool& fits) {
  static int cached[lbm::MAX_DEVICES][256 / 64 + 1] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= lbm::MAX_DEVICES) return cudaErrorInvalidDevice;
  int& per_sm = cached[dev][threads / 64];
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, channel_kbc_kernel<T>, threads,
                                                      0);
    if (e != cudaSuccess) return e;
  }
  fits = blocks <= static_cast<int64_t>(per_sm) * sms;
  return cudaSuccess;
}

template <typename T>
int launch(const void* fin, void* fout, long long R, long long C, double s2,
           double rho_in, double rho_out, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(R) * C;
  if (n == 0) return 0;
  int sms = 0;
  cudaError_t e = lbm::sm_count(sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = block_threads(n, sms);
  const int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  bool pdl = false;
  e = one_wave<T>(threads, blocks, sms, pdl);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  // grid, block, dynamic shared memory, stream, attributes, their count
  const cudaLaunchConfig_t cfg = {dim3(static_cast<unsigned>(blocks)),
                                  dim3(static_cast<unsigned>(threads)), 0, stream, attr,
                                  pdl ? 1u : 0u};
  e = cudaLaunchKernelEx(&cfg, channel_kbc_kernel<T>, static_cast<const T*>(fin),
                         static_cast<T*>(fout), static_cast<int64_t>(R), static_cast<int64_t>(C),
                         lbm::kbc::make_params<T>(s2), static_cast<T>(rho_in),
                         static_cast<T>(rho_out));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
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
