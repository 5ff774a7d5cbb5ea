// Kernel 22: one step of the ring cavity, the square annulus around a solid
// block [L/4, 3L/4)^2 in a closed L x L box, driven by a force (F, 0) on a
// strip of the left arm.
//
// Replaces the TPU kernel lbm_tpu/kernels/cavity_pallas.py:29
// make_cavity_fused_step.  Its plain version is
// kernels/cavity.py::plain_cavity_step, lbm_tpu's jnp step
// (scenes/cavity.py:125-143) written with the port's operators, transcribed
// in its order and built with -fmad=false (_build.UNIT_FLAGS), so each
// operation rounds once, as the plain version's elementwise ops do.  One
// step (decompose_domain_loop.cpp:38-261):
//   1. rho, u = m1 / rho; on the strip, rows [a+5, a+55) x cols [0, a) with
//      a = L/4, the velocity shift u_x += F (:117);
//   2. BGK at the compressible equilibrium of the shifted velocity;
//   3. on the strip only, the standard Guo source (ics2 = 3, ics4 = 9) of
//      the uniform force (F, 0) at the shifted velocity (:156-163);
//   4. the periodic push;
//   5. halfway bounce-back on row 0, row L-1, column 0, column L-1, then on
//      the block's four faces (scenes/cavity.py:35-52): the left face on
//      column a and the right on column b-1 over rows [a, b), the top on
//      row a and the bottom on row b-1 over columns [a, b), b = 3L/4.  The
//      block's inside keeps colliding and streaming, as in lbm_tpu.
//
// One thread per cell, neighbouring columns along a warp.  One writer per
// output entry: every wall rule, outer or block, writes
// new[opp(k)] = coll[k] of its own cell, so an entry that any rule writes
// gets the same value whichever rule comes last in lbm_tpu's order, and the
// cell's thread writes it from its own post-collision populations.  A push
// into such an entry is dropped (kernel 9's rule, csrc/channel_variant.cu).
//
// Shapes: any L >= 4 (the wrapper checks); L need not be a multiple of 4.
//
// Bound: device-memory bytes, 72 B/cell per float32 step (9 planes in, 9
// out).  Left on the table: the ownership test of each push (integer work
// in every thread) and the strip's branch.

#include <cuda_runtime.h>

#include "d2q9.cuh"

namespace {

template <typename T>
struct Params {
  T omega, one_m_omega;  // BGK rate and 1 - omega
  T pref;                // 1 - omega/2, the Guo prefactor
  T force;               // F, the strip's force along the rows
};

// The planes of (r, c) that a wall rule writes (lbm::PX etc.); the block's
// left and top faces are high-side walls of the fluid before them.
__device__ __forceinline__ unsigned owned(int64_t r, int64_t c, int64_t L, int64_t a,
                                          int64_t b) {
  using lbm::MX; using lbm::MY; using lbm::PX; using lbm::PY;
  unsigned m = 0;
  if (r == 0) m |= PX;
  if (r == L - 1) m |= MX;
  if (c == 0) m |= PY;
  if (c == L - 1) m |= MY;
  const bool brows = r >= a && r < b;
  const bool bcols = c >= a && c < b;
  if (brows && c == a) m |= MY;      // left face: 4, 7, 8
  if (brows && c == b - 1) m |= PY;  // right face: 2, 5, 6
  if (bcols && r == a) m |= MX;      // top face: 3, 7, 6
  if (bcols && r == b - 1) m |= PX;  // bottom face: 1, 5, 8
  return m;
}

template <typename T>
__global__ void cavity_kernel(const T* __restrict__ fin, T* __restrict__ fout, int64_t L,
                              Params<T> P) {
  const int64_t n = L * L;
  const int64_t cell = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  const int64_t r = cell / L;
  const int64_t c = cell - r * L;
  const int64_t a = L / 4;
  const int64_t b = 3 * L / 4;
  const bool strip = r >= a + 5 && r < a + 55 && c < a;

  // 1-2. the shifted velocity and BGK
  T f[9];
  lbm::load9(fin, n, cell, f);
  T rho, mx, my;
  lbm::moments(f, rho, mx, my);
  T ux = mx / rho;
  const T uy = my / rho;
  if (strip) ux = ux + P.force;
  T feq[9], coll[9];
  lbm::equilibrium(rho, ux, uy, feq);
#pragma unroll
  for (int k = 0; k < 9; ++k) coll[k] = P.one_m_omega * f[k] + P.omega * feq[k];

  // 3. the Guo source of (F, 0) on the strip (ops/d2q9.py guo_source)
  if (strip) {
    const T uf = P.force * ux + T(0) * uy;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const T s = (T(3.0) + T(9.0) * lbm::cu(k, ux, uy)) * lbm::cu(k, P.force, T(0)) -
                  T(3.0) * uf;
      coll[k] = coll[k] + P.pref * s * T(lbm::weight(k));
    }
  }

  // 4. the periodic push, less the entries a wall rule writes
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int64_t rd = lbm::wrap(r + lbm::cx(k), L);
    const int64_t cd = lbm::wrap(c + lbm::cy(k), L);
    if (!(owned(rd, cd, L, a, b) & (1u << k))) fout[k * n + rd * L + cd] = coll[k];
  }

  // 5. the wall rules of this cell's own entries
  const unsigned m = owned(r, c, L, a, b);
#pragma unroll
  for (int k = 1; k < 9; ++k)
    if (m & (1u << k)) fout[k * n + cell] = coll[lbm::opp(k)];
}

template <typename T>
int launch(const void* fin, void* fout, long long L, const double* d, cudaStream_t stream) {
  Params<T> P;
  P.omega = T(d[0]); P.one_m_omega = T(d[1]); P.pref = T(d[2]); P.force = T(d[3]);
  const int64_t n = static_cast<int64_t>(L) * L;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  cavity_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(fin), static_cast<T*>(fout), L, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One ring-cavity step f_in -> f_out (9, L, L; distinct buffers) on
// `stream`; R and C must both be L >= 4.  `consts` holds 4 scalars already
// rounded to the state's type, in the order of
// kernels/cavity.py::cavity_constants: omega, 1 - omega, 1 - omega/2, F.
// Returns the cudaError_t of the launch (0 = accepted).
extern "C" int lbm_cavity(const void* fin, void* fout, long long R, long long C,
                          const double* consts, int is_f64, void* stream) {
  if (R != C || R < 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(fin, fout, R, consts, s)
                : launch<float>(fin, fout, R, consts, s);
}
