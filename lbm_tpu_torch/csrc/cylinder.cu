// Kernel 15: one step of the IBM cylinder's grid work, with the forcing's
// output as the Guo source; and kernel 18, the same engine with the closed
// box's walls, the grid step of the moving-body scenes.
//
// Replaces the TPU kernel lbm_tpu/kernels/cylinder_pallas.py:129
// make_cylinder_fused_step (helpers _collide_guo_stream :50, _make_body
// :101, _abb_coeffs :38).  Its plain version is
// kernels/cylinder.py::plain_cylinder_step, lbm_tpu's jnp step body
// (scenes/obstacles.py:224-243) with a precomputed force, transcribed in its
// order and built with -fmad=false (_build.UNIT_FLAGS), so each operation
// rounds once, as the plain version's elementwise ops do.  One step:
//   1. rho, u = m1 / rho, the compressible equilibrium, BGK;
//   2. inside the ROI, the Guo source of F (kernel 16's output, read at the
//      ROI's origin) with the coefficients (ics2, ics4): the weak (1/3, 1/9)
//      of the reference's cylinder program by default, or the standard
//      (3, 9).  Outside the ROI nothing is added, which is what adding
//      the source of F = 0 would give, bit for bit;
//   3. the periodic push;
//   4. anti-bounce-back on rows 0 and R-1 at the constant wall velocity
//      (u_stream, 0) (cylinder_test.cpp:132-154);
//   5. specular on column C-1, then on column 0 (cylinder_test.cpp:156-163).
//
// One thread per cell, neighbouring columns along a warp.  One writer per
// output entry: the anti-bounce-back rows own all eight moving planes of
// rows 0 and R-1, the specular columns own planes 4, 8, 7 of column C-1
// and 2, 6, 5 of column 0.  A push into an owned entry is dropped (kernel
// 9's rule, csrc/channel_variant.cu), and the thread of the wall cell
// writes the rule's value from its own post-collision populations: the row
// rule first and the column rule over it, so each corner's planes come
// from the last rule in lbm_tpu's order (row 0, row R-1, column C-1,
// column 0; scenes/obstacles.py:239-242).
//
// Shapes: any R >= 4 and C >= 4 with the ROI inside the grid.
//
// Bound: device-memory bytes, 72 B/cell per float32 step (9 planes in, 9
// out) plus the ROI's 8 B/cell of F.  Left on the table: the branch on
// the ROI in every thread.
//
// Kernel 18 (BOX = true) replaces the TPU kernel
// lbm_tpu/kernels/cylinder_pallas.py:153 make_box_fused_step.  Its plain
// version is kernels/cylinder.py::plain_box_step, the grid half of lbm_tpu's
// jnp falling-body steps (scenes/obstacles.py:1040-1066): steps 1-3 as above
// with the standard Guo pair (3, 9), then halfway bounce-back on row 0, row
// R-1, column 0 and column C-1 (in that order, :1064-1065).  The force
// window follows the body, so its origin is not known on the host: the
// moving-forcing kernels 19-21 write it as two int32 on the device, and
// every thread here reads it there, so a step needs no host
// synchronisation.  Any origin is safe: a cell reads F only when it lies
// in the window.  One writer per entry as above: row 0 owns the planes
// with c_x = +1, row R-1 those with c_x = -1, column 0 those with c_y = +1
// and column C-1 those with c_y = -1; where a row and a column rule meet
// (the corners), both write the same post-collision value, so lbm_tpu's
// order is kept trivially.  Bound and design as kernel 15's.

#include <cuda_runtime.h>

#include "d2q9.cuh"

namespace {

template <typename T>
struct Params {
  T omega, one_m_omega;  // BGK rate and 1 - omega
  T pref, ics2, ics4;    // 1 - omega/2 and the Guo coefficients
  T abb[9];              // anti-bounce-back coefficients at (u_stream, 0)
};

template <typename T, bool BOX>
__global__ void cylinder_kernel(const T* __restrict__ fin, const T* __restrict__ F,
                                T* __restrict__ fout, int64_t R, int64_t C, int64_t r0,
                                int64_t c0, int64_t rw, int64_t cw,
                                const int* __restrict__ origin, Params<T> P) {
  if constexpr (BOX) {
    r0 = origin[0];
    c0 = origin[1];
  }
  const int64_t n = R * C;
  const int64_t cell = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  const int64_t r = cell / C;
  const int64_t c = cell - r * C;

  // 1. BGK at the compressible equilibrium
  T f[9];
  lbm::load9(fin, n, cell, f);
  T rho, mx, my;
  lbm::moments(f, rho, mx, my);
  const T ux = mx / rho;
  const T uy = my / rho;
  T feq[9], coll[9];
  lbm::equilibrium(rho, ux, uy, feq);
#pragma unroll
  for (int k = 0; k < 9; ++k) coll[k] = P.one_m_omega * f[k] + P.omega * feq[k];

  // 2. the Guo source of the ROI's force (ops/d2q9.py guo_source)
  const int64_t rr = r - r0;
  const int64_t cc = c - c0;
  if (rr >= 0 && rr < rw && cc >= 0 && cc < cw) {
    const T Fx = F[rr * cw + cc];
    const T Fy = F[rw * cw + rr * cw + cc];
    const T uf = ux * Fx + uy * Fy;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const T s = (P.ics2 + P.ics4 * lbm::cu(k, ux, uy)) * lbm::cu(k, Fx, Fy) - P.ics2 * uf;
      coll[k] = coll[k] + P.pref * s * T(lbm::weight(k));
    }
  }

  // 3. the periodic push, less the entries a wall rule owns
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int64_t rd = lbm::wrap(r + lbm::cx(k), R);
    const int64_t cd = lbm::wrap(c + lbm::cy(k), C);
    bool owned;
    if constexpr (BOX)
      owned = (rd == 0 && lbm::cx(k) == 1) || (rd == R - 1 && lbm::cx(k) == -1) ||
              (cd == 0 && lbm::cy(k) == 1) || (cd == C - 1 && lbm::cy(k) == -1);
    else
      owned = (k != 0 && (rd == 0 || rd == R - 1)) || (cd == C - 1 && lbm::cy(k) == -1) ||
              (cd == 0 && lbm::cy(k) == 1);
    if (!owned) fout[k * n + rd * C + cd] = coll[k];
  }

  // 4-5. the wall rules of this cell's own entries: rows, then columns
  T own[9];
  unsigned mask = 0;
  if constexpr (BOX) {
    // halfway bounce-back: an outgoing population returns reversed
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      const bool out = (r == 0 && lbm::cx(k) == -1) || (r == R - 1 && lbm::cx(k) == 1) ||
                       (c == 0 && lbm::cy(k) == -1) || (c == C - 1 && lbm::cy(k) == 1);
      if (out) {
        own[lbm::opp(k)] = coll[k];
        mask |= 1u << lbm::opp(k);
      }
    }
  } else if (r == 0 || r == R - 1) {
#pragma unroll
    for (int k = 1; k < 9; ++k) own[lbm::opp(k)] = -coll[k] + P.abb[k];
    mask |= 0x1FEu;
  }
  if (!BOX && c == C - 1) {  // outgoing 2, 5, 6 into spec_y: 4, 8, 7
    own[4] = coll[2]; own[8] = coll[5]; own[7] = coll[6];
    mask |= (1u << 4) | (1u << 8) | (1u << 7);
  }
  if (!BOX && c == 0) {  // outgoing 4, 7, 8 into spec_y: 2, 6, 5
    own[2] = coll[4]; own[6] = coll[7]; own[5] = coll[8];
    mask |= (1u << 2) | (1u << 6) | (1u << 5);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k)
    if (mask & (1u << k)) fout[k * n + cell] = own[k];
}

template <typename T>
int launch(const void* fin, const void* F, void* fout, long long R, long long C,
           long long r0, long long c0, long long rw, long long cw, const double* d,
           cudaStream_t stream) {
  if (R < 4 || C < 4 || r0 < 0 || c0 < 0 || rw < 0 || cw < 0 || r0 + rw > R ||
      c0 + cw > C)
    return static_cast<int>(cudaErrorInvalidValue);
  Params<T> P;
  P.omega = T(d[0]); P.one_m_omega = T(d[1]);
  P.pref = T(d[2]); P.ics2 = T(d[3]); P.ics4 = T(d[4]);
  for (int k = 0; k < 9; ++k) P.abb[k] = T(d[5 + k]);
  const int64_t n = static_cast<int64_t>(R) * C;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  cylinder_kernel<T, false><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(fin), static_cast<const T*>(F), static_cast<T*>(fout), R, C,
      r0, c0, rw, cw, nullptr, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_box(const void* fin, const void* F, const int* origin, void* fout, long long R,
               long long C, long long rw, long long cw, const double* d,
               cudaStream_t stream) {
  if (R < 4 || C < 4 || rw < 0 || cw < 0 || rw > R || cw > C)
    return static_cast<int>(cudaErrorInvalidValue);
  Params<T> P;
  P.omega = T(d[0]); P.one_m_omega = T(d[1]);
  P.pref = T(d[2]); P.ics2 = T(d[3]); P.ics4 = T(d[4]);
  for (int k = 0; k < 9; ++k) P.abb[k] = T(0);
  const int64_t n = static_cast<int64_t>(R) * C;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  cylinder_kernel<T, true><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(fin), static_cast<const T*>(F), static_cast<T*>(fout), R, C,
      0, 0, rw, cw, origin, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One cylinder step f_in -> f_out (distinct buffers) on `stream`, with the
// force F (2, rw, cw) over the ROI whose first cell is (r0, c0).  `consts`
// holds 14 scalars already rounded to the state's type, in the order of
// kernels/cylinder.py::cylinder_constants: omega, 1 - omega, 1 - omega/2,
// ics2, ics4, the ABB coefficients (9).  Returns the cudaError_t of the
// launch (0 = accepted).
extern "C" int lbm_cylinder(const void* fin, const void* F, void* fout, long long R,
                            long long C, long long r0, long long c0, long long rw,
                            long long cw, const double* consts, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(fin, F, fout, R, C, r0, c0, rw, cw, consts, s)
                : launch<float>(fin, F, fout, R, C, r0, c0, rw, cw, consts, s);
}

// One box step (kernel 18) f_in -> f_out (distinct buffers) on `stream`,
// with the force F (2, rw, cw) over the window whose first cell is the
// device's origin[0], origin[1] (int32).  `consts` holds 5 scalars already
// rounded to the state's type, in the order of
// kernels/cylinder.py::box_constants: omega, 1 - omega, 1 - omega/2, ics2,
// ics4.  Returns the cudaError_t of the launch (0 = accepted).
extern "C" int lbm_box_step(const void* fin, const void* F, const void* origin, void* fout,
                            long long R, long long C, long long rw, long long cw,
                            const double* consts, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(origin);
  return is_f64 ? launch_box<double>(fin, F, o, fout, R, C, rw, cw, consts, s)
                : launch_box<float>(fin, F, o, fout, R, C, rw, cw, consts, s);
}
