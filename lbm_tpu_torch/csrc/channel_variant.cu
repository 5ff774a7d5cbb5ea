// Kernel 9: one step of the single-phase channel variants (gravity,
// specular, free-stream, vertical-Poiseuille and TRT channels).
//
// Replaces the TPU kernel lbm_tpu/kernels/channel_pallas.py:158
// make_channel_variant_step.  Its plain version is the SinglePhaseModel
// composition of kernels/channel.py::channel_variant_model (the jnp scene
// path of lbm_tpu/scenes/channel.py), transcribed in its order and built
// with -fmad=false (_build.UNIT_FLAGS), so each operation rounds once, as the
// plain version's elementwise ops do.  One step:
//   1. macroscopics: u = m1 (incompressible) or m1 / rho;
//   2. the uniform force shift u += F;
//   3. the incompressible or compressible equilibrium at (rho, u);
//   4. BGK, or TRT per opposite pair (models/trt.py);
//   5. the reference's weak (1/3, 1/9) Guo source (gravity_test.cpp:154);
//   6. the pressure-periodic rewrite of the virtual lines 0 and N-1 along
//      rows (axis 0) or columns (axis 1) from lines N-2 and 1;
//   7. the periodic push;
//   8. the row walls (bounce-back or anti-bounce-back at a constant wall
//      velocity), then the column walls (bounce-back or specular).
// The collision-changing choices (incompressible, TRT, force) are template
// parameters; the boundary choices and constants are plain arguments, the
// constants rounded to T on the host as the plain version rounds them.
//
// One thread per cell, neighbouring columns along a warp.  A thread on a
// virtual line recomputes the whole collision of its source cell (line N-2
// or 1 in its column or row, force and Guo included) from f_in, so no
// thread depends on another's result.
//
// One writer per output entry.  A wall rule overwrites entries of its wall
// line: bounce-back rows the planes with cx = -1 on row R-1 and cx = +1 on
// row 0; anti-bounce-back rows all eight moving planes on rows 0 and R-1;
// column walls the planes with cy = -1 on column C-1 and cy = +1 on column
// 0.  A push into an overwritten entry is dropped, and the thread that owns
// the wall cell writes the rule's value instead, built from its own coll:
// the row rule first and the column rule over it, so at a corner with
// anti-bounce-back rows and specular columns planes 4, 8, 7 (at column C-1)
// come from the specular rule, as in lbm_tpu.  With `spec_skip_rows` the
// column rule skips rows 0 and R-1 (free_stream's corner-consistent mode,
// the specular lane 1:-1), which the anti-bounce-back rows then own.
//
// Shapes: any R >= 4 and C >= 4 (no tiling limits).
//
// Bound: device-memory bytes, 72 B/cell per float32 step, as kernel 2.  Left
// on the table: the redundant collision on the two pressure lines (their
// warps diverge, and on columns every warp of the grid's edge does), and
// the branches on the boundary arguments in every thread.

#include <cuda_runtime.h>

#include "d2q9.cuh"

namespace {

enum Walls { NONE = 0, BOUNCE = 1, ABB = 2, SPECULAR = 2 };

template <typename T>
struct Params {
  T omega, one_m_omega, omega_minus;  // BGK rate; TRT even and odd rates
  T fx, fy, pref, ics2, ics4;         // force and the weak Guo coefficients
  T cf[9];                            // c_k . F
  T rho_in, rho_out;                  // virtual inlet / outlet densities
  T abb[9];                           // anti-bounce-back coefficients
  int pressure_axis;                  // -1 none, 0 rows, 1 columns
  int row_walls;                      // NONE, BOUNCE or ABB
  int col_walls;                      // NONE, BOUNCE or SPECULAR
  int spec_skip_rows;                 // column rule skips rows 0 and R-1
};

// ops/d2q9.py incomp_equilibrium / equilibrium at (rho, ux, uy), in order.
template <typename T, bool INCOMP>
__device__ __forceinline__ void equilibrium(T rho, T ux, T uy, T feq[9]) {
  const T uu = ux * ux + uy * uy;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const T cu = lbm::cu(k, ux, uy);
    if (INCOMP) {
      feq[k] = (rho + T(3.0) * cu) * T(lbm::weight(k));
    } else {
      T t = T(1.0) + T(3.0) * cu;
      t = t + T(4.5) * cu * cu;
      t = t - T(1.5) * uu;
      feq[k] = rho * t * T(lbm::weight(k));
    }
  }
}

// Steps 1-5 for one cell: its post-collision populations, its equilibrium
// and its (shifted) velocity.
template <typename T, bool INCOMP, bool TRT, bool FORCE>
__device__ __forceinline__ void collide(const T* __restrict__ fin, int64_t n,
                                        int64_t cell, const Params<T>& P,
                                        T coll[9], T feq[9], T& ux, T& uy) {
  T f[9];
  lbm::load9(fin, n, cell, f);
  T rho, mx, my;
  lbm::moments(f, rho, mx, my);
  if (INCOMP) {
    ux = mx;
    uy = my;
  } else {
    ux = mx / rho;
    uy = my / rho;
  }
  if (FORCE) {
    ux = ux + P.fx;
    uy = uy + P.fy;
  }
  equilibrium<T, INCOMP>(rho, ux, uy, feq);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (TRT) {
      const int o = lbm::opp(k);
      const T ne_even = T(0.5) * ((f[k] + f[o]) - (feq[k] + feq[o]));
      const T ne_odd = T(0.5) * ((f[k] - f[o]) - (feq[k] - feq[o]));
      coll[k] = f[k] - P.omega * ne_even - P.omega_minus * ne_odd;
    } else {
      coll[k] = P.one_m_omega * f[k] + P.omega * feq[k];
    }
  }
  if (FORCE) {
    const T uf = P.fx * ux + P.fy * uy;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const T s = (P.ics2 + P.ics4 * lbm::cu(k, ux, uy)) * P.cf[k] - P.ics2 * uf;
      coll[k] = coll[k] + P.pref * s * T(lbm::weight(k));
    }
  }
}

// Whether a wall rule overwrites entry (k, r, c).
template <typename T>
__device__ __forceinline__ bool owned(int k, int64_t r, int64_t c, int64_t R,
                                      int64_t C, const Params<T>& P) {
  if (P.row_walls == BOUNCE &&
      ((r == R - 1 && lbm::cx(k) == -1) || (r == 0 && lbm::cx(k) == 1)))
    return true;
  if (P.row_walls == ABB && (r == 0 || r == R - 1) && k != 0) return true;
  if (P.col_walls != NONE && !(P.spec_skip_rows && (r == 0 || r == R - 1)) &&
      ((c == C - 1 && lbm::cy(k) == -1) || (c == 0 && lbm::cy(k) == 1)))
    return true;
  return false;
}

template <typename T, bool INCOMP, bool TRT, bool FORCE>
__global__ void channel_variant_kernel(const T* __restrict__ fin,
                                       T* __restrict__ fout, int64_t R, int64_t C,
                                       Params<T> P) {
  const int64_t n = R * C;
  const int64_t cell = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  const int64_t r = cell / C;
  const int64_t c = cell - r * C;

  T coll[9], feq[9], ux, uy;
  collide<T, INCOMP, TRT, FORCE>(fin, n, cell, P, coll, feq, ux, uy);

  // 6. virtual inlet (line 0) from line N-2, virtual outlet (line N-1) from
  // line 1: eq(u[src], rho_bc) + coll[src] - feq[src]
  const int64_t line = P.pressure_axis == 0 ? r : c;
  const int64_t N = P.pressure_axis == 0 ? R : C;
  if (P.pressure_axis >= 0 && (line == 0 || line == N - 1)) {
    const int64_t src_line = line == 0 ? N - 2 : 1;
    const int64_t src = P.pressure_axis == 0 ? src_line * C + c : r * C + src_line;
    const T rho_bc = line == 0 ? P.rho_in : P.rho_out;
    T coll_s[9], feq_s[9], e[9], ux_s, uy_s;
    collide<T, INCOMP, TRT, FORCE>(fin, n, src, P, coll_s, feq_s, ux_s, uy_s);
    equilibrium<T, INCOMP>(rho_bc, ux_s, uy_s, e);
#pragma unroll
    for (int k = 0; k < 9; ++k) coll[k] = e[k] + coll_s[k] - feq_s[k];
  }

  // 7. the periodic push, less the entries a wall rule owns
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int64_t rr = lbm::wrap(r + lbm::cx(k), R);
    const int64_t cc = lbm::wrap(c + lbm::cy(k), C);
    if (!owned(k, rr, cc, R, C, P)) fout[k * n + rr * C + cc] = coll[k];
  }

  // 8. the wall rules of this cell's own entries: rows, then columns
  T own[9];
  unsigned mask = 0;
  if (P.row_walls == BOUNCE) {
    if (r == R - 1) {  // outgoing 1, 5, 8
      own[3] = coll[1]; own[7] = coll[5]; own[6] = coll[8];
      mask |= (1u << 3) | (1u << 7) | (1u << 6);
    }
    if (r == 0) {  // outgoing 3, 6, 7
      own[1] = coll[3]; own[8] = coll[6]; own[5] = coll[7];
      mask |= (1u << 1) | (1u << 8) | (1u << 5);
    }
  } else if (P.row_walls == ABB && (r == 0 || r == R - 1)) {
#pragma unroll
    for (int k = 1; k < 9; ++k) own[lbm::opp(k)] = -coll[k] + P.abb[k];
    mask |= 0x1FEu;
  }
  if (P.col_walls != NONE && !(P.spec_skip_rows && (r == 0 || r == R - 1))) {
    // outgoing 2, 5, 6 at column C-1 and 4, 7, 8 at column 0, into plane
    // opp(k) (bounce-back) or spec_y(k) (specular)
    if (c == C - 1) {
      own[4] = coll[2];
      if (P.col_walls == SPECULAR) {
        own[8] = coll[5]; own[7] = coll[6];
      } else {
        own[7] = coll[5]; own[8] = coll[6];
      }
      mask |= (1u << 4) | (1u << 7) | (1u << 8);
    }
    if (c == 0) {
      own[2] = coll[4];
      if (P.col_walls == SPECULAR) {
        own[6] = coll[7]; own[5] = coll[8];
      } else {
        own[5] = coll[7]; own[6] = coll[8];
      }
      mask |= (1u << 2) | (1u << 5) | (1u << 6);
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k)
    if (mask & (1u << k)) fout[k * n + cell] = own[k];
}

template <typename T, bool INCOMP, bool TRT, bool FORCE>
int launch(const void* fin, void* fout, long long R, long long C, const Params<T>& P,
           cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(R) * C;
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  channel_variant_kernel<T, INCOMP, TRT, FORCE>
      <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
          static_cast<const T*>(fin), static_cast<T*>(fout), R, C, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* fin, void* fout, long long R, long long C, const double* d,
             int incompressible, int trt, int force, int pressure_axis, int row_walls,
             int col_walls, int spec_skip_rows, cudaStream_t s) {
  Params<T> P;
  P.omega = T(d[0]); P.one_m_omega = T(d[1]); P.omega_minus = T(d[2]);
  P.fx = T(d[3]); P.fy = T(d[4]); P.pref = T(d[5]); P.ics2 = T(d[6]); P.ics4 = T(d[7]);
  for (int k = 0; k < 9; ++k) P.cf[k] = T(d[8 + k]);
  P.rho_in = T(d[17]); P.rho_out = T(d[18]);
  for (int k = 0; k < 9; ++k) P.abb[k] = T(d[19 + k]);
  P.pressure_axis = pressure_axis;
  P.row_walls = row_walls;
  P.col_walls = col_walls;
  P.spec_skip_rows = spec_skip_rows;
  if (trt && force) return static_cast<int>(cudaErrorInvalidValue);
  if (incompressible) {
    if (trt) return launch<T, true, true, false>(fin, fout, R, C, P, s);
    return force ? launch<T, true, false, true>(fin, fout, R, C, P, s)
                 : launch<T, true, false, false>(fin, fout, R, C, P, s);
  }
  if (trt) return launch<T, false, true, false>(fin, fout, R, C, P, s);
  return force ? launch<T, false, false, true>(fin, fout, R, C, P, s)
               : launch<T, false, false, false>(fin, fout, R, C, P, s);
}

}  // namespace

// One channel-variant step f_in -> f_out (distinct buffers) on `stream`.
// `consts` holds 28 scalars already rounded to the state's type, in the order
// of kernels/channel.py::variant_constants: omega, 1 - omega, omega_minus,
// fx, fy, 1 - omega/2, 1/3, 1/9, c_k.F (9), rho_in, rho_out, the ABB
// coefficients (9).  Returns the cudaError_t of the launch (0 = accepted).
extern "C" int lbm_channel_variant(const void* fin, void* fout, long long R,
                                   long long C, const double* consts,
                                   int incompressible, int trt, int force,
                                   int pressure_axis, int row_walls, int col_walls,
                                   int spec_skip_rows, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? dispatch<double>(fin, fout, R, C, consts, incompressible, trt, force,
                                   pressure_axis, row_walls, col_walls, spec_skip_rows, s)
                : dispatch<float>(fin, fout, R, C, consts, incompressible, trt, force,
                                  pressure_axis, row_walls, col_walls, spec_skip_rows, s);
}
