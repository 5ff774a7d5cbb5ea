// The MRT colour-gradient two-phase step of one tile, shared by kernels 6-8;
// kernel 12 (csrc/rk_cg.cu) reuses its tile, window, stencil and pull
// (Window, corr5, clamp_index, pull_source).
//
// Replaces the body of the TPU kernels in lbm_tpu/kernels/mrtcg_pallas.py:
// make_mrtcg_body :644 around _make_collide :289, _mrt_omega1 :221,
// _corr5_multi :103 and _stream_with_bcs / _stream_sum_with_bcs :552-635.
// The arithmetic is that of the plain version kernels/mrtcg.py::make_collide,
// operation for operation in the same order; the sources build with
// -fmad=false (kernels/_build.py UNIT_FLAGS), so no multiply-add is
// contracted and the kernels reproduce the plain PyTorch versions, whose
// elementwise ops each round once: bit for bit on the H100, both modes,
// float32 and float64 (chip_smoke.py phase 3).
//
// One launch is one step.  A block owns a TY x TX tile of output cells and
// works in three stages, each ended by __syncthreads():
//   1. the derived scalars psi, q_c ux and q_c uy (in CSF mode also the
//      normal n, from the 5x5 gradient of psi) on the tile plus a halo of
//      H = 3 cells (H = 5 in CSF mode: the curvature chains two 5x5
//      stencils), into shared memory;
//   2. the collision of every cell of the tile plus a 1-cell ring, its 18
//      post-collision values into shared memory (the CSF force of tile
//      cells goes straight to the output: it is carried, not streamed);
//   3. each tile cell PULLS its streamed populations with exactly the
//      select chain of _stream_with_bcs (pull_source): periodic, then the column repair
//      without the diagonal offset on rows 1..R-2, then bounce-back on row
//      R-1 and on row 0.  The red density of the reduced state is the sum
//      of the pulled red values in ascending k, with no atomics.
// Replicate padding is an index clamp: a stencil tap reads
// (clamp(r, 0, R-1), clamp(c, 0, C-1)).  Columns are periodic for the
// stream, so the ring of an edge block wraps to the far column; that
// column's stencil taps sit in a small "seam" window of H columns at the
// far edge, filled by the edge blocks only.
//
// The columns a launch works on are a policy (PeriodicCols, BandCols,
// LaneCols): the grid's C columns, wrapped as above, for the single-device
// and row-sharded kernels; or the padded columns of a rows x cols shard
// (csrc/halo2d.cuh, kernels 37 and 38), or the window of a lane block
// (kernel 39), where a value is read at its padded or window column (the
// strips or the window's margins hold the neighbours', so nothing wraps
// and no seam is needed) while the rules, the stencils' replicate clamp
// and the column repair of the stream, use that column's wrapped global
// column.
//
// State layouts (planes of R*C, row-major): reduced in/out = 9 summed
// populations, red density (+ fstx, fsty); full = 9 red, 9 blue (+ fst).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "d2q9.cuh"
#include "halo.cuh"
#include "halo2d.cuh"

namespace lbm {
namespace mrtcg {

using lbm::THREADS;
using lbm::TX;
using lbm::TY;
constexpr int RING_R = TY + 2;
constexpr int RING_C = TX + 2;
constexpr int RING_N = RING_R * RING_C;

// Scalars of the step, in the order kernels/mrtcg.py::kernel_params writes
// them (Python doubles, rounded once to T on the host).
enum P {
  INV_R0, INV_B0, DELTA, R_VAL, B_VAL, S1, S2, S3, T2, T3,
  R_PHI0, R_PHI1, R_PHI5, B_PHI0, B_PHI1, B_PHI5,
  R_ETA1, R_ETA5, B_ETA1, B_ETA5, GX, GY, HALF_GX, HALF_GY,
  R_ALPHA_C, B_ALPHA_C, BETA_R, BETA_B, BETA_S, A_SIGMA, M_HALF_SIGMA,
  S_A_PREF, SOURCE, CF0, CF1, CF2, CF3, CF3_0, CF3_1, CF3_2, CF3_3, NPARAM
};

template <typename T>
struct Params {
  T v[NPARAM];
};

// MRT moment matrix and its inverse (core/lattice.py M_MRT, MI_MRT).
__host__ __device__ constexpr double m_mrt(int i, int j) {
  constexpr double t[9][9] = {
      {1, 1, 1, 1, 1, 1, 1, 1, 1},      {-4, -1, -1, -1, -1, 2, 2, 2, 2},
      {4, -2, -2, -2, -2, 1, 1, 1, 1},  {0, 1, 0, -1, 0, 1, -1, -1, 1},
      {0, -2, 0, 2, 0, 1, -1, -1, 1},   {0, 0, 1, 0, -1, 1, 1, -1, -1},
      {0, 0, -2, 0, 2, 1, 1, -1, -1},   {0, 1, -1, 1, -1, 0, 0, 0, 0},
      {0, 0, 0, 0, 0, 1, -1, 1, -1}};
  return t[i][j];
}

__host__ __device__ constexpr double mi_mrt(int i, int j) {
  constexpr double t[9][9] = {
      {4, -4, 4, 0, 0, 0, 0, 0, 0},     {4, -1, -2, 6, -6, 0, 0, 9, 0},
      {4, -1, -2, 0, 0, 6, -6, -9, 0},  {4, -1, -2, -6, 6, 0, 0, 9, 0},
      {4, -1, -2, 0, 0, -6, 6, -9, 0},  {4, 2, 1, 6, 3, 6, 3, 0, 9},
      {4, 2, 1, -6, -3, 6, 3, 0, -9},   {4, 2, 1, -6, -3, -6, -3, 0, 9},
      {4, 2, 1, 6, 3, -6, -3, 0, -9}};
  return (1.0 / 36.0) * t[i][j];
}

// Base relaxation rates of moments 1, 2, 4, 6 (7, 8 relax at s_nu).
__host__ __device__ constexpr double s_base(int row) {
  return row == 1 ? 1.25 : row == 2 ? 1.14 : (row == 4 || row == 6) ? 1.6 : 0.0;
}

// Colour-gradient perturbation constants B (core/lattice.py B_CG).
__host__ __device__ constexpr double b_cg(int k) {
  return k == 0 ? -4.0 / 27.0 : (k <= 4 ? 2.0 / 27.0 : 5.0 / 108.0);
}

// 5x5 isotropic derivative weights (ops/gradients.py KERNEL_X5 / KERNEL_Y5):
// (1/5040) xi[a][b] times the row (DIR 0) or column (DIR 1) offset.
__host__ __device__ constexpr double xi5(int a, int b) {
  constexpr double t[5][5] = {{1, 32, 84, 32, 1},
                              {32, 448, 960, 448, 32},
                              {84, 960, 0, 960, 84},
                              {32, 448, 960, 448, 32},
                              {1, 32, 84, 32, 1}};
  return (1.0 / 5040.0) * t[a][b];
}

template <int DIR>
__host__ __device__ constexpr double k5(int a, int b) {
  return xi5(a, b) * (DIR == 0 ? a - 2.0 : b - 2.0);
}

constexpr double UNIT_DIAG = 0.7071067811865475;  // core/lattice.py UNIT_C[0, 5]

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// The columns of a launch, as the tile engine addresses them.  A column c
// is where a value lives (memory and the window); ``global(c)`` is the grid
// column whose rules apply there.  ``first()`` and ``end()``, the columns a
// launch writes, are read on the host too (the launch's grid).
//
// PeriodicCols: every column of the grid, c = the global column; the ring
// wraps and the edge blocks fill the window's seam.
struct PeriodicCols {
  static constexpr bool SEAM = true;
  int64_t C;  // the grid's columns

  __host__ __device__ __forceinline__ int64_t first() const { return 0; }
  __host__ __device__ __forceinline__ int64_t end() const { return C; }
  __device__ __forceinline__ bool readable(int64_t c) const { return c >= 0 && c < C; }
  __device__ __forceinline__ int64_t ring(int64_t c) const { return wrap(c, C); }
  __device__ __forceinline__ int64_t global(int64_t c) const { return c; }
  // the column that a stencil tap d columns off c reads (replicate padding)
  __device__ __forceinline__ int64_t tap(int64_t c, int d) const {
    return clamp_index(c + d, C);
  }
};

// BandCols: the padded columns of a rows x cols shard (csrc/halo2d.cuh),
// c = the padded column q; the launch writes [o_lo, o_hi) and reads
// [rd_lo, rd_hi).  Column q is global column off + q wrapped into [0, C)
// (off = the shard's column offset less the halo, so it may be negative).
// A tap d columns off q reads the padded column that holds clamp(g + d, 0,
// C-1) for g = global(q): at the grid's columns 0 and C-1 it stays on q's
// side of the seam, as the single-device step's replicate padding does.
struct BandCols {
  static constexpr bool SEAM = false;
  int64_t C, off, rd_lo, rd_hi, o_lo, o_hi;

  __host__ __device__ __forceinline__ int64_t first() const { return o_lo; }
  __host__ __device__ __forceinline__ int64_t end() const { return o_hi; }
  __device__ __forceinline__ bool readable(int64_t c) const { return c >= rd_lo && c < rd_hi; }
  __device__ __forceinline__ int64_t ring(int64_t c) const { return c; }
  __device__ __forceinline__ int64_t global(int64_t c) const { return wrap(off + c, C); }
  __device__ __forceinline__ int64_t tap(int64_t c, int d) const {
    const int64_t g = global(c);
    return c + (clamp_index(g + d, C) - g);
  }
};

// LaneCols: the window of lane block j = blockIdx.z of one grid (kernel 39),
// c = the window column q, which holds global column j lb - margin + q
// wrapped into [0, C).  A launch reads the window [0, lb + 2 margin) and
// writes its columns [rps, lb + 2 margin - rps), rps the columns a sweep
// consumes (the engine's H); the taps and the column repair as BandCols',
// at the wrapped global column.  The wrap is three selects, no division
// (every stencil tap computes it): `off` = -margin mod C, set on the host,
// puts j lb + off in [0, 2C), and a window at most 2C wide (the host's
// guard) puts the column in [0, 3C).
struct LaneCols {
  static constexpr bool SEAM = false;
  int64_t C, lb, margin, rps, off;

  __host__ __device__ __forceinline__ int64_t first() const { return rps; }
  __host__ __device__ __forceinline__ int64_t end() const { return lb + 2 * margin - rps; }
  __device__ __forceinline__ bool readable(int64_t c) const {
    return c >= 0 && c < lb + 2 * margin;
  }
  __device__ __forceinline__ int64_t ring(int64_t c) const { return c; }
  __device__ __forceinline__ int64_t global(int64_t c) const {
    int64_t g = off + static_cast<int64_t>(blockIdx.z) * lb;
    g = g >= C ? g - C : g;
    g += c;
    g = g >= C ? g - C : g;
    return g >= C ? g - C : g;
  }
  __device__ __forceinline__ int64_t tap(int64_t c, int d) const {
    const int64_t g = global(c);
    return c + (clamp_index(g + d, C) - g);
  }
};

// Where a block's scalar windows live: rows [r0 - H, r0 + TY + H), main
// columns [c0 - H, c0 + TX + H), plus the seam columns [seam_lo, seam_lo + H).
template <int H>
struct Window {
  static constexpr int ROWS = TY + 2 * H;
  static constexpr int MAIN = TX + 2 * H;
  static constexpr int COLS = MAIN + H;
  static constexpr int N = ROWS * COLS;
  int64_t r0, c0, seam_lo;

  __device__ __forceinline__ int slot(int64_t gr, int64_t gc) const {
    const int64_t rel = gc - (c0 - H);
    const int64_t col = (rel >= 0 && rel < MAIN) ? rel : MAIN + (gc - seam_lo);
    return static_cast<int>((gr - (r0 - H)) * COLS + col);
  }
};

// 5x5 cross-correlation of a window field at global row gr and column gc
// (a column of `cols`), replicate padded, taps in row-major order with zero
// weights skipped (the order of ops/gradients.py::correlate2d_replicate).
// The mask-free instance (EDGE false: a shard whose rows stay clear of the
// grid's walls) clamps no row.
template <int DIR, typename T, int H, bool EDGE = true, typename Cols>
__device__ __forceinline__ T corr5(const T* field, const Window<H>& w, int64_t gr,
                                   int64_t gc, int64_t R, const Cols cols) {
  T acc = T(0);
  bool have = false;
#pragma unroll
  for (int a = 0; a < 5; ++a) {
    const int64_t rr = EDGE ? clamp_index(gr + a - 2, R) : gr + a - 2;
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      const double wt = k5<DIR>(a, b);
      if (wt == 0.0) continue;
      const T term = T(wt) * field[w.slot(rr, cols.tap(gc, b - 2))];
      acc = have ? acc + term : term;
      have = true;
    }
  }
  return acc;
}

// The macroscopic fields of one cell (lbm_tpu mrtcg_pallas.py:698-718).
template <typename T>
struct Cell {
  T fsum[9];
  T rho, r_rho, b_rho, fstx, fsty;
};

template <typename T, bool CSF, bool RIN>
__device__ __forceinline__ void load_cell(const T* __restrict__ in, int64_t n,
                                          int64_t cell, Cell<T>& m) {
  if (RIN) {
#pragma unroll
    for (int k = 0; k < 9; ++k) m.fsum[k] = in[k * n + cell];
    m.rho = m.fsum[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) m.rho = m.rho + m.fsum[k];
    m.r_rho = in[9 * n + cell];
    m.b_rho = m.rho - m.r_rho;
    if (CSF) {
      m.fstx = in[10 * n + cell];
      m.fsty = in[11 * n + cell];
    }
  } else {
    T rf[9], bf[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      rf[k] = in[k * n + cell];
      bf[k] = in[(9 + k) * n + cell];
    }
    m.r_rho = rf[0];
    m.b_rho = bf[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      m.r_rho = m.r_rho + rf[k];
      m.b_rho = m.b_rho + bf[k];
    }
    m.rho = m.r_rho + m.b_rho;
#pragma unroll
    for (int k = 0; k < 9; ++k) m.fsum[k] = rf[k] + bf[k];
    if (CSF) {
      m.fstx = in[18 * n + cell];
      m.fsty = in[19 * n + cell];
    }
  }
}

// The velocity the step derives: (momentum + 0.5 (Fg [+ fst_prev])) / rho.
template <typename T>
struct Velocity {
  T inv_rho, ux, uy;
  T fs_p[4], fd_p[4];
};

template <typename T, bool CSF>
__device__ __forceinline__ Velocity<T> velocity(const Cell<T>& m, const Params<T>& p) {
  Velocity<T> v;
  v.inv_rho = T(1.0) / m.rho;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v.fs_p[i] = m.fsum[pair_kp(i)] + m.fsum[pair_km(i)];
    v.fd_p[i] = m.fsum[pair_kp(i)] - m.fsum[pair_km(i)];
  }
  const T mom_x = v.fd_p[0] + v.fd_p[2] + v.fd_p[3];
  const T mom_y = v.fd_p[1] + v.fd_p[2] - v.fd_p[3];
  if (CSF) {
    v.ux = (mom_x + T(0.5) * (p.v[GX] + m.fstx)) * v.inv_rho;
    v.uy = (mom_y + T(0.5) * (p.v[GY] + m.fsty)) * v.inv_rho;
  } else {
    v.ux = (mom_x + p.v[HALF_GX]) * v.inv_rho;
    v.uy = (mom_y + p.v[HALF_GY]) * v.inv_rho;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T phase(const Cell<T>& m, const Params<T>& p) {
  const T a = m.r_rho * p.v[INV_R0];
  const T b = m.b_rho * p.v[INV_B0];
  return (a - b) / (a + b);
}

// s_nu(psi): three selects in models/mrt_cg.py's order, as comparisons (no
// fmin/fmax), so a NaN stays a NaN.
template <typename T>
__device__ __forceinline__ T relax(T psi, const Params<T>& p) {
  const T pos = p.v[S1] + p.v[S2] * psi + p.v[S3] * psi * psi;
  const T neg = p.v[S1] + p.v[T2] * psi + p.v[T3] * psi * psi;
  T out = psi > p.v[DELTA] ? p.v[R_VAL] : pos;
  out = psi <= T(0.0) ? neg : out;
  return psi < -p.v[DELTA] ? p.v[B_VAL] : out;
}

// The normal n = -grad(psi) / (1e-20 + |grad(psi)|) at one cell.
template <typename T, int H, bool EDGE, typename Cols>
__device__ __forceinline__ void normal(const T* s_psi, const Window<H>& w, int64_t gr,
                                       int64_t gc, int64_t R, const Cols cols, T& nx, T& ny) {
  const T gpx = corr5<0, T, H, EDGE>(s_psi, w, gr, gc, R, cols);
  const T gpy = corr5<1, T, H, EDGE>(s_psi, w, gr, gc, R, cols);
  const T gn = sqrt(gpx * gpx + gpy * gpy);
  const T inv_gn = T(1.0) / (T(1e-20) + gn);
  nx = -(gpx * inv_gn);
  ny = -(gpy * inv_gn);
}

template <typename T>
__device__ __forceinline__ T mrow(int row, T f0, const T parts[4], bool with_k0) {
  T acc = T(0);
  bool have = false;
  if (with_k0) {
    const double w0 = m_mrt(row, 0);
    if (w0 == 1.0) {
      acc = f0;
      have = true;
    } else if (w0 != 0.0) {
      acc = T(w0) * f0;
      have = true;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double wt = m_mrt(row, pair_kp(i));
    if (wt == 0.0) continue;
    const T term = wt == 1.0 ? parts[i] : T(wt) * parts[i];
    acc = have ? acc + term : term;
    have = true;
  }
  return acc;
}

// One term of a row of Mi applied to the relaxed moments v.
template <typename T>
__device__ __forceinline__ void mi_acc(int k, int j, const T v[9], T& acc, bool& have) {
  const double wt = mi_mrt(k, j);
  if (wt == 0.0) return;
  const T term = wt == 1.0 ? v[j] : T(wt) * v[j];
  acc = have ? acc + term : term;
  have = true;
}

// Row k of Mi over the even moments 1, 2, 7, 8 / the odd moments 4, 6.
template <typename T>
__device__ __forceinline__ T midot_even(int k, const T v[9]) {
  T acc = T(0);
  bool have = false;
  mi_acc(k, 1, v, acc, have);
  mi_acc(k, 2, v, acc, have);
  mi_acc(k, 7, v, acc, have);
  mi_acc(k, 8, v, acc, have);
  return acc;
}

template <typename T>
__device__ __forceinline__ T midot_odd(int k, const T v[9]) {
  T acc = T(0);
  bool have = false;
  mi_acc(k, 4, v, acc, have);
  mi_acc(k, 6, v, acc, have);
  return acc;
}

// The collision of one cell (kernels/mrtcg.py::make_collide).  ``out``
// gets the 9 values of channel A then the 9 of channel B: red and blue
// (ROUT false) or the colour sum and red (ROUT true).
template <typename T, bool CSF, bool ROUT, int H, bool EDGE, typename Cols>
__device__ __forceinline__ void collide_cell(const Cell<T>& m, const Params<T>& p,
                                             const T* s_psi, const T* s_qx, const T* s_qy,
                                             const T* s_nx, const T* s_ny,
                                             const Window<H>& w, int64_t gr, int64_t gc,
                                             int64_t R, const Cols cols, T out[18],
                                             T& fstx, T& fsty) {
  const Velocity<T> v = velocity<T, CSF>(m, p);
  const T ux = v.ux, uy = v.uy, inv_rho = v.inv_rho, rho = m.rho;
  const T r_rho = m.r_rho, b_rho = m.b_rho;
  const T x2 = ux * ux, y2 = uy * uy;
  const T uu = x2 + y2;
  const T cu_p[4] = {ux, uy, ux + uy, ux - uy};

  const T psi = phase(m, p);
  const T s_nu = relax(psi, p);
  const T gpx = corr5<0, T, H, EDGE>(s_psi, w, gr, gc, R, cols);
  const T gpy = corr5<1, T, H, EDGE>(s_psi, w, gr, gc, R, cols);
  const T gn = sqrt(gpx * gpx + gpy * gpy);
  const T inv_gn = T(1.0) / (T(1e-20) + gn);

  const T ab0 = p.v[R_PHI0] * r_rho + p.v[B_PHI0] * b_rho;
  const T ab1 = p.v[R_PHI1] * r_rho + p.v[B_PHI1] * b_rho;
  const T ab5 = p.v[R_PHI5] * r_rho + p.v[B_PHI5] * b_rho;
  const T ee1 = p.v[R_ETA1] * r_rho + p.v[B_ETA1] * b_rho;
  const T ee5 = p.v[R_ETA5] * r_rho + p.v[B_ETA5] * b_rho;
  const T uu_rho6 = T(6.0) * (uu * rho);
  const T rho2 = rho + rho;
  const T gq = T(1.0 / 3.0) * ee5 - T(4.0 / 3.0) * ee1;
  T meq[9];
  meq[1] = T(8.0) * ab5 - T(4.0) * (ab0 + ab1) + uu_rho6;
  meq[2] = T(4.0) * (ab0 + ab5) - T(8.0) * ab1 - uu_rho6;
  meq[4] = ux * gq;
  meq[6] = uy * gq;
  meq[7] = rho2 * (x2 - y2);
  meq[8] = rho2 * (ux * uy);
  const T dxqx = corr5<0, T, H, EDGE>(s_qx, w, gr, gc, R, cols);
  const T dyqy = corr5<1, T, H, EDGE>(s_qy, w, gr, gc, R, cols);
  const T c1 = T(3.0 * (1.0 - 0.5 * 1.25)) * (dxqx + dyqy);
  const T c7 = (T(1.0) - T(0.5) * s_nu) * (dxqx - dyqy);

  // omega1 in moment space, pair-factored (mrt_omega1_pairs)
  T mv[9];
  mv[1] = (meq[1] - mrow(1, m.fsum[0], v.fs_p, true)) * T(s_base(1));
  mv[2] = (meq[2] - mrow(2, m.fsum[0], v.fs_p, true)) * T(s_base(2));
  mv[7] = (meq[7] - mrow(7, m.fsum[0], v.fs_p, true)) * s_nu;
  mv[8] = (meq[8] - mrow(8, m.fsum[0], v.fs_p, true)) * s_nu;
  mv[4] = (meq[4] - mrow(4, m.fsum[0], v.fd_p, false)) * T(s_base(4));
  mv[6] = (meq[6] - mrow(6, m.fsum[0], v.fd_p, false)) * T(s_base(6));
  mv[1] = mv[1] + c1;
  mv[7] = mv[7] + c7;
  T o1[9];
  o1[0] = midot_even(0, mv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T even = midot_even(pair_kp(i), mv);
    const T odd = midot_odd(pair_kp(i), mv);
    o1[pair_kp(i)] = even + odd;
    o1[pair_km(i)] = even - odd;
  }

  const T gc_p[4] = {gpx, gpy, gpx + gpy, gpx - gpy};
  T o2[9];
  if (!CSF) {
    const T A_gn = (p.v[A_SIGMA] * s_nu) * gn;
    o2[0] = A_gn * T(-b_cg(0));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const T unit = gc_p[i] * inv_gn;
      const T val = A_gn * (T(weight(pair_kp(i))) * unit * unit - T(b_cg(pair_kp(i))));
      o2[pair_kp(i)] = val;
      o2[pair_km(i)] = val;
    }
    fstx = fsty = T(0);
  } else {
    const T nx = -(gpx * inv_gn);
    const T ny = -(gpy * inv_gn);
    const T dxnx = corr5<0, T, H, EDGE>(s_nx, w, gr, gc, R, cols);
    const T dynx = corr5<1, T, H, EDGE>(s_nx, w, gr, gc, R, cols);
    const T dxny = corr5<0, T, H, EDGE>(s_ny, w, gr, gc, R, cols);
    const T dyny = corr5<1, T, H, EDGE>(s_ny, w, gr, gc, R, cols);
    const T K = nx * ny * (dynx + dxny) - nx * nx * dyny - ny * ny * dxnx;
    fstx = p.v[M_HALF_SIGMA] * (K * gpx);
    fsty = p.v[M_HALF_SIGMA] * (K * gpy);
    const T uFs3 = T(3.0) * (ux * fstx + uy * fsty);
    const T Fc_p[4] = {fstx, fsty, fstx + fsty, fstx - fsty};
    o2[0] = p.v[S_A_PREF] * (T(weight(0)) * (-uFs3));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const T wk = T(weight(pair_kp(i)));
      const T even = wk * (T(9.0) * cu_p[i] * Fc_p[i] - uFs3);
      const T odd = wk * (T(3.0) * Fc_p[i]);
      o2[pair_kp(i)] = p.v[S_A_PREF] * (even + odd);
      o2[pair_km(i)] = p.v[S_A_PREF] * (even - odd);
    }
  }

  // recolouring (+ the Guo source): kap(opp(k)) = -kap(k)
  const T rb_gn = (r_rho * b_rho) * (inv_rho * inv_rho) * inv_gn;
  const T r_frac = r_rho * inv_rho;
  const T b_frac = b_rho * inv_rho;
  const bool source = p.v[SOURCE] != T(0);
  const T pref = T(1.0) - T(0.5) * s_nu;
  const T uF3 = T(3.0) * (ux * p.v[GX] + uy * p.v[GY]);
  const T ab_cls[2] = {ab1, ab5};

  auto o3 = [&](int k, T total, bool has_kap, T kap, bool has_src, T src) {
    if (ROUT) {
      T cs = has_kap ? total + p.v[BETA_S] * kap : total;
      T cr = has_kap ? r_frac * total + p.v[BETA_R] * kap : r_frac * total;
      if (has_src) {
        cs = cs + T(2.0) * src;
        cr = cr + src;
      }
      out[k] = cs;
      out[9 + k] = cr;
    } else {
      T o3r = has_kap ? r_frac * total + p.v[BETA_R] * kap : r_frac * total;
      T o3b = has_kap ? b_frac * total + p.v[BETA_B] * kap : b_frac * total;
      if (has_src) {
        o3r = o3r + src;
        o3b = o3b + src;
      }
      out[k] = o3r;
      out[9 + k] = o3b;
    }
  };

  const T total0 = m.fsum[0] + o1[0] + o2[0];
  o3(0, total0, false, T(0), source, pref * (-uF3) * T(weight(0)));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = pair_kp(i), km = pair_km(i);
    const double unit_scale = (CSF || i < 2) ? 1.0 : UNIT_DIAG;
    const T kap = (rb_gn * (T(unit_scale) * gc_p[i])) * ab_cls[i < 2 ? 0 : 1];
    T src_p = T(0), src_m = T(0);
    if (source) {
      const T pw = pref * T(weight(kp));
      const T even_s = pw * (T(9.0) * cu_p[i] * p.v[CF0 + i] - uF3);
      const T odd_s = pw * p.v[CF3_0 + i];
      src_p = even_s + odd_s;
      src_m = even_s - odd_s;
    }
    o3(kp, m.fsum[kp] + o1[kp] + o2[kp], true, kap, source, src_p);
    o3(km, m.fsum[km] + o1[km] + o2[km], true, -kap, source, src_m);
  }
}

// Where tile cell (ty, tx), at global row gr and global column gc, pulls
// its population k from in the ring of post-collision values: the ring slot
// and the plane, by the select chain of _stream_with_bcs (periodic, then the
// column repair without the diagonal offset on rows 1..R-2 at the grid's
// columns 0 and C-1, then bounce-back on row R-1 and, written last, on row
// 0).  Each output entry has exactly one writer, its own thread.  The
// mask-free instance (EDGE false) has no wall row.
struct PullSource {
  int slot, plane;
};

template <bool EDGE = true>
__device__ __forceinline__ PullSource pull_source(int k, int ty, int tx, int64_t gr,
                                                  int64_t gc, int64_t R, int64_t C) {
  const bool interior = !EDGE || (gr >= 1 && gr <= R - 2);
  int sr = ty + 1 - cx(k), sc = tx + 1 - cy(k), sk = k;  // periodic stream
  if (interior && ((gc == 0 && cy(k) > 0) || (gc == C - 1 && cy(k) < 0)))
    sr = ty + 1;  // periodic column repair without the diagonal offset
  if (!EDGE) return {sr * RING_C + sc, sk};
  if (gr == R - 1 && cx(k) < 0) {  // bounce-back on row R-1
    sr = ty + 1;
    sc = tx + 1;
    sk = opp(k);
  }
  if (gr == 0 && cx(k) > 0) {  // bounce-back on row 0, written last
    sr = ty + 1;
    sc = tx + 1;
    sk = opp(k);
  }
  return {sr * RING_C + sc, sk};
}

// Where a step reads and writes, by global row: one (planes, R, C) buffer
// in and one out (the single-device kernels; lbm::halo::ShardIO is a row
// shard with halo inputs, kernels 29-31; lbm::halo2d::Shard2DIO a rows x
// cols shard, kernels 37-38).
template <typename T>
struct FlatIO {
  const T* in;
  T* out;
  int64_t n, C;

  __device__ __forceinline__ const T* src(int64_t gr, int64_t gc, int64_t& plane) const {
    plane = n;
    return in + gr * C + gc;
  }
  __device__ __forceinline__ T* dst(int64_t gr, int64_t gc, int64_t& plane) const {
    plane = n;
    return out + gr * C + gc;
  }
};

// Kernel 39's memory: rows by global index, columns by window column q of
// lane block j = blockIdx.z (LaneCols).  It reads the state itself at q's
// wrapped global column (the first sweep: no gather copy) or the previous
// sweep's windows, (lanes, planes, R, w_in); it writes the next sweep's
// windows, (lanes, planes, R, w_out), whose column 0 is q = rps, or on the
// last sweep (margin rps, w_out = lb) the state's columns [j lb, (j + 1) lb).
template <typename T>
struct LaneIO {
  const T* in;
  T* out;
  int64_t R, planes, w_in, w_out;
  LaneCols cols;
  bool in_state, out_state;

  __device__ __forceinline__ const T* src(int64_t gr, int64_t q, int64_t& plane) const {
    if (in_state) {
      plane = R * cols.C;
      return in + gr * cols.C + cols.global(q);
    }
    plane = R * w_in;
    return in + static_cast<int64_t>(blockIdx.z) * planes * plane + gr * w_in + q;
  }
  __device__ __forceinline__ T* dst(int64_t gr, int64_t q, int64_t& plane) const {
    const int64_t o = q - cols.rps;
    if (out_state) {
      plane = R * cols.C;
      return out + gr * cols.C + static_cast<int64_t>(blockIdx.z) * cols.lb + o;
    }
    plane = R * w_out;
    return out + static_cast<int64_t>(blockIdx.z) * planes * plane + gr * w_out + o;
  }
};

// The global rows of a launch: the grid's R (its walls at rows 0 and R-1),
// the rows it may read [rd_lo, rd_hi) and the rows it writes [o_lo, o_hi).
struct Rows {
  int64_t R, rd_lo, rd_hi, o_lo, o_hi;
};

template <int H>
__host__ __device__ constexpr int scalar_fields() {
  return H == 5 ? 5 : 3;
}

template <typename T, bool CSF>
constexpr size_t smem_bytes() {
  constexpr int H = CSF ? 5 : 3;
  return sizeof(T) * (scalar_fields<H>() * Window<H>::N + 18 * RING_N);
}

template <typename T, bool CSF, bool RIN, bool ROUT, typename IO, bool EDGE, typename Cols>
__global__ void __launch_bounds__(THREADS)
    mrtcg_kernel(const IO io, const Rows rows, const Cols cols, const Params<T> p) {
  constexpr int H = CSF ? 5 : 3;
  using Win = Window<H>;
  extern __shared__ unsigned char smem_raw[];
  T* s_psi = reinterpret_cast<T*>(smem_raw);
  T* s_qx = s_psi + Win::N;
  T* s_qy = s_qx + Win::N;
  T* s_nx = s_qy + Win::N;  // CSF only
  T* s_ny = s_nx + Win::N;
  T* s_ring = s_psi + scalar_fields<H>() * Win::N;

  const int64_t R = rows.R, C = cols.C;
  const int64_t r0 = rows.o_lo + static_cast<int64_t>(blockIdx.y) * TY;
  const int64_t c0 = cols.first() + static_cast<int64_t>(blockIdx.x) * TX;
  const int tid = threadIdx.x;
  const bool left = Cols::SEAM && c0 == 0;
  const bool right = Cols::SEAM && c0 + TX >= C;
  Win w;
  w.r0 = r0;
  w.c0 = c0;
  w.seam_lo = left ? C - H : 0;
  auto readable = [&](int64_t gr, int64_t gc) {
    return gr >= rows.rd_lo && gr < rows.rd_hi && cols.readable(gc);
  };
  auto load = [&](int64_t gr, int64_t gc, Cell<T>& m) {
    int64_t plane;
    const T* q = io.src(gr, gc, plane);
    load_cell<T, CSF, RIN>(q, plane, 0, m);
  };

  // stage 1: psi, q_c ux, q_c uy on the window (main columns, then the seam)
  auto scalars = [&](int64_t gr, int64_t gc, int slot) {
    Cell<T> m;
    load(gr, gc, m);
    const Velocity<T> v = velocity<T, CSF>(m, p);
    const T q_c = p.v[R_ALPHA_C] * m.r_rho + p.v[B_ALPHA_C] * m.b_rho;
    s_psi[slot] = phase(m, p);
    s_qx[slot] = q_c * v.ux;
    s_qy[slot] = q_c * v.uy;
  };
  for (int i = tid; i < Win::ROWS * Win::MAIN; i += THREADS) {
    const int wr = i / Win::MAIN, wc = i % Win::MAIN;
    const int64_t gr = r0 - H + wr, gc = c0 - H + wc;
    if (readable(gr, gc)) scalars(gr, gc, wr * Win::COLS + wc);
  }
  if (left || right) {
    for (int i = tid; i < Win::ROWS * H; i += THREADS) {
      const int wr = i / H, q = i % H;
      const int64_t gr = r0 - H + wr, gc = w.seam_lo + q;
      if (readable(gr, gc)) scalars(gr, gc, wr * Win::COLS + Win::MAIN + q);
    }
  }
  __syncthreads();

  // stage 1b (CSF): the normal within 3 cells of the tile
  if (CSF) {
    constexpr int NR = TY + 6, NC = TX + 6;
    for (int i = tid; i < NR * NC; i += THREADS) {
      const int64_t gr = r0 - 3 + i / NC, gc = c0 - 3 + i % NC;
      if (readable(gr, gc))
        normal<T, H, EDGE>(s_psi, w, gr, gc, R, cols, s_nx[w.slot(gr, gc)],
                           s_ny[w.slot(gr, gc)]);
    }
    if (left || right) {
      // the seam cells the wrapped ring column's stencil reads
      const int64_t lo = left ? C - 3 : 0;
      for (int i = tid; i < (TY + 6) * 3; i += THREADS) {
        const int64_t gr = r0 - 3 + i / 3, gc = lo + i % 3;
        if (readable(gr, gc))
          normal<T, H, EDGE>(s_psi, w, gr, gc, R, cols, s_nx[w.slot(gr, gc)],
                             s_ny[w.slot(gr, gc)]);
      }
    }
    __syncthreads();
  }

  // stage 2: the collision on the tile plus a 1-cell ring
  const int64_t nrows = rows.o_hi - r0 < TY ? rows.o_hi - r0 : TY;
  const int64_t ncols = cols.end() - c0 < TX ? cols.end() - c0 : TX;
  for (int i = tid; i < RING_N; i += THREADS) {
    const int ri = i / RING_C, rj = i % RING_C;
    const int64_t gr = r0 - 1 + ri;
    if (ri > nrows + 1 || rj > ncols + 1 || gr < rows.rd_lo || gr >= rows.rd_hi) continue;
    const int64_t gc = cols.ring(c0 - 1 + rj);
    Cell<T> m;
    load(gr, gc, m);
    T coll[18];
    T fx, fy;
    collide_cell<T, CSF, ROUT, H, EDGE>(m, p, s_psi, s_qx, s_qy, s_nx, s_ny, w, gr, gc, R,
                                        cols, coll, fx, fy);
#pragma unroll
    for (int k = 0; k < 18; ++k) s_ring[k * RING_N + i] = coll[k];
    if (CSF && ri >= 1 && ri <= nrows && rj >= 1 && rj <= ncols) {
      const int fp = ROUT ? 10 : 18;  // fst is carried, not streamed
      int64_t plane;
      T* q = io.dst(gr, gc, plane);
      q[fp * plane] = fx;
      q[(fp + 1) * plane] = fy;
    }
  }
  __syncthreads();

  // stage 3: pull with the select chain of _stream_with_bcs
  const int ty = tid / TX, tx = tid % TX;
  if (ty >= nrows || tx >= ncols) return;
  const int64_t gr = r0 + ty, gc = c0 + tx;
  int64_t plane;
  T* q = io.dst(gr, gc, plane);
  T red_sum = T(0);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const PullSource src = pull_source<EDGE>(k, ty, tx, gr, cols.global(gc), R, C);
    q[k * plane] = s_ring[src.plane * RING_N + src.slot];
    const T b = s_ring[(9 + src.plane) * RING_N + src.slot];
    if (ROUT)
      red_sum = k == 0 ? b : red_sum + b;
    else
      q[(9 + k) * plane] = b;
  }
  if (ROUT) q[9 * plane] = red_sum;
}

// One launch over the rows `rows` and the columns `cols` with the memory
// `io` (`lanes` lane blocks along the grid's z, kernel 39); returns the
// cudaError_t of the launch (0 = accepted).
template <typename T, bool CSF, bool RIN, bool ROUT, typename IO, bool EDGE, typename Cols>
int launch_rows(const IO& io, const Rows& rows, const Cols cols, const double* params,
                cudaStream_t stream, unsigned lanes = 1) {
  const int64_t width = cols.end() - cols.first();
  if (rows.o_hi <= rows.o_lo || width <= 0) return 0;
  Params<T> p;
  for (int i = 0; i < NPARAM; ++i) p.v[i] = static_cast<T>(params[i]);
  constexpr size_t smem = smem_bytes<T, CSF>();
  static bool configured[MAX_DEVICES] = {};
  const cudaError_t e = smem_opt_in(mrtcg_kernel<T, CSF, RIN, ROUT, IO, EDGE, Cols>,
                                    static_cast<int>(smem), configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((width + TX - 1) / TX),
                  static_cast<unsigned>((rows.o_hi - rows.o_lo + TY - 1) / TY), lanes);
  mrtcg_kernel<T, CSF, RIN, ROUT, IO, EDGE, Cols><<<grid, THREADS, smem, stream>>>(io, rows,
                                                                                   cols, p);
  return static_cast<int>(cudaGetLastError());
}

// One step in -> out (distinct buffers) on `stream`.
template <typename T, bool CSF, bool RIN, bool ROUT>
int launch(const void* in, void* out, long long R, long long C, const double* params,
           cudaStream_t stream) {
  if (R <= 0 || C <= 0) return 0;
  const FlatIO<T> io{static_cast<const T*>(in), static_cast<T*>(out), R * C, C};
  return launch_rows<T, CSF, RIN, ROUT, FlatIO<T>, true>(io, Rows{R, 0, R, 0, R},
                                                         PeriodicCols{C}, params, stream);
}

// The rows of a halo launch (csrc/halo.cuh) in global terms.
template <typename T>
Rows halo_rows(const lbm::halo::Launch<T>& L) {
  return Rows{L.R, L.global(L.in_lo), L.global(L.in_hi), L.global(L.out.lo),
              L.global(L.out.hi)};
}

// Kernels 29 and 31: one sweep of the reduced (RIN = ROUT = true, kernel 29)
// or the full (both false, kernel 31) step on a row shard with halo inputs,
// geometry `geom`; the masked instance on the edge ranks.
template <typename T, bool CSF, bool RIN, bool ROUT>
int launch_halo(const long long* geom, const double* params, cudaStream_t stream) {
  const lbm::halo::Launch<T> L = lbm::halo::parse<T>(geom);
  if (L.R < 4 || L.in.C < 3) return static_cast<int>(cudaErrorInvalidValue);
  const lbm::halo::ShardIO<T> io{L.in, L.out, L.off};
  using IO = lbm::halo::ShardIO<T>;
  const PeriodicCols cols{L.in.C};
  return L.edge ? launch_rows<T, CSF, RIN, ROUT, IO, true>(io, halo_rows(L), cols, params,
                                                           stream)
                : launch_rows<T, CSF, RIN, ROUT, IO, false>(io, halo_rows(L), cols, params,
                                                            stream);
}

// The rows and the columns of a rows x cols launch (csrc/halo2d.cuh): rows
// in global terms, columns padded (BandCols).
template <typename T>
Rows halo2d_rows(const lbm::halo2d::Launch<T>& L) {
  return Rows{L.R, L.global_row(L.r_lo), L.global_row(L.r_hi), L.global_row(L.out.r_lo),
              L.global_row(L.out.r_hi)};
}

template <typename T>
BandCols halo2d_cols(const lbm::halo2d::Launch<T>& L) {
  return BandCols{L.C, L.off_c - L.in.halo, L.c_lo, L.c_hi, L.out.c_lo, L.out.c_hi};
}

// Kernel 38: one sweep of the full step on a rows x cols shard, geometry
// `geom` (csrc/halo2d.cuh); the masked instance on the edge row ranks.
template <typename T, bool CSF, bool RIN, bool ROUT>
int launch_halo2d(const long long* geom, const double* params, cudaStream_t stream) {
  const lbm::halo2d::Launch<T> L = lbm::halo2d::parse<T>(geom);
  if (L.R < 4 || L.C < 3) return static_cast<int>(cudaErrorInvalidValue);
  using IO = lbm::halo2d::Shard2DIO<T>;
  const IO io{L.in, L.out, L.off_r};
  return L.edge ? launch_rows<T, CSF, RIN, ROUT, IO, true>(io, halo2d_rows(L), halo2d_cols(L),
                                                           params, stream)
                : launch_rows<T, CSF, RIN, ROUT, IO, false>(io, halo2d_rows(L), halo2d_cols(L),
                                                            params, stream);
}

template <bool RIN, bool ROUT>
int dispatch_halo2d(const long long* geom, const double* params, int csf, int is_f64,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return csf ? launch_halo2d<double, true, RIN, ROUT>(geom, params, s)
               : launch_halo2d<double, false, RIN, ROUT>(geom, params, s);
  return csf ? launch_halo2d<float, true, RIN, ROUT>(geom, params, s)
             : launch_halo2d<float, false, RIN, ROUT>(geom, params, s);
}

// The four type x mode instances of one halo step.
template <bool RIN, bool ROUT>
int dispatch_halo(const long long* geom, const double* params, int csf, int is_f64,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return csf ? launch_halo<double, true, RIN, ROUT>(geom, params, s)
               : launch_halo<double, false, RIN, ROUT>(geom, params, s);
  return csf ? launch_halo<float, true, RIN, ROUT>(geom, params, s)
             : launch_halo<float, false, RIN, ROUT>(geom, params, s);
}

// Kernel 39: one sweep of the reduced step over the C / lb lane blocks of
// one grid, the input window's margin `margin` (in_state: the input is the
// state), the output's margin - H (out_state: the state, margin == H); a
// window at most 2C wide.
template <typename T, bool CSF>
int launch_lanes(const void* in, void* out, long long R, long long C, long long lb,
                 long long margin, int in_state, int out_state, const double* params,
                 cudaStream_t stream) {
  constexpr int H = CSF ? 5 : 3;  // the columns a sweep consumes
  if (R < 4 || C < 3 || lb <= 0 || C % lb != 0 || C / lb > 65535 || margin < H ||
      lb + 2 * margin > 2 * C || (out_state != 0) != (margin == H))
    return static_cast<int>(cudaErrorInvalidValue);
  const LaneCols cols{C, lb, margin, H, (C - margin % C) % C};
  const int64_t w_in = lb + 2 * margin;
  const LaneIO<T> io{static_cast<const T*>(in), static_cast<T*>(out), R, CSF ? 12 : 10, w_in,
                     w_in - 2 * H, cols, in_state != 0, out_state != 0};
  return launch_rows<T, CSF, true, true, LaneIO<T>, true>(io, Rows{R, 0, R, 0, R}, cols, params,
                                                          stream, static_cast<unsigned>(C / lb));
}

template <bool RIN, bool ROUT>
int dispatch(const void* in, void* out, long long R, long long C, const double* params,
             int csf, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return csf ? launch<double, true, RIN, ROUT>(in, out, R, C, params, s)
               : launch<double, false, RIN, ROUT>(in, out, R, C, params, s);
  return csf ? launch<float, true, RIN, ROUT>(in, out, R, C, params, s)
             : launch<float, false, RIN, ROUT>(in, out, R, C, params, s);
}

}  // namespace mrtcg
}  // namespace lbm
