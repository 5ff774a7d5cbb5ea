// The MRT colour-gradient two-phase step, shared by kernels 6-8, 29, 31, 38
// and 39; kernel 12 (csrc/rk_cg.cu) reuses its tile helpers (Window, corr5,
// clamp_index, pull_source) and its column policies.
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
// One launch is one step (one sweep of a sharded or lanes call), on one of
// two engines that compute the same cells bit for bit; the launch's plan
// (csrc/strip_plan.cuh strips_pay) picks one.
//   The tile engine (tile_kernel): a block owns an 8 x 32 tile of output
//   cells and works in three stages (window scalars, collisions of the tile
//   and its 1-cell ring, the pull), 2.08 window scalars (CSF 2.95, and 2.08
//   normals) and 1.33 collisions per output cell, every rule applied at
//   every stencil tap (WindowTaps).
//   The strip engine (strip_kernel): a block walks down a strip of at most
//   62 columns, G rows a group (4 in float32, 2 in float64; 64 G threads),
//   keeping rings of rows in shared memory: the next group's input window
//   rows (cp.async, csrc/async_copy.cuh), the scalars psi, q_c ux and q_c
//   uy (+ the CSF normal) on the rows the stencils reach, and the 18
//   post-collision values of the rows the pull reads.  A long segment costs
//   ~1.1 scalar evaluations and ~1.03 collisions an output cell; a thread's
//   collision column and its stencil taps' columns (the column policy's
//   rule, the seam) are computed once per strip and its taps' rows once per
//   cell, so a tap is one add (StripTaps); outputs go out as streaming
//   stores (__stcs).  But a segment's first group re-reads 2 H rows and
//   collides G + 2, about three groups' work, so the strip engine takes
//   only launches whose blocks walk enough groups: the big grids in CSF and
//   float64 and the float32 reduced step from 32 groups a block; the
//   scenes' small grids, most shards and the float32 perturbation step
//   with 18 output planes stay on the tile.
// Each group of the strip engine:
//   1. the scalars of its G new window rows, from the stage (CSF: then the
//      normal n, from the 5x5 gradient of psi);
//   2. the collision of G rows of the strip and its 1-column ring, into the
//      post ring, each thread's next input loaded into registers while it
//      computes (the CSF force of output cells goes straight to the output:
//      it is carried, not streamed);
//   3. each output cell PULLS its streamed populations with exactly the
//      select chain of _stream_with_bcs (pull_offset; the tile's
//      pull_source): periodic, then the column repair without the diagonal
//      offset on rows 1..R-2, then bounce-back on row R-1 and on row 0.
//      The red density of the reduced state is the sum of the pulled red
//      values in ascending k, with no atomics.
// What bounds the strip engine (H100 80GB HBM3 at 700 W, builds timed with
// parts removed; PERF.md section 6): kernel 6 at 4096x2048 float32 took
// 0.559 ms against 0.200 for its bytes; without its collisions 0.521,
// without its pull 0.553, without both 0.214.  The collision stage and the
// pull's stores each take about the whole step and overlap: a gain needs
// both cut.  110-128 registers in float32 (168-234 in float64, no spills)
// leave 2 blocks of 256 threads on an SM (float64: 2-3 of 128; 1 in the
// full CSF layout, whose 120 KB of shared memory fill an SM).
// Replicate padding is an index clamp: a stencil tap reads
// (clamp(r, 0, R-1), clamp(c, 0, C-1)).  Columns are periodic for the
// stream, so the ring of an edge block wraps to the far column; that
// column's stencil taps sit in a small "seam" window of H columns at the
// far edge, filled by the edge blocks or strips only.
//
// The columns a launch works on are a policy (PeriodicCols, BandCols,
// LaneCols): the grid's C columns, wrapped as above, for the single-device
// and row-sharded kernels; or the padded columns of a rows x cols shard
// (csrc/halo2d.cuh, kernels 37 and 38), or the window of a lane block
// (kernel 39), where a value is read at its padded or window column (the
// strips or the window's margins hold the neighbours', so nothing wraps
// and no seam is needed) while the rules, the stencils' replicate clamp
// and the column repair of the stream, use that column's wrapped global
// column, which the tile engine computes at every tap and the strip engine
// once per thread and strip.
//
// State layouts (planes of R*C, row-major): reduced in/out = 9 summed
// populations, red density (+ fstx, fsty); full = 9 red, 9 blue (+ fst).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "d2q9.cuh"
#include "halo.cuh"
#include "halo2d.cuh"
#include "strip_plan.cuh"

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

// The columns of a launch, as the engines address them.  A column c
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

// The shared-memory offsets of the 5x5 taps around one cell of the strip
// engine: tap (a, b) reads field[row[a] + col[b]].  The rules are already in
// them: the replicate clamp at the grid's rows 0 and R-1 in `row`, the
// column policy's (``Cols::tap``) and the window's seam in `col`, each
// computed once for the cell (and `col` once per thread and strip).
struct Taps {
  int row[5];
  int col[5];
};

// corr5 on taps: the same terms in the same order.
template <int DIR, typename T>
__device__ __forceinline__ T corr5_at(const T* field, const Taps& t) {
  T acc = T(0);
  bool have = false;
#pragma unroll
  for (int a = 0; a < 5; ++a) {
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      const double wt = k5<DIR>(a, b);
      if (wt == 0.0) continue;
      const T term = T(wt) * field[t.row[a] + t.col[b]];
      acc = have ? acc + term : term;
      have = true;
    }
  }
  return acc;
}

// The stencils of one cell as each engine reads its fields: `at<DIR>(field)`
// is corr5 of that field at the cell.  StripTaps: on precomputed taps;
// WindowTaps: on a tile's window, every rule applied at every tap.
struct StripTaps {
  const Taps& t;
  template <int DIR, typename T>
  __device__ __forceinline__ T at(const T* field) const {
    return corr5_at<DIR>(field, t);
  }
};

template <int H, bool EDGE, typename Cols>
struct WindowTaps {
  const Window<H>& w;
  int64_t gr, gc, R;
  Cols cols;
  template <int DIR, typename T>
  __device__ __forceinline__ T at(const T* field) const {
    return corr5<DIR, T, H, EDGE>(field, w, gr, gc, R, cols);
  }
};

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
template <typename T, typename S>
__device__ __forceinline__ void normal(const T* s_psi, const S& st, T& nx, T& ny) {
  const T gpx = st.template at<0>(s_psi);
  const T gpy = st.template at<1>(s_psi);
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
template <typename T, bool CSF, bool ROUT, typename S>
__device__ __forceinline__ void collide_cell(const Cell<T>& m, const Params<T>& p,
                                             const T* s_psi, const T* s_qx, const T* s_qy,
                                             const T* s_nx, const T* s_ny, const S& st,
                                             T out[18], T& fstx, T& fsty) {
  const Velocity<T> v = velocity<T, CSF>(m, p);
  const T ux = v.ux, uy = v.uy, inv_rho = v.inv_rho, rho = m.rho;
  const T r_rho = m.r_rho, b_rho = m.b_rho;
  const T x2 = ux * ux, y2 = uy * uy;
  const T uu = x2 + y2;
  const T cu_p[4] = {ux, uy, ux + uy, ux - uy};

  const T psi = phase(m, p);
  const T s_nu = relax(psi, p);
  const T gpx = st.template at<0>(s_psi);
  const T gpy = st.template at<1>(s_psi);
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
  const T dxqx = st.template at<0>(s_qx);
  const T dyqy = st.template at<1>(s_qy);
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
    const T dxnx = st.template at<0>(s_nx);
    const T dynx = st.template at<1>(s_nx);
    const T dxny = st.template at<0>(s_ny);
    const T dyny = st.template at<1>(s_ny);
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

// pull_source's select chain for the strip engine, relative to the cell:
// population k of the cell at global row gr and global column gcg comes
// from row gr + dr, column + dc, plane `plane` of the post-collision rows.
struct PullOffset {
  int dr, dc, plane;
};

template <bool EDGE>
__device__ __forceinline__ PullOffset pull_offset(int k, int64_t gr, int64_t gcg, int64_t R,
                                                  int64_t C) {
  const bool interior = !EDGE || (gr >= 1 && gr <= R - 2);
  int dr = -cx(k), dc = -cy(k), sk = k;  // periodic stream
  if (interior && ((gcg == 0 && cy(k) > 0) || (gcg == C - 1 && cy(k) < 0)))
    dr = 0;  // periodic column repair without the diagonal offset
  if (!EDGE) return {dr, dc, sk};
  if (gr == R - 1 && cx(k) < 0) {  // bounce-back on row R-1
    dr = 0;
    dc = 0;
    sk = opp(k);
  }
  if (gr == 0 && cx(k) > 0) {  // bounce-back on row 0, written last
    dr = 0;
    dc = 0;
    sk = opp(k);
  }
  return {dr, dc, sk};
}

// Where a step reads and writes, by global row: one (planes, R, C) buffer
// in and one out (the single-device kernels; lbm::halo::ShardIO is a row
// shard with halo inputs, kernels 29-31; lbm::halo2d::Shard2DIO a rows x
// cols shard, kernel 38, and lbm::halo2d::PartsIO one read from 3 x 3
// parts, kernel 37).
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

// The tile engine's shared memory: the scalar fields on the window and the
// 18 post-collision values on the ring of the tile.
template <typename T, bool CSF>
constexpr size_t tile_smem_bytes() {
  constexpr int H = CSF ? 5 : 3;
  return sizeof(T) * ((CSF ? 5 : 3) * Window<H>::N + 18 * RING_N);
}

// The tile engine: one step (or sweep) of one TY x TX tile of output cells
// a block, in three stages, each ended by __syncthreads():
//   1. the derived scalars psi, q_c ux and q_c uy (in CSF mode also the
//      normal n, from the 5x5 gradient of psi) on the tile plus a halo of H
//      cells, into shared memory;
//   2. the collision of every cell of the tile plus a 1-cell ring, its 18
//      post-collision values into shared memory (the CSF force of tile
//      cells goes straight to the output: it is carried, not streamed);
//   3. each tile cell pulls its streamed populations (pull_source).
// It takes the launches whose strip plan is too short to pay a segment's
// first group (strips_pay): the scenes' small grids and most shards.
template <typename T, bool CSF, bool RIN, bool ROUT, typename IO, bool EDGE, typename Cols>
__global__ void __launch_bounds__(THREADS)
    tile_kernel(const IO io, const Rows rows, const Cols cols, const Params<T> p) {
  constexpr int H = CSF ? 5 : 3;
  using Win = Window<H>;
  using Taps5 = WindowTaps<H, EDGE, Cols>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_psi = reinterpret_cast<T*>(smem_raw);
  T* s_qx = s_psi + Win::N;
  T* s_qy = s_qx + Win::N;
  T* s_nx = s_qy + Win::N;  // CSF only
  T* s_ny = s_nx + Win::N;
  T* s_ring = s_psi + (CSF ? 5 : 3) * Win::N;

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
        normal(s_psi, Taps5{w, gr, gc, R, cols}, s_nx[w.slot(gr, gc)], s_ny[w.slot(gr, gc)]);
    }
    if (left || right) {
      // the seam cells the wrapped ring column's stencil reads
      const int64_t lo = left ? C - 3 : 0;
      for (int i = tid; i < (TY + 6) * 3; i += THREADS) {
        const int64_t gr = r0 - 3 + i / 3, gc = lo + i % 3;
        if (readable(gr, gc))
          normal(s_psi, Taps5{w, gr, gc, R, cols}, s_nx[w.slot(gr, gc)], s_ny[w.slot(gr, gc)]);
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
    collide_cell<T, CSF, ROUT>(m, p, s_psi, s_qx, s_qy, s_nx, s_ny, Taps5{w, gr, gc, R, cols},
                               coll, fx, fy);
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

// The strip engine: one step (or sweep) of the rows `rows` and the columns
// `cols`, memory `io`.  A block walks each segment [s_lo, s_hi) of its
// units down its strip in groups of G rows.  The first group of a segment (output rows [s_lo,
// s_lo + G)) reads its window rows [s_lo - H, s_lo + G + H) straight from
// memory, collides the G + 2 rows [s_lo - 1, s_lo + G + 1) (the threads of
// rows ty < 2 take two) and pulls; each later group, output rows [a, a + G):
//   stage      the input rows [a + G + H, a + 2 G + H) of the next group go
//              into the other half of the stage by async copies;
//   scalars    psi, q_c ux, q_c uy on the window rows [a + H, a + H + G),
//              from the stage;
//   normals    (CSF) n on the rows [a + 3, a + 3 + G), columns [c0 - 3, c0 +
//              w + 3) and the 3 seam columns;
//   collide    the rows [a + 1, a + 1 + G) on the strip's NX columns, into
//              the post ring, each thread loading its next input while it
//              computes (the CSF force of an output cell to the output);
//   pull       the output rows [a, a + G): pull_offset's select chain.
// Barriers: after scalars (and normals), and after collide once the copies
// have landed.  Rows reach below s_hi as far as the stencils need (scalars
// to s_hi + H, normals to s_hi + 3, collisions to s_hi + 1), and a cell is
// loaded only where `rows` and `cols` make it readable.
template <typename T, bool CSF, bool RIN, bool ROUT, typename IO, bool EDGE, typename Cols>
__global__ void __launch_bounds__(Strip<T>::THREADS, Strip<T>::MIN_BLOCKS)
    strip_kernel(const IO io, const Rows rows, const Cols cols, const Strips sp,
                 const Params<T> p) {
  using Rg = Rings<T, CSF, RIN>;
  constexpr int H = Rg::H, G = Rg::G, NX = Rg::NX, NT = Strip<T>::THREADS;
  constexpr int MAIN = Rg::MAIN, COLS = Rg::COLS, PL = Rg::PLANES;
  constexpr int NS = Rg::NS, NK = Rg::NK, FIELD = Rg::FIELD, POST = Rg::POST;
  constexpr int NCOLS_N = Strip<T>::WMAX + 6;  // normal columns of a strip, at most
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const s_stage = reinterpret_cast<T*>(smem_raw);
  T* const s_psi = s_stage + Rg::STAGE;
  T* const s_qx = s_psi + FIELD;
  T* const s_qy = s_qx + FIELD;
  T* const s_nx = s_qy + FIELD;  // CSF only
  T* const s_ny = s_nx + FIELD;
  T* const s_post = s_psi + Rg::FIELDS * FIELD;

  const int64_t R = rows.R, C = cols.C;
  const int tid = threadIdx.x, tx = tid % NX, ty = tid / NX;
  const int64_t units = sp.n * sp.groups;
  int64_t u = static_cast<int64_t>(blockIdx.x) * sp.per;
  const int64_t u_end = u + sp.per < units ? u + sp.per : units;
  while (u < u_end) {
    const int64_t strip = u / sp.groups, g0 = u % sp.groups;
    const int64_t g1 = g0 + (u_end - u) < sp.groups ? g0 + (u_end - u) : sp.groups;
    u += g1 - g0;
    const int64_t c0 = cols.first() + strip * sp.W;
    const int w = static_cast<int>(cols.end() - c0 < sp.W ? cols.end() - c0 : sp.W);
    const int64_t s_lo = rows.o_lo + g0 * G;
    const int64_t s_hi = rows.o_lo + g1 * G < rows.o_hi ? rows.o_lo + g1 * G : rows.o_hi;

    // the window: main columns [c0 - H, c0 + w + H), the seam at MAIN
    const bool left = Cols::SEAM && c0 == 0;
    const bool right = Cols::SEAM && c0 + w >= C;
    const bool seam = left || right;
    const int64_t seam_lo = left ? C - H : 0;
    const int64_t wc0 = c0 - H;
    const int mainw = w + 2 * H;
    auto colslot = [&](int64_t gc) -> int {
      const int64_t rel = gc - wc0;
      return static_cast<int>(rel >= 0 && rel < mainw ? rel : MAIN + (gc - seam_lo));
    };
    auto window_col = [&](int j, int64_t& gc) -> bool {
      if (j < mainw) {
        gc = wc0 + j;
        return true;
      }
      gc = seam_lo + (j - MAIN);
      return seam && j >= MAIN;
    };
    auto readable = [&](int64_t gr, int64_t gc) {
      return gr >= rows.rd_lo && gr < rows.rd_hi && cols.readable(gc);
    };
    // ring slots: every row a segment touches is >= s_lo - H
    const int64_t base = s_lo - H;
    auto srow = [&](int64_t gr) { return (static_cast<int>(gr - base) % NS) * COLS; };
    auto krow = [&](int64_t gr) { return (static_cast<int>(gr - base) % NK) * NX; };
    auto taps_rows = [&](int64_t gr, Taps& t) {
#pragma unroll
      for (int a = 0; a < 5; ++a) t.row[a] = srow(EDGE ? clamp_index(gr + a - 2, R) : gr + a - 2);
    };
    // scalar rows [s_lo - H, s_hi + H), normal rows [s_lo - 3, s_hi + 3)
    auto window_cell = [&](int i, int64_t r_lo, int& rr, int& j, int64_t& gr, int64_t& gc) {
      rr = i / COLS;
      j = i % COLS;
      gr = r_lo + rr;
      return gr < s_hi + H && window_col(j, gc) && readable(gr, gc);
    };
    auto put_scalars = [&](const Cell<T>& m, int64_t gr, int j) {
      const Velocity<T> v = velocity<T, CSF>(m, p);
      const T q_c = p.v[R_ALPHA_C] * m.r_rho + p.v[B_ALPHA_C] * m.b_rho;
      const int s = srow(gr) + j;
      s_psi[s] = phase(m, p);
      s_qx[s] = q_c * v.ux;
      s_qy[s] = q_c * v.uy;
    };
    // the input rows [a + H, a + H + G) of group a into stage buffer `buf`
    auto stage = [&](int64_t a, int buf) {
      T* const dst = s_stage + buf * (G * PL * COLS);
      for (int i = tid; i < G * COLS; i += NT) {
        int rr, j;
        int64_t gr, gc;
        if (!window_cell(i, a + H, rr, j, gr, gc)) continue;
        int64_t plane;
        const T* q = io.src(gr, gc, plane);
        T* d = dst + rr * (PL * COLS) + j;
#pragma unroll
        for (int k = 0; k < PL; ++k) async_copy(d + k * COLS, q + k * plane);
      }
    };
    auto scalars = [&](int64_t a, int buf) {
      const T* const src = s_stage + buf * (G * PL * COLS);
      for (int i = tid; i < G * COLS; i += NT) {
        int rr, j;
        int64_t gr, gc;
        if (!window_cell(i, a + H, rr, j, gr, gc)) continue;
        Cell<T> m;
        load_cell<T, CSF, RIN>(src + rr * (PL * COLS), COLS, j, m);
        put_scalars(m, gr, j);
      }
    };
    // the first group's rows [s_lo - H, s_lo + G + H), straight from memory
    auto first_scalars = [&]() {
      for (int i = tid; i < (G + 2 * H) * COLS; i += NT) {
        int rr, j;
        int64_t gr, gc;
        if (!window_cell(i, s_lo - H, rr, j, gr, gc)) continue;
        Cell<T> m;
        int64_t plane;
        const T* const in = io.src(gr, gc, plane);
        load_cell<T, CSF, RIN>(in, plane, 0, m);
        put_scalars(m, gr, j);
      }
    };
    // the normal on the rows [r_lo, r_lo + n): the strip's columns and 3 each
    // side, then the 3 seam cells the wrapped ring column reads
    auto normals = [&](int64_t r_lo, int n) {
      for (int i = tid; i < n * (NCOLS_N + 3); i += NT) {
        const int rr = i / (NCOLS_N + 3), j = i % (NCOLS_N + 3);
        const int64_t gr = r_lo + rr;
        int64_t gc;
        if (j < w + 6)
          gc = c0 - 3 + j;
        else if (seam && j >= NCOLS_N)
          gc = (left ? C - 3 : 0) + (j - NCOLS_N);
        else
          continue;
        if (gr >= s_hi + 3 || !readable(gr, gc)) continue;
        Taps t;
        taps_rows(gr, t);
#pragma unroll
        for (int b = 0; b < 5; ++b) t.col[b] = colslot(cols.tap(gc, b - 2));
        T nx, ny;
        normal(s_psi, StripTaps{t}, nx, ny);
        const int s = srow(gr) + colslot(gc);
        s_nx[s] = nx;
        s_ny[s] = ny;
      }
    };

    // this thread's collision column (the ring's at tx = 0 and w + 1) and
    // the window columns of its taps, for the whole segment
    const bool on = tx <= w + 1;
    const int64_t gcc = on ? cols.ring(c0 - 1 + tx) : c0;
    Taps t;
#pragma unroll
    for (int b = 0; b < 5; ++b) t.col[b] = colslot(cols.tap(gcc, b - 2));
    auto collides = [&](int64_t gr) {
      return on && gr >= s_lo - 1 && gr < s_hi + 1 && gr >= rows.rd_lo && gr < rows.rd_hi;
    };
    // the input of this thread's next collision, loaded while the current
    // one computes
    T raw[PL];
    auto fetch = [&](int64_t gr) {
      if (!collides(gr)) return;
      int64_t plane;
      const T* const in = io.src(gr, gcc, plane);
#pragma unroll
      for (int k = 0; k < PL; ++k) raw[k] = in[k * plane];
    };
    auto collide = [&](int64_t gr, int64_t next) {
      if (!collides(gr)) {
        fetch(next);
        return;
      }
      taps_rows(gr, t);
      Cell<T> m;
      load_cell<T, CSF, RIN>(raw, 1, 0, m);
      fetch(next);
      T coll[18];
      T fx, fy;
      collide_cell<T, CSF, ROUT>(m, p, s_psi, s_qx, s_qy, s_nx, s_ny, StripTaps{t}, coll, fx,
                                 fy);
      T* const d = s_post + krow(gr) + tx;
#pragma unroll
      for (int k = 0; k < 18; ++k) d[k * POST] = coll[k];
      if (CSF && gr >= s_lo && gr < s_hi && tx >= 1 && tx <= w) {
        const int fp = ROUT ? 10 : 18;  // fst is carried, not streamed
        int64_t plane;
        T* q = io.dst(gr, gcc, plane);
        q[fp * plane] = fx;
        q[(fp + 1) * plane] = fy;
      }
    };
    auto pull = [&](int64_t a) {
      const int64_t gr = a + ty;
      if (tx < 1 || tx > w || gr >= s_hi) return;
      const int64_t gc = c0 - 1 + tx;
      const int64_t gcg = cols.global(gc);
      const int rm = krow(gr - 1) + tx, r0 = krow(gr) + tx, rp = krow(gr + 1) + tx;
      int64_t plane;
      T* q = io.dst(gr, gc, plane);
      T red_sum = T(0);
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const PullOffset o = pull_offset<EDGE>(k, gr, gcg, R, C);
        const int slot = (o.dr < 0 ? rm : (o.dr > 0 ? rp : r0)) + o.dc;
        __stcs(q + k * plane, s_post[o.plane * POST + slot]);
        const T b = s_post[(9 + o.plane) * POST + slot];
        if (ROUT)
          red_sum = k == 0 ? b : red_sum + b;
        else
          __stcs(q + (9 + k) * plane, b);
      }
      if (ROUT) __stcs(q + 9 * plane, red_sum);
    };

    // the first group: its window rows and the warm-up rows above it from
    // memory, G + 2 rows of collisions (threads of rows ty < 2 take two),
    // while the second group's rows are copied in
    if (s_lo + G < s_hi) stage(s_lo + G, 1);
    async_commit();
    fetch(s_lo - 1 + ty);
    first_scalars();
    __syncthreads();
    if (CSF) {
      normals(s_lo - 3, G + 6);
      __syncthreads();
    }
    if (ty < 2) {
      collide(s_lo - 1 + ty, s_lo - 1 + G + ty);
      collide(s_lo - 1 + G + ty, s_lo + 1 + G + ty);
    } else {
      collide(s_lo - 1 + ty, s_lo + 1 + G + ty);
    }
    async_wait_all();
    __syncthreads();
    pull(s_lo);
    for (int64_t a = s_lo + G, k = 1; a < s_hi; a += G, ++k) {
      if (a + G < s_hi) stage(a + G, static_cast<int>((k + 1) & 1));
      async_commit();
      scalars(a, static_cast<int>(k & 1));
      __syncthreads();
      if (CSF) {
        normals(a + 3, G);
        __syncthreads();
      }
      collide(a + 1 + ty, a + 1 + G + ty);
      async_wait_all();
      __syncthreads();
      pull(a);
    }
  }
}

// The blocks of one instance the card holds at once and the SMs, per device
// (0 until the first launch there asks).
template <typename K>
inline cudaError_t resident_blocks(K kernel, int threads, size_t smem,
                                   int (&slots)[MAX_DEVICES], int (&sm_count)[MAX_DEVICES],
                                   int& held, int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (slots[dev] == 0) {
    int n = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    sm_count[dev] = n;
    slots[dev] = n * per_sm;
  }
  held = slots[dev];
  sms = sm_count[dev];
  return cudaSuccess;
}

// The engine a launch takes: 0 by its plan (strips_pay), 1 the tile, 2 the
// strip.  Set only by lbm_mrtcg_force_engine, through which the tests and
// chip_smoke.py hold each engine at every shape and time one against the
// other.
inline int forced_engine = 0;

// One launch over the rows `rows` and the columns `cols` with the memory
// `io` (`lanes` lane blocks along the grid's z, kernel 39; `sharded`: a row
// or rows x cols shard's memory), on the engine its plan picks; returns the
// cudaError_t of the launch (0 = accepted).
template <typename T, bool CSF, bool RIN, bool ROUT, typename IO, bool EDGE, typename Cols>
int launch_rows(const IO& io, const Rows& rows, const Cols cols, const double* params,
                cudaStream_t stream, unsigned lanes = 1, bool sharded = false) {
  const int64_t width = cols.end() - cols.first();
  if (rows.o_hi <= rows.o_lo || width <= 0) return 0;
  Params<T> p;
  for (int i = 0; i < NPARAM; ++i) p.v[i] = static_cast<T>(params[i]);
  const auto strip = strip_kernel<T, CSF, RIN, ROUT, IO, EDGE, Cols>;
  const auto tile = tile_kernel<T, CSF, RIN, ROUT, IO, EDGE, Cols>;
  constexpr size_t strip_smem = Rings<T, CSF, RIN>::BYTES, tile_smem = tile_smem_bytes<T, CSF>();
  static bool strip_ready[MAX_DEVICES] = {}, tile_ready[MAX_DEVICES] = {};
  static int slots[MAX_DEVICES] = {}, sm_count[MAX_DEVICES] = {};
  cudaError_t e = smem_opt_in(strip, static_cast<int>(strip_smem), strip_ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  int held = 0, sms = 0;
  e = resident_blocks(strip, Strip<T>::THREADS, strip_smem, slots, sm_count, held, sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t nrows = rows.o_hi - rows.o_lo;
  const Strips sp = plan_strips<T, CSF, RIN, ROUT>(width, nrows, held, sms, lanes, sharded);
  if (forced_engine == 0 ? sp.strips : forced_engine == 2) {
    const dim3 grid(static_cast<unsigned>(sp.blocks), 1, lanes);
    strip<<<grid, Strip<T>::THREADS, strip_smem, stream>>>(io, rows, cols, sp, p);
    return static_cast<int>(cudaGetLastError());
  }
  e = smem_opt_in(tile, static_cast<int>(tile_smem), tile_ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((width + TX - 1) / TX),
                  static_cast<unsigned>((nrows + TY - 1) / TY), lanes);
  tile<<<grid, THREADS, tile_smem, stream>>>(io, rows, cols, p);
  return static_cast<int>(cudaGetLastError());
}

// One engine kernel as phase 2 of chip_smoke.py reports it, into out[0..4]:
// registers, local bytes a thread (spills), dynamic shared memory, threads
// and the blocks an SM holds (CUDA's occupancy calculator on this device).
template <typename K>
inline cudaError_t describe_kernel(K kernel, int threads, size_t smem, long long* out) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  out[0] = a.numRegs;
  out[1] = static_cast<long long>(a.localSizeBytes);
  out[2] = static_cast<long long>(smem);
  out[3] = threads;
  out[4] = per_sm;
  return e;
}

// The memories of an engine instance: the flat grid (kernels 6-8), a row
// shard with and without wall rows (29, 31), a rows x cols shard with and
// without (38), lane windows (39).
enum Mem { FLAT, SHARD_EDGE, SHARD, SHARD2D_EDGE, SHARD2D, LANES };

template <typename T, bool CSF, bool RIN, bool ROUT, Mem M>
int describe_mem(long long* out) {
  using lbm::halo::ShardIO;
  using lbm::halo2d::Shard2DIO;
  cudaError_t e;
  auto both = [&](auto strip, auto tile) {
    cudaError_t r = describe_kernel(strip, Strip<T>::THREADS, Rings<T, CSF, RIN>::BYTES, out);
    return r != cudaSuccess ? r
                            : describe_kernel(tile, THREADS, tile_smem_bytes<T, CSF>(), out + 5);
  };
  if constexpr (M == FLAT)
    e = both(strip_kernel<T, CSF, RIN, ROUT, FlatIO<T>, true, PeriodicCols>,
             tile_kernel<T, CSF, RIN, ROUT, FlatIO<T>, true, PeriodicCols>);
  else if constexpr (M == SHARD_EDGE || M == SHARD)
    e = both(strip_kernel<T, CSF, RIN, ROUT, ShardIO<T>, M == SHARD_EDGE, PeriodicCols>,
             tile_kernel<T, CSF, RIN, ROUT, ShardIO<T>, M == SHARD_EDGE, PeriodicCols>);
  else if constexpr (M == SHARD2D_EDGE || M == SHARD2D)
    e = both(strip_kernel<T, CSF, RIN, ROUT, Shard2DIO<T>, M == SHARD2D_EDGE, BandCols>,
             tile_kernel<T, CSF, RIN, ROUT, Shard2DIO<T>, M == SHARD2D_EDGE, BandCols>);
  else
    e = both(strip_kernel<T, CSF, RIN, ROUT, LaneIO<T>, true, LaneCols>,
             tile_kernel<T, CSF, RIN, ROUT, LaneIO<T>, true, LaneCols>);
  return static_cast<int>(e);
}

template <typename T, bool CSF, bool RIN, bool ROUT, Mem M, Mem... REST>
int describe_nth(int k, long long* out) {
  if (k == 0) return describe_mem<T, CSF, RIN, ROUT, M>(out);
  if constexpr (sizeof...(REST) > 0) return describe_nth<T, CSF, RIN, ROUT, REST...>(k - 1, out);
  return -1;
}

// Instance i of a unit whose layout is (RIN, ROUT) and whose memories are
// MEMS, both engines: out[0..4] the strip kernel's and out[5..9] the tile
// kernel's (describe_kernel), out[10..12] float64, CSF and the memory (Mem);
// i = 4 memory + 2 float64 + CSF.  Returns -1 past the last instance, else
// the cudaError_t of the queries.
template <bool RIN, bool ROUT, Mem... MEMS>
int describe_unit(int i, long long* out) {
  constexpr Mem mems[] = {MEMS...};
  if (i < 0 || i >= 4 * static_cast<int>(sizeof...(MEMS))) return -1;
  const int m = i / 4, f64 = (i % 4) / 2, csf = i % 2;
  out[10] = f64;
  out[11] = csf;
  out[12] = mems[m];
  if (f64)
    return csf ? describe_nth<double, true, RIN, ROUT, MEMS...>(m, out)
               : describe_nth<double, false, RIN, ROUT, MEMS...>(m, out);
  return csf ? describe_nth<float, true, RIN, ROUT, MEMS...>(m, out)
             : describe_nth<float, false, RIN, ROUT, MEMS...>(m, out);
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
__host__ __device__ Rows halo_rows(const lbm::halo::Launch<T>& L) {
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
                                                           stream, 1, true)
                : launch_rows<T, CSF, RIN, ROUT, IO, false>(io, halo_rows(L), cols, params,
                                                            stream, 1, true);
}

// The rows and the columns of a rows x cols launch (csrc/halo2d.cuh Launch
// or PartsLaunch): rows in global terms, columns padded (BandCols).
template <typename L>
__host__ __device__ Rows halo2d_rows(const L& l) {
  return Rows{l.R, l.global_row(l.r_lo), l.global_row(l.r_hi), l.global_row(l.out.r_lo),
              l.global_row(l.out.r_hi)};
}

template <typename L>
__host__ __device__ BandCols halo2d_cols(const L& l) {
  return BandCols{l.C, l.off_c - l.in.halo, l.c_lo, l.c_hi, l.out.c_lo, l.out.c_hi};
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
                                                           params, stream, 1, true)
                : launch_rows<T, CSF, RIN, ROUT, IO, false>(io, halo2d_rows(L), halo2d_cols(L),
                                                            params, stream, 1, true);
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
