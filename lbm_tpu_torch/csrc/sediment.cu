// Kernel 17: one step of rectangle sedimentation, a BGK fluid f and a
// passive advection-diffusion scalar g coupled one way, on 18 planes.
//
// Replaces the TPU kernel lbm_tpu/kernels/sediment_pallas.py:79
// make_sediment_fused_step (helpers _bgk9 :49, _stream9 :67).  Its plain
// version is kernels/sediment.py::plain_sediment_step, lbm_tpu's jnp step
// (scenes/obstacles.py:455-491) written with the port's boundary rules,
// transcribed in its order and built with -fmad=false (_build.UNIT_FLAGS), so
// each operation rounds once, as the plain version's elementwise ops do.
// One step (test/rectangle_sedimentation_test.cpp:125-236):
//   1. both BGK collisions at the compressible equilibrium, the scalar's at
//      the velocity u + w_s in both components (:125, :201);
//   2. the zero-gradient outflows on g before the stream: row 0 takes row
//      1's post-collision g, then column C-1 of rows 1..R-2 takes column
//      C-2's (:134-141);
//   3. the periodic push of f and g;
//   4. the fluid's walls, in order: anti-bounce-back inlet on column 0 at
//      the wall velocity (0, u_in), rows 1..R-2 (:148-157); the
//      extrapolated anti-bounce-back outlet on column C-1, from the
//      start-of-step u of columns C-1 and C-2 (:159-172); specular row 0
//      (:174-177); bounce-back row R-1 (:179-182); the rectangle's
//      bounce-back walls (:184-196);
//   5. the scalar's walls, in order: the ADE Dirichlet inlet, 2 g_eq at
//      the updated velocity, on column 0 rows 1..R-2 (:199-218); the
//      rectangle's anti-bounce-back walls, the first running to the last
//      row (:220-232); bounce-back row R-1 (:233-236).
//
// One thread per cell, neighbouring columns along a warp.  A thread that
// needs a neighbour's values recomputes them from f_in: row 0 collides
// row 1's scalar, column C-1 collides column C-2's scalar and takes its
// start-of-step velocity.  Those neighbour loads are issued with the
// cell's own 18, before any arithmetic, so one memory round trip serves
// the whole cell (cell (0, C-1), which needs both neighbours, loads column
// C-2's f after its collision).  The ADE inlet's updated velocity is
// local: on rows 1..R-2 of column 0 the inlet rewrites all 8 moving f
// populations from the cell's own post-collision values, and the rest
// population does not move, so the cell's new f is known to its own thread
// (the geometry keeps the rectangle off column 0).
//
// One writer per output entry.  Every wall rule writes entries of its own
// cell.  A push into an entry that a rule writes is dropped (kernel 9's
// rule, csrc/channel_variant.cu), and the thread of the wall cell applies
// the rules in the plain version's order, each over the last, and writes
// what stands at the end.  So g plane 7 at (R-1, C28) comes from the row
// R-1 bounce-back over the rectangle's first wall, and f at (0, C-1) and
// (R-1, C-1) from the row rules over the outlet, as in lbm_tpu (which keeps
// the reference's double write at :155-157).
//
// Launch: lbm::launch_cells (d2q9.cuh), as kernels 2, 4, 9, 23 and 24:
// blocks sized to the card and a programmatic dependent launch where the
// grid fits the card in one wave (each instance asks its own occupancy), a
// plain one at many waves; lbm::grid_wait before the first load (the
// caching allocator may hand step n+1's output the buffer step n still
// reads), lbm::grid_release once the cell's loads are issued.  The index
// type I is int32_t where the 18 planes' offsets fit it, else int64_t.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py --k17-k30, CUDA
// graphs, in turns, us a step): 256x320 float32 7.56 -> 4.93, float64
// 10.08 -> 7.81; 4096x2048 float32 521 -> 475, float64 895 -> 894, against
// the first design's plain launch of 256 threads with 64-bit indices and
// the neighbour loads after the collisions.  Of the levers at 256x320 in
// float32: the 64-bit indices' division r = cell / C cost 2.0 us (6.96),
// the plain launch 0.50 (5.43), the neighbour loads after the collisions
// 0.31 (5.23); 128-thread blocks lost 0.31 in float32 and won 0.78 in
// float64 (128 registers a thread, 152 with 64-bit indices); handing
// column C-2's values over by __shfl_up_sync (5.00) and computing the
// owned() masks once from row and column flags (5.40) lost.
//
// Shapes: R, C >= 4, 1 <= R23 <= R-2, 1 <= C28 <= C38 <= C-2.
//
// Bound: device-memory bytes, 144 B/cell per float32 step (18 planes in,
// 18 out).  Left on the table: the edge threads' recomputed collisions
// (their warps diverge) and the rule branches in every thread.

#include <cuda_runtime.h>

#include "d2q9.cuh"

namespace {

template <typename T>
struct Params {
  T omega, one_m_omega, w_s, c_w;  // BGK rate, 1 - omega, settling velocity, inlet C
  T abb_in[9];                     // the inlet's ABB coefficients at (0, u_in)
  int R23, C28, C38;               // the rectangle: top row, first and second wall
  int inlet_rows;                  // C = c_w on the inlet's last inlet_rows rows
};

// Moments of one cell's f: rho, u = m1 / rho.
template <typename T>
__device__ __forceinline__ void velocity(const T f[9], T& rho, T& ux, T& uy) {
  T mx, my;
  lbm::moments(f, rho, mx, my);
  ux = mx / rho;
  uy = my / rho;
}

template <typename T>
__device__ __forceinline__ void bgk(const T x[9], T dens, T ux, T uy, const Params<T>& P,
                                    T out[9]) {
  T eq[9];
  lbm::equilibrium(dens, ux, uy, eq);
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = P.one_m_omega * x[k] + P.omega * eq[k];
}

// The scalar's post-collision populations gc of a cell from its g and its
// velocity (ux, uy).
template <typename T>
__device__ __forceinline__ void scalar_collision(const T g[9], T ux, T uy, const Params<T>& P,
                                                 T gc[9]) {
  T conc = g[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) conc += g[k];
  bgk(g, conc, ux + P.w_s, uy + P.w_s, P, gc);
}

// The 9 planes of `cell` from `src` (plane stride n).
template <typename T, typename I>
__device__ __forceinline__ void load9(const T* __restrict__ src, I n, I cell, T out[9]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = src[k * n + cell];
}

// The planes of (r, c) that a wall rule writes: f in bits 0-8, g in 9-17.
template <typename T, typename I>
__device__ __forceinline__ unsigned owned(I r, I c, I R, I C, const Params<T>& P) {
  unsigned m = 0;
  const bool lane = r >= 1 && r <= R - 2;
  const bool walls = r >= P.R23 + 1;  // the rectangle's side walls, down from R23 + 1
  const bool ceil = r == P.R23 && c >= P.C28 && c <= P.C38;
  // f: inlet, outlet, row 0, row R-1, the rectangle
  if (c == 0 && lane) m |= 0x1FEu;
  if (c == C - 1) m |= 0x1FEu;
  if (r == 0) m |= (1u << 1) | (1u << 5) | (1u << 8);
  if (r == R - 1) m |= (1u << 3) | (1u << 7) | (1u << 6);
  if (walls && lane && c == P.C28) m |= (1u << 8) | (1u << 4) | (1u << 7);
  if (ceil) m |= (1u << 6) | (1u << 3) | (1u << 7);
  if (walls && lane && c == P.C38) m |= (1u << 5) | (1u << 2) | (1u << 6);
  // g: inlet, the rectangle (first wall to the last row), row R-1
  unsigned g = 0;
  if (c == 0 && lane) g |= 0x1FEu;
  if (walls && c == P.C28) g |= (1u << 8) | (1u << 4) | (1u << 7);
  if (ceil) g |= (1u << 6) | (1u << 3) | (1u << 7);
  if (walls && lane && c == P.C38) g |= (1u << 5) | (1u << 2) | (1u << 6);
  if (r == R - 1) g |= (1u << 3) | (1u << 7) | (1u << 6);
  return m | (g << 9);
}

// A one-period wrap in the kernel's index type (lbm::wrap's rule).
template <typename I>
__device__ __forceinline__ I wrap(I i, I n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// Kernel 17: one thread a cell, its index arithmetic in I.
template <typename T, typename I>
__global__ void sediment_kernel(const T* __restrict__ fin, T* __restrict__ fout, I R, I C,
                                Params<T> P) {
  const I n = R * C;
  const I cell = static_cast<I>(blockIdx.x) * static_cast<I>(blockDim.x) +
                 static_cast<I>(threadIdx.x);
  if (cell >= n) return;
  const I r = cell / C;
  const I c = cell - r * C;
  const bool lane = r >= 1 && r <= R - 2;
  const bool outlet = c == C - 1;
  // the neighbour whose values the cell takes: row 1's for row 0 (its
  // scalar), column C-2's for column C-1 (its scalar and its velocity)
  const bool near = r == 0 || outlet;
  const I nb = r == 0 ? C + c : cell - 1;
  lbm::grid_wait();

  // 1. the loads, the neighbour's with the cell's own; the next step's
  // launch is released once they are issued
  T f[9], g[9], fn[9], gn[9];
  load9(fin, n, cell, f);
  load9(fin + 9 * n, n, cell, g);
  if (near) {
    load9(fin, n, nb, fn);
    load9(fin + 9 * n, n, nb, gn);
  }
  lbm::grid_release();

  // both collisions
  T rho, ux, uy;
  velocity(f, rho, ux, uy);
  T fc[9], gc[9];
  bgk(f, rho, ux, uy, P, fc);
  scalar_collision(g, ux, uy, P, gc);

  // 2. the zero-gradient outflows on g (row 0 first, then column C-1), and
  // the outlet's start-of-step velocity of column C-2
  T ux2 = T(0), uy2 = T(0);
  if (near) {
    T rho2, vx, vy;
    velocity(fn, rho2, vx, vy);
    if (r == 0 || lane) scalar_collision(gn, vx, vy, P, gc);
    ux2 = vx;
    uy2 = vy;
    if (r == 0 && outlet) {  // the corner: row 1 was its scalar's neighbour
      T f2[9];
      load9(fin, n, cell - 1, f2);
      velocity(f2, rho2, ux2, uy2);
    }
  }

  // 3. the periodic push, less the entries a wall rule writes
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const I rd = wrap<I>(r + lbm::cx(k), R);
    const I cd = wrap<I>(c + lbm::cy(k), C);
    const unsigned m = owned(rd, cd, R, C, P);
    const I dst = rd * C + cd;
    if (!(m & (1u << k))) fout[k * n + dst] = fc[k];
    if (!(m & (1u << (9 + k)))) fout[(9 + k) * n + dst] = gc[k];
  }

  // 4. the fluid's rules at this cell, in the plain version's order
  T fo[9], go[9];
  if (c == 0 && lane) {  // inlet
#pragma unroll
    for (int k = 1; k < 9; ++k) fo[lbm::opp(k)] = -fc[k] + P.abb_in[k];
  }
  if (outlet) {  // outlet, from the start-of-step u of columns C-1, C-2
    const T uwx = T(1.5) * ux - T(0.5) * ux2;
    const T uwy = T(1.5) * uy - T(0.5) * uy2;
#pragma unroll
    for (int k = 1; k < 9; ++k) fo[lbm::opp(k)] = -fc[k] + lbm::abb_coefficient(k, uwx, uwy);
  }
  if (r == 0) {  // specular: outgoing 3, 6, 7 into spec_x 1, 5, 8
    fo[1] = fc[3]; fo[5] = fc[6]; fo[8] = fc[7];
  }
  if (r == R - 1) {  // bounce-back: outgoing 1, 5, 8 into 3, 7, 6
    fo[3] = fc[1]; fo[7] = fc[5]; fo[6] = fc[8];
  }
  const bool walls = r >= P.R23 + 1;
  const bool ceil = r == P.R23 && c >= P.C28 && c <= P.C38;
  if (walls && lane && c == P.C28) {
    fo[8] = fc[6]; fo[4] = fc[2]; fo[7] = fc[5];
  }
  if (ceil) {
    fo[6] = fc[8]; fo[3] = fc[1]; fo[7] = fc[5];
  }
  if (walls && lane && c == P.C38) {
    fo[5] = fc[7]; fo[2] = fc[4]; fo[6] = fc[8];
  }

  // 5. the scalar's rules at this cell, in the plain version's order
  if (c == 0 && lane) {  // ADE inlet at the cell's updated velocity
    fo[0] = fc[0];       // the rest population stays
    T rho_n, unx, uny;
    velocity(fo, rho_n, unx, uny);
    const T uwx = unx + P.w_s;
    const T uwy = uny + P.w_s;
    const T uu = uwx * uwx + uwy * uwy;
    const T cw = r >= R - P.inlet_rows ? P.c_w : T(0);
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      const T cu = lbm::cu(k, uwx, uwy);
      T t = T(1.0) + T(3.0) * cu;
      t = t + T(4.5) * cu * cu;
      t = t - T(1.5) * uu;
      go[lbm::opp(k)] = -gc[k] + T(2.0) * (t * T(lbm::weight(k)) * cw);
    }
  }
  if (walls && c == P.C28) {
    go[8] = -gc[6]; go[4] = -gc[2]; go[7] = -gc[5];
  }
  if (ceil) {
    go[6] = -gc[8]; go[3] = -gc[1]; go[7] = -gc[5];
  }
  if (walls && lane && c == P.C38) {
    go[5] = -gc[7]; go[2] = -gc[4]; go[6] = -gc[8];
  }
  if (r == R - 1) {
    go[3] = gc[1]; go[7] = gc[5]; go[6] = gc[8];
  }

  const unsigned m = owned(r, c, R, C, P);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (m & (1u << k)) fout[k * n + cell] = fo[k];
    if (m & (1u << (9 + k))) fout[(9 + k) * n + cell] = go[k];
  }
}

template <typename T>
Params<T> params(const double* d, const int* geom) {
  Params<T> P;
  P.omega = T(d[0]); P.one_m_omega = T(d[1]); P.w_s = T(d[2]); P.c_w = T(d[3]);
  for (int k = 0; k < 9; ++k) P.abb_in[k] = T(d[4 + k]);
  P.R23 = geom[0]; P.C28 = geom[1]; P.C38 = geom[2]; P.inlet_rows = geom[3];
  return P;
}

// Whether the kernel's offsets, up to 18 planes of n cells, fit int32_t.
constexpr bool fits32(int64_t n) { return n <= 0x7fffffff / 18; }

// The most threads a block of type T takes (lbm::launch_cells sizes it from
// there): 128 in float64, where a thread holds 128 registers and blocks of
// 128 ran 256x320 in 7.8 us against 8.6 for blocks of 256 (H100).
template <typename T>
constexpr int KERNEL17_MAX_THREADS = sizeof(T) == 8 ? 128 : 256;

// Kernel 17 through lbm::launch_cells: blocks sized to the card (at most
// KERNEL17_MAX_THREADS), a programmatic dependent launch where the grid
// fits it in one wave (each instance with its own occupancy in
// launch_cells' cache); 32-bit indices where the state's offsets fit them.
template <typename T>
int launch(const void* fin, void* fout, long long R, long long C, const double* d,
           const int* geom, cudaStream_t stream) {
  const Params<T> P = params<T>(d, geom);
  if (R < 4 || C < 4 || P.R23 < 1 || P.R23 > R - 2 || P.C28 < 1 || P.C28 > P.C38 ||
      P.C38 > C - 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(R) * C;
  const T* in = static_cast<const T*>(fin);
  T* out = static_cast<T*>(fout);
  constexpr int MAXT = KERNEL17_MAX_THREADS<T>;
  if (fits32(n))
    return static_cast<int>(lbm::launch_cells<sediment_kernel<T, int32_t>, MAXT>(
        n, stream, in, out, static_cast<int32_t>(R), static_cast<int32_t>(C), P));
  return static_cast<int>(lbm::launch_cells<sediment_kernel<T, int64_t>, MAXT>(
      n, stream, in, out, static_cast<int64_t>(R), static_cast<int64_t>(C), P));
}

// The instance of type T and index type I at n cells as the card reports
// it, into out[0..6]: registers, local bytes a thread, threads a block,
// resident blocks per SM, blocks, 1 where the grid fits the card in one
// wave (launch_cells then makes it a programmatic dependent launch), and the
// index bits.
template <typename T, typename I>
int describe_instance(long long n, long long* out) {
  const auto kernel = sediment_kernel<T, I>;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  int sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = lbm::sm_count(sms);
  const int fit = lbm::block_threads(n, sms);
  const int threads = fit < KERNEL17_MAX_THREADS<T> ? fit : KERNEL17_MAX_THREADS<T>;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                          threads, 0);
  const long long blocks = (n + threads - 1) / threads;
  out[0] = a.numRegs;
  out[1] = static_cast<long long>(a.localSizeBytes);
  out[2] = threads;
  out[3] = per_sm;
  out[4] = blocks;
  out[5] = blocks <= static_cast<long long>(per_sm) * sms;
  out[6] = 8 * static_cast<long long>(sizeof(I));
  return static_cast<int>(e);
}

// The instance that `launch` takes for type T at n cells.
template <typename T>
int describe(long long n, long long* out) {
  return fits32(n) ? describe_instance<T, int32_t>(n, out) : describe_instance<T, int64_t>(n, out);
}

}  // namespace

// One sedimentation step S_in -> S_out (18, R, C; distinct buffers) on
// `stream`.  `consts` holds 13 scalars already rounded to the state's type,
// in the order of kernels/sediment.py::sediment_constants: omega,
// 1 - omega, w_s, C_w, the inlet's ABB coefficients (9); `geom` the four
// ints R23, C28, C38, inlet_rows.  Returns the cudaError_t of the launch
// (0 = accepted).
extern "C" int lbm_sediment(const void* fin, void* fout, long long R, long long C,
                            const double* consts, const int* geom, int is_f64,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(fin, fout, R, C, consts, geom, s)
                : launch<float>(fin, fout, R, C, consts, geom, s);
}

// Kernel 17's instance of type `is_f64` launched over `n` cells, as the
// card reports it, into out[0..6] (describe_instance above).
extern "C" int lbm_sediment_describe(long long n, int is_f64, long long* out) {
  return is_f64 ? describe<double>(n, out) : describe<float>(n, out);
}
