// Kernel 12: one RK (Rothman-Keller / Reis-Phillips) colour-gradient mixture
// step, (11, R, C) -> (11, R, C), state [f (9), r_rho, b_rho].
//
// Replaces the TPU kernel lbm_tpu/kernels/rk_pallas.py:163
// make_rk_fused_step (body make_rk_body :130, collision _make_collide :31).
// The arithmetic is the plain version kernels/rk.py::make_collide, operation
// for operation in the same order, built with -fmad=false
// (kernels/_build.py UNIT_FLAGS): each operation rounds once, as the plain
// version's elementwise ops do, so the two agree bit for bit.  One step:
// omega_rp and alpha/phi per cell, the 5x5 replicate-padded colour gradient
// taken once on r_rho/rho, BGK + Guo gravity + the Reis perturbation in
// opposite-pair even/odd parts, the +/-beta recolouring, per-colour streaming
// with the multiphase walls (the rule of kernel 6), and the colour sums.
//
// Design: the tile engine of kernels 6-8 (csrc/mrtcg.cuh), not a second
// one.  A block owns a TY x TX tile and works in three stages, each ended by
// __syncthreads(): (1) r_rho/rho on the tile plus a halo of 3 (the stencil's
// 2 and the ring's 1) into a mrtcg::Window, its wrapped "seam" columns
// filled by the edge blocks; (2) the collision of every cell of the tile
// plus a 1-cell ring (columns wrap, rows end at the walls), 18 per-colour
// values into shared memory; (3) each tile cell pulls its streamed values
// with mrtcg::pull_source, writes f = red + blue per direction and the two
// colour sums in ascending k.  One writer per output entry, no atomics.
// In float64 the tile is staged (STAGED): a stage 0 issues every load of
// stages 1 and 2 at once as a cp.async into shared memory, in two groups
// (the window's two colour densities, then the ring cells' 11 planes);
// stage 1 runs on the first group while the second arrives, and each
// collision reads its 11 inputs from shared memory and writes its 18 values
// over them.  In float32 stages 1 and 2 load into registers.
//
// This source also holds kernel 30, lbm_halo_rk: the same step on a row
// shard with halo inputs (csrc/halo.cuh, kernels/sharded.py), its memory
// by global row (lbm::halo::ShardIO) as kernel 29's; it replaces
// lbm_tpu/kernels/sharded_pallas.py:486 make_sharded_rk_step.  Kernel 30
// runs a call (one step) over up to MAX_SHARDS row shards of a card in one
// launch (rk_halo_shards: blockIdx.z the shard, the shards' halo::Launch a
// __grid_constant__ parameter), each reading its neighbours' 3 edge rows
// in place from parallel/halo.py ring_rows' views at their own plane
// strides, edge and interior shards in one launch as kernel 37's.
// Measured (H100 80GB HBM3, 700 W; chip_smoke.py --k17-k30, CUDA graphs,
// in turns; us a call at 1024x256 on 8 shards, then at 4096x2048): float32
// 18.5 and 438, float64 26.2 and 674, against the first design's launch a
// shard from exchange_rows' copies, 76.9 / 545 and 92.9 / 757.  Fed the
// exchange's copies, the batch takes 50.4 us (float32); launched a shard
// at a time, the reads in place 42.7.  Float32 is capped at five blocks an
// SM (48 registers; uncapped 80 and three blocks: 19.2 us, 552); the
// masked instance for every shard in float32 lost (20.0 us, 576 uncapped).  And kernel
// 37, lbm_halo2d_rk: the step on rows x cols shards (csrc/halo2d.cuh,
// kernels/sharded2d.py make_sharded2d_rk_step), its rows by global index
// and its columns the shard's padded ones (mrtcg::BandCols: values read in
// the padded block, the stencil's clamp and the column repair at the
// grid's global columns 0 and C-1); it replaces
// lbm_tpu/kernels/sharded2d_pallas.py:432 make_sharded2d_rk_step on
// make_local_2d_body_step (:392, its pallas_call at :411).
//
// Kernel 37 runs a call (one step) over up to MAX_SHARDS shards of a card
// in one launch (rk_cg_shards: blockIdx.z the shard, the shards'
// halo2d::PartsLaunch a __grid_constant__ parameter), each padded block
// read in place from parallel/halo.py ring_2d's 3 x 3 parts
// (halo2d::PartsIO; the float64 stage's cp.async copies issued from the
// parts' addresses), edge and interior shards in one launch, through
// lbm::launch_grid with the tile's dynamic shared memory (a dependent
// launch only where the batch fits one wave: rk_rayleigh_taylor's 1024x256
// on (4, 2) is 1,024 blocks).  Measured (H100 80GB HBM3, 700.00 W;
// chip_smoke.py --k37-k14, CUDA graphs, in turns; us a call at 1024x256
// on (4, 2), then ms at 4096x2048): float32 19.40 and 0.539, float64 27.77
// and 0.712, against the first design's launch a shard from exchange_2d's
// copies, 116.98 / 0.591 and 135.91 / 0.825.  Of the levers, fed the
// exchange's copies the batch takes 89.45 us (float32), launched a shard at
// a time the reads in place 44.24.  Per type the faster of two designs for
// edge and interior shards: in float32 a branch per block on its shard's
// edge flag (the masked instance for every shard 21.67 us, 0.635 ms, at 72
// registers against 64), in float64 the masked instance for every shard
// (the branch 29.67 us, 0.708 ms).  Float64 is capped at three blocks an
// SM, kernel 12's occupancy (78 registers; uncapped, 100 registers leave
// two: 33.80 us, 0.818 ms); float32 stays uncapped (capped at five blocks
// an SM, 48 registers: 21.52 us, though 0.496 ms at 4096x2048).  Slower
// too, and dropped: the parts copied into shared memory once a block (it
// freed no register; PERF.md section 6).
//
// Bound: device-memory bytes.  88 B/cell in float32 (11 planes read once,
// 11 written once), 176 in float64, against 416 operations per cell
// counted on the plain version (chip_smoke.py phase 6); at 4096x2048 the
// bytes alone take 0.220 ms at 3.35 TB/s (0.441 in float64), at the RK
// scene's 1024x256 6.9 us (13.8).  Measured on an H100 80GB HBM3 at 700 W,
// CUDA graphs of 100 calls, in turns with the tile that loads into
// registers in both types (chip_smoke.py --rk-breakdown; PERF.md section
// 6): float64 27.9 us at 1024x256 (0.49 of the bound) and 0.652 ms at
// 4096x2048 (0.68), against 28.9 and 0.712; float32 15.7 us (0.44) and
// 0.429 ms (0.51).  Staging the loads pays in float64, where a block
// holds 80 registers and three blocks share an SM, so a tile's loads
// otherwise wait on one another; in float32 (five blocks an SM) the staged
// tile is slower, 16.8 us and 0.454 ms.  Slower too, the same bits
// (chip_smoke.py RK_DESIGNS): one copy group in float64, and in both types
// the window loop unrolled and taps computed once a cell.  What bounds
// float32: at 1024x256 the collisions (1.33 a cell, ~6 us) and stage 1
// (3.9 us); at 4096x2048 the 22 plane streams (0.36-0.37 ms without the
// collisions).

#include "mrtcg.cuh"  // and async_copy.cuh

namespace {

using lbm::cx;
using lbm::cy;
using lbm::pair_km;
using lbm::pair_kp;
using lbm::weight;
using lbm::wrap;
namespace mc = lbm::mrtcg;

constexpr int H = 3;  // the 5x5 stencil's 2 plus the ring's 1
using Win = mc::Window<H>;

// Scalars of the step, in the order kernels/rk.py::kernel_params writes them.
enum P { R_ALPHA, B_ALPHA, R_NU, B_NU, A_SIGMA, BETA, SOURCE, GX, GY,
         CF0, CF1, CF2, CF3, CF3_0, CF3_1, CF3_2, CF3_3, NPARAM };

template <typename T>
struct Params {
  T v[NPARAM];
};

// Unit velocity set (core/lattice.py UNIT_C) of the pair leaders 1, 2, 5, 8.
__host__ __device__ constexpr double ncx(int i) {
  return i == 0 ? 1.0 : i == 1 ? 0.0 : mc::UNIT_DIAG;
}
__host__ __device__ constexpr double ncy(int i) {
  return i == 0 ? 0.0 : i == 1 ? 1.0 : i == 2 ? mc::UNIT_DIAG : -mc::UNIT_DIAG;
}

// The collision of one cell (kernels/rk.py::make_collide): red in out[0..8],
// blue in out[9..17].
template <typename T, bool EDGE, typename Cols>
__device__ __forceinline__ void collide_cell(const T* __restrict__ in, int64_t n,
                                             int64_t cell, const Params<T>& p,
                                             const T* s_af, const Win& w, int64_t gr,
                                             int64_t gc, int64_t R, const Cols cols,
                                             T out[18]) {
  T f[9];
  lbm::load9(in, n, cell, f);
  const T r_rho = in[9 * n + cell];
  const T b_rho = in[10 * n + cell];
  const T rho = r_rho + b_rho;
  const T inv_rho = T(1.0) / rho;
  const T mx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8];
  const T my = f[2] - f[4] + f[5] + f[6] - f[7] - f[8];
  const T ux = mx * inv_rho;
  const T uy = my * inv_rho;
  const T uu = ux * ux + uy * uy;

  const T omega = rho / (T(3.0) * (r_rho * p.v[R_NU] + b_rho * p.v[B_NU]) + T(0.5) * rho);
  const T alpha = (p.v[R_ALPHA] * r_rho + p.v[B_ALPHA] * b_rho) * inv_rho;
  const T phi_ax = T(0.2) - T(0.2) * alpha;
  const T phi_di = T(0.05) - T(0.05) * alpha;

  const T Fx = mc::corr5<0, T, H, EDGE>(s_af, w, gr, gc, R, cols);
  const T Fy = mc::corr5<1, T, H, EDGE>(s_af, w, gr, gc, R, cols);
  const T Fn = sqrt(Fx * Fx + Fy * Fy);
  const T inv_Fn = T(1.0) / (Fn + T(1e-20));

  const T C_kl = T(1.0) - fabs((r_rho - b_rho) * inv_rho);
  const T A_kl = p.v[A_SIGMA] * omega;
  const T AC = A_kl * C_kl * Fn;
  const T inv_F2 = T(1.0) / (T(1e-20) + Fn * Fn);

  const T rb = r_rho * b_rho * inv_rho;
  const T ratio_r = r_rho * inv_rho;
  const T ratio_b = b_rho * inv_rho;
  const T cu_p[4] = {ux, uy, ux + uy, ux - uy};
  const T Fc_p[4] = {Fx, Fy, Fx + Fy, Fx - Fy};
  const T one_m = T(1.0) - omega;
  const T pref = T(1.0) - T(0.5) * omega;
  const bool source = p.v[SOURCE] != T(0);
  const T uF3 = T(3.0) * (ux * p.v[GX] + uy * p.v[GY]);
  const T uu15 = T(1.5) * uu;
  const T beta = p.v[BETA];

  T post0 = one_m * f[0] + omega * (rho * (alpha - T(weight(0)) * uu15)) +
            AC * T(-mc::b_cg(0));
  if (source) post0 = post0 + pref * (-uF3) * T(weight(0));
  out[0] = ratio_r * post0;
  out[9] = ratio_b * post0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = pair_kp(i), km = pair_km(i);
    const T phi = i < 2 ? phi_ax : phi_di;
    const T wk = T(weight(kp));
    const T cu = cu_p[i];
    const T even_f = omega * (rho * (phi + wk * (T(4.5) * cu * cu - uu15)));
    const T odd_f = omega * (rho * (T(3.0 * weight(kp)) * cu));
    const T Fc = Fc_p[i];
    const T omega2 = AC * (wk * Fc * Fc * inv_F2 - T(mc::b_cg(kp)));
    T base_p = one_m * f[kp] + (even_f + odd_f) + omega2;
    T base_m = one_m * f[km] + (even_f - odd_f) + omega2;
    if (source) {
      const T pw = pref * wk;
      const T even_s = pw * (T(9.0) * cu * p.v[CF0 + i] - uF3);
      const T odd_s = pw * p.v[CF3_0 + i];
      base_p = base_p + (even_s + odd_s);
      base_m = base_m + (even_s - odd_s);
    }
    const T kap = rb * (T(ncx(i)) * Fx + T(ncy(i)) * Fy) * inv_Fn * phi;
    const T kap_m = -kap;
    out[kp] = ratio_r * base_p + beta * kap;
    out[9 + kp] = ratio_b * base_p - beta * kap;
    out[km] = ratio_r * base_m + beta * kap_m;
    out[9 + km] = ratio_b * base_m - beta * kap_m;
  }
}

// Whether a tile's loads are staged: in float64 every load of stages 1-2
// (the window's colour densities, then the ring cells' 11 planes) is a
// cp.async issued at stage 0, in two groups, so that stage 1 runs while the
// planes arrive and the collisions read shared memory; in float32 stage 1
// loads the window and stage 2 each ring cell's planes into registers (the
// staged float32 tile measured slower: the note at the top).
template <typename T>
constexpr bool STAGED = sizeof(T) == 8;

// Shared memory: r_rho / rho on the window, the 18 post-collision values on
// the ring (staged: its 11 input planes first, in place), and staged the
// window's two colour densities.
template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * ((STAGED<T> ? 3 : 1) * Win::N + 18 * mc::RING_N);
}

// One TY x TX tile of a launch, tile (blockIdx.x, blockIdx.y) of the rows
// `rows` and the columns `cols`, memory `io`: the body of kernels 12, 30 and
// 37.
template <typename T, typename IO, bool EDGE, typename Cols>
__device__ __forceinline__ void rk_tile(const IO& io, const mc::Rows& rows, const Cols& cols,
                                        const Params<T>& p) {
  using mc::RING_C;
  using mc::RING_N;
  using mc::TX;
  using mc::TY;
  extern __shared__ unsigned char smem_raw[];
  T* s_af = reinterpret_cast<T*>(smem_raw);
  T* s_ring = s_af + Win::N;

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

  // (stage 0's window loop is written apart from float32's stage 1: one
  // loop shared by both cost the float32 kernel a register and 0.7%)
  if constexpr (STAGED<T>) {
    // stage 0: the copies, each issued at once: the colour densities on the
    // window (main columns, then the seam), then the ring cells' 11 planes
    T* s_rb = s_ring + 18 * RING_N;  // r_rho, then b_rho, on the window
    auto copy_rb = [&](int64_t gr, int64_t gc, int slot) {
      int64_t plane;
      const T* q = io.src(gr, gc, plane);
      lbm::async_copy(s_rb + slot, q + 9 * plane);
      lbm::async_copy(s_rb + Win::N + slot, q + 10 * plane);
    };
    for (int i = tid; i < Win::ROWS * Win::MAIN; i += mc::THREADS) {
      const int wr = i / Win::MAIN, wc = i % Win::MAIN;
      const int64_t gr = r0 - H + wr, gc = c0 - H + wc;
      if (readable(gr, gc)) copy_rb(gr, gc, wr * Win::COLS + wc);
    }
    if (left || right) {
      for (int i = tid; i < Win::ROWS * H; i += mc::THREADS) {
        const int wr = i / H, q = i % H;
        const int64_t gr = r0 - H + wr, gc = w.seam_lo + q;
        if (readable(gr, gc)) copy_rb(gr, gc, wr * Win::COLS + Win::MAIN + q);
      }
    }
    lbm::async_commit();
    const int64_t nrows = rows.o_hi - r0 < TY ? rows.o_hi - r0 : TY;
    const int64_t ncols = cols.end() - c0 < TX ? cols.end() - c0 : TX;
    for (int i = tid; i < RING_N; i += mc::THREADS) {
      const int ri = i / RING_C, rj = i % RING_C;
      const int64_t gr = r0 - 1 + ri;
      if (ri > nrows + 1 || rj > ncols + 1 || gr < rows.rd_lo || gr >= rows.rd_hi) continue;
      int64_t plane;
      const T* q = io.src(gr, cols.ring(c0 - 1 + rj), plane);
#pragma unroll
      for (int k = 0; k < 11; ++k) lbm::async_copy(s_ring + k * RING_N + i, q + k * plane);
    }
    lbm::async_commit();
    lbm::async_wait_prior<1>();
    __syncthreads();
    // stage 1: r_rho / rho on the window while the planes arrive (a slot no
    // copy filled is never read)
    for (int i = tid; i < Win::N; i += mc::THREADS) {
      const T r_rho = s_rb[i];
      const T rho = r_rho + s_rb[Win::N + i];
      s_af[i] = r_rho * (T(1.0) / rho);
    }
    lbm::async_wait_all();
  } else {
    // stage 1: r_rho / rho on the window (main columns, then the seam)
    auto a_frac = [&](int64_t gr, int64_t gc, int slot) {
      int64_t plane;
      const T* q = io.src(gr, gc, plane);
      const T r_rho = q[9 * plane];
      const T rho = r_rho + q[10 * plane];
      s_af[slot] = r_rho * (T(1.0) / rho);
    };
    for (int i = tid; i < Win::ROWS * Win::MAIN; i += mc::THREADS) {
      const int wr = i / Win::MAIN, wc = i % Win::MAIN;
      const int64_t gr = r0 - H + wr, gc = c0 - H + wc;
      if (readable(gr, gc)) a_frac(gr, gc, wr * Win::COLS + wc);
    }
    if (left || right) {
      for (int i = tid; i < Win::ROWS * H; i += mc::THREADS) {
        const int wr = i / H, q = i % H;
        const int64_t gr = r0 - H + wr, gc = w.seam_lo + q;
        if (readable(gr, gc)) a_frac(gr, gc, wr * Win::COLS + Win::MAIN + q);
      }
    }
  }
  __syncthreads();

  // stage 2: the collision on the tile plus a 1-cell ring (staged: from
  // shared memory, each ring slot's 18 values over its own 11 inputs)
  const int64_t nrows = rows.o_hi - r0 < TY ? rows.o_hi - r0 : TY;
  const int64_t ncols = cols.end() - c0 < TX ? cols.end() - c0 : TX;
  for (int i = tid; i < RING_N; i += mc::THREADS) {
    const int ri = i / RING_C, rj = i % RING_C;
    const int64_t gr = r0 - 1 + ri;
    if (ri > nrows + 1 || rj > ncols + 1 || gr < rows.rd_lo || gr >= rows.rd_hi) continue;
    const int64_t gc = cols.ring(c0 - 1 + rj);
    int64_t plane;
    const T* q;
    if constexpr (STAGED<T>) {
      plane = RING_N;
      q = s_ring + i;
    } else {
      q = io.src(gr, gc, plane);
    }
    T coll[18];
    collide_cell<T, EDGE>(q, plane, 0, p, s_af, w, gr, gc, R, cols, coll);
#pragma unroll
    for (int k = 0; k < 18; ++k) s_ring[k * RING_N + i] = coll[k];
  }
  __syncthreads();

  // stage 3: pull, add the colours, sum each colour in ascending k
  const int ty = tid / TX, tx = tid % TX;
  if (ty >= nrows || tx >= ncols) return;
  const int64_t gr = r0 + ty, gc = c0 + tx;
  int64_t plane;
  T* q = io.dst(gr, gc, plane);
  T r_sum = T(0), b_sum = T(0);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const mc::PullSource src = mc::pull_source<EDGE>(k, ty, tx, gr, cols.global(gc), R, C);
    const T r = s_ring[src.plane * RING_N + src.slot];
    const T b = s_ring[(9 + src.plane) * RING_N + src.slot];
    q[k * plane] = r + b;
    r_sum = k == 0 ? r : r_sum + r;
    b_sum = k == 0 ? b : b_sum + b;
  }
  q[9 * plane] = r_sum;
  q[10 * plane] = b_sum;
}

template <typename T, typename IO, bool EDGE, typename Cols>
__global__ void __launch_bounds__(mc::THREADS)
    rk_cg_kernel(const IO io, const mc::Rows rows, const Cols cols, const Params<T> p) {
  rk_tile<T, IO, EDGE>(io, rows, cols, p);
}

// The shards of one launch of kernel 30 or 37: up to MAX_SHARDS shards of
// one device and type (kernels/_build.py MAX_SHARDS), one a grid layer
// (blockIdx.z), a __grid_constant__ kernel parameter.
constexpr int MAX_SHARDS = 8;

template <typename L>
struct Shards {
  L s[MAX_SHARDS];
};

// 8 shards' geometries and the scalars fit the 4 KB of kernel parameters
// that every toolkit takes (3,144 bytes in float64).
static_assert(sizeof(Shards<lbm::halo2d::PartsLaunch<double>>) + sizeof(Params<double>) <= 4096,
              "kernel 37's parameters exceed 4 KB");

// Kernel 37: one sweep on each of up to MAX_SHARDS rows x cols shards, each
// read in place from its 3 x 3 parts (PartsIO).  Tiles of shard blockIdx.z
// cover its output band; a block past it leaves at once.  Edge and interior
// shards share the launch: in float32 a block takes its shard's instance, a
// branch uniform over the block; in float64 every block the masked one,
// which gives the mask-free one's bits on an interior shard (no row clamps
// and no wall rows there).  Float64 is held to kernel 12's occupancy, three
// blocks an SM (the note at the top).
template <typename T>
__global__ void __launch_bounds__(mc::THREADS, sizeof(T) == 8 ? 3 : 1)
    rk_cg_shards(const __grid_constant__ Shards<lbm::halo2d::PartsLaunch<T>> shards,
                 const Params<T> p) {
  using IO = lbm::halo2d::PartsIO<T>;
  const lbm::halo2d::PartsLaunch<T>& L = shards.s[blockIdx.z];
  const mc::Rows rows = mc::halo2d_rows(L);
  const mc::BandCols cols = mc::halo2d_cols(L);
  if (rows.o_lo + static_cast<int64_t>(blockIdx.y) * mc::TY >= rows.o_hi ||
      cols.first() + static_cast<int64_t>(blockIdx.x) * mc::TX >= cols.end())
    return;
  lbm::grid_wait();
  const IO io{L};
  if (L.edge || sizeof(T) == 8)
    rk_tile<T, IO, true>(io, rows, cols, p);
  else
    rk_tile<T, IO, false>(io, rows, cols, p);
}

// Kernel 30's instance of type T: the resident blocks an SM its registers
// must allow.  Three in float64, as kernel 12's (its shared memory allows no
// more); five in float32, 48 registers where it would take 80 (3 blocks an
// SM): 18.5 against 19.2 us a call at 1024x256 on 8 shards and 438 against
// 552 us at 4096x2048 (H100).
template <typename T>
constexpr int KERNEL30_MIN_BLOCKS = sizeof(T) == 8 ? 3 : 5;

// Kernel 30: one sweep on each of up to MAX_SHARDS row shards, each read in
// place from its three buffers (ShardIO: the neighbours' edge rows at their
// own plane strides, or the exchange's copies).  Tiles of shard blockIdx.z
// cover its output rows; a block past them leaves at once.  Edge and
// interior shards share the launch as kernel 37's do: a branch per block on
// the shard's edge flag in float32, the masked instance for every shard in
// float64 (an interior shard's band reaches neither wall row, so it gives
// the mask-free one's bits).  MINB: KERNEL30_MIN_BLOCKS.
template <typename T, int MINB>
__global__ void __launch_bounds__(mc::THREADS, MINB)
    rk_halo_shards(const __grid_constant__ Shards<lbm::halo::Launch<T>> shards,
                   const Params<T> p) {
  using IO = lbm::halo::ShardIO<T>;
  const lbm::halo::Launch<T>& L = shards.s[blockIdx.z];
  const mc::Rows rows = mc::halo_rows(L);
  const mc::PeriodicCols cols{L.in.C};
  if (rows.o_lo + static_cast<int64_t>(blockIdx.y) * mc::TY >= rows.o_hi ||
      static_cast<int64_t>(blockIdx.x) * mc::TX >= cols.end())
    return;
  lbm::grid_wait();
  const IO io{L.in, L.out, L.off};
  if (L.edge || sizeof(T) == 8)
    rk_tile<T, IO, true>(io, rows, cols, p);
  else
    rk_tile<T, IO, false>(io, rows, cols, p);
}

static_assert(sizeof(Shards<lbm::halo::Launch<double>>) + sizeof(Params<double>) <= 4096,
              "kernel 30's parameters exceed 4 KB");

template <typename T, typename IO, bool EDGE, typename Cols>
int launch_rows(const IO& io, const mc::Rows& rows, const Cols cols, const double* params,
                cudaStream_t stream) {
  const int64_t width = cols.end() - cols.first();
  if (rows.o_hi <= rows.o_lo || width <= 0) return 0;
  Params<T> p;
  for (int i = 0; i < NPARAM; ++i) p.v[i] = static_cast<T>(params[i]);
  constexpr size_t smem = smem_bytes<T>();
  static bool configured[lbm::MAX_DEVICES] = {};
  const cudaError_t e = lbm::smem_opt_in(rk_cg_kernel<T, IO, EDGE, Cols>,
                                         static_cast<int>(smem), configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((width + mc::TX - 1) / mc::TX),
                  static_cast<unsigned>((rows.o_hi - rows.o_lo + mc::TY - 1) / mc::TY));
  rk_cg_kernel<T, IO, EDGE, Cols><<<grid, mc::THREADS, smem, stream>>>(io, rows, cols, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* in, void* out, long long R, long long C, const double* params,
           cudaStream_t stream) {
  if (R <= 0 || C <= 0) return 0;
  const mc::FlatIO<T> io{static_cast<const T*>(in), static_cast<T*>(out), R * C, C};
  return launch_rows<T, mc::FlatIO<T>, true>(io, mc::Rows{R, 0, R, 0, R}, mc::PeriodicCols{C},
                                             params, stream);
}

// Kernel 30: one sweep over `n` row shards of one device, their geometries
// `geoms` back to back (csrc/halo.cuh Geom): the tile grid of the largest
// output band, one grid layer a shard, through lbm::launch_grid (a
// programmatic dependent launch in one wave).
template <typename T>
int launch_halo(const long long* geoms, int n, const double* params, cudaStream_t stream) {
  using L = lbm::halo::Launch<T>;
  if (n < 1 || n > MAX_SHARDS) return static_cast<int>(cudaErrorInvalidValue);
  Shards<L> shards;
  int64_t gx = 0, gy = 0;
  for (int b = 0; b < n; ++b) {
    const L& s = shards.s[b] = lbm::halo::parse<T>(geoms + b * lbm::halo::NGEOM);
    if (s.R < 4 || s.in.C < 3) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t height = s.out.hi - s.out.lo;
    if (height <= 0) continue;
    gx = (s.in.C + mc::TX - 1) / mc::TX > gx ? (s.in.C + mc::TX - 1) / mc::TX : gx;
    gy = (height + mc::TY - 1) / mc::TY > gy ? (height + mc::TY - 1) / mc::TY : gy;
  }
  if (gx <= 0 || gy <= 0) return 0;
  if (gx > 0x7fffffff || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Params<T> p;
  for (int i = 0; i < NPARAM; ++i) p.v[i] = static_cast<T>(params[i]);
  constexpr int MINB = KERNEL30_MIN_BLOCKS<T>;
  constexpr size_t smem = smem_bytes<T>();
  static bool configured[lbm::MAX_DEVICES] = {};
  const cudaError_t e =
      lbm::smem_opt_in(rk_halo_shards<T, MINB>, static_cast<int>(smem), configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy), static_cast<unsigned>(n));
  return static_cast<int>(lbm::launch_grid<rk_halo_shards<T, MINB>>(grid, mc::THREADS, smem,
                                                                      stream, shards, p));
}

// Kernel 37: one sweep over `n` shards of one device, their parts
// geometries `geoms` back to back (csrc/halo2d.cuh PartsGeom): the tile grid
// of the largest output band, one grid layer a shard, through
// lbm::launch_grid (a programmatic dependent launch in one wave).
template <typename T>
int launch_halo2d(const long long* geoms, int n, const double* params, cudaStream_t stream) {
  using L = lbm::halo2d::PartsLaunch<T>;
  if (n < 1 || n > MAX_SHARDS) return static_cast<int>(cudaErrorInvalidValue);
  Shards<L> shards;
  int64_t gx = 0, gy = 0;
  for (int b = 0; b < n; ++b) {
    const L& s = shards.s[b] = lbm::halo2d::parse_parts<T>(geoms + b * lbm::halo2d::NPARTS_GEOM);
    if (s.R < 4 || s.C < 3) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t width = s.out.c_hi - s.out.c_lo, height = s.out.r_hi - s.out.r_lo;
    if (width <= 0 || height <= 0) continue;
    gx = (width + mc::TX - 1) / mc::TX > gx ? (width + mc::TX - 1) / mc::TX : gx;
    gy = (height + mc::TY - 1) / mc::TY > gy ? (height + mc::TY - 1) / mc::TY : gy;
  }
  if (gx <= 0 || gy <= 0) return 0;
  if (gx > 0x7fffffff || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Params<T> p;
  for (int i = 0; i < NPARAM; ++i) p.v[i] = static_cast<T>(params[i]);
  constexpr size_t smem = smem_bytes<T>();
  static bool configured[lbm::MAX_DEVICES] = {};
  const cudaError_t e = lbm::smem_opt_in(rk_cg_shards<T>, static_cast<int>(smem), configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy), static_cast<unsigned>(n));
  return static_cast<int>(
      lbm::launch_grid<rk_cg_shards<T>>(grid, mc::THREADS, smem, stream, shards, p));
}

}  // namespace

// One step in -> out (distinct buffers) on `stream`; `params` are the
// NPARAM doubles of kernels/rk.py::kernel_params.  Returns the cudaError_t
// of the launch (0 = accepted).
extern "C" int lbm_rk_cg(const void* in, void* out, long long R, long long C,
                         const double* params, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(in, out, R, C, params, s)
                : launch<float>(in, out, R, C, params, s);
}

// Kernel 30: one sweep of the step on each of `n_shards` (1 to MAX_SHARDS)
// row shards of one device, `geoms` their geometry arrays back to back
// (csrc/halo.cuh), `params` those of lbm_rk_cg.
extern "C" int lbm_halo_rk(const long long* geoms, const double* params, int n_shards, int, int,
                           int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_halo<double>(geoms, n_shards, params, s)
                : launch_halo<float>(geoms, n_shards, params, s);
}

// Kernel 37: one sweep of the step on each of `n_shards` (1 to MAX_SHARDS)
// rows x cols shards of one device, `geoms` their parts geometry arrays back
// to back (csrc/halo2d.cuh PartsGeom), `params` those of lbm_rk_cg.
extern "C" int lbm_halo2d_rk(const long long* geoms, const double* params, int n_shards, int,
                             int, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_halo2d<double>(geoms, n_shards, params, s)
                : launch_halo2d<float>(geoms, n_shards, params, s);
}

// Kernel 12's instance of type `is_f64` on the flat grid as the card reports
// it, into out[0..4]: registers, local bytes a thread, shared memory,
// threads and resident blocks per SM.
extern "C" int lbm_rk_describe(int is_f64, long long* out) {
  using mc::FlatIO;
  using mc::PeriodicCols;
  return static_cast<int>(
      is_f64 ? mc::describe_kernel(rk_cg_kernel<double, FlatIO<double>, true, PeriodicCols>,
                                   mc::THREADS, smem_bytes<double>(), out)
             : mc::describe_kernel(rk_cg_kernel<float, FlatIO<float>, true, PeriodicCols>,
                                   mc::THREADS, smem_bytes<float>(), out));
}

// Kernel 30's instance of type `is_f64` (rk_halo_shards) as the card reports
// it, into out[0..4]: registers, local bytes a thread, shared memory,
// threads and resident blocks per SM.
extern "C" int lbm_rk_halo_describe(int is_f64, long long* out) {
  return static_cast<int>(
      is_f64
          ? mc::describe_kernel(rk_halo_shards<double, KERNEL30_MIN_BLOCKS<double>>,
                                mc::THREADS, smem_bytes<double>(), out)
          : mc::describe_kernel(rk_halo_shards<float, KERNEL30_MIN_BLOCKS<float>>, mc::THREADS,
                                smem_bytes<float>(), out));
}
