// Kernel 14: one fully periodic Shan-Chen pseudopotential step,
// f (9, R, C) -> (9, R, C).
//
// Replaces the TPU kernel lbm_tpu/kernels/shan_chen_pallas.py:172
// make_sc_fused_step (body make_sc_body :138, force _sc_force :44,
// collision _collide_sc :71, psi of resolve_eos :109).  The arithmetic is
// the plain version kernels/shan_chen.py::make_collide, operation for
// operation in the same order, built with -fmad=false (kernels/_build.py
// UNIT_FLAGS) and without fast math (libdevice exp and IEEE sqrt), so the
// two agree bit for bit.  Template instances: EOS in {exponential,
// Carnahan-Starling} x forcing in {Guo, velocity shift}.  lbm_tpu fuses up
// to 4 steps per launch; here one launch is one step.
//
// Design: one thread per cell and PUSH streaming (each thread writes its 9
// post-collision values to the wrapped destinations, a bijection, so every
// entry has one writer).  The force at a cell needs psi at its 8
// neighbours, so a TY x TX block first computes psi once per cell of its
// tile plus a 1-cell halo (rho, then one exp, or the CS EOS with a
// division, a sqrt and a clamp) into shared memory, ends that stage with
// __syncthreads(), then collides each tile cell and pushes.  With push, the
// halo is 1 (pull would need the collisions of the ring and psi at a halo
// of 2).
//
// Bound: device-memory bytes.  72 B/cell in float32 (9 planes read once,
// 9 written once), 144 in float64, against 177 operations per cell
// (exponential EOS, Guo forcing; 137 for CS with the velocity shift)
// counted on the plain version (chip_smoke.py phase 6).  What the design
// pays over that: the halo's psi is computed again by the neighbour tiles
// (10x34 for 8x32 cells, 1.33x) from a second read of their planes (L2),
// one barrier per tile, and no multiply-add.
//
// The window's rows and columns wrap by one period (wrap_window; a
// remainder only on a grid shorter or narrower than a tile) and the pushes
// by lbm::wrap, and a step launches through lbm::launch_grid: a
// programmatic dependent launch where the grid fits the card in one wave
// (sc_flat_interface's 256x128 is 128 blocks), its threads waiting before
// their first load and each block releasing the next step at its exit.
// Measured (H100 80GB HBM3, 700.00 W; chip_smoke.py --k37-k14, CUDA graphs,
// in turns, sc/guo): at 256x128, 4 steps a call, 9.98 us a call in
// float32 (2.49 a launch) and 12.87 in float64, against the first design's
// 16.48 and 17.95; at 4096x2048 0.2820 / 0.4715 ms a step against 0.3556 /
// 0.5035.  Slower, the same bits: the 64-bit remainder for every window
// load and push (15.43 us a call at 256x128, 0.3546 ms at 4096x2048), the
// plain launch (11.96 us) and the release by each thread once its loads
// are issued (10.90 us).
//
// This source also holds kernel 32, lbm_halo_shan_chen: the same step on
// row shards with halo inputs (csrc/halo.cuh, kernels/sharded.py
// make_sharded_sc_step), which replaces lbm_tpu's Shan-Chen body
// (shan_chen_pallas.py:138 make_sc_body) on the row-sharded driver
// (sharded_pallas.py:345 make_sharded_body_step, its pallas_call at :321).
// A sweep reads the padded rows [in_lo, in_hi) through the three-buffer row
// view, computes psi there, collides the rows [in_lo + 1, in_hi - 1) (psi's
// stencil reaches one row further than the push) and pushes into
// [out_lo, out_hi): 2 rows of the strip per sweep, so at most 4 sweeps per
// 8-row exchange.  The collision is the same device function as kernel
// 14's (sc_collide), built with the same flags, so an n-shard run equals
// kernel 14 bit for bit.
//
// And kernel 35, lbm_halo2d_shan_chen: the step on rows x cols shards
// (csrc/halo2d.cuh, kernels/sharded2d.py make_sharded2d_sc_step), which
// replaces lbm_tpu's Shan-Chen body on its 2-D wrapper
// (sharded2d_pallas.py:549 make_sharded2d_sc_step on
// make_local_2d_body_step :392, its pallas_call at :411).  Kernel 32's
// sweep in both axes: psi on each tile window's readable cells of the
// padded block [in_r_lo, in_r_hi) x [in_c_lo, in_c_hi), the collision on
// that band less one line a side, the push into the output band; nothing
// wraps, since the block's parts hold the neighbours' lines.  2 lines a
// sweep in both axes, so at most 4 sweeps per exchange.
//
// Both run one sweep of up to MAX_SHARDS shards of a card in one launch
// (blockIdx.z the shard, their geometries a __grid_constant__ parameter,
// each shard with its own sweep bands), and a first sweep reads the ring
// neighbours' lines in place where they share the card: kernel 32 through
// the row view's per-buffer plane strides (parallel/halo.py ring_rows),
// kernel 35 through the 3 x 3 parts of halo2d.cuh's Parts (ring_2d); later
// sweeps read a scratch slab.  sc_phase_separation's 256x256 on 8 shards,
// 4 sweeps a call, was 32 launches and 16 exchange copies a call, each
// sweep a band of 40-50 blocks on a card of 132 SMs; it is now 4 launches
// and no copy.  Where the whole grid fits the card in one wave the launch
// is a programmatic dependent one (lbm::launch_grid, d2q9.cuh): its threads
// wait for the sweep before it ahead of their first load, and a block lets
// the next sweep launch when it exits.  Released by each thread once its
// loads were issued (kernel 4's choice) or at its start, a call of 4 sweeps
// at sc_phase_separation's 256x256 ran 1.5-7.0 us slower in float32 (H100,
// chip_smoke.py --k32-k35: the designs "release after loads" and "release
// first").

#include <cuda_runtime.h>

#include "d2q9.cuh"
#include "halo.cuh"
#include "halo2d.cuh"

namespace {

using lbm::cx;
using lbm::cy;
using lbm::pair_km;
using lbm::pair_kp;
using lbm::THREADS;
using lbm::TX;
using lbm::TY;
using lbm::weight;
using lbm::wrap_any;

constexpr int WR = TY + 2;
constexpr int WC = TX + 2;
constexpr int WN = WR * WC;

// Scalars of the step, in the order kernels/shan_chen.py::kernel_params
// writes them.
enum P { OMEGA, ONE_M_OMEGA, INV_OMEGA, MINUS_G, PREF_W0, PREF_W1, PREF_W5, CS_B4, CS_T,
         CS_A, NPARAM };

template <typename T>
struct Params {
  T v[NPARAM];
};

// psi(rho): 1 - exp(-rho), or the Carnahan-Starling pseudopotential
// sqrt(max(6 (rho/3 - P_cs), 0)) with the clamp as a comparison (a NaN
// stays a NaN).
template <typename T, bool CS>
__device__ __forceinline__ T psi_of(T rho, const Params<T>& p) {
  if (!CS) return T(1.0) - exp(-rho);
  const T eta = p.v[CS_B4] * rho;
  const T e2 = eta * eta;
  const T om = T(1.0) - eta;
  const T P = rho * p.v[CS_T] * (T(1.0) + eta + e2 - e2 * eta) / (om * om * om) -
              p.v[CS_A] * rho * rho;
  const T rad = T(6.0) * (rho * T(1.0 / 3.0) - P);
  return sqrt(rad < T(0.0) ? T(0.0) : rad);
}

// The force and the forced BGK collision of one cell from its 9
// populations and the psi window around it (`w0` its slot, rows WC apart).
template <typename T, bool CS, bool SHIFT>
__device__ __forceinline__ void sc_collide(const T f[9], const T* s_psi, int w0,
                                           const Params<T>& p, T out[9]) {
  T rho = f[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) rho = rho + f[k];

  // the paired neighbour force over the pair leaders 1, 2, 5, 8
  T fx = T(0), fy = T(0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = pair_kp(i);
    const T pos = s_psi[w0 + cx(kp) * WC + cy(kp)];
    const T neg = s_psi[w0 - cx(kp) * WC - cy(kp)];
    const T d = T(weight(kp)) * (pos - neg);
    if (cx(kp) != 0) {
      const T t = T(cx(kp)) * d;
      fx = i == 0 ? t : fx + t;
    }
    if (cy(kp) != 0) {
      const T t = T(cy(kp)) * d;
      fy = i == 1 ? t : fy + t;
    }
  }
  const T mg = p.v[MINUS_G] * s_psi[w0];
  const T Fx = mg * fx;
  const T Fy = mg * fy;

  const T inv_rho = T(1.0) / rho;
  const T mx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8];
  const T my = f[2] - f[4] + f[5] + f[6] - f[7] - f[8];
  const T half_or_inv = SHIFT ? p.v[INV_OMEGA] : T(0.5);
  const T ux = (mx + half_or_inv * Fx) * inv_rho;
  const T uy = (my + half_or_inv * Fy) * inv_rho;

  // forced BGK: the paired equilibrium (_bgk9), plus the paired Guo source
  const lbm::Pairs<T> pr = lbm::d2q9_pairs(ux, uy);
  const T om = p.v[OMEGA], one_m = p.v[ONE_M_OMEGA];
  out[0] = one_m * f[0] + om * (T(weight(0)) * rho * pr.t0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = pair_kp(i), km = pair_km(i);
    const T wr = T(weight(kp)) * rho;
    const T even = om * (wr * (pr.t0 + T(4.5) * pr.cc[i]));
    const T odd = om * (wr * (T(3.0) * pr.cu[i]));
    out[kp] = one_m * f[kp] + (even + odd);
    out[km] = one_m * f[km] + (even - odd);
  }
  if (!SHIFT) {
    const T uF3 = T(3.0) * (ux * Fx + uy * Fy);
    out[0] = out[0] - p.v[PREF_W0] * uF3;
    const T cf[4] = {Fx, Fy, Fx + Fy, Fx - Fy};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = pair_kp(i), km = pair_km(i);
      const T pw = i < 2 ? p.v[PREF_W1] : p.v[PREF_W5];
      const T even = pw * (T(9.0) * pr.cu[i] * cf[i] - uF3);
      const T odd = pw * (T(3.0) * cf[i]);
      out[kp] = out[kp] + (even + odd);
      out[km] = out[km] + (even - odd);
    }
  }
}

// A row or column of a tile window, c in [-1, n + TX], wrapped into [0, n)
// by one period, or, on a grid shorter or narrower than a tile, by a
// remainder.  Only addresses depend on it.  With a 64-bit remainder for
// every load and push, a call of 4 sweeps at 256x256 on 8 shards took 28-32
// us against 20-21 (H100, chip_smoke.py --k32-k35, the design "64-bit
// wraps").
__device__ __forceinline__ int64_t wrap_window(int64_t c, int64_t n) {
  if (c < 0) c += n;
  if (c >= n) c -= n;
  return c < n ? c : wrap_any(c, n);
}

template <typename T, bool CS, bool SHIFT>
__global__ void __launch_bounds__(THREADS)
    shan_chen_kernel(const T* __restrict__ fin, T* __restrict__ fout, int64_t R, int64_t C,
                     const Params<T> p) {
  __shared__ T s_psi[WN];
  const int64_t n = R * C;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * TY;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * TX;
  const int tid = threadIdx.x;

  // stage 1: psi on the tile plus a 1-cell halo
  lbm::grid_wait();
  for (int i = tid; i < WN; i += THREADS) {
    const int64_t gr = wrap_window(r0 - 1 + i / WC, R), gc = wrap_window(c0 - 1 + i % WC, C);
    const int64_t cell = gr * C + gc;
    T rho = fin[cell];
#pragma unroll
    for (int k = 1; k < 9; ++k) rho = rho + fin[k * n + cell];
    s_psi[i] = psi_of<T, CS>(rho, p);
  }
  __syncthreads();

  // stage 2: collide each tile cell and push
  const int ty = tid / TX, tx = tid % TX;
  const int64_t gr = r0 + ty, gc = c0 + tx;
  if (gr >= R || gc >= C) return;
  T f[9], out[9];
  lbm::load9(fin, n, gr * C + gc, f);
  sc_collide<T, CS, SHIFT>(f, s_psi, (ty + 1) * WC + (tx + 1), p, out);
#pragma unroll
  for (int k = 0; k < 9; ++k)
    fout[k * n + lbm::wrap(gr + cx(k), R) * C + lbm::wrap(gc + cy(k), C)] = out[k];
}

// The shards of one launch of kernel 32 or 35: up to MAX_SHARDS shards of
// one device and type (kernels/_build.py MAX_SHARDS), one a grid layer
// (blockIdx.z), a __grid_constant__ kernel parameter (~1.3 KB for 32, ~2.7
// KB for 35).
constexpr int MAX_SHARDS = 8;

template <typename L>
struct Shards {
  L s[MAX_SHARDS];
};

// Kernel 32: one sweep on each of up to MAX_SHARDS row shards.  Tiles of
// shard blockIdx.z cover the padded rows [in_lo + 1, in_hi - 1) that its
// sweep collides; psi is computed on the readable rows [in_lo, in_hi) of
// each tile's window, columns wrapped.  A block past its shard's rows
// leaves at once.
template <typename T, bool CS, bool SHIFT>
__global__ void __launch_bounds__(THREADS)
    shan_chen_halo(const __grid_constant__ Shards<lbm::halo::Launch<T>> shards,
                   const Params<T> p) {
  const lbm::halo::Launch<T>& L = shards.s[blockIdx.z];
  const lbm::halo::View<T>& in = L.in;
  const int64_t C = in.C, in_lo = L.in_lo, in_hi = L.in_hi;
  const int64_t r0 = in_lo + 1 + static_cast<int64_t>(blockIdx.y) * TY;
  if (r0 >= in_hi - 1) return;
  __shared__ T s_psi[WN];
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * TX;
  const int tid = threadIdx.x;

  lbm::grid_wait();
  for (int i = tid; i < WN; i += THREADS) {
    const int64_t pr = r0 - 1 + i / WC;
    if (pr < in_lo || pr >= in_hi) continue;  // read by no cell this sweep collides
    int64_t plane;
    const T* src = in.locate(pr, wrap_window(c0 - 1 + i % WC, C), plane);
    T rho = src[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) rho = rho + src[k * plane];
    s_psi[i] = psi_of<T, CS>(rho, p);
  }
  __syncthreads();

  const int ty = tid / TX, tx = tid % TX;
  const int64_t pr = r0 + ty, gc = c0 + tx;
  if (pr >= in_hi - 1 || gc >= C) return;
  int64_t plane;
  const T* src = in.locate(pr, gc, plane);
  T f[9], o[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = src[k * plane];
  sc_collide<T, CS, SHIFT>(f, s_psi, (ty + 1) * WC + (tx + 1), p, o);
  const lbm::halo::Out<T>& out = L.out;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int64_t pd = pr + cx(k);
    if (out.has(pd)) out.at(pd, lbm::wrap(gc + cy(k), C))[k * out.plane] = o[k];
  }
}

// Kernel 35: one sweep on each of up to MAX_SHARDS rows x cols shards, each
// read from its 3 x 3 parts.  Tiles of shard blockIdx.z cover the padded
// cells [r_lo + 1, r_hi - 1) x [c_lo + 1, c_hi - 1) that its sweep
// collides; psi is computed on each tile window's readable cells.
template <typename T, bool CS, bool SHIFT>
__global__ void __launch_bounds__(THREADS)
    shan_chen_halo2d(const __grid_constant__ Shards<lbm::halo2d::PartsLaunch<T>> shards,
                     const Params<T> p) {
  const lbm::halo2d::PartsLaunch<T>& L = shards.s[blockIdx.z];
  const lbm::halo2d::Parts<T>& in = L.in;
  const int64_t r_lo = L.r_lo, r_hi = L.r_hi, c_lo = L.c_lo, c_hi = L.c_hi;
  const int64_t r0 = r_lo + 1 + static_cast<int64_t>(blockIdx.y) * TY;
  const int64_t q0 = c_lo + 1 + static_cast<int64_t>(blockIdx.x) * TX;
  if (r0 >= r_hi - 1 || q0 >= c_hi - 1) return;
  __shared__ T s_psi[WN];
  const int tid = threadIdx.x;

  lbm::grid_wait();
  for (int i = tid; i < WN; i += THREADS) {
    const int64_t pr = r0 - 1 + i / WC, q = q0 - 1 + i % WC;
    if (pr < r_lo || pr >= r_hi || q < c_lo || q >= c_hi) continue;  // read by no cell
    int64_t plane;
    const T* src = in.locate(pr, q, plane);
    T rho = src[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) rho = rho + src[k * plane];
    s_psi[i] = psi_of<T, CS>(rho, p);
  }
  __syncthreads();

  const int ty = tid / TX, tx = tid % TX;
  const int64_t pr = r0 + ty, q = q0 + tx;
  if (pr >= r_hi - 1 || q >= c_hi - 1) return;
  int64_t plane;
  const T* src = in.locate(pr, q, plane);
  T f[9], o[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = src[k * plane];
  sc_collide<T, CS, SHIFT>(f, s_psi, (ty + 1) * WC + (tx + 1), p, o);
  const lbm::halo2d::Out<T>& out = L.out;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int64_t pd = pr + cx(k), qd = q + cy(k);
    if (out.has(pd, qd)) out.at(pd, qd)[k * out.plane] = o[k];
  }
}

// Kernel 14: one step through lbm::launch_grid (a programmatic dependent
// launch where the grid fits the card in one wave, released at each block's
// exit).
template <typename T, bool CS, bool SHIFT>
int launch_one(const T* fin, T* fout, long long R, long long C, const Params<T>& p,
               cudaStream_t stream) {
  const int64_t gy = (R + TY - 1) / TY;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((C + TX - 1) / TX), static_cast<unsigned>(gy));
  const int64_t rows = R, cols = C;
  return static_cast<int>(lbm::launch_grid<shan_chen_kernel<T, CS, SHIFT>>(
      grid, THREADS, 0, stream, fin, fout, rows, cols, p));
}

// One sweep of kernel 32 or 35 over `n` shards of one device, their
// geometries `geoms` back to back (NGEOM values each): the tile grid of the
// largest band (`tiles` gives a shard's (column tiles, row tiles)), one grid
// layer a shard, through lbm::launch_grid (a programmatic dependent launch
// in one wave).
template <auto KERNEL, typename L, int NGEOM, L (*PARSE)(const long long*), typename T,
          typename Tiles>
int launch_shards(const long long* geoms, int n, const Params<T>& p, cudaStream_t stream,
                  Tiles tiles) {
  if (n < 1 || n > MAX_SHARDS) return static_cast<int>(cudaErrorInvalidValue);
  Shards<L> shards;
  int64_t gx = 0, gy = 0;
  for (int b = 0; b < n; ++b) {
    shards.s[b] = PARSE(geoms + b * NGEOM);
    int64_t tx = 0, ty = 0;
    tiles(shards.s[b], tx, ty);
    gx = tx > gx ? tx : gx;
    gy = ty > gy ? ty : gy;
  }
  if (gx <= 0 || gy <= 0) return 0;
  if (gx > 0x7fffffff || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy), static_cast<unsigned>(n));
  return static_cast<int>(lbm::launch_grid<KERNEL>(grid, THREADS, 0, stream, shards, p));
}

template <typename T, bool CS, bool SHIFT>
int launch_halo_one(const long long* geoms, int n, const Params<T>& p, cudaStream_t stream) {
  using L = lbm::halo::Launch<T>;
  return launch_shards<shan_chen_halo<T, CS, SHIFT>, L, lbm::halo::NGEOM, lbm::halo::parse<T>>(
      geoms, n, p, stream, [](const L& s, int64_t& tx, int64_t& ty) {
        const int64_t rows = s.in_hi - s.in_lo - 2;
        tx = rows > 0 ? (s.in.C + TX - 1) / TX : 0;
        ty = rows > 0 ? (rows + TY - 1) / TY : 0;
      });
}

template <typename T, bool CS, bool SHIFT>
int launch_halo2d_one(const long long* geoms, int n, const Params<T>& p, cudaStream_t stream) {
  using L = lbm::halo2d::PartsLaunch<T>;
  return launch_shards<shan_chen_halo2d<T, CS, SHIFT>, L, lbm::halo2d::NPARTS_GEOM,
                       lbm::halo2d::parse_parts<T>>(
      geoms, n, p, stream, [](const L& s, int64_t& tx, int64_t& ty) {
        const int64_t rows = s.r_hi - s.r_lo - 2, cols = s.c_hi - s.c_lo - 2;
        tx = rows > 0 && cols > 0 ? (cols + TX - 1) / TX : 0;
        ty = rows > 0 && cols > 0 ? (rows + TY - 1) / TY : 0;
      });
}

template <typename T>
Params<T> params_of(const double* params) {
  Params<T> p;
  for (int i = 0; i < NPARAM; ++i) p.v[i] = static_cast<T>(params[i]);
  return p;
}

template <typename T>
int launch(const void* fin, void* fout, long long R, long long C, const double* params,
           int eos, int forcing, cudaStream_t stream) {
  if (R <= 0 || C <= 0) return 0;
  const Params<T> p = params_of<T>(params);
  const T* in = static_cast<const T*>(fin);
  T* out = static_cast<T*>(fout);
  if (eos == 0)
    return forcing == 0 ? launch_one<T, false, false>(in, out, R, C, p, stream)
                        : launch_one<T, false, true>(in, out, R, C, p, stream);
  return forcing == 0 ? launch_one<T, true, false>(in, out, R, C, p, stream)
                      : launch_one<T, true, true>(in, out, R, C, p, stream);
}

template <typename T>
int launch_halo(const long long* geoms, int n, const double* params, int eos, int forcing,
                cudaStream_t stream) {
  const Params<T> p = params_of<T>(params);
  if (eos == 0)
    return forcing == 0 ? launch_halo_one<T, false, false>(geoms, n, p, stream)
                        : launch_halo_one<T, false, true>(geoms, n, p, stream);
  return forcing == 0 ? launch_halo_one<T, true, false>(geoms, n, p, stream)
                      : launch_halo_one<T, true, true>(geoms, n, p, stream);
}

template <typename T>
int launch_halo2d(const long long* geoms, int n, const double* params, int eos, int forcing,
                  cudaStream_t stream) {
  const Params<T> p = params_of<T>(params);
  if (eos == 0)
    return forcing == 0 ? launch_halo2d_one<T, false, false>(geoms, n, p, stream)
                        : launch_halo2d_one<T, false, true>(geoms, n, p, stream);
  return forcing == 0 ? launch_halo2d_one<T, true, false>(geoms, n, p, stream)
                      : launch_halo2d_one<T, true, true>(geoms, n, p, stream);
}

}  // namespace

// One step f_in -> f_out (distinct buffers) on `stream`; `params` are the
// NPARAM doubles of kernels/shan_chen.py::kernel_params, `eos` 0 = sc,
// 1 = cs, `forcing` 0 = guo, 1 = shift.  Returns the cudaError_t of the
// launch (0 = accepted).
extern "C" int lbm_shan_chen(const void* fin, void* fout, long long R, long long C,
                             const double* params, int eos, int forcing, int is_f64,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(fin, fout, R, C, params, eos, forcing, s)
                : launch<float>(fin, fout, R, C, params, eos, forcing, s);
}

// Kernel 32: one sweep on each of `n_shards` (1 to MAX_SHARDS) row shards
// of one device, `geoms` their geometry arrays back to back (csrc/halo.cuh);
// `params`, `eos` and `forcing` as lbm_shan_chen's.
extern "C" int lbm_halo_shan_chen(const long long* geoms, const double* params, int n_shards,
                                  int eos, int forcing, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_halo<double>(geoms, n_shards, params, eos, forcing, s)
                : launch_halo<float>(geoms, n_shards, params, eos, forcing, s);
}

// Kernel 35: one sweep on each of `n_shards` (1 to MAX_SHARDS) rows x cols
// shards of one device, `geoms` their parts geometry arrays back to back
// (csrc/halo2d.cuh PartsGeom); `params`, `eos` and `forcing` as
// lbm_shan_chen's.
extern "C" int lbm_halo2d_shan_chen(const long long* geoms, const double* params, int n_shards,
                                    int eos, int forcing, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_halo2d<double>(geoms, n_shards, params, eos, forcing, s)
                : launch_halo2d<float>(geoms, n_shards, params, eos, forcing, s);
}
