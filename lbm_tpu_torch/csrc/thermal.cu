// Kernels 23 and 24: one coupled step of the thermal scenes, a BGK fluid f
// with the Boussinesq buoyancy (g_beta theta, 0) as a Guo force, and the
// temperature theta carried by an advection-diffusion distribution g, on
// the state S = [f (9), g (QG)]: 18 planes with a D2Q9 temperature, 14
// with a D2Q5 one (rest + axis directions, w = [1/3, 1/6 x4]).  Each kernel
// has one instance per scalar lattice (the template parameter QG).
//
// Kernel 23 (CAVITY = false) replaces the TPU kernel
// lbm_tpu/kernels/thermal_pallas.py:245 make_thermal_fused_step (bodies
// make_thermal_body :134, make_thermal5_body :199; collisions
// _collide_buoyant :43, _collide_buoyant5 :76; _stream5 :119): the
// Rayleigh-Benard slot, periodic columns, hot row 0 and cold row R-1.
// Kernel 24 (CAVITY = true) replaces :344 make_heated_cavity_fused_step
// (make_heated_cavity5_body :289 and its inline D2Q9 body): the de Vahl
// Davis cavity, hot column 0, cold column C-1, adiabatic rows.
//
// Their plain versions are kernels/thermal.py::plain_rb_step and
// plain_heated_cavity_step, lbm_tpu's jnp steps (scenes/thermal.py:142-200
// and :401-463) on the concatenated state, transcribed in their order and
// built with -fmad=false (_build.UNIT_FLAGS), so each operation rounds once,
// as the plain versions' elementwise ops do.  The D2Q5 collision follows
// the TPU kernel's even/odd pairing (thermal_pallas.py:103-116), which the
// plain version writes the same way.  One step:
//   1. rho and theta as sequential sums, u = m1 / rho, then the half-force
//      shift u_x += (0.5 g_beta theta) / rho;
//   2. BGK on f at the compressible equilibrium plus the standard Guo
//      source of (g_beta theta, 0); BGK on g at the temperature's
//      equilibrium (D2Q9: the compressible equilibrium with theta for rho);
//   3. the periodic push of f and g;
//   4. the walls, each rule over the last, in lbm_tpu's order:
//      Rayleigh-Benard: f halfway bounce-back on rows 0 and R-1; g
//      incoming-only ADE-Dirichlet, g_new[opp(k)] = -g_coll[k] + 2 w_k
//      theta_w with theta_w = +1/2 on row 0 and -1/2 on row R-1 (D2Q5: the
//      one incoming direction of each row);
//      heated cavity: f halfway bounce-back on rows 0, R-1, then columns 0,
//      C-1; g the ADE-Dirichlet columns (+1/2 on column 0, -1/2 on column
//      C-1), then bounce-back on rows 0 and R-1, so at a corner the row
//      rule wins for g where the plane is shared (thermal_pallas.py:404-437).
//
// One thread per cell, neighbouring columns along a warp.  One writer per
// output entry: a push into an entry that a wall rule writes is dropped
// (kernel 9's rule, csrc/channel_variant.cu), and the thread of the wall
// cell applies the rules in order, each over the last, from its own
// post-collision populations, and writes what stands at the end.  Every f
// rule writes f_new[opp(k)] = f_coll[k], so for f the order does not
// change a value; for g it does at the cavity's corners.
//
// Launch: lbm::launch_cells (d2q9.cuh), as kernels 2, 4 and 9: blocks sized
// to the card (rayleigh_benard's 64x128 is 128 blocks of 64 threads,
// heated_cavity's 128x128 256) and a programmatic dependent launch where the
// grid fits the card in one wave, a plain one at many waves.
// lbm::grid_wait comes before the first load or store (the caching
// allocator may hand step n+1's output the buffer step n still reads), and
// lbm::grid_release once the cell's 18 or 14 loads are issued.  That took
// the float32 launch shapes from 2.18-2.69 to 1.39-1.79 us a step, and
// 4096x2048 stays within 0.35% of the first design's plain 256-thread
// launch in both types.  Timed against it, in turns, bit for bit (H100
// 80GB HBM3, 700 W; chip_smoke.py k23_k24_times, its designs): without the
// dependent launch +0.28-0.59 us a step at the launch shapes; 256-thread
// blocks up to +0.35 in float32 and +0.25-0.56 in float64; the release at
// each block's exit up to +0.31; 32-bit indices (an int32_t instance where
// (9 + QG) R C fits in 31 bits) +0.4-3.5% at 4096x2048 and no better at the
// launch shapes taken together; the push's owned() tests only near a wall
// line, one uniform branch for the interior's warps, -0.07 to -0.26 us at
// 64x128, +0.11-0.22 at 128x128 and up to +3.3% at 4096x2048 in float32;
// both together the fastest at every float32 launch shape (-0.04 to -0.41
// us) but +2.2-3.6% at 4096x2048.
//
// Shapes: R, C >= 4 (the wrapper checks).
//
// Kernel 28 (thermal_halo_kernel, lbm_halo_thermal) is kernel 23's D2Q9
// instance on a row shard with halo inputs (csrc/halo.cuh): the same
// collision and wall rules, with the walls at the grid's global rows 0 and
// R-1, the band of each sweep ending there, and no wall test at all on the
// interior ranks.  It replaces lbm_tpu/kernels/sharded_pallas.py:503
// make_sharded_thermal_step (body thermal_pallas.py:134).
//
// Kernel 36 (thermal_halo2d_kernel, lbm_halo2d_thermal) is the same D2Q9
// step on rows x cols shards (csrc/halo2d.cuh, kernels/sharded2d.py
// make_sharded2d_thermal_step): one thread per cell of the padded band it
// reads, pushes into the output band only and nothing wraps (the column
// strips hold the neighbours' columns); the row walls act by global row on
// the shards of row ranks 0 and nx-1, the columns are periodic with no
// mask.  One launch runs one sweep of up to MAX_SHARDS shards of a card,
// blockIdx.y the shard, their geometries a kernel parameter (~2.2 KB):
// at the thermal gate's 64x128 on a (4, 2) mesh a shard's band is ~2,500
// cells, so a launch per shard and sweep (64 a call of 8 sweeps) spent
// each one's ~3 us of launch and ramp on 10 blocks; one launch a sweep
// over the 8 shards cut a step from 29.5 to 11.8 us in float32 (33.4 to
// 12.7 in float64) and 4096x2048 on (4, 2) by 7% (4%), bit for bit the
// per-shard launches (H100 80GB HBM3, 700 W; PERF.md section 6).  Against
// its bound (chip_smoke.py sharded_times): 0.60 at 4096x2048 on (4, 2), s =
// 1 (0.604 ms a step, 0.362 for its bytes); 0.10 at s = 8, whose sweeps
// each move their bands where the bound counts one pass; 0.01 at the
// gate's 64x128, where a step is launches and the exchange.  It
// replaces lbm_tpu/kernels/sharded2d_pallas.py:578
// make_sharded2d_thermal_step on make_local_2d_body_step (:392, its
// pallas_call at :411).
//
// Bound: device-memory bytes, per float32 step 144 B/cell with a D2Q9
// temperature (18 planes in, 18 out), 112 B/cell with D2Q5 (14 and 14);
// at the launch shapes 0.20-0.40 of it, the dependent launch's chain and
// ramp, not the bytes.  Left on the table: the ownership test of each push
// and the wall branches in every thread (the near-wall design above, at
// one wave only: an instance picked by the grid's waves).

#include <cuda_runtime.h>

#include "d2q9.cuh"
#include "halo.cuh"
#include "halo2d.cuh"

namespace {

template <typename T>
struct Params {
  T omega_f, one_m_omega_f;  // the fluid's BGK rate and 1 - omega_f
  T pref;                    // 1 - omega_f / 2, the Guo prefactor
  T omega_g, one_m_omega_g;  // the temperature's BGK rate and 1 - omega_g
  T g_beta;                  // buoyancy per unit theta
};

// The planes of (r, c) that a wall rule writes: f in bits 0-8, g in bits
// 9-17 (D2Q9) or 9-13 (D2Q5).  The D2Q5 planes are D2Q9's first five.
// I, the index type: int64_t in kernels 28 and 36, thermal_kernel's I in 23 and 24.
template <int QG, bool CAVITY, typename I>
__device__ __forceinline__ unsigned owned(I r, I c, I R, I C) {
  unsigned f = 0, g = 0;
  if (r == 0) { f |= lbm::PX; g |= QG == 9 ? lbm::PX : 1u << 1; }
  if (r == R - 1) { f |= lbm::MX; g |= QG == 9 ? lbm::MX : 1u << 3; }
  if (CAVITY) {
    if (c == 0) { f |= lbm::PY; g |= QG == 9 ? lbm::PY : 1u << 2; }
    if (c == C - 1) { f |= lbm::MY; g |= QG == 9 ? lbm::MY : 1u << 4; }
  }
  return f | (g << 9);
}

// The D2Q5 collision in the TPU kernel's even/odd pairing
// (kernels/thermal.py::d2q5_collision).
template <typename T>
__device__ __forceinline__ void collide_d2q5(const T g[5], T theta, T ux, T uy,
                                             const Params<T>& P, T gc[5]) {
  const T uu15 = T(1.5) * (ux * ux + uy * uy);
  const T th6 = T(1.0 / 6.0) * theta;
  gc[0] = P.one_m_omega_g * g[0] + P.omega_g * (T(1.0 / 3.0) * theta * (T(1.0) - uu15));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = 1 + i, km = 3 + i;
    const T cu = i == 0 ? ux : uy;
    const T even = th6 * (T(1.0) + T(4.5) * cu * cu - uu15);
    const T odd = th6 * (T(3.0) * cu);
    gc[kp] = P.one_m_omega_g * g[kp] + P.omega_g * (even + odd);
    gc[km] = P.one_m_omega_g * g[km] + P.omega_g * (even - odd);
  }
}

// Steps 1 and 2 of one cell: the macroscopics with the half-force shift,
// then both collisions, the Guo buoyancy source on f.
template <typename T, int QG>
__device__ __forceinline__ void collide(const T f[9], const T g[QG], const Params<T>& P,
                                        T fc[9], T gc[QG]) {
  T rho, mx, my;
  lbm::moments(f, rho, mx, my);
  T theta = g[0];
#pragma unroll
  for (int k = 1; k < QG; ++k) theta += g[k];
  const T Fx = P.g_beta * theta;
  const T ux = mx / rho + T(0.5) * Fx / rho;
  const T uy = my / rho;

  T feq[9];
  lbm::equilibrium(rho, ux, uy, feq);
  const T uf = ux * Fx + uy * T(0);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    fc[k] = P.one_m_omega_f * f[k] + P.omega_f * feq[k];
    const T s = (T(3.0) + T(9.0) * lbm::cu(k, ux, uy)) * lbm::cu(k, Fx, T(0)) - T(3.0) * uf;
    fc[k] = fc[k] + P.pref * s * T(lbm::weight(k));
  }
  if constexpr (QG == 9) {
    T geq[9];
    lbm::equilibrium(theta, ux, uy, geq);
#pragma unroll
    for (int k = 0; k < 9; ++k) gc[k] = P.one_m_omega_g * g[k] + P.omega_g * geq[k];
  } else {
    collide_d2q5(g, theta, ux, uy, P, gc);
  }
}

// Step 4's temperature values of the wall cell (r, c), each rule over the
// last, in lbm_tpu's order: go[k] for the g planes its walls own.
template <typename T, int QG, bool CAVITY, typename I>
__device__ __forceinline__ void wall_rules(I r, I c, I R, I C, const T gc[QG], T go[QG]) {
  if constexpr (CAVITY) {
    if constexpr (QG == 9) {
#pragma unroll
      for (int k = 1; k < 9; ++k) {
        const unsigned bit = 1u << k;
        const int o = lbm::opp(k);
        if (c == 0 && (lbm::PY & bit)) go[k] = -gc[o] + T(lbm::weight(k));
        if (c == C - 1 && (lbm::MY & bit)) go[k] = -gc[o] - T(lbm::weight(k));
        if (r == 0 && (lbm::PX & bit)) go[k] = gc[o];
        if (r == R - 1 && (lbm::MX & bit)) go[k] = gc[o];
      }
    } else {
      if (c == 0) go[2] = -gc[4] + T(1.0 / 6.0);
      if (c == C - 1) go[4] = -gc[2] - T(1.0 / 6.0);
      if (r == 0) go[1] = gc[3];
      if (r == R - 1) go[3] = gc[1];
    }
  } else {
    if constexpr (QG == 9) {
#pragma unroll
      for (int k = 1; k < 9; ++k) {
        const unsigned bit = 1u << k;
        const int o = lbm::opp(k);
        if (r == 0 && (lbm::PX & bit)) go[k] = -gc[o] + T(lbm::weight(k));
        if (r == R - 1 && (lbm::MX & bit)) go[k] = -gc[o] - T(lbm::weight(k));
      }
    } else {
      if (r == 0) go[1] = -gc[3] + T(1.0 / 6.0);
      if (r == R - 1) go[3] = -gc[1] - T(1.0 / 6.0);
    }
  }
}

// The wall cell's writes: f_new[k] = f_coll[opp(k)] and g_new[k] = go[k] for
// the planes its walls own (mask m), into the planes at `dst`.
template <typename T, int QG, typename I>
__device__ __forceinline__ void write_walls(unsigned m, const T fc[9], const T go[QG], T* dst,
                                            I plane) {
#pragma unroll
  for (int k = 1; k < 9; ++k)
    if (m & (1u << k)) dst[k * plane] = fc[lbm::opp(k)];
#pragma unroll
  for (int k = 1; k < QG; ++k)
    if (m & (1u << (9 + k))) dst[(9 + k) * plane] = go[k];
}

// A one-period wrap in the kernel's index type (lbm::wrap's rule).
template <typename I>
__device__ __forceinline__ I wrap(I i, I n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// Kernels 23 and 24: one thread a cell, its index arithmetic (the cell's
// row and column, the one-period wraps, the owned() tests, the plane
// offsets) in I: int64_t as launched (chip_smoke.py's design "32-bit
// indices" launches the int32_t instance where the state's offsets fit in
// 31 bits).
template <typename T, int QG, bool CAVITY, typename I>
__global__ void thermal_kernel(const T* __restrict__ fin, T* __restrict__ fout, I R, I C,
                               Params<T> P) {
  const I n = R * C;
  const I cell = static_cast<I>(blockIdx.x) * static_cast<I>(blockDim.x) +
                 static_cast<I>(threadIdx.x);
  if (cell >= n) return;
  const I r = cell / C;
  const I c = cell - r * C;
  lbm::grid_wait();

  // 1-2. the macroscopics and both collisions; the next step's launch is
  // released once this cell's loads are issued
  T f[9], g[QG];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = fin[k * n + cell];
#pragma unroll
  for (int k = 0; k < QG; ++k) g[k] = fin[(9 + k) * n + cell];
  lbm::grid_release();
  T fc[9], gc[QG];
  collide<T, QG>(f, g, P, fc, gc);

  // 3. the periodic push, less the entries a wall rule writes
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const I rd = wrap<I>(r + lbm::cx(k), R);
    const I cd = wrap<I>(c + lbm::cy(k), C);
    const unsigned m = owned<QG, CAVITY>(rd, cd, R, C);
    const I dst = rd * C + cd;
    if (!(m & (1u << k))) fout[k * n + dst] = fc[k];
    if (k < QG && !(m & (1u << (9 + k)))) fout[(9 + k) * n + dst] = gc[k];
  }

  // 4. this cell's wall rules, in lbm_tpu's order
  const unsigned m = owned<QG, CAVITY>(r, c, R, C);
  if (!m) return;
  T go[QG];
  wall_rules<T, QG, CAVITY>(r, c, R, C, gc, go);
  write_walls<T, QG>(m, fc, go, fout + cell, n);
}

// Kernel 28: one sweep of the Rayleigh-Benard step (D2Q9 temperature) on a
// row shard with halo inputs (csrc/halo.cuh).  One thread per cell of the
// padded rows [in_lo, in_hi); the band ends at the grid's walls, and the
// wall rules act at the global rows 0 and R-1 (`r`), exactly as kernel
// 23's do, in the masked (EDGE) instance of ranks 0 and n-1.  The pushes
// leave the band [out_lo, out_hi) unwritten beyond its rows.
template <typename T, bool EDGE>
__global__ void thermal_halo_kernel(lbm::halo::View<T> in, lbm::halo::Out<T> out,
                                    int64_t in_lo, int64_t n_cells, int64_t off, int64_t R,
                                    Params<T> P) {
  constexpr int QG = 9;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_cells) return;
  const int64_t C = in.C;
  const int64_t row = i / C;
  const int64_t p = in_lo + row;
  const int64_t c = i - row * C;
  const int64_t r = off - in.halo + p;  // the global row

  int64_t plane;
  const T* src = in.locate(p, c, plane);
  T f[9], g[QG];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    f[k] = src[k * plane];
    g[k] = src[(9 + k) * plane];
  }
  T fc[9], gc[QG];
  collide<T, QG>(f, g, P, fc, gc);

#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int64_t pd = p + lbm::cx(k);
    if (!out.has(pd)) continue;
    const int64_t cd = lbm::wrap(c + lbm::cy(k), C);
    const unsigned m = EDGE ? owned<QG, false>(r + lbm::cx(k), cd, R, C) : 0u;
    T* dst = out.at(pd, cd);
    if (!(m & (1u << k))) dst[k * out.plane] = fc[k];
    if (!(m & (1u << (9 + k)))) dst[(9 + k) * out.plane] = gc[k];
  }

  if (!EDGE || !out.has(p)) return;
  const unsigned m = owned<QG, false>(r, c, R, C);
  if (!m) return;
  T go[QG];
  wall_rules<T, QG, false>(r, c, R, C, gc, go);
  write_walls<T, QG>(m, fc, go, out.at(p, c), out.plane);
}

// Kernel 36's shards of one launch: up to MAX_SHARDS rows x cols shards of
// one device, one a grid row (blockIdx.y), each with its own sweep bands
// (csrc/halo2d.cuh); ~2.2 KB of kernel parameters in float32 and float64.
constexpr int MAX_SHARDS = 8;

template <typename T>
struct Shards {
  lbm::halo2d::Launch<T> s[MAX_SHARDS];
};

// Kernel 36: one sweep of the Rayleigh-Benard step (D2Q9 temperature) on
// each of up to MAX_SHARDS rows x cols shards.  One thread per cell of a
// shard's padded band [r_lo, r_hi) x [c_lo, c_hi); `r` is the global row,
// the wall rules kernel 28's, in the shards whose rows reach a wall.
template <typename T>
__global__ void thermal_halo2d_kernel(const __grid_constant__ Shards<T> shards,
                                      const Params<T> P) {
  constexpr int QG = 9;
  const lbm::halo2d::Launch<T>& L = shards.s[blockIdx.y];
  const int64_t width = L.c_hi - L.c_lo;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (width <= 0 || i >= (L.r_hi - L.r_lo) * width) return;
  const int64_t row = i / width;
  const int64_t p = L.r_lo + row;
  const int64_t q = L.c_lo + (i - row * width);
  const int64_t r = L.global_row(p);
  const int64_t R = L.R, C = L.C;
  const lbm::halo2d::Out<T>& out = L.out;

  int64_t plane;
  const T* src = L.in.locate(p, q, plane);
  T f[9], g[QG];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    f[k] = src[k * plane];
    g[k] = src[(9 + k) * plane];
  }
  T fc[9], gc[QG];
  collide<T, QG>(f, g, P, fc, gc);

#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int64_t pd = p + lbm::cx(k), qd = q + lbm::cy(k);
    if (!out.has(pd, qd)) continue;
    const unsigned m = L.edge ? owned<QG, false>(r + lbm::cx(k), int64_t{0}, R, C) : 0u;
    T* dst = out.at(pd, qd);
    if (!(m & (1u << k))) dst[k * out.plane] = fc[k];
    if (!(m & (1u << (9 + k)))) dst[(9 + k) * out.plane] = gc[k];
  }

  if (!L.edge || !out.has(p, q)) return;
  const unsigned m = owned<QG, false>(r, int64_t{0}, R, C);
  if (!m) return;
  T go[QG];
  wall_rules<T, QG, false>(r, int64_t{0}, R, C, gc, go);
  write_walls<T, QG>(m, fc, go, out.at(p, q), out.plane);
}

template <typename T>
Params<T> params(const double* d) {
  Params<T> P;
  P.omega_f = T(d[0]); P.one_m_omega_f = T(d[1]); P.pref = T(d[2]);
  P.omega_g = T(d[3]); P.one_m_omega_g = T(d[4]); P.g_beta = T(d[5]);
  return P;
}

template <typename T>
int launch_halo(const long long* geom, const double* d, cudaStream_t stream) {
  const lbm::halo::Launch<T> L = lbm::halo::parse<T>(geom);
  if (L.R < 4 || L.in.C < 4) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = (L.in_hi - L.in_lo) * L.in.C;
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  if (L.edge)
    thermal_halo_kernel<T, true><<<blocks, threads, 0, stream>>>(L.in, L.out, L.in_lo, n, L.off,
                                                                 L.R, params<T>(d));
  else
    thermal_halo_kernel<T, false><<<blocks, threads, 0, stream>>>(L.in, L.out, L.in_lo, n,
                                                                  L.off, L.R, params<T>(d));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_halo2d(const long long* geoms, int n, const double* d, cudaStream_t stream) {
  if (n < 1 || n > MAX_SHARDS) return static_cast<int>(cudaErrorInvalidValue);
  Shards<T> shards;
  int64_t most = 0;
  for (int i = 0; i < n; ++i) {
    const lbm::halo2d::Launch<T> L = lbm::halo2d::parse<T>(geoms + i * lbm::halo2d::NGEOM);
    if (L.R < 4 || L.C < 4) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t cells = (L.r_hi - L.r_lo) * (L.c_hi - L.c_lo);
    most = cells > most ? cells : most;
    shards.s[i] = L;
  }
  if (most <= 0) return 0;
  const int threads = 256;
  const dim3 grid(static_cast<unsigned>((most + threads - 1) / threads), static_cast<unsigned>(n));
  thermal_halo2d_kernel<T><<<grid, threads, 0, stream>>>(shards, params<T>(d));
  return static_cast<int>(cudaGetLastError());
}

// Kernel 23 or 24 through lbm::launch_cells: blocks sized to the card, a
// programmatic dependent launch where the grid fits it in one wave, each
// instance with its own occupancy in launch_cells' cache; 64-bit indices.
template <typename T, int QG, bool CAVITY>
int launch(const void* fin, void* fout, long long R, long long C, const double* d,
           cudaStream_t stream) {
  if (R < 4 || C < 4) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(R) * C;
  return static_cast<int>(lbm::launch_cells<thermal_kernel<T, QG, CAVITY, int64_t>>(
      n, stream, static_cast<const T*>(fin), static_cast<T*>(fout), static_cast<int64_t>(R),
      static_cast<int64_t>(C), params<T>(d)));
}

template <int QG, bool CAVITY>
int dispatch(const void* fin, void* fout, long long R, long long C, const double* consts,
             int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double, QG, CAVITY>(fin, fout, R, C, consts, s)
                : launch<float, QG, CAVITY>(fin, fout, R, C, consts, s);
}

}  // namespace

// One thermal step S_in -> S_out (distinct buffers; 18 planes for the _q9
// instances, 14 for _q5) on `stream`.  `consts` holds 6 scalars already
// rounded to the state's type, in the order of
// kernels/thermal.py::thermal_constants: omega_f, 1 - omega_f,
// 1 - omega_f/2, omega_g, 1 - omega_g, g_beta.  Returns the cudaError_t of
// the launch (0 = accepted).
extern "C" int lbm_thermal_rb_q9(const void* fin, void* fout, long long R, long long C,
                                 const double* consts, int is_f64, void* stream) {
  return dispatch<9, false>(fin, fout, R, C, consts, is_f64, stream);
}

extern "C" int lbm_thermal_rb_q5(const void* fin, void* fout, long long R, long long C,
                                 const double* consts, int is_f64, void* stream) {
  return dispatch<5, false>(fin, fout, R, C, consts, is_f64, stream);
}

extern "C" int lbm_heated_cavity_q9(const void* fin, void* fout, long long R, long long C,
                                    const double* consts, int is_f64, void* stream) {
  return dispatch<9, true>(fin, fout, R, C, consts, is_f64, stream);
}

extern "C" int lbm_heated_cavity_q5(const void* fin, void* fout, long long R, long long C,
                                    const double* consts, int is_f64, void* stream) {
  return dispatch<5, true>(fin, fout, R, C, consts, is_f64, stream);
}

// Kernel 28: one sweep of the Rayleigh-Benard step with a D2Q9 temperature
// on a row shard, geometry `geom` (csrc/halo.cuh), `consts` the 6 scalars of
// lbm_thermal_rb_q9.  Returns the cudaError_t of the launch (0 = accepted).
extern "C" int lbm_halo_thermal(const long long* geom, const double* consts, int, int,
                                int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_halo<double>(geom, consts, s) : launch_halo<float>(geom, consts, s);
}

// Kernel 36: one sweep of the Rayleigh-Benard step with a D2Q9 temperature
// on each of `n_shards` (1 to MAX_SHARDS) rows x cols shards of one device,
// `geoms` their n_shards geometry arrays back to back (csrc/halo2d.cuh),
// `consts` the 6 scalars of lbm_thermal_rb_q9.  Returns the cudaError_t of
// the launch.
extern "C" int lbm_halo2d_thermal(const long long* geoms, const double* consts, int n_shards,
                                  int, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_halo2d<double>(geoms, n_shards, consts, s)
                : launch_halo2d<float>(geoms, n_shards, consts, s);
}

// The programmatic dependent launches that lbm::launch_grid has made in this
// process, every kernel of the library counted (d2q9.cuh).
extern "C" long long lbm_dependent_launches() { return lbm::dependent_launches.load(); }
