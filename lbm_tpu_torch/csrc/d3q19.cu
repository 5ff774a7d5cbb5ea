// Kernels 25 and 26: one D3Q19 step, BGK with an optional Guo force along
// z, the periodic push and the optional halfway walls of lbm_tpu's 3-D
// scenes, on the 19-population state.  One template over the type and the
// address order; kernel 25 reads the planes layout (19, X, Y, Z), kernel 26
// the lanes layout (19, Y, X*Z) with lane = z*X + x:
//   planes: offset ((k*X + x)*Y + y)*Z + z
//   lanes:  offset (k*Y + y)*(X*Z) + z*X + x
//
// Kernel 25 replaces the TPU kernel lbm_tpu/kernels/d3q19_pallas.py:101
// make_d3q19_fused_step (body make_d3q19_body :173, collision _collide_x
// :50); kernel 26 replaces d3q19_lanes_pallas.py:153 make_d3q19_lanes_step
// (make_d3q19_lanes_body :71).  On the TPU the lanes layout widened the
// vector ops; here it only changes the address order, and kernel 26 gives
// kernel 25's result bit for bit.  Their plain versions are
// kernels/d3q19.py::plain_d3q19_step and plain_d3q19_lanes_step, which
// follow _collide_x term for term; built with -fmad=false
// (_build.UNIT_FLAGS), each operation rounds once, as theirs do.  One step:
//   1. rho as a running sum, the moments per axis in k order, inv_rho =
//      1/rho, u = m * inv_rho; with a force, u_z = (m_z + gz/2) * inv_rho;
//   2. BGK, each k / opp(k) pair sharing its even part
//      w rho (1 + 4.5 cu^2 - 1.5 u.u) and splitting its odd part w rho 3 cu,
//      both times omega; with a force the Guo source of (0, 0, gz), paired
//      the same way;
//   3. the periodic push;
//   4. the walls, each rule over the last, in lbm_tpu's order: the x end
//      walls (x_walls: the reversed population arrives at the same cell,
//      with no y or z displacement, even for a diagonal k), the y faces
//      (y_walls; with the lid, the y = Y-1 face subtracts 6 w_k c_z,k u_lid
//      from each reflected population with c_z != 0), then the z faces
//      (z_walls).  At the lid's edges (y = Y-1, z = 0 or Z-1) the z rule
//      overwrites the lid's corrected value with the plain reflection: z
//      wins (d3q19_pallas.py:226-242).
//
// One thread per cell, the innermost memory index along the warp (z for
// the planes, x for the lanes).  One writer per output entry: every wall
// rule writes new[opp(k)] = coll[k] from its own cell, so the wall cell's
// thread applies the rules in order and writes what stands at the end, and
// a push into an entry that a rule writes is dropped (kernel 22's rule,
// csrc/cavity.cu).  Offsets are 64-bit.
//
// Shapes: X, Y, Z >= 1 on a periodic axis and >= 2 on a walled one (the
// wrapper checks; the entry points refuse a non-positive size).
//
// Bound: device-memory bytes, 152 B/cell per float32 step (19 planes in,
// 19 out), 304 B in float64.  Left on the table: the ownership test of each
// push, the wall branches in every thread, and the uncoalesced pushes of
// the directions that move along the innermost axis.
//
// This source also holds kernel 33, lbm_halo_d3q19: kernel 25's step on a
// shard of the y axis with halo inputs (csrc/halo.cuh,
// kernels/sharded.py make_sharded_d3q19_step), which replaces lbm_tpu's
// D3Q19 body (d3q19_pallas.py:173 make_d3q19_body) on the row-sharded
// driver (sharded_pallas.py:345, its pallas_call at :321).  The planes
// state (19, X, Y, Z) is (19 X, Y, Z) in memory, so a shard of Y is a row
// shard of 19 X planes of Z columns, read through the three-buffer row
// view.  One thread per cell (x, padded row p, z) of the band a sweep
// reads, z innermost; x and z wrap or meet their walls as in kernel 25, y
// is the padded row and never wraps, and the y faces and the lid act at
// the grid's global rows 0 and Y-1 by the same ownership rule (`owned`).
// The collision is kernel 25's device function (collide19), built with the
// same flags, so an n-shard run equals kernel 25 bit for bit.
//
// One launch runs one sweep of up to MAX_SHARDS shards of a card, their
// geometries a __grid_constant__ parameter and blockIdx.y the shard, each
// with its own sweep bands (kernels/sharded.py launch_sweeps_shards): the
// sweeps of a small shard (the cavity3d gate's 8 rows over 8 shards: ~12k
// cells a sweep) are launch-bound, 16 launches a call of 2 sweeps before,
// 2 now.  A first sweep reads the ring neighbours' edge rows in place where
// they lie on the shard's device (their own buffer, plane stride R_loc Z;
// parallel/halo.py ring_rows): no exchange copy on one card.

#include <cuda_runtime.h>

#include <cstdint>

#include "halo.cuh"

namespace {

constexpr int Q = 19;

// The velocities of lbm_tpu/ops/d3q19.py C3, column k.
__host__ __device__ constexpr int cx(int k) {
  return (k == 1 || k == 7 || k == 9 || k == 11 || k == 13) ? 1
         : (k == 2 || k == 8 || k == 10 || k == 12 || k == 14) ? -1 : 0;
}
__host__ __device__ constexpr int cy(int k) {
  return (k == 3 || k == 7 || k == 10 || k == 15 || k == 17) ? 1
         : (k == 4 || k == 8 || k == 9 || k == 16 || k == 18) ? -1 : 0;
}
__host__ __device__ constexpr int cz(int k) {
  return (k == 5 || k == 11 || k == 14 || k == 15 || k == 18) ? 1
         : (k == 6 || k == 12 || k == 13 || k == 16 || k == 17) ? -1 : 0;
}

// opp(k): the pairs are (1, 2), (3, 4), ..., (17, 18)
__host__ __device__ constexpr int opp(int k) { return k == 0 ? 0 : (k & 1 ? k + 1 : k - 1); }

constexpr int X_WALLS = 1, Y_WALLS = 2, Z_WALLS = 4, FORCE = 8, LID = 16;

template <typename T>
struct Params {
  T omega, one_m_omega;  // BGK rate and 1 - omega
  T gz, half_gz;         // the force along z and gz / 2
  T pw0, pw1, pw2;       // pref * w for the rest, axis and diagonal weights
  T os1, os2;            // pref * w * (3 gz), axis and diagonal: the Guo odd part
  T lid;                 // 6 w_diag u_lid, the lid's correction
};

// Whether a wall rule writes plane k of (x, y, z).
__device__ __forceinline__ bool owned(int k, int64_t x, int64_t y, int64_t z, int64_t X,
                                      int64_t Y, int64_t Z, int flags) {
  return ((flags & X_WALLS) && ((x == 0 && cx(k) > 0) || (x == X - 1 && cx(k) < 0))) ||
         ((flags & Y_WALLS) && ((y == 0 && cy(k) > 0) || (y == Y - 1 && cy(k) < 0))) ||
         ((flags & Z_WALLS) && ((z == 0 && cz(k) > 0) || (z == Z - 1 && cz(k) < 0)));
}

template <bool LANES>
__device__ __forceinline__ int64_t lin(int64_t x, int64_t y, int64_t z, int64_t X, int64_t Y,
                                       int64_t Z) {
  return LANES ? (y * Z + z) * X + x : (x * Y + y) * Z + z;
}

__device__ __forceinline__ int64_t wrap(int64_t i, int64_t n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// 1-2. The collision of one cell (_collide_x :56-98): its 19 populations
// in, the post-collision values out.
template <typename T>
__device__ __forceinline__ void collide19(const T f[Q], const Params<T>& P, bool force,
                                          T coll[Q]) {
  // 1. the moments (_collide_x :56-72)
  T rho = f[0];
#pragma unroll
  for (int k = 1; k < Q; ++k) rho = rho + f[k];
  const T inv_rho = T(1) / rho;
  T mx = f[1], my = f[3], mz = f[5];  // the first term of each axis has c = +1
#pragma unroll
  for (int k = 2; k < Q; ++k) {
    if (cx(k)) mx = mx + f[k] * T(cx(k));
    if (cy(k) && k != 3) my = my + f[k] * T(cy(k));
    if (cz(k) && k != 5) mz = mz + f[k] * T(cz(k));
  }
  const T ux = mx * inv_rho;
  const T uy = my * inv_rho;
  const T uz = force ? (mz + P.half_gz) * inv_rho : mz * inv_rho;
  const T uu15 = T(1.5) * (ux * ux + uy * uy + uz * uz);

  // 2. BGK and the Guo source, pair by pair (_collide_x :74-98)
  coll[0] = P.one_m_omega * f[0] + P.omega * (T(1.0 / 3.0) * rho * (T(1) - uu15));
  if (force) coll[0] = coll[0] - P.pw0 * (T(3) * uz * P.gz);
#pragma unroll
  for (int k = 1; k < Q; k += 2) {
    const int ko = k + 1;
    const T cu = T(cx(k)) * ux + T(cy(k)) * uy + T(cz(k)) * uz;
    const T wr = T(k < 7 ? 1.0 / 18.0 : 1.0 / 36.0) * rho;
    const T even = P.omega * (wr * (T(1) + T(4.5) * cu * cu - uu15));
    const T odd = P.omega * (wr * (T(3) * cu));
    coll[k] = P.one_m_omega * f[k] + (even + odd);
    coll[ko] = P.one_m_omega * f[ko] + (even - odd);
    if (force) {
      const T pw = k < 7 ? P.pw1 : P.pw2;
      const T os = k < 7 ? P.os1 : P.os2;
      const T cF = T(cz(k)) * P.gz;
      const T even_s = pw * (T(9) * cu * cF - T(3) * uz * P.gz);
      const T odd_s = cz(k) > 0 ? os : (cz(k) < 0 ? -os : T(0) * os);
      coll[k] = coll[k] + (even_s + odd_s);
      coll[ko] = coll[ko] + (even_s - odd_s);
    }
  }
}

// 4. The value a wall rule writes into plane q of the cell (x, y, z), which
// owns it: the reflection of coll[opp(q)], the lid's correction on the
// y = Y-1 face, and a z rule after it writing the plain reflection again.
template <typename T>
__device__ __forceinline__ T wall_value(int q, const T coll[Q], int64_t y, int64_t z,
                                        int64_t Y, int64_t Z, const Params<T>& P, int flags) {
  const int k = opp(q);  // the outgoing population that q reverses
  T v = coll[k];
  if ((flags & Y_WALLS) && (flags & LID) && y == Y - 1 && cy(q) < 0 && cz(k))
    v = v - (cz(k) > 0 ? P.lid : -P.lid);
  if ((flags & Z_WALLS) && ((z == 0 && cz(q) > 0) || (z == Z - 1 && cz(q) < 0))) v = coll[k];
  return v;
}

template <typename T, bool LANES>
__global__ void d3q19_kernel(const T* __restrict__ fin, T* __restrict__ fout, int64_t X,
                             int64_t Y, int64_t Z, Params<T> P, int flags) {
  const int64_t n = X * Y * Z;
  const int64_t cell = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  int64_t x, y, z;
  if (LANES) {
    x = cell % X;
    const int64_t t = cell / X;
    z = t % Z;
    y = t / Z;
  } else {
    z = cell % Z;
    const int64_t t = cell / Z;
    y = t % Y;
    x = t / Y;
  }
  T f[Q], coll[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) f[k] = fin[k * n + cell];
  collide19(f, P, flags & FORCE, coll);

  // 3. the periodic push, less the entries a wall rule writes
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int64_t xd = wrap(x + cx(k), X), yd = wrap(y + cy(k), Y), zd = wrap(z + cz(k), Z);
    if (!owned(k, xd, yd, zd, X, Y, Z, flags))
      fout[k * n + lin<LANES>(xd, yd, zd, X, Y, Z)] = coll[k];
  }

  // 4. the wall rules of this cell's own entries, in lbm_tpu's order
#pragma unroll
  for (int q = 1; q < Q; ++q)
    if (owned(q, x, y, z, X, Y, Z, flags))
      fout[q * n + cell] = wall_value(q, coll, y, z, Y, Z, P, flags);
}

// Kernel 33's shards of one launch: up to MAX_SHARDS shards of one device,
// one a grid row (blockIdx.y); ~1.3 KB of kernel parameters.
constexpr int MAX_SHARDS = 8;

template <typename T>
struct Shards {
  lbm::halo::Launch<T> s[MAX_SHARDS];
};

// Kernel 33: one sweep on each of up to MAX_SHARDS shards of the y axis.
// Thread i of grid row b takes the cell (x, padded row in_lo + r, z) of
// shard b's band [in_lo, in_hi); global row y = p + g0 (g0 = off - halo).
// Plane (k, x) of a buffer is k X + x.
template <typename T>
__global__ void d3q19_halo(const __grid_constant__ Shards<T> shards, int64_t X, Params<T> P,
                           int flags) {
  const lbm::halo::Launch<T>& L = shards.s[blockIdx.y];
  const lbm::halo::View<T>& in = L.in;
  const lbm::halo::Out<T>& out = L.out;
  const int64_t Z = in.C, Y = L.R, rows = L.in_hi - L.in_lo;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= X * rows * Z) return;
  const int64_t z = i % Z;
  const int64_t t = i / Z;
  const int64_t p = L.in_lo + t % rows;
  const int64_t x = t / rows;
  const int64_t y = L.global(p);
  int64_t plane;
  const T* src = in.locate(p, z, plane);
  T f[Q], coll[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) f[k] = src[(k * X + x) * plane];
  collide19(f, P, flags & FORCE, coll);

#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int64_t pd = p + cy(k);
    const int64_t xd = wrap(x + cx(k), X), zd = wrap(z + cz(k), Z);
    if (out.has(pd) && !owned(k, xd, y + cy(k), zd, X, Y, Z, flags))
      out.at(pd, zd)[(k * X + xd) * out.plane] = coll[k];
  }
  if (!out.has(p)) return;
  T* own = out.at(p, z);
#pragma unroll
  for (int q = 1; q < Q; ++q)
    if (owned(q, x, y, z, X, Y, Z, flags))
      own[(q * X + x) * out.plane] = wall_value(q, coll, y, z, Y, Z, P, flags);
}

template <typename T>
Params<T> params_of(const double* d) {
  Params<T> P;
  P.omega = T(d[0]); P.one_m_omega = T(d[1]); P.gz = T(d[2]); P.half_gz = T(d[3]);
  P.pw0 = T(d[4]); P.pw1 = T(d[5]); P.pw2 = T(d[6]); P.os1 = T(d[7]); P.os2 = T(d[8]);
  P.lid = T(d[9]);
  return P;
}

template <typename T, bool LANES>
int launch(const void* fin, void* fout, long long X, long long Y, long long Z, const double* d,
           int flags, cudaStream_t stream) {
  const Params<T> P = params_of<T>(d);
  const int64_t n = static_cast<int64_t>(X) * Y * Z;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  d3q19_kernel<T, LANES><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(fin), static_cast<T*>(fout), X, Y, Z, P, flags);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_halo(const long long* geoms, int n, const double* d, long long X, int flags,
                cudaStream_t stream) {
  if (n < 1 || n > MAX_SHARDS || X < 1) return static_cast<int>(cudaErrorInvalidValue);
  Shards<T> shards;
  int64_t most = 0;
  for (int b = 0; b < n; ++b) {
    const lbm::halo::Launch<T> L = lbm::halo::parse<T>(geoms + b * lbm::halo::NGEOM);
    if (L.in.C < 1 || L.R < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t cells = X * (L.in_hi - L.in_lo) * L.in.C;
    most = cells > most ? cells : most;
    shards.s[b] = L;
  }
  if (most <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (most + threads - 1) / threads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
  d3q19_halo<T><<<grid, threads, 0, stream>>>(shards, X, params_of<T>(d), flags);
  return static_cast<int>(cudaGetLastError());
}

template <bool LANES>
int dispatch(const void* fin, void* fout, long long X, long long Y, long long Z,
             const double* consts, int flags, int is_f64, void* stream) {
  if (X < 1 || Y < 1 || Z < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double, LANES>(fin, fout, X, Y, Z, consts, flags, s)
                : launch<float, LANES>(fin, fout, X, Y, Z, consts, flags, s);
}

}  // namespace

// One D3Q19 step f_in -> f_out (19 * X * Y * Z entries; distinct buffers) on
// `stream`.  `consts` holds 10 scalars already rounded to the state's type,
// in the order of kernels/d3q19.py::d3q19_constants; `flags` ORs 1 (x
// walls), 2 (y walls), 4 (z walls), 8 (the force) and 16 (the lid).
// Returns the cudaError_t of the launch (0 = accepted).
extern "C" int lbm_d3q19(const void* fin, void* fout, long long X, long long Y, long long Z,
                         const double* consts, int flags, int is_f64, void* stream) {
  return dispatch<false>(fin, fout, X, Y, Z, consts, flags, is_f64, stream);
}

// The same step on the lanes layout (19, Y, X*Z), lane = z*X + x.
extern "C" int lbm_d3q19_lanes(const void* fin, void* fout, long long X, long long Y,
                               long long Z, const double* consts, int flags, int is_f64,
                               void* stream) {
  return dispatch<true>(fin, fout, X, Y, Z, consts, flags, is_f64, stream);
}

// Kernel 33: one sweep of the step on each of `n_shards` (1 to MAX_SHARDS)
// shards of the y axis of the planes state on one device, `geoms` their
// n_shards geometry arrays back to back (csrc/halo.cuh: 19 X planes, rows
// y, columns z, the grid's Y rows); `consts` and `flags` as lbm_d3q19's.
// Returns the cudaError_t of the launch (0 = accepted).
extern "C" int lbm_halo_d3q19(const long long* geoms, const double* consts, int n_shards, int X,
                              int flags, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_halo<double>(geoms, n_shards, consts, X, flags, s)
                : launch_halo<float>(geoms, n_shards, consts, X, flags, s);
}
