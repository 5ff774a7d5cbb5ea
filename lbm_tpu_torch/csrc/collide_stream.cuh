// The periodic D2Q9 collide-stream step around a local collision, in its
// two forms: the single-device step of kernels 1, 3, 5, 10 and 11, and the
// sharded call of kernels 27 (row shards, kernels/sharded.py) and 34 (rows x
// cols shards, kernels/sharded2d.py), which runs a call's s steps on up to
// MAX_SHARDS shards of a card in one launch.  Each family's source defines
// its collision once, as a functor `op(f, coll)` on one cell's 9
// populations, and instantiates every form with it, so the sharded steps
// compute with the same device code and the same compiler flags as the
// single-device one, and an n-shard run equals it bit for bit.
//
// Step: stream(collide(f)), as lbm_tpu's step is (collide_stream.py:116-117):
// a cell's 9 populations are collided and coll_k moves to (r + cx_k, c +
// cy_k).  (A pull kernel that gathers and then collides would compute
// collide(stream(f)), a different state.)
//
// Single device (periodic_step): a thread loads its cell's 9 populations,
// collides, and PUSHES coll_k into a separate output buffer; threads along a
// warp take neighbouring columns, so every plane load and store is
// coalesced.  Several steps per call are several launches.
//
// Kernels 27 and 34 replace lbm_tpu/kernels/sharded_pallas.py:171
// make_local_halo_step (:528 make_sharded_fused_step) and
// sharded2d_pallas.py:223 make_local_2d_step (its pallas_call at :240; :290
// make_sharded_fused_step_2d), whose kernels run a call's s steps on a VMEM
// slab (the loop `for _s in range(substeps)` of sharded_pallas.py:184-190).
// A shard's input is its padded block of (rows + 2 halo) x (cols + 2 halo)
// cells, read in place from 3 x 3 parts (`Shard`): the shard itself in the
// middle, its eight neighbours' edge lines and corners around it, each with
// its own base, plane stride and row stride (parallel/halo.py ring_rows and
// ring_2d: views of a neighbour's buffer where it shares the card, copies
// only across cards).  A row shard (kernel 27) has the middle column of
// parts only and wraps its columns mod cols.  Two engines, the same bits:
//   * tile_steps (s >= 2): a block owns an output tile of the shard, loads
//     the tile and s lines on every side into shared memory once (cp.async),
//     runs the s steps there, the region it computes shrinking by one line a
//     side each step, and writes the tile once: one pass over device memory
//     a call.  The steps run in place in one buffer by the AA pattern: an odd
//     step reads a cell's own 9 values and writes coll_k back into plane
//     opp(k) of the same cell; an even step gathers f_k from plane opp(k) of
//     the cell at x - c_k, collides, and writes coll_k into plane k at x +
//     c_k.  The locations a thread writes are exactly those it read, and no
//     two threads share one, so one barrier a step is enough, and no value
//     waits in registers across it;
//   * push_step (s = 1): one thread per cell of the shard and a one-line
//     ring around it, reading in place, pushing into the shard only.
// Either way each cell's populations go through op(f, coll) with the same 9
// inputs as the single-device kernel's, so the result is its bits.
//
// Bound: device-memory bytes, 72 B/cell in float32 (9 planes in, 9 out) once
// a call over the shards' cells, plus the s lines a side the first step
// reads; the tile engine reads its box, (TR + 2 s)(TC + 2 s) cells for TR x TC
// written, and collides each box cell of the shrinking regions.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "async_copy.cuh"
#include "d2q9.cuh"

namespace lbm {

template <typename T, typename Op>
__global__ void periodic_step(const T* __restrict__ fin, T* __restrict__ fout, int64_t R,
                              int64_t C, Op op) {
  const int64_t n = R * C;
  const int64_t cell = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  const int64_t r = cell / C;
  const int64_t c = cell - r * C;

  T f[9];
  load9(fin, n, cell, f);
  T coll[9];
  op(f, coll);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int64_t rr = wrap(r + cx(k), R);
    const int64_t cc = wrap(c + cy(k), C);
    fout[k * n + rr * C + cc] = coll[k];
  }
}

// One periodic step f_in -> f_out (distinct buffers); returns the
// cudaError_t of the launch (0 = accepted).
template <typename T, typename Op>
int launch_periodic(const void* fin, void* fout, long long R, long long C, const Op& op,
                    cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(R) * C;
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  periodic_step<T, Op><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(fin), static_cast<T*>(fout), R, C, op);
  return static_cast<int>(cudaGetLastError());
}

namespace block {

// The most shards one launch takes (kernels/_build.py MAX_SHARDS).
constexpr int MAX_SHARDS = 8;

// The geometry array of one shard, in the order of kernels/sharded.py
// BLOCK_GEOM: 3 x 3 parts (base, plane stride, row stride) row-major, then
// the output (base, plane stride, row stride), the parts' halo, the shard's
// rows and columns, and whether its columns wrap (a row shard).
enum Geom { PARTS = 0, OUT = 27, OUT_PLANE, OUT_LD, HALO, ROWS, COLS, WRAP, NGEOM };

template <typename T>
struct Part {
  const T* base;
  int64_t plane, ld;
};

// One shard's padded block, read in place, and its output.  Padded row p
// lies in part row 0 (p < halo), 1 (the shard's rows) or 2; padded column q
// in part column 0, 1 or 2 the same way, or, where the columns wrap, in part
// column 1 at column (q - halo) mod cols.
template <typename T>
struct Shard {
  Part<T> in[3][3];
  T* out;
  int64_t out_plane, out_ld, halo, rows, cols;
  int wrap;

  // Plane 0's entry at padded (p, q); `plane` gets that part's stride.
  __device__ __forceinline__ const T* locate(int64_t p, int64_t q, int64_t& plane) const {
    const int a = p < halo ? 0 : (p < halo + rows ? 1 : 2);
    const int64_t r = p - (a == 0 ? 0 : (a == 1 ? halo : halo + rows));
    int b = 1;
    int64_t c;
    if (wrap) {
      c = wrap_any(q - halo, cols);
    } else {
      b = q < halo ? 0 : (q < halo + cols ? 1 : 2);
      c = q - (b == 0 ? 0 : (b == 1 ? halo : halo + cols));
    }
    const Part<T>& P = in[a][b];
    plane = P.plane;
    return P.base + r * P.ld + c;
  }
};

// The shards of one launch, a kernel parameter (~2.2 KB); blockIdx.y picks one.
template <typename T>
struct Shards {
  Shard<T> s[MAX_SHARDS];
};

template <typename T>
inline Shard<T> parse(const long long* g) {
  Shard<T> S;
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      const long long* p = g + PARTS + 3 * (3 * a + b);
      S.in[a][b] = Part<T>{reinterpret_cast<const T*>(p[0]), p[1], p[2]};
    }
  S.out = reinterpret_cast<T*>(g[OUT]);
  S.out_plane = g[OUT_PLANE];
  S.out_ld = g[OUT_LD];
  S.halo = g[HALO];
  S.rows = g[ROWS];
  S.cols = g[COLS];
  S.wrap = g[WRAP] != 0;
  return S;
}

// The tile engine's shared-memory box: ROWS x COLS cells of 9 planes, one
// buffer, THREADS threads a block (COLS a row, THREADS / COLS rows a pass),
// MIN_BLOCKS resident blocks an SM asked of ptxas.  A call of s steps writes
// an interior of (ROWS - 2 s) x (COLS - 2 s) cells.  The collisions are
// bound by their latency more than by their count (an H100 timed it,
// chip_smoke.py --k27-k34): resident warps pay first, fewer halo collisions
// second.  Float32 takes two blocks an SM of 48 rows, 110.6 KB and 512
// threads each (64 registers a thread), or, for a long collision (HEAVY:
// KBC, the power law), one block of 96 rows and 1024 threads (1.33 box cells
// collided a written cell against 1.54); float64 one block of 48 rows, 221
// KB, with 1024 threads, or 512 where the collision needs more than 64
// registers (WIDE: KBC, 118-128 in float64).
template <typename T, bool WIDE, bool HEAVY>
struct Box {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr bool TALL = F32 && HEAVY;
  static constexpr int ROWS = TALL ? 96 : 48;
  static constexpr int COLS = 64;
  static constexpr int THREADS = TALL || !(F32 || WIDE) ? 1024 : 512;
  static constexpr int MIN_BLOCKS = F32 && !TALL ? 2 : 1;
  static constexpr int PLANE = ROWS * COLS;
  static constexpr size_t BYTES = sizeof(T) * 9 * PLANE;
};

// Whether a collision functor declares `static constexpr bool WIDE = true`
// (`wide`) or `HEAVY = true` (`heavy`).
template <typename Op, typename = void>
struct wide : std::false_type {};
template <typename Op>
struct wide<Op, std::void_t<decltype(Op::WIDE)>> : std::bool_constant<Op::WIDE> {};
template <typename Op, typename = void>
struct heavy : std::false_type {};
template <typename Op>
struct heavy<Op, std::void_t<decltype(Op::HEAVY)>> : std::bool_constant<Op::HEAVY> {};

// The box of a collision.
template <typename T, typename Op>
using BoxOf = Box<T, wide<Op>::value, heavy<Op>::value>;

// The plan of a launch: the tile engine where a call runs two steps or
// more, the one-thread-a-cell push for one step.
constexpr bool use_tile(int steps) { return steps >= 2; }

// The s-step call on one tile of one shard (blockIdx.x the tile, row-major
// over tiles_c tile columns; blockIdx.y the shard).  Box cell (r, c) is
// padded (p0 + r, q0 + c); step t collides the box cells [t - 1, hb - t + 1)
// x [t - 1, wb - t + 1), whose values at time t - 1 are exact.
template <typename T, typename Op, typename B = BoxOf<T, Op>>
__global__ void __launch_bounds__(B::THREADS, B::MIN_BLOCKS)
    tile_steps(const __grid_constant__ Shards<T> shards, int steps, int tiles_c, Op op) {
  constexpr int BC = B::COLS, PLANE = B::PLANE, PASS = B::THREADS / BC;
  const Shard<T>& S = shards.s[blockIdx.y];
  const int TR = B::ROWS - 2 * steps, TC = BC - 2 * steps;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x / tiles_c) * TR;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x % tiles_c) * TC;
  if (r0 >= S.rows || c0 >= S.cols) return;  // the whole block: no barrier waits
  const int h = S.rows - r0 < TR ? static_cast<int>(S.rows - r0) : TR;
  const int w = S.cols - c0 < TC ? static_cast<int>(S.cols - c0) : TC;
  const int hb = h + 2 * steps, wb = w + 2 * steps;
  const int64_t p0 = S.halo - steps + r0, q0 = S.halo - steps + c0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* box = reinterpret_cast<T*>(smem_raw);
  const int tx = threadIdx.x % BC, ty = threadIdx.x / BC;

  if (tx < wb)
    for (int r = ty; r < hb; r += PASS) {
      int64_t plane;
      const T* src = S.locate(p0 + r, q0 + tx, plane);
      T* dst = box + r * BC + tx;
#pragma unroll
      for (int k = 0; k < 9; ++k) async_copy(dst + k * PLANE, src + k * plane);
    }
  async_commit();
  async_wait_all();
  __syncthreads();

  for (int t = 1; t <= steps; ++t) {
    const int lo = t - 1;
    if (tx >= lo && tx < wb - lo)
      for (int r = lo + ty; r < hb - lo; r += PASS) {
        T* x = box + r * BC + tx;
        T f[9], coll[9];
        if (t & 1) {
#pragma unroll
          for (int k = 0; k < 9; ++k) f[k] = x[k * PLANE];
          op(f, coll);
#pragma unroll
          for (int k = 0; k < 9; ++k) x[opp(k) * PLANE] = coll[k];
        } else {
#pragma unroll
          for (int k = 0; k < 9; ++k) f[k] = x[opp(k) * PLANE - cx(k) * BC - cy(k)];
          op(f, coll);
#pragma unroll
          for (int k = 0; k < 9; ++k) x[k * PLANE + cx(k) * BC + cy(k)] = coll[k];
        }
      }
    __syncthreads();
  }

  // f_k at time s: plane k in place after an even step, plane opp(k) of the
  // cell at x - c_k after an odd one
  if (tx >= steps && tx < steps + w)
    for (int r = steps + ty; r < steps + h; r += PASS) {
      const T* x = box + r * BC + tx;
      T* dst = S.out + (r0 + r - steps) * S.out_ld + (c0 + tx - steps);
      if (steps & 1) {
#pragma unroll
        for (int k = 0; k < 9; ++k)
          dst[k * S.out_plane] = x[opp(k) * PLANE - cx(k) * BC - cy(k)];
      } else {
#pragma unroll
        for (int k = 0; k < 9; ++k) dst[k * S.out_plane] = x[k * PLANE];
      }
    }
}

// One step on each shard: a thread per cell of the shard and a one-line ring
// around it ((rows + 2) x (cols + 2) cells, blockIdx.y the shard), pushing
// into the shard's cells only.
template <typename T, typename Op>
__global__ void push_step(const __grid_constant__ Shards<T> shards, Op op) {
  const Shard<T>& S = shards.s[blockIdx.y];
  const int64_t wp = S.cols + 2;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= (S.rows + 2) * wp) return;
  const int64_t a = i / wp - 1, b = i % wp - 1;  // the cell, in the shard's indices
  int64_t plane;
  const T* src = S.locate(S.halo + a, S.halo + b, plane);
  T f[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = src[k * plane];
  T coll[9];
  op(f, coll);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int64_t r = a + cx(k), c = b + cy(k);
    if (r >= 0 && r < S.rows && c >= 0 && c < S.cols)
      S.out[k * S.out_plane + r * S.out_ld + c] = coll[k];
  }
}

// A call of `steps` steps (1 to the parts' halo) on each of `n` (1 to
// MAX_SHARDS) shards of the current device, `geoms` their geometry arrays
// back to back, one launch; returns its cudaError_t (0 = accepted).
template <typename T, typename Op>
int launch_shards(const long long* geoms, int n, int steps, const Op& op,
                  cudaStream_t stream) {
  if (n < 1 || n > MAX_SHARDS || steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  Shards<T> shards;
  int64_t rows = 0, cols = 0;
  for (int i = 0; i < n; ++i) {
    const Shard<T> S = parse<T>(geoms + i * NGEOM);
    if (S.rows < 1 || S.cols < 1 || S.halo < steps)
      return static_cast<int>(cudaErrorInvalidValue);
    rows = S.rows > rows ? S.rows : rows;
    cols = S.cols > cols ? S.cols : cols;
    shards.s[i] = S;
  }
  if (use_tile(steps)) {
    using B = BoxOf<T, Op>;
    static bool done[MAX_DEVICES] = {};
    const cudaError_t e = smem_opt_in(tile_steps<T, Op>, static_cast<int>(B::BYTES), done);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t TR = B::ROWS - 2 * steps, TC = B::COLS - 2 * steps;
    if (TR < 1 || TC < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t tiles_c = (cols + TC - 1) / TC, tiles = (rows + TR - 1) / TR * tiles_c;
    if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(n));
    tile_steps<T, Op><<<grid, B::THREADS, B::BYTES, stream>>>(shards, steps,
                                                              static_cast<int>(tiles_c), op);
  } else {
    const int threads = 256;
    const int64_t blocks = ((rows + 2) * (cols + 2) + threads - 1) / threads;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
    push_step<T, Op><<<grid, threads, 0, stream>>>(shards, op);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace block
}  // namespace lbm
