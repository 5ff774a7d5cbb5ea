// Halo inputs of the rows x cols body kernels 35-38 (kernels/sharded2d.py).
//
// Replaces the slab pipeline of lbm_tpu/kernels/sharded2d_pallas.py:240
// (make_local_2d_step :223, the kernel _kernel with its four DMAs a block,
// _dma_in): a shard of an (nx, ny) mesh reads its padded block
// [0, R_loc + 2 halo) x [0, C_loc + 2 halo) in place from five buffers, each
// a (planes, rows, cols) tensor with its own plane and row strides:
//   top   padded rows [0, halo),           columns [halo, halo + C_loc)
//   mid   padded rows [halo, halo + R_loc), the same columns (the shard)
//   bot   padded rows [halo + R_loc, ...),  the same columns
//   left  every padded row, columns [0, halo)
//   right every padded row, columns [halo + C_loc, C_loc + 2 halo)
// The column strips carry their row halos (parallel/halo.py exchange_2d),
// so a corner comes from the diagonal neighbour.  lbm_tpu packs its two
// column halves into one 128-lane tile after the interior lanes, a Mosaic
// layout; here each side is its own strip, `halo` columns wide.  Nothing is
// concatenated: later sweeps of one exchange read a scratch slab of the
// whole padded block, passed as the same five parts of one buffer.
//
// A launch writes the padded cells [out_r_lo, out_r_hi) x [out_c_lo,
// out_c_hi) of `out`, whose row 0 and column 0 are padded row and column
// `out_first` (halo for the shard itself, 0 for a slab), from the cells
// [in_r_lo, in_r_hi) x [in_c_lo, in_c_hi) that it reads.  The Python side
// (kernels/sharded2d.py launch_sweeps_2d) chooses the bands: sweep j of s
// writes s - j more rows and columns on each side of the shard.
//
// Kernels 35 and 37 read their padded block from 3 x 3 parts instead
// (`Parts` below): parallel/halo.py ring_2d's views of the neighbours' own
// lines, which a five-part left or right strip cannot name (its corners lie
// in two other blocks).
//
// The body kernels 36-38 (kernels/sharded2d.py make_sharded2d_body_step)
// read five more entries, in either geometry: the shard's global row and
// column offsets, the grid's R and C, and whether the shard's rows reach a
// wall (row ranks 0 and nx-1).  Padded row p is global row off_r - halo + p, padded column q
// global column off_c - halo + q, wrapped into [0, C): the walls and the
// stencils' replicate padding act by global index, while every value is
// read from the padded block, never wrapped within it.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace lbm {
namespace halo2d {

// The geometry array of one launch, in the order of kernels/sharded2d.py GEOM.
enum Geom {
  TOP, MID, BOT, LEFT, RIGHT, OUT,
  TOP_PLANE, MID_PLANE, BOT_PLANE, LEFT_PLANE, RIGHT_PLANE, OUT_PLANE,
  TOP_LD, MID_LD, BOT_LD, LEFT_LD, RIGHT_LD, OUT_LD,
  HALO, R_LOC, C_LOC, IN_R_LO, IN_R_HI, IN_C_LO, IN_C_HI,
  OUT_R_LO, OUT_R_HI, OUT_C_LO, OUT_C_HI, OUT_FIRST, OFF_R, OFF_C, ROWS, COLS, EDGE, NGEOM
};

// One of the five input buffers: plane 0's base, plane and row strides.
template <typename T>
struct Part {
  const T* base;
  int64_t plane, ld;

  __device__ __forceinline__ const T* at(int64_t r, int64_t c, int64_t& pl) const {
    pl = plane;
    return base + r * ld + c;
  }
};

// The padded block of one shard, read in place from its five buffers.
template <typename T>
struct View {
  Part<T> top, mid, bot, left, right;
  int64_t halo, r_loc, c_loc;

  // Plane 0's entry at padded (p, q); `plane` gets that buffer's stride.
  __device__ __forceinline__ const T* locate(int64_t p, int64_t q, int64_t& plane) const {
    if (q < halo) return left.at(p, q, plane);
    if (q >= halo + c_loc) return right.at(p, q - halo - c_loc, plane);
    const int64_t c = q - halo;
    if (p < halo) return top.at(p, c, plane);
    if (p < halo + r_loc) return mid.at(p - halo, c, plane);
    return bot.at(p - halo - r_loc, c, plane);
  }
};

// The padded cells a launch writes; row and column 0 of `base` are `first`.
template <typename T>
struct Out {
  T* base;
  int64_t plane, ld, first, r_lo, r_hi, c_lo, c_hi;

  __device__ __forceinline__ bool has(int64_t p, int64_t q) const {
    return p >= r_lo && p < r_hi && q >= c_lo && q < c_hi;
  }
  __device__ __forceinline__ T* at(int64_t p, int64_t q) const {
    return base + (p - first) * ld + (q - first);
  }
};

// One launch's geometry, parsed on the host.
template <typename T>
struct Launch {
  View<T> in;
  Out<T> out;
  int64_t r_lo, r_hi, c_lo, c_hi;  // the cells read
  int64_t off_r, off_c, R, C;      // the shard's global offsets, the grid's shape
  bool edge;                       // the shard's rows reach a wall

  // the global row of padded row p, the global column of padded column q
  __host__ __device__ int64_t global_row(int64_t p) const { return off_r - in.halo + p; }
  __host__ __device__ int64_t global_col(int64_t q) const {
    const int64_t g = off_c - in.halo + q;
    return g < 0 ? g + C : (g >= C ? g - C : g);
  }
};

template <typename T>
inline Launch<T> parse(const long long* g) {
  auto part = [&](int buf, int plane, int ld) {
    return Part<T>{reinterpret_cast<const T*>(g[buf]), g[plane], g[ld]};
  };
  Launch<T> L;
  L.in.top = part(TOP, TOP_PLANE, TOP_LD);
  L.in.mid = part(MID, MID_PLANE, MID_LD);
  L.in.bot = part(BOT, BOT_PLANE, BOT_LD);
  L.in.left = part(LEFT, LEFT_PLANE, LEFT_LD);
  L.in.right = part(RIGHT, RIGHT_PLANE, RIGHT_LD);
  L.in.halo = g[HALO];
  L.in.r_loc = g[R_LOC];
  L.in.c_loc = g[C_LOC];
  L.out = Out<T>{reinterpret_cast<T*>(g[OUT]), g[OUT_PLANE], g[OUT_LD], g[OUT_FIRST],
                 g[OUT_R_LO], g[OUT_R_HI], g[OUT_C_LO], g[OUT_C_HI]};
  L.r_lo = g[IN_R_LO];
  L.r_hi = g[IN_R_HI];
  L.c_lo = g[IN_C_LO];
  L.c_hi = g[IN_C_HI];
  L.off_r = g[OFF_R];
  L.off_c = g[OFF_C];
  L.R = g[ROWS];
  L.C = g[COLS];
  L.edge = g[EDGE] != 0;
  return L;
}

// The padded block of one shard read in place from 3 x 3 parts (kernel 35;
// parallel/halo.py ring_2d): part (a, b) holds padded rows [0, halo),
// [halo, halo + r_loc) or the rest by a, and the columns the same way by b,
// each with its own plane and row strides: a neighbour's own lines where
// it shares the card, a copy elsewhere, or 3 x 3 views of one scratch slab.
template <typename T>
struct Parts {
  Part<T> in[3][3];
  int64_t halo, r_loc, c_loc;

  // Plane 0's entry at padded (p, q); `plane` gets that part's stride.
  __device__ __forceinline__ const T* locate(int64_t p, int64_t q, int64_t& plane) const {
    const int a = p < halo ? 0 : (p < halo + r_loc ? 1 : 2);
    const int b = q < halo ? 0 : (q < halo + c_loc ? 1 : 2);
    const int64_t r = p - (a == 0 ? 0 : (a == 1 ? halo : halo + r_loc));
    const int64_t c = q - (b == 0 ? 0 : (b == 1 ? halo : halo + c_loc));
    return in[a][b].at(r, c, plane);
  }
};

// The geometry array of one shard of a parts launch, in the order of
// kernels/sharded2d.py PARTS_GEOM: the 3 x 3 parts row-major, each (base,
// plane stride, row stride), then the output, the parts' halo and the
// shard's rows and columns, the cells read and the cells written, and the
// body kernels' five entries (kernel 37 reads them, kernel 35 does not).
enum PartsGeom {
  PARTS = 0, P_OUT = 27, P_OUT_PLANE, P_OUT_LD, P_OUT_FIRST, P_HALO, P_R_LOC, P_C_LOC,
  P_IN_R_LO, P_IN_R_HI, P_IN_C_LO, P_IN_C_HI, P_OUT_R_LO, P_OUT_R_HI, P_OUT_C_LO, P_OUT_C_HI,
  P_OFF_R, P_OFF_C, P_ROWS, P_COLS, P_EDGE, NPARTS_GEOM
};

// One shard's sweep on its 3 x 3 parts, parsed on the host.
template <typename T>
struct PartsLaunch {
  Parts<T> in;
  Out<T> out;
  int64_t r_lo, r_hi, c_lo, c_hi;  // the cells read
  int64_t off_r, off_c, R, C;      // the shard's global offsets, the grid's shape
  bool edge;                       // the shard's rows reach a wall

  // the global row of padded row p
  __host__ __device__ int64_t global_row(int64_t p) const { return off_r - in.halo + p; }
};

template <typename T>
inline PartsLaunch<T> parse_parts(const long long* g) {
  PartsLaunch<T> L;
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      const long long* p = g + PARTS + 3 * (3 * a + b);
      L.in.in[a][b] = Part<T>{reinterpret_cast<const T*>(p[0]), p[1], p[2]};
    }
  L.in.halo = g[P_HALO];
  L.in.r_loc = g[P_R_LOC];
  L.in.c_loc = g[P_C_LOC];
  L.out = Out<T>{reinterpret_cast<T*>(g[P_OUT]), g[P_OUT_PLANE], g[P_OUT_LD], g[P_OUT_FIRST],
                 g[P_OUT_R_LO], g[P_OUT_R_HI], g[P_OUT_C_LO], g[P_OUT_C_HI]};
  L.r_lo = g[P_IN_R_LO];
  L.r_hi = g[P_IN_R_HI];
  L.c_lo = g[P_IN_C_LO];
  L.c_hi = g[P_IN_C_HI];
  L.off_r = g[P_OFF_R];
  L.off_c = g[P_OFF_C];
  L.R = g[P_ROWS];
  L.C = g[P_COLS];
  L.edge = g[P_EDGE] != 0;
  return L;
}

// A kernel's memory (kernel 38 on the tile and strip engines of
// csrc/mrtcg.cuh): rows by global index, as lbm::halo::ShardIO's, columns
// by padded index q (the engine's BandCols), the shard's five buffers in and
// `out` written.
template <typename T>
struct Shard2DIO {
  View<T> in;
  Out<T> out;
  int64_t off_r;

  __device__ __forceinline__ const T* src(int64_t gr, int64_t q, int64_t& plane) const {
    return in.locate(gr - off_r + in.halo, q, plane);
  }
  __device__ __forceinline__ T* dst(int64_t gr, int64_t q, int64_t& plane) const {
    plane = out.plane;
    return out.at(gr - off_r + in.halo, q);
  }
};

// Kernel 37's memory, as Shard2DIO's but read from the 3 x 3 parts of one
// shard of a batched launch: a reference to its geometry, which stays in the
// kernel's parameter space (a copy would index the parts in local memory).
template <typename T>
struct PartsIO {
  const PartsLaunch<T>& L;

  __device__ __forceinline__ const T* src(int64_t gr, int64_t q, int64_t& plane) const {
    return L.in.locate(gr - L.off_r + L.in.halo, q, plane);
  }
  __device__ __forceinline__ T* dst(int64_t gr, int64_t q, int64_t& plane) const {
    plane = L.out.plane;
    return L.out.at(gr - L.off_r + L.in.halo, q);
  }
};

}  // namespace halo2d
}  // namespace lbm
