// Halo inputs of the row-sharded kernels 27-30 (kernels/sharded.py).
//
// Replaces the slab pipeline of lbm_tpu/kernels/sharded_pallas.py:202
// _halo_body_kernel (called at :321 by make_local_halo_body_step), which
// DMAs block 0's top halo and the last block's bottom halo from the
// exchanged buffers instead of the periodic wrap.  Here a launch reads a
// shard's padded rows p in [0, R_loc + 2 halo) in place from three buffers,
// each a (planes, rows, C) tensor with its own plane stride: rows
// p < halo from `top`, rows halo..halo+R_loc-1 from `mid` (the shard),
// the rest from `bot`.  Nothing is concatenated: a copy of the shard with
// its halos would cost a full read and write of the shard per exchange.
// Later sweeps of one exchange read a scratch slab of all the padded rows,
// passed as the same three parts of one buffer.  Padded row p is global row
// off - halo + p, so the walls and the stencils' replicate padding sit at
// the grid's rows 0 and R-1 on every shard.
//
// A launch writes the padded rows [out_lo, out_hi) of `out`, whose row 0
// is padded row `out_first` (halo for the shard's own rows, 0 for a slab),
// from the padded rows [in_lo, in_hi) that it reads.  The Python side
// (kernels/sharded.py launch_sweeps) chooses those bands so that every row
// written is exact: sweep j of s writes the rows the remaining s - j sweeps
// need, and the wall families' bands end at the grid's walls.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "d2q9.cuh"

namespace lbm {
namespace halo {

// The geometry array of one launch, in the order of kernels/sharded.py GEOM.
enum Geom {
  TOP, MID, BOT, OUT, TOP_PLANE, MID_PLANE, BOT_PLANE, OUT_PLANE, HALO, R_LOC, COLS,
  IN_LO, IN_HI, OUT_LO, OUT_HI, OUT_FIRST, OFF, ROWS, EDGE, NGEOM
};

// The padded rows of one shard, read in place from their three buffers.
template <typename T>
struct View {
  const T* top;
  const T* mid;
  const T* bot;
  int64_t top_plane, mid_plane, bot_plane, halo, r_loc, C;

  // Plane 0's entry at padded (p, c); `plane` gets that buffer's stride.
  __device__ __forceinline__ const T* locate(int64_t p, int64_t c, int64_t& plane) const {
    if (p < halo) {
      plane = top_plane;
      return top + p * C + c;
    }
    if (p < halo + r_loc) {
      plane = mid_plane;
      return mid + (p - halo) * C + c;
    }
    plane = bot_plane;
    return bot + (p - halo - r_loc) * C + c;
  }
};

// The padded rows [lo, hi) that a launch writes; row 0 of `base` is `first`.
template <typename T>
struct Out {
  T* base;
  int64_t plane, first, lo, hi, C;

  __device__ __forceinline__ bool has(int64_t p) const { return p >= lo && p < hi; }
  __device__ __forceinline__ T* at(int64_t p, int64_t c) const {
    return base + (p - first) * C + c;
  }
};

// One launch's geometry, parsed on the host.
template <typename T>
struct Launch {
  View<T> in;
  Out<T> out;
  int64_t in_lo, in_hi, off, R;
  bool edge;

  // the global row of padded row p, and back
  __host__ __device__ int64_t global(int64_t p) const { return off - in.halo + p; }
  __host__ __device__ int64_t padded(int64_t gr) const { return gr - off + in.halo; }
};

template <typename T>
inline Launch<T> parse(const long long* g) {
  Launch<T> L;
  L.in.top = reinterpret_cast<const T*>(g[TOP]);
  L.in.mid = reinterpret_cast<const T*>(g[MID]);
  L.in.bot = reinterpret_cast<const T*>(g[BOT]);
  L.in.top_plane = g[TOP_PLANE];
  L.in.mid_plane = g[MID_PLANE];
  L.in.bot_plane = g[BOT_PLANE];
  L.in.halo = g[HALO];
  L.in.r_loc = g[R_LOC];
  L.in.C = g[COLS];
  L.out.base = reinterpret_cast<T*>(g[OUT]);
  L.out.plane = g[OUT_PLANE];
  L.out.first = g[OUT_FIRST];
  L.out.lo = g[OUT_LO];
  L.out.hi = g[OUT_HI];
  L.out.C = g[COLS];
  L.in_lo = g[IN_LO];
  L.in_hi = g[IN_HI];
  L.off = g[OFF];
  L.R = g[ROWS];
  L.edge = g[EDGE] != 0;
  return L;
}

// A stencil kernel's memory by global row (kernels 29 and 30 on the tile
// engine of csrc/mrtcg.cuh): the shard's padded rows in, `out` written.
template <typename T>
struct ShardIO {
  View<T> in;
  Out<T> out;
  int64_t off;

  __device__ __forceinline__ const T* src(int64_t gr, int64_t gc, int64_t& plane) const {
    return in.locate(gr - off + in.halo, gc, plane);
  }
  __device__ __forceinline__ T* dst(int64_t gr, int64_t gc, int64_t& plane) const {
    plane = out.plane;
    return out.at(gr - off + in.halo, gc);
  }
};

}  // namespace halo
}  // namespace lbm
