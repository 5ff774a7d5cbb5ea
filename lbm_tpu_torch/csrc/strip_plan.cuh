// The geometry of the MRT-CG strip engine (csrc/mrtcg.cuh) and the rule
// that gives a launch to it or to the tile engine.  Host arithmetic only,
// with no CUDA header, so that a C++ compiler alone can build it: the tests
// hold this one copy of the plan on the CPU (tests/test_torch_mrtcg.py) and
// through the library on the card.
#pragma once

#include <cstddef>
#include <cstdint>

namespace lbm {
namespace mrtcg {

// The strip engine's shape for type T: a block walks down a strip of at
// most WMAX = NX - 2 output columns, G rows at a time, with NX * G threads;
// thread (ty, tx) collides column tx of the strip's NX (its columns and the
// ring's two) in row ty of a group, and pulls the output cell there.
template <typename T>
struct Strip {
  static constexpr int NX = 64;
  static constexpr int G = sizeof(T) == 4 ? 4 : 2;
  static constexpr int THREADS = NX * G;
  static constexpr int WMAX = NX - 2;
  static constexpr int MIN_BLOCKS = 2;  // resident blocks per SM asked of ptxas
};

// A strip's columns are a multiple of this: whole 32-byte sectors of the
// output rows where a block writes 18 planes, or any float64 output, so
// that no sector is written half by one block and half by its neighbour.
template <typename T, bool ROUT>
constexpr int strip_align() {
  return sizeof(T) == 8 ? 4 : (ROUT ? 1 : 8);
}

// The shared memory of one block, in elements of T:
//   stage  2 x G input rows of the window (all planes; filled by async
//          copies one group ahead of their use);
//   fields psi, q_c ux, q_c uy (+ nx, ny in CSF mode) on NS = G + 2 H
//          window rows (what a segment's first group writes), a ring: slot
//          (row - base) mod NS;
//   post   the 18 post-collision values on NK = G + 2 rows of NX columns,
//          a ring the same way.
// A window row holds the main columns [c0 - H, c0 + w + H) of a strip of w
// columns from c0, then H seam columns at MAIN (the wrapped neighbours of
// the grid's edge strips under PeriodicCols).
template <typename T, bool CSF, bool RIN>
struct Rings {
  static constexpr int H = CSF ? 5 : 3;
  static constexpr int G = Strip<T>::G, NX = Strip<T>::NX;
  static constexpr int MAIN = Strip<T>::WMAX + 2 * H;
  static constexpr int COLS = MAIN + H;
  static constexpr int PLANES = RIN ? (CSF ? 12 : 10) : (CSF ? 20 : 18);
  static constexpr int FIELDS = CSF ? 5 : 3;
  static constexpr int NS = G + 2 * H;
  static constexpr int NK = G + 2;
  static constexpr int STAGE = 2 * G * PLANES * COLS;
  static constexpr int FIELD = NS * COLS;
  static constexpr int POST = NK * NX;
  static constexpr size_t BYTES = sizeof(T) * (STAGE + FIELDS * FIELD + 18 * POST);
};

// A launch's work: its columns cut into n strips of W (the last may be
// narrower), its rows into groups of G; unit u = strip * groups + group,
// and block b takes the units [b per, (b + 1) per), consecutive rows of one
// strip or the end of one and the start of the next.  `strips`: whether
// the strip engine takes the launch (strips_pay).
struct Strips {
  int64_t W, n, groups, per, blocks;
  bool strips;
};

// The groups a block of the strip engine must walk before it overtakes the
// 8 x 32 tile engine, by instance (0: never).  A segment's first group
// re-reads 2 H rows of scalars and collides G + 2 rows, about three groups'
// work, so short segments lose; the heavier cells (CSF, float64) gain more
// a group and overtake sooner.  From a sweep of kernels 6 and 8 over grids
// from 128x128 to 4096x2048 and of the sharded kernels on an H100, each
// engine in turns with the other (chip_smoke.py --engine-sweep; PERF.md
// section 6).  The float32 perturbation step with 18 output planes never
// gained (bound by its stores); the row and rows x cols shards' memories
// lose more per segment and need twice the count.
template <typename T, bool CSF, bool RIN, bool ROUT>
constexpr int64_t min_groups() {
  if (sizeof(T) == 4) return CSF ? 16 : (ROUT ? 32 : 0);
  return CSF && !RIN ? 32 : 8;
}

template <typename T, bool CSF, bool RIN, bool ROUT>
constexpr bool strips_pay(int64_t per, bool sharded) {
  return min_groups<T, CSF, RIN, ROUT>() > 0 &&
         per >= (sharded ? 2 : 1) * min_groups<T, CSF, RIN, ROUT>();
}

// The plan of a launch of `width` columns and `nrows` rows, `lanes` lane
// blocks along the grid's z, on a card of `sms` SMs that holds `held`
// blocks of the strip instance at once: as many blocks as the card holds,
// and at least two waves of one block per SM, over the lanes, at most one
// per unit (fewer, longer segments: a segment's first group re-reads 2 H
// rows).  `sharded`: the memory is a row or a rows x cols shard's.
template <typename T, bool CSF, bool RIN, bool ROUT>
inline Strips plan_strips(int64_t width, int64_t nrows, int64_t held, int64_t sms,
                          int64_t lanes, bool sharded) {
  constexpr int64_t A = strip_align<T, ROUT>(), WMAX = Strip<T>::WMAX / A * A, G = Strip<T>::G;
  const int64_t wanted = ((held > 2 * sms ? held : 2 * sms) + lanes - 1) / lanes;
  Strips s;
  s.n = (width + WMAX - 1) / WMAX;
  s.W = ((width + s.n - 1) / s.n + A - 1) / A * A;
  s.n = (width + s.W - 1) / s.W;
  s.groups = (nrows + G - 1) / G;
  const int64_t units = s.n * s.groups;
  const int64_t blocks = wanted < 1 ? 1 : (wanted > units ? units : wanted);
  s.per = (units + blocks - 1) / blocks;
  s.blocks = (units + s.per - 1) / s.per;
  s.strips = strips_pay<T, CSF, RIN, ROUT>(s.per, sharded);
  return s;
}

// plan_strips into out[0..6]: W, n, groups, per, blocks, the strip
// engine's shared memory a block in bytes, and 1 where it takes the launch.
template <typename T, bool CSF, bool RIN, bool ROUT>
void plan_into(int64_t width, int64_t nrows, int64_t held, int64_t sms, int64_t lanes,
               bool sharded, long long* out) {
  const Strips s = plan_strips<T, CSF, RIN, ROUT>(width, nrows, held, sms, lanes, sharded);
  out[0] = s.W;
  out[1] = s.n;
  out[2] = s.groups;
  out[3] = s.per;
  out[4] = s.blocks;
  out[5] = static_cast<long long>(Rings<T, CSF, RIN>::BYTES);
  out[6] = s.strips ? 1 : 0;
}

// The instance of (is_f64, csf, rin, rout): the layouts the units build
// (reduced in and out, kernels 6, 29, 39; reduced in, full out, kernel 7;
// full in and out, kernels 8, 31, 38).  out[0] = -1 for any other.
inline void plan_by_layout(long long width, long long nrows, long long held, long long sms,
                           long long lanes, int sharded, int csf, int is_f64, int rin, int rout,
                           long long* out) {
  const long long a[5] = {width, nrows, held, sms, lanes};
  const bool sh = sharded != 0;
  const int key = (is_f64 ? 8 : 0) | (csf ? 4 : 0) | (rin ? 2 : 0) | (rout ? 1 : 0);
  switch (key) {
    case 0: return plan_into<float, false, false, false>(a[0], a[1], a[2], a[3], a[4], sh, out);
    case 2: return plan_into<float, false, true, false>(a[0], a[1], a[2], a[3], a[4], sh, out);
    case 3: return plan_into<float, false, true, true>(a[0], a[1], a[2], a[3], a[4], sh, out);
    case 4: return plan_into<float, true, false, false>(a[0], a[1], a[2], a[3], a[4], sh, out);
    case 6: return plan_into<float, true, true, false>(a[0], a[1], a[2], a[3], a[4], sh, out);
    case 7: return plan_into<float, true, true, true>(a[0], a[1], a[2], a[3], a[4], sh, out);
    case 8: return plan_into<double, false, false, false>(a[0], a[1], a[2], a[3], a[4], sh, out);
    case 10: return plan_into<double, false, true, false>(a[0], a[1], a[2], a[3], a[4], sh, out);
    case 11: return plan_into<double, false, true, true>(a[0], a[1], a[2], a[3], a[4], sh, out);
    case 12: return plan_into<double, true, false, false>(a[0], a[1], a[2], a[3], a[4], sh, out);
    case 14: return plan_into<double, true, true, false>(a[0], a[1], a[2], a[3], a[4], sh, out);
    case 15: return plan_into<double, true, true, true>(a[0], a[1], a[2], a[3], a[4], sh, out);
    default: out[0] = -1;
  }
}

}  // namespace mrtcg
}  // namespace lbm
