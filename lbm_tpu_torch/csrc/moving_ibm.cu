// Kernels 19-21: one step of the moving-body immersed boundary's forcing
// side, in one launch (one block forces, the others zero the window): the
// window origin from the body state,
// the Peskin factors rebuilt at the markers, the multi-direct forcing toward
// the rigid velocity and the rigid update.
//
// Replace the TPU kernels of lbm_tpu/kernels/moving_ibm_pallas.py:
//   19 (VARIANT 0) make_moving_forcing_step :163 (pallas_call :278), one
//      translating body (falling_cylinder);
//   20 (VARIANT 1) make_moving_rot_step :301 (:429), one rotating body
//      (falling_ellipse): targets U_b + w x r_j, torque, Cayley orientation;
//   21 (VARIANT 2) make_moving_bodies_step :452 (:614), B translating bodies
//      in one union window of wr rows x the full width following the lowest
//      centre row, per-body momentum exchange and Glowinski barriers.
// Their plain versions are kernels/moving_ibm.py::plain_moving_forcing,
// plain_moving_rot and plain_moving_bodies (lbm_tpu's jnp steps,
// scenes/obstacles.py:1040-1071, :735-773, :670-704, on ops/moving_ibm.py).
// Each writes F over the window (2, wr, cw), the window's origin (two
// int32, which kernel 18 reads on the device) and the new body state; the
// state never leaves the device, so a step is two launches (this one and
// kernel 18) and no host synchronisation.
//
// Design.  The dense factors X (wr, M), Y (cw, M) of the plain version are
// zero outside each marker's 4x4 support, and a marker stays within max
// |offset| of its body's centre, so the kernel works in each body's box:
// side 2 K + 5 from floor(centre) - K - 1, K = ceil(max |offset|) + 1, 31x31
// cells at r = 12 where the DKT window holds 14,848 or 29,184.  Slot s = b
// S^2 + lr S + lc is a cell of body b's box; a cell in two boxes (bodies
// closer than a box) has a slot in each, both computing the same values,
// and its F is written from the first.  No cell table is built: the
// wrapper cuts the body frame into unit buckets once and lists, per bucket,
// the markers within 2 sqrt 2 + sqrt 2 / 2 (+ 0.1) of its centre, every
// marker whose support can hold a cell of the bucket (kernels/moving_ibm.py
// Boxes).  Block 0 of 1 + fill_blocks:
//   0. the bodies' boxes and frames into shared memory;  barrier;
//   A. stages the bucket lists (cp.async); 8 lanes per marker: its position
//      and target, the separable weights wx[a] = phi(row_a - x), wy[b] =
//      phi(col_b - y) (the plain version's peskin4j, term for term), its
//      support's first row and column in the window; one thread per slot
//      in the window, in some body's ring band (within r_min - 3 .. r_max
//      + 3 of a centre) and in a bucket that lists a marker: the 9 planes
//      there, and a place in the live list (a ballot and one int atomic a
//      warp: the list's order reaches no value); zeros for the boxes'
//      other cells in the window;  barrier;
//   B. per iteration, one marker per 4 lanes, a row of its support a lane:
//      u_j (the row's columns summed in order, then the 4 rows in order
//      through shuffles), f_j = 2 rho_j (U_j - u_j);  barrier;  one thread
//      per live slot gathers the spread over the bodies in order and each
//      bucket's candidates in ascending marker, a candidate counted where
//      its support holds the cell (the first iteration keeps the first 6
//      covering markers in shared memory for the later ones), and updates u
//      and F (the last iteration writes F to the window);  barrier;
//   C. the origin and, one thread per body, the rigid update: sums over the
//      body's markers in marker order, the barriers (kernel 21) and the
//      Cayley map (kernel 20).
// The other blocks write zeros over the window's cells outside every box
// while block 0 works: each computes the origin and the boxes from the
// state, so no synchronisation is needed.  The spread is a gather in
// ascending marker order with no float atomics, so two runs are
// bit-identical; every term and sum is the earlier window-table design's,
// in its order, so the two give the same bits.  The working set (5 values
// and 3 ints per slot, 17 values and 3 ints per marker, the bucket lists, 6
// ints per thread) lives in dynamic shared memory when it fits the 227 KiB
// a block may take (the DKT pair in float64: 164 KB), else in a global
// scratch buffer the wrapper allocates, which stays in L2.
//
// Numbers: the plain version sums its interpolations and spreads in its
// matmuls' order (BLAS on the CPU, cuBLAS on the card) and its per-body
// sums in torch.sum's, so kernel and plain version agree within
// chip_smoke.py's TOL, not bit for bit.  Built with -fmad=false
// (_build.UNIT_FLAGS): every other operation rounds as the plain version's.
//
// Where the time went (`chip_smoke.py --ibm-breakdown` on an H100 80GB
// HBM3 at 700 W, float32, CUDA graphs; PERF.md section 6): the earlier
// design rebuilt a cell table over the whole window every step, 7.5 us of
// kernel 19's 17.9 and 35.8 of kernel 21's 57.8 (73.1 of 98.5 at 228
// rows), and its forcing iterations took 8.5 and 15.2 us; an empty
// one-block kernel's dependent launch takes 0.8 us.
//
// Bound: latency.  Block 0 runs on one SM of 132: the launch's floor, one
// round trip to L2 for the band's planes, then 2 (m_max - 1) - 1
// barrier-separated phases of shared-memory work over a few hundred
// markers and about a thousand live slots.  Bytes (9 planes read over the
// support, 2 written over the window) and operations are tiny next to that;
// chip_smoke.py states the roofline bound from both.

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "d2q9.cuh"

namespace {

constexpr int MAX_THREADS = 1024;
// The dynamic shared memory a block may opt into on Hopper (sm_90).
constexpr long long SMEM_LIMIT = 232448;
constexpr int LANES = 10;  // kernels/moving_ibm.py STATE_LANES
// The largest window (kernels/moving_ibm.py MAX_WINDOW_CELLS): F's two
// planes, the live list's F indices and the zeroing loops index the window
// with int, so 2 wr cw must stay below 2^31; rows and columns are otherwise
// only bounded by the grid's.
constexpr long long MAX_CELLS = ((1LL << 31) - 1) / 2;
// The covering markers a first-pass live slot keeps in shared memory across
// the iterations, the first EREG in ascending marker, each packed as 16 j +
// 4 a + b (row a, column b of its support); the rest are found again each
// iteration.
constexpr int EREG = 6;
enum { CEN_X, CEN_Y, UB_X, UB_Y, FH_X, FH_Y, ORI_C, ORI_S, ANG_W, TRQ };

template <typename T>
struct Consts {
  T g_net, m_eff, i_eff;       // net gravity force, inertia, moment of inertia
  T radius, zeta, eps, eps_w;  // the barriers (kernel 21)
  T Hm, Wm;                    // H - 0.5, W - 0.5: the far walls
  T near_lo, near_hi;          // the squared radii of a body's ring band
};

// The geometry of one launch: the window, the bodies' boxes, the buckets.
struct Geom {
  int H, W, half, wr, cw, Mb, B, K, QB;
  __host__ __device__ int side() const { return 2 * K + 5; }
};

__device__ __forceinline__ int round_even(float x) { return static_cast<int>(rintf(x)); }
__device__ __forceinline__ int round_even(double x) { return static_cast<int>(rint(x)); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ops/moving_ibm.py peskin4j, term for term (src/ibm.cpp:39-45).
template <typename T>
__device__ __forceinline__ T peskin(T r) {
  r = fabs(r);
  const T in1 = T(1) + T(4) * r - T(4) * r * r;
  const T in2 = T(-7) + T(12) * r - T(4) * r * r;
  const T s1 = sqrt(in1 > T(0) ? in1 : T(1));
  const T s2 = sqrt(in2 > T(0) ? in2 : T(1));
  const T inner = T(0.125) * (T(3) - T(2) * r + (in1 > T(0) ? s1 : T(0)));
  const T outer = T(0.125) * (T(5) - T(2) * r - (in2 > T(0) ? s2 : T(0)));
  return r <= T(1) ? inner : (r <= T(2) ? outer : T(0));
}

// The window's origin from the body state: rint(centre) - half (round half
// to even, as the plain version's torch.round), clipped; kernel 21's window
// spans the full width below the lowest centre row.
template <typename T, int VARIANT>
__device__ __forceinline__ void window_origin(const T* st, const Geom& g, int& r0, int& c0) {
  if (VARIANT == 2) {
    T cmin = st[CEN_X];
    for (int b = 1; b < g.B; ++b) cmin = fmin(cmin, st[b * LANES + CEN_X]);
    r0 = clampi(round_even(cmin) - g.half, 0, g.H - g.wr);
    c0 = 0;
  } else {
    r0 = clampi(round_even(st[CEN_X]) - g.half, 0, g.H - g.wr);
    c0 = clampi(round_even(st[CEN_Y]) - g.half, 0, g.W - g.cw);
  }
}

// Body b's box, the cells its markers' supports can reach: side 2 K + 5
// from floor(centre) - K - 1, with K = ceil(max |offset|) + 1 (a marker
// at x = c + r, |r| <= K, covers rows floor(x) - 1 .. floor(x) + 2).  And
// its frame: a world offset p maps to the body frame as (cr px + sr py,
// -sr px + cr py), (cr, sr) = (cos, sin) / (cos^2 + sin^2); (1, 0) when
// the body does not rotate.
template <typename T>
struct Body {
  int R0, C0;
  T cx, cy, cr, sr;
};

template <typename T, int VARIANT>
__device__ __forceinline__ Body<T> body(const T* st, int b, int K) {
  const T* s = st + b * LANES;
  Body<T> o;
  o.cx = s[CEN_X];
  o.cy = s[CEN_Y];
  o.R0 = static_cast<int>(floor(o.cx)) - K - 1;
  o.C0 = static_cast<int>(floor(o.cy)) - K - 1;
  if (VARIANT == 1) {
    const T c = s[ORI_C], sn = s[ORI_S];
    const T inv = T(1) / (c * c + sn * sn);
    o.cr = c * inv;
    o.sr = sn * inv;
  } else {
    o.cr = T(1);
    o.sr = T(0);
  }
  return o;
}

// Whether body b's box is the first (lowest b) that holds grid cell (r, c):
// the box whose slot writes the cell's F.
template <typename T>
__device__ __forceinline__ bool first_box(const Body<T>* bodies, int b, int r, int c, int S) {
  for (int q = 0; q < b; ++q) {
    const Body<T>& bq = bodies[q];
    if (r >= bq.R0 && r < bq.R0 + S && c >= bq.C0 && c < bq.C0 + S) return false;
  }
  return true;
}

// Whether grid cell (r, c) lies in body b's band: within the squared radii
// [near_lo, near_hi] of its centre, which hold every cell a marker of the
// body can reach.
template <typename T>
__device__ __forceinline__ bool near(const Body<T>& bd, int r, int c, const Consts<T>& P) {
  const T pr = T(r) - bd.cx, pc = T(c) - bd.cy;
  const T d2 = pr * pr + pc * pc;
  return d2 >= P.near_lo && d2 <= P.near_hi;
}

// The bucket of grid cell (r, c) in body bd's frame, or -1 off the buckets
// or where the bucket lists no marker (ptr: the bucket list's offsets).
template <typename T>
__device__ __forceinline__ int bucket_of(const Body<T>& bd, int r, int c, int QB,
                                         const int* ptr) {
  const T pr = T(r) - bd.cx, pc = T(c) - bd.cy;
  const int kr = static_cast<int>(floor(bd.cr * pr + bd.sr * pc)) + QB;
  const int kc = static_cast<int>(floor(bd.cr * pc - bd.sr * pr)) + QB;
  if (kr < 0 || kr >= 2 * QB || kc < 0 || kc >= 2 * QB) return -1;
  const int k = kr * 2 * QB + kc;
  return ptr[k + 1] > ptr[k] ? k : -1;
}

// The working set of block 0, carved from one buffer: the bodies, then
// values, then ints.  Slot s = b S^2 + lr S + lc is cell (R0_b + lr, C0_b +
// lc) of body b's box; a cell in two boxes has two slots, which hold the
// same values.  The live list holds the slots in the window and in some
// body's band, each with the window index its F goes to (-1 where an
// earlier box writes it); a slot's cell is found again from its box
// (slot_cell).
template <typename T>
struct Work {
  Body<T>* bodies;                                               // per body
  T *rho, *ux, *uy, *Fx, *Fy;                                    // per slot
  T *wx, *wy, *rx, *ry, *tx, *ty, *rho_j, *fx, *fy, *fxt, *fyt;  // per marker
  int *rb, *cb, *slot0;                                          // per marker
  int *bkt_ptr, *bkt_ent, *lslot, *lout, *cov_j, *nlive;

  __device__ Work(void* base, int B, int ns, int M, int nb, int ne, int nt) {
    bodies = static_cast<Body<T>*>(base);
    T* v = reinterpret_cast<T*>(static_cast<unsigned char*>(base) + body_bytes(B));
    rho = v; ux = rho + ns; uy = ux + ns; Fx = uy + ns; Fy = Fx + ns;
    wx = Fy + ns; wy = wx + 4 * M; rx = wy + 4 * M; ry = rx + M; tx = ry + M; ty = tx + M;
    rho_j = ty + M; fx = rho_j + M; fy = fx + M; fxt = fy + M; fyt = fxt + M;
    int* i = reinterpret_cast<int*>(fyt + M);
    rb = i; cb = rb + M; slot0 = cb + M; bkt_ptr = slot0 + M; bkt_ent = bkt_ptr + nb + 1;
    lslot = bkt_ent + ne; lout = lslot + ns; cov_j = lout + ns;
    nlive = cov_j + EREG * nt;
  }
  __host__ __device__ static long long body_bytes(int B) {
    return (static_cast<long long>(B) * sizeof(Body<T>) + 15) / 16 * 16;
  }
};

template <typename T>
__host__ __device__ inline long long work_bytes(int B, int ns, int M, int nb, int ne, int nt) {
  return Work<T>::body_bytes(B) + (5LL * ns + 17LL * M) * sizeof(T) +
         4LL * (3LL * M + nb + 1 + ne + 2LL * ns + EREG * nt + 1);
}

// The grid cell (r, c) of slot s = b S^2 + lr S + lc: cell (R0_b + lr,
// C0_b + lc) of body b's box.  Returns b.
template <typename T>
__device__ __forceinline__ int slot_cell(const Work<T>& w, int s, int S, int& r, int& c) {
  const int b = s / (S * S);
  const int l = s - b * (S * S);
  const int lr = l / S;
  r = w.bodies[b].R0 + lr;
  c = w.bodies[b].C0 + (l - lr * S);
  return b;
}

// The 4 terms of a 4-lane group summed in lane order (the parent design's
// sequential order over the box's rows); every lane of the group gets the
// same sum.  All 32 lanes call it.
template <typename T>
__device__ __forceinline__ T sum4(T p) {
  const int base = (threadIdx.x & 31) & ~3;
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < 4; ++k) acc += __shfl_sync(0xffffffffu, p, base + k);
  return acc;
}

// Lane a's term of marker j's interpolation of a slot field: row a of its
// support, (sum over the row's columns of field * wy) * wx[a], the plain
// version's colsum(X * (g @ Y)) restricted to the support; 0 off the window.
template <typename T>
__device__ __forceinline__ T interp_row(const Work<T>& w, const T* field, int j, int a, int S,
                                        const Geom& g) {
  const int rr = w.rb[j] + a;
  if (rr < 0 || rr >= g.wr) return T(0);
  const int slot = w.slot0[j] + a * S;
  T v = T(0);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int cc = w.cb[j] + b;
    if (cc >= 0 && cc < g.cw) v += field[slot + b] * w.wy[4 * j + b];
  }
  return v * w.wx[4 * j + a];
}

// Calls fn(e) for each marker j whose support holds window cell (rr, cc)
// (grid cell (r, c)), in ascending j: over the bodies whose band holds the
// cell, in order, and the candidates of the cell's bucket in the body's
// frame, in order; e = 16 j + 4 a + b, the cell being row a, column b of
// j's support.
template <typename T, typename Fn>
__device__ __forceinline__ void for_cover(const Work<T>& w, const Geom& g, const Consts<T>& P,
                                          int r, int c, int rr, int cc, Fn fn) {
  for (int q = 0; q < g.B; ++q) {
    const Body<T>& bq = w.bodies[q];
    if (!near(bq, r, c, P)) continue;
    const int k = bucket_of(bq, r, c, g.QB, w.bkt_ptr);
    if (k < 0) continue;
    const int e1 = w.bkt_ptr[k + 1];
    for (int e = w.bkt_ptr[k]; e < e1; ++e) {
      const int j = q * g.Mb + w.bkt_ent[e];
      const int dr = rr - w.rb[j];
      const int dc = cc - w.cb[j];
      if (static_cast<unsigned>(dr) < 4u && static_cast<unsigned>(dc) < 4u)
        fn(16 * j + 4 * dr + dc);
    }
  }
}


// Marker j's term of the spread at row a, column b of its support (e = 16 j
// + 4 a + b): (wx[a] f_j) wy[b], the parent design's term.
template <typename T>
__device__ __forceinline__ void spread_term(const Work<T>& w, int e, T& sx, T& sy) {
  const int j = e >> 4;
  const T wa = w.wx[4 * j + ((e >> 2) & 3)];
  const T wb = w.wy[4 * j + (e & 3)];
  sx += (wa * w.fx[j]) * wb;
  sy += (wa * w.fy[j]) * wb;
}

template <typename T, int VARIANT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    moving_kernel(const T* __restrict__ fin, const T* __restrict__ st_in,
                  const T* __restrict__ dx, const T* __restrict__ dy, T* __restrict__ Fout,
                  int* __restrict__ origin, T* __restrict__ st_out, T* scratch,
                  const int* __restrict__ bkt_ptr_in, const int* __restrict__ bkt_ent_in,
                  int n_ent, Geom g, int n_iter, Consts<T> P) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n = g.wr * g.cw;
  const int M = g.B * g.Mb;
  const int S = g.side();
  const int SS = S * S;
  const int NS = g.B * SS;
  const int NB = 4 * g.QB * g.QB;
  int r0, c0;
  window_origin<T, VARIANT>(st_in, g, r0, c0);

  if (blockIdx.x > 0) {
    // the other blocks: zeros over the window's cells outside every box
    for (int i = (blockIdx.x - 1) * nt + tid; i < n; i += (gridDim.x - 1) * nt) {
      const int rr = i / g.cw;
      const int r = r0 + rr, c = c0 + (i - rr * g.cw);
      bool boxed = false;
      for (int b = 0; b < g.B && !boxed; ++b) {
        const Body<T> bd = body<T, VARIANT>(st_in, b, g.K);
        boxed = r >= bd.R0 && r < bd.R0 + S && c >= bd.C0 && c < bd.C0 + S;
      }
      if (!boxed) {
        Fout[i] = T(0);
        Fout[n + i] = T(0);
      }
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bool in_smem = scratch == nullptr;
  Work<T> w(in_smem ? static_cast<void*>(smem_raw) : static_cast<void*>(scratch), g.B, NS, M,
            NB, n_ent, nt);
  const int64_t plane = static_cast<int64_t>(g.H) * g.W;

  // 0. the bodies' boxes and frames
  for (int b = tid; b < g.B; b += nt) w.bodies[b] = body<T, VARIANT>(st_in, b, g.K);
  if (tid == 0) *w.nlive = 0;
  __syncthreads();

  // A. the bucket lists staged; the markers; the live slots' macroscopics,
  // and zeros over the boxes' cells that no marker reaches
  if (in_smem) {
    for (int i = tid; i <= NB; i += nt) lbm::async_copy(w.bkt_ptr + i, bkt_ptr_in + i);
    for (int i = tid; i < n_ent; i += nt) lbm::async_copy(w.bkt_ent + i, bkt_ent_in + i);
    lbm::async_commit();
  } else {
    for (int i = tid; i <= NB; i += nt) w.bkt_ptr[i] = bkt_ptr_in[i];
    for (int i = tid; i < n_ent; i += nt) w.bkt_ent[i] = bkt_ent_in[i];
  }
  // the markers, 8 lanes each: every lane finds the position, lane k < 4
  // the row weight wx[k], lane 4 + k the column weight wy[k]
  for (int q = tid; q < 8 * M; q += nt) {
    const int j = q >> 3;
    const int k = q & 7;
    const int b = j / g.Mb;
    const int jj = j - b * g.Mb;
    const T* s = st_in + b * LANES;
    T x, y, tgx, tgy, rxj = T(0), ryj = T(0);
    if (VARIANT == 1) {
      const T c = s[ORI_C], sn = s[ORI_S], om = s[ANG_W];
      rxj = c * dx[jj] - sn * dy[jj];
      ryj = sn * dx[jj] + c * dy[jj];
      x = s[CEN_X] + rxj;
      y = s[CEN_Y] + ryj;
      tgx = s[UB_X] - om * ryj;
      tgy = s[UB_Y] + om * rxj;
    } else {
      x = s[CEN_X] + dx[jj];
      y = s[CEN_Y] + dy[jj];
      tgx = s[UB_X];
      tgy = s[UB_Y];
    }
    const int fr = static_cast<int>(floor(x)) - 1;
    const int fc = static_cast<int>(floor(y)) - 1;
    if (k < 4) w.wx[4 * j + k] = peskin(T(fr + k) - x);
    else w.wy[4 * j + k - 4] = peskin(T(fc + k - 4) - y);
    if (k == 0) {
      w.rx[j] = rxj;
      w.ry[j] = ryj;
      w.tx[j] = tgx;
      w.ty[j] = tgy;
      w.fxt[j] = T(0);
      w.fyt[j] = T(0);
      w.rb[j] = fr - r0;
      w.cb[j] = fc - c0;
      w.slot0[j] = b * SS + (fr - w.bodies[b].R0) * S + (fc - w.bodies[b].C0);
    }
  }
  const unsigned lane = threadIdx.x & 31;
  for (int base = 0; base < NS; base += nt) {  // uniform trip count: the list's ballot
    const int s = base + tid;
    bool live = false, write = false;
    int r = 0, c = 0, rr = 0, cc = 0;
    if (s < NS) {
      const int b = slot_cell(w, s, S, r, c);
      rr = r - r0;
      cc = c - c0;
      if (rr >= 0 && rr < g.wr && cc >= 0 && cc < g.cw) {
        for (int q = 0; q < g.B && !live; ++q)
          live = near(w.bodies[q], r, c, P) &&
                 bucket_of(w.bodies[q], r, c, g.QB, bkt_ptr_in) >= 0;
        write = first_box(w.bodies, b, r, c, S);
      }
    }
    // the live slots join the list, a warp at a time (its order reaches no value)
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    int at = 0;
    if (lane == 0 && ballot != 0u) at = atomicAdd(w.nlive, __popc(ballot));
    at = __shfl_sync(0xffffffffu, at, 0) + __popc(ballot & ((1u << lane) - 1u));
    if (live) {
      w.lslot[at] = s;
      w.lout[at] = write ? rr * g.cw + cc : -1;
      T rh, mx, my;
      T f[9];
      lbm::load9(fin, plane, static_cast<int64_t>(r) * g.W + c, f);
      lbm::moments(f, rh, mx, my);
      w.rho[s] = rh;
      w.ux[s] = mx / rh;
      w.uy[s] = my / rh;
      w.Fx[s] = T(0);
      w.Fy[s] = T(0);
    }
    if (write && (!live || n_iter == 0)) {
      Fout[rr * g.cw + cc] = T(0);
      Fout[n + rr * g.cw + cc] = T(0);
    }
  }
  if (in_smem) lbm::async_wait_all();
  __syncthreads();

  // B. the forcing iterations: per marker (4 lanes, a row of its support
  // each) u_j and f_j = 2 rho_j (U_j - u_j); per live slot the spread over
  // its covering markers in ascending order (the first pass's slots keep
  // them in registers from the first iteration on) and the update of u
  const int nlive = *w.nlive;
  const int groups = nt >> 2;
  const int gid = tid >> 2;
  const int a = tid & 3;
  int ncov = 0;  // the first-pass slot's covering markers
  int k_s = 0, k_r = 0, k_c = 0, k_rr = 0, k_cc = 0, k_out = -1;
  T k_ux = T(0), k_uy = T(0), k_Fx = T(0), k_Fy = T(0), k_inv = T(0);
  if (tid < nlive) {  // the first pass's slot
    k_s = w.lslot[tid];
    slot_cell(w, k_s, S, k_r, k_c);
    k_rr = k_r - r0;
    k_cc = k_c - c0;
    k_out = w.lout[tid];
    k_ux = w.ux[k_s];
    k_uy = w.uy[k_s];
    k_inv = T(1) / w.rho[k_s];
  }
  for (int it = 0; it < n_iter; ++it) {
    for (int base = 0; base < M; base += groups) {
      const int j = base + gid;
      const bool on = j < M;
      T prho = T(0), pux = T(0), puy = T(0);
      if (on) {
        if (it == 0) prho = interp_row(w, w.rho, j, a, S, g);
        pux = interp_row(w, w.ux, j, a, S, g);
        puy = interp_row(w, w.uy, j, a, S, g);
      }
      T rj;
      if (it == 0) {
        rj = sum4(prho);
        if (on && a == 0) w.rho_j[j] = rj;
      } else {
        rj = on ? w.rho_j[j] : T(0);
      }
      const T uxj = sum4(pux);
      const T uyj = sum4(puy);
      if (on && a == 0) {
        const T two_rho = T(2) * rj;
        const T fxj = two_rho * (w.tx[j] - uxj);
        const T fyj = two_rho * (w.ty[j] - uyj);
        w.fx[j] = fxj;
        w.fy[j] = fyj;
        w.fxt[j] = w.fxt[j] + fxj;
        w.fyt[j] = w.fyt[j] + fyj;
      }
    }
    __syncthreads();
    const bool last = it == n_iter - 1;
    if (tid < nlive) {  // the first pass: the covering markers in registers
      T sx = T(0), sy = T(0);
      if (it == 0) {
        for_cover(w, g, P, k_r, k_c, k_rr, k_cc, [&](int e) {
          spread_term(w, e, sx, sy);
          if (ncov < EREG) w.cov_j[ncov * nt + tid] = e;
          ++ncov;
        });
      } else {
#pragma unroll
        for (int t = 0; t < EREG; ++t) {
          if (t < ncov) {
            spread_term(w, w.cov_j[t * nt + tid], sx, sy);
          }
        }
        if (ncov > EREG) {
          int seen = 0;
          for_cover(w, g, P, k_r, k_c, k_rr, k_cc, [&](int e) {
            if (seen++ >= EREG) spread_term(w, e, sx, sy);
          });
        }
      }
      k_Fx = k_Fx + sx;
      k_Fy = k_Fy + sy;
      if (!last) {
        k_ux = k_ux + (T(0.5) * sx) * k_inv;
        k_uy = k_uy + (T(0.5) * sy) * k_inv;
        w.ux[k_s] = k_ux;
        w.uy[k_s] = k_uy;
      } else if (k_out >= 0) {
        Fout[k_out] = k_Fx;
        Fout[n + k_out] = k_Fy;
      }
    }
    for (int k = tid + nt; k < nlive; k += nt) {  // later passes: found again each time
      const int s = w.lslot[k];
      int r, c;
      slot_cell(w, s, S, r, c);
      T sx = T(0), sy = T(0);
      for_cover(w, g, P, r, c, r - r0, c - c0, [&](int e) { spread_term(w, e, sx, sy); });
      w.Fx[s] = w.Fx[s] + sx;
      w.Fy[s] = w.Fy[s] + sy;
      if (!last) {
        const T inv = T(1) / w.rho[s];
        w.ux[s] = w.ux[s] + (T(0.5) * sx) * inv;
        w.uy[s] = w.uy[s] + (T(0.5) * sy) * inv;
      } else if (w.lout[k] >= 0) {
        Fout[w.lout[k]] = w.Fx[s];
        Fout[n + w.lout[k]] = w.Fy[s];
      }
    }
    if (!last) __syncthreads();
  }

  // C. the origin and the rigid update, one thread per body: sums over the
  // body's markers in marker order
  if (tid == 0) {
    origin[0] = r0;
    origin[1] = c0;
  }
  for (int b = tid; b < g.B; b += nt) {
    T Sx = T(0), Sy = T(0), Sq = T(0);
#pragma unroll 8
    for (int j = b * g.Mb; j < (b + 1) * g.Mb; ++j) {
      Sx += w.fxt[j];
      Sy += w.fyt[j];
      if (VARIANT == 1) Sq += w.rx[j] * w.fyt[j] - w.ry[j] * w.fxt[j];
    }
    const T* s = st_in + b * LANES;
    T* o = st_out + b * LANES;
    const T Fhx = -Sx, Fhy = -Sy;
    T ax = Fhx + P.g_net, ay = Fhy + T(0);
    if (VARIANT == 2) {  // ops/moving_ibm.py barrier_forces, term for term
      const T reach = P.radius + P.radius + P.zeta;
      T px = T(0), py = T(0);
      for (int q = 0; q < g.B; ++q) {
        const T dvx = s[CEN_X] - st_in[q * LANES + CEN_X];
        const T dvy = s[CEN_Y] - st_in[q * LANES + CEN_Y];
        const T d = sqrt(dvx * dvx + dvy * dvy + (q == b ? T(1) : T(0)));
        T ov = fmax(reach - d, T(0));
        ov = ov * (q == b ? T(0) : T(1));
        px += dvx / d * (ov * ov) / P.eps;
        py += dvy / d * (ov * ov) / P.eps;
      }
      const T rz = P.radius + P.zeta;
      const T lox = fmax(T(-0.5) - (s[CEN_X] - rz), T(0));
      const T loy = fmax(T(-0.5) - (s[CEN_Y] - rz), T(0));
      const T hix = fmax(-((P.Hm - s[CEN_X]) - rz), T(0));
      const T hiy = fmax(-((P.Wm - s[CEN_Y]) - rz), T(0));
      ax = ax + (px + (lox * lox - hix * hix) / P.eps_w);
      ay = ay + (py + (loy * loy - hiy * hiy) / P.eps_w);
    }
    const T ubx = s[UB_X] + ax / P.m_eff;
    const T uby = s[UB_Y] + ay / P.m_eff;
    o[CEN_X] = s[CEN_X] + ubx;
    o[CEN_Y] = s[CEN_Y] + uby;
    o[UB_X] = ubx;
    o[UB_Y] = uby;
    o[FH_X] = Fhx;
    o[FH_Y] = Fhy;
    if (VARIANT == 1) {  // ops/moving_ibm.py cayley_rotate
      const T Th = -Sq;
      const T om = s[ANG_W] + Th / P.i_eff;
      const T t = T(0.5) * om;
      const T t2 = t * t;
      const T den = T(1) / (T(1) + t2);
      const T c = s[ORI_C], sn = s[ORI_S];
      o[ORI_C] = (c * (T(1) - t2) - sn * (T(2) * t)) * den;
      o[ORI_S] = (sn * (T(1) - t2) + c * (T(2) * t)) * den;
      o[ANG_W] = om;
      o[TRQ] = Th;
    } else {
      for (int l = ORI_C; l < LANES; ++l) o[l] = s[l];
    }
  }
}

template <typename T, int VARIANT>
int launch(const void* fin, const void* st_in, const void* dx, const void* dy, void* Fout,
           void* origin, void* st_out, void* scratch, const int* bkt_ptr, const int* bkt_ent,
           int n_ent, const Geom& g, int n_iter, int threads, int fill_blocks,
           const double* d, cudaStream_t stream) {
  if (g.wr < 1 || g.cw < 1 || g.wr > g.H || g.cw > g.W ||
      static_cast<long long>(g.wr) * g.cw > MAX_CELLS ||
      g.Mb < 1 || g.B < 1 || n_iter < 0 || g.K < 1 || g.QB < 1 || n_ent < 0 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 || fill_blocks < 1 ||
      (VARIANT != 2 && g.B != 1) || (VARIANT == 2 && g.cw != g.W))
    return static_cast<int>(cudaErrorInvalidValue);
  Consts<T> P;
  P.g_net = T(d[0]); P.m_eff = T(d[1]); P.i_eff = T(d[2]);
  P.radius = T(d[3]); P.zeta = T(d[4]); P.eps = T(d[5]); P.eps_w = T(d[6]);
  P.Hm = T(d[7]); P.Wm = T(d[8]); P.near_lo = T(d[9]); P.near_hi = T(d[10]);
  size_t smem = 0;
  if (scratch == nullptr) {
    const long long S = g.side();
    const long long bytes = work_bytes<T>(g.B, static_cast<int>(g.B * S * S), g.B * g.Mb,
                                          4 * g.QB * g.QB, n_ent, threads);
    if (bytes > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
    smem = static_cast<size_t>(bytes);
    // the opt-in above 48 KB, once per instantiation and device
    static bool opted_in[lbm::MAX_DEVICES] = {};
    if (smem > 48 * 1024) {
      const cudaError_t e = lbm::smem_opt_in(moving_kernel<T, VARIANT>,
                                             static_cast<int>(SMEM_LIMIT), opted_in);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  moving_kernel<T, VARIANT><<<1 + fill_blocks, threads, smem, stream>>>(
      static_cast<const T*>(fin), static_cast<const T*>(st_in), static_cast<const T*>(dx),
      static_cast<const T*>(dy), static_cast<T*>(Fout), static_cast<int*>(origin),
      static_cast<T*>(st_out), static_cast<T*>(scratch), bkt_ptr, bkt_ent, n_ent, g, n_iter, P);
  return static_cast<int>(cudaGetLastError());
}

template <int VARIANT>
int dispatch(const void* fin, const void* st_in, const void* dx, const void* dy, void* Fout,
             void* origin, void* st_out, void* scratch, const void* bkt_ptr, const void* bkt_ent,
             int n_ent, int H, int W, int half, int wr, int cw, int Mb, int B, int n_iter, int K,
             int QB, int threads, int fill_blocks, const double* consts, int is_f64,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g{H, W, half, wr, cw, Mb, B, K, QB};
  const int* p = static_cast<const int*>(bkt_ptr);
  const int* e = static_cast<const int*>(bkt_ent);
  return is_f64 ? launch<double, VARIANT>(fin, st_in, dx, dy, Fout, origin, st_out, scratch, p, e,
                                          n_ent, g, n_iter, threads, fill_blocks, consts, s)
                : launch<float, VARIANT>(fin, st_in, dx, dy, Fout, origin, st_out, scratch, p, e,
                                         n_ent, g, n_iter, threads, fill_blocks, consts, s);
}

}  // namespace

// One forcing step on `stream`: f_in (9, H, W), the body states st_in (B,
// 10), the body-frame marker offsets dx, dy (Mb,) in the state's type ->
// F_out (2, wr, cw), origin (2,) int32, st_out (B, 10), by one block of
// `threads` threads and `fill_blocks` more that zero the window off the
// boxes.  bkt_ptr ((2 QB)^2 + 1) and bkt_ent (n_ent) int32: the markers
// (0 .. Mb - 1, ascending) a body-frame bucket's cells can meet
// (kernels/moving_ibm.py marker_buckets); K the boxes' reach.  scratch is
// null when the working set fits in shared memory, else a buffer of at
// least kernels/moving_ibm.py::scratch_bytes bytes.  `consts` holds the 11
// scalars of kernels/moving_ibm.py::_consts, already rounded to the state's
// type.  Returns the cudaError_t of the launch (0 = accepted).
#define LBM_MOVING_ENTRY(name, variant)                                                        \
  extern "C" int name(const void* fin, const void* st_in, const void* dx, const void* dy,     \
                      void* Fout, void* origin, void* st_out, void* scratch,                  \
                      const void* bkt_ptr, const void* bkt_ent, int n_ent, int H, int W,      \
                      int half, int wr, int cw, int Mb, int B, int n_iter, int K, int QB,     \
                      int threads, int fill_blocks, const double* consts, int is_f64,         \
                      void* stream) {                                                         \
    return dispatch<variant>(fin, st_in, dx, dy, Fout, origin, st_out, scratch, bkt_ptr,      \
                             bkt_ent, n_ent, H, W, half, wr, cw, Mb, B, n_iter, K, QB,        \
                             threads, fill_blocks, consts, is_f64, stream);                   \
  }

LBM_MOVING_ENTRY(lbm_moving_forcing, 0)  // kernel 19
LBM_MOVING_ENTRY(lbm_moving_rot, 1)      // kernel 20
LBM_MOVING_ENTRY(lbm_moving_bodies, 2)   // kernel 21
