// Kernels 19-21: one step of the moving-body immersed boundary's forcing
// side, in one launch of one block: the window origin from the body state,
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
// zero outside each marker's 4x4 support, so the block works on the
// support alone:
//   0. every thread computes the origin from the state: rint(centre) - half
//      (round half to even, as the plain version's torch.round), clipped;
//   1. one thread per marker: its position and target, the separable
//      weights wx[a] = phi(row_a - x), wy[b] = phi(col_b - y) of its 4x4
//      box (the plain version's peskin4j, term for term) and the box's
//      first row and column in the window;
//   2. the support's cell -> (marker, slot) table, built every step: an
//      integer count per window cell (atomicAdd), a block scan into
//      offsets and the list of support cells, a fill (atomicAdd on a
//      cursor) and a sort of each cell's entries into ascending marker,
//      so the order a cell sums in does not depend on the threads;
//   3. the macroscopics at the support cells only (the DKT window has up to
//      29,184 cells, its support at most 16 M = 2,432);
//   4. rho_j, then m_max - 1 iterations of: per marker, interpolate u from
//      its box and set f_j = 2 rho_j (U_j - u_j); per support cell, gather
//      the spread of f_j through its table and update u and F;
//   5. F over the window (zero off the support) and, one thread per body,
//      the rigid update: sums over the body's markers in marker order, the
//      barriers (kernel 21) and the Cayley map (kernel 20).
// The spread is a gather, not a float scatter with atomics, so two runs are
// bit-identical.  The working set (5 values and 3 ints per window cell, 17
// values and 18 ints per marker) lives in dynamic shared memory when it fits
// the 227 KiB a block may take (falling_cylinder's 34x34 window: 84,120 B
// in float64, the ellipse's 42x42: 116,152 B), else in a global scratch buffer
// the wrapper allocates, which stays in L2 (the DKT windows).
//
// Numbers: the plain version sums its interpolations and spreads in its
// matmuls' order (BLAS on the CPU, cuBLAS on the card) and its per-body
// sums in torch.sum's, so kernel and plain version agree within
// chip_smoke.py's TOL, not bit for bit.  Built with -fmad=false
// (_build.UNIT_FLAGS): every other operation rounds as the plain version's.
//
// Bound: latency.  One block on one SM of 132 runs about a dozen phases a
// barrier apart, four of them per forcing iteration; the bytes (9 planes
// read over the support, 2 written over the window) and operations are
// tiny next to that; chip_smoke.py states the bound from both.  Left on the
// table: the marker phases keep only M of the block's threads busy, and
// the table is rebuilt every step although the support moves by at most a
// cell.

#include <cuda_runtime.h>

#include "d2q9.cuh"

namespace {

constexpr int THREADS = 1024;
// The dynamic shared memory a block may opt into on Hopper (sm_90).
constexpr long long SMEM_LIMIT = 232448;
constexpr int LANES = 10;  // kernels/moving_ibm.py STATE_LANES
enum { CEN_X, CEN_Y, UB_X, UB_Y, FH_X, FH_Y, ORI_C, ORI_S, ANG_W, TRQ };

template <typename T>
struct Consts {
  T g_net, m_eff, i_eff;       // net gravity force, inertia, moment of inertia
  T radius, zeta, eps, eps_w;  // the barriers (kernel 21)
  T Hm, Wm;                    // H - 0.5, W - 0.5: the far walls
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

// The working set, carved from one buffer: values first, then ints.
template <typename T>
struct Work {
  T *rho, *ux, *uy, *Fx, *Fy;                          // per window cell
  T *wx, *wy, *rx, *ry, *tx, *ty, *rho_j, *fx, *fy, *fxt, *fyt;  // per marker
  int *cnt, *ptr, *sup, *rb, *cb, *ent, *part, *nsup;

  __device__ Work(void* base, int n, int M) {
    T* v = static_cast<T*>(base);
    rho = v; ux = rho + n; uy = ux + n; Fx = uy + n; Fy = Fx + n;
    wx = Fy + n; wy = wx + 4 * M; rx = wy + 4 * M; ry = rx + M; tx = ry + M; ty = tx + M;
    rho_j = ty + M; fx = rho_j + M; fy = fx + M; fxt = fy + M; fyt = fxt + M;
    int* i = reinterpret_cast<int*>(fyt + M);
    cnt = i; ptr = cnt + n; sup = ptr + n + 1; rb = sup + n; cb = rb + M; ent = cb + M;
    part = ent + 16 * M; nsup = part + 2 * THREADS;
  }
};

__host__ __device__ inline long long work_bytes(int n, int M, int itemsize) {
  return (5LL * n + 17LL * M) * itemsize + 4LL * (3LL * n + 18LL * M + 2LL * THREADS + 2);
}

// Window cell of entry e = 16 j + 4 a + b (row a, column b of marker j's
// box), or -1 outside the window.
template <typename T>
__device__ __forceinline__ int entry_cell(const Work<T>& w, int e, int wr, int cw) {
  const int j = e >> 4;
  const int rr = w.rb[j] + ((e >> 2) & 3);
  const int cc = w.cb[j] + (e & 3);
  return (rr >= 0 && rr < wr && cc >= 0 && cc < cw) ? rr * cw + cc : -1;
}

// Marker j's interpolation of a window field: sum over the box's rows of
// (sum over its columns of field * wy) * wx, the plain version's
// colsum(X * (g @ Y)) restricted to the support.
template <typename T>
__device__ __forceinline__ T interp(const Work<T>& w, const T* field, int j, int wr, int cw) {
  T acc = T(0);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int rr = w.rb[j] + a;
    if (rr < 0 || rr >= wr) continue;
    T v = T(0);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int cc = w.cb[j] + b;
      if (cc >= 0 && cc < cw) v += field[rr * cw + cc] * w.wy[4 * j + b];
    }
    acc += v * w.wx[4 * j + a];
  }
  return acc;
}

template <typename T, int VARIANT>
__global__ void __launch_bounds__(THREADS)
    moving_kernel(const T* __restrict__ fin, const T* __restrict__ st_in,
                  const T* __restrict__ dx, const T* __restrict__ dy, T* __restrict__ Fout,
                  int* __restrict__ origin, T* __restrict__ st_out, T* scratch, int H, int W,
                  int half, int wr, int cw, int Mb, int B, int n_iter, Consts<T> P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = wr * cw;
  const int M = B * Mb;
  const int tid = threadIdx.x;
  Work<T> w(scratch != nullptr ? static_cast<void*>(scratch) : static_cast<void*>(smem_raw),
            n, M);
  const int64_t plane = static_cast<int64_t>(H) * W;

  // 0. the window's origin
  int r0, c0;
  if (VARIANT == 2) {
    T cmin = st_in[CEN_X];
    for (int b = 1; b < B; ++b) cmin = fmin(cmin, st_in[b * LANES + CEN_X]);
    r0 = clampi(round_even(cmin) - half, 0, H - wr);
    c0 = 0;
  } else {
    r0 = clampi(round_even(st_in[CEN_X]) - half, 0, H - wr);
    c0 = clampi(round_even(st_in[CEN_Y]) - half, 0, W - cw);
  }

  // 1. the markers: position, target, weights, box
  for (int j = tid; j < M; j += THREADS) {
    const int b = j / Mb;
    const int jj = j - b * Mb;
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
    w.rx[j] = rxj;
    w.ry[j] = ryj;
    w.tx[j] = tgx;
    w.ty[j] = tgy;
    w.fxt[j] = T(0);
    w.fyt[j] = T(0);
    const int fr = static_cast<int>(floor(x)) - 1;
    const int fc = static_cast<int>(floor(y)) - 1;
    w.rb[j] = fr - r0;
    w.cb[j] = fc - c0;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      w.wx[4 * j + a] = peskin(T(fr + a) - x);
      w.wy[4 * j + a] = peskin(T(fc + a) - y);
    }
  }
  for (int i = tid; i < n; i += THREADS) w.cnt[i] = 0;
  __syncthreads();

  // 2. the cell -> entry table: counts
  for (int e = tid; e < 16 * M; e += THREADS) {
    const int cell = entry_cell(w, e, wr, cw);
    if (cell >= 0) atomicAdd(&w.cnt[cell], 1);
  }
  __syncthreads();
  // a block scan of the counts and of the support flags over contiguous
  // chunks (Hillis-Steele over the THREADS chunk sums)
  const int chunk = (n + THREADS - 1) / THREADS;
  const int lo = min(tid * chunk, n);
  const int hi = min(lo + chunk, n);
  int se = 0, ss = 0;
  for (int i = lo; i < hi; ++i) {
    se += w.cnt[i];
    ss += w.cnt[i] > 0;
  }
  int* pe = w.part;
  int* ps = w.part + THREADS;
  pe[tid] = se;
  ps[tid] = ss;
  __syncthreads();
  for (int off = 1; off < THREADS; off <<= 1) {
    const int ve = tid >= off ? pe[tid - off] : 0;
    const int vs = tid >= off ? ps[tid - off] : 0;
    __syncthreads();
    pe[tid] += ve;
    ps[tid] += vs;
    __syncthreads();
  }
  int be = pe[tid] - se;
  int bs = ps[tid] - ss;
  for (int i = lo; i < hi; ++i) {
    w.ptr[i] = be;
    be += w.cnt[i];
    if (w.cnt[i] > 0) w.sup[bs++] = i;
    w.cnt[i] = 0;  // now the fill cursor
  }
  if (tid == THREADS - 1) {
    w.ptr[n] = pe[tid];
    *w.nsup = ps[tid];
  }
  __syncthreads();
  // fill, then sort each cell's entries into ascending (marker, slot)
  for (int e = tid; e < 16 * M; e += THREADS) {
    const int cell = entry_cell(w, e, wr, cw);
    if (cell >= 0) w.ent[w.ptr[cell] + atomicAdd(&w.cnt[cell], 1)] = e;
  }
  __syncthreads();
  const int nsup = *w.nsup;
  for (int k = tid; k < nsup; k += THREADS) {
    const int i = w.sup[k];
    for (int p = w.ptr[i] + 1; p < w.ptr[i + 1]; ++p) {
      const int e = w.ent[p];
      int q = p - 1;
      while (q >= w.ptr[i] && w.ent[q] > e) {
        w.ent[q + 1] = w.ent[q];
        --q;
      }
      w.ent[q + 1] = e;
    }
  }

  // 3. the macroscopics at the support cells
  for (int k = tid; k < nsup; k += THREADS) {
    const int i = w.sup[k];
    const int rr = i / cw;
    const int cc = i - rr * cw;
    T f[9];
    lbm::load9(fin, plane, static_cast<int64_t>(r0 + rr) * W + (c0 + cc), f);
    T rh, mx, my;
    lbm::moments(f, rh, mx, my);
    w.rho[i] = rh;
    w.ux[i] = mx / rh;
    w.uy[i] = my / rh;
    w.Fx[i] = T(0);
    w.Fy[i] = T(0);
  }
  __syncthreads();

  // 4. the forcing iterations
  for (int j = tid; j < M; j += THREADS) w.rho_j[j] = interp(w, w.rho, j, wr, cw);
  __syncthreads();
  for (int it = 0; it < n_iter; ++it) {
    for (int j = tid; j < M; j += THREADS) {
      const T two_rho = T(2) * w.rho_j[j];
      const T fxj = two_rho * (w.tx[j] - interp(w, w.ux, j, wr, cw));
      const T fyj = two_rho * (w.ty[j] - interp(w, w.uy, j, wr, cw));
      w.fx[j] = fxj;
      w.fy[j] = fyj;
      w.fxt[j] = w.fxt[j] + fxj;
      w.fyt[j] = w.fyt[j] + fyj;
    }
    __syncthreads();
    for (int k = tid; k < nsup; k += THREADS) {
      const int i = w.sup[k];
      T sx = T(0), sy = T(0);
      for (int p = w.ptr[i]; p < w.ptr[i + 1]; ++p) {
        const int e = w.ent[p];
        const int j = e >> 4;
        const T wa = w.wx[4 * j + ((e >> 2) & 3)];
        const T wb = w.wy[4 * j + (e & 3)];
        sx += (wa * w.fx[j]) * wb;
        sy += (wa * w.fy[j]) * wb;
      }
      const T inv = T(1) / w.rho[i];
      w.ux[i] = w.ux[i] + (T(0.5) * sx) * inv;
      w.uy[i] = w.uy[i] + (T(0.5) * sy) * inv;
      w.Fx[i] = w.Fx[i] + sx;
      w.Fy[i] = w.Fy[i] + sy;
    }
    __syncthreads();
  }

  // 5. F over the window, the origin, and the rigid update per body
  for (int i = tid; i < n; i += THREADS) {
    const bool on = w.cnt[i] > 0;
    Fout[i] = on ? w.Fx[i] : T(0);
    Fout[n + i] = on ? w.Fy[i] : T(0);
  }
  if (tid == 0) {
    origin[0] = r0;
    origin[1] = c0;
  }
  if (tid < B) {
    const int b = tid;
    const T* s = st_in + b * LANES;
    T* o = st_out + b * LANES;
    T Sx = T(0), Sy = T(0), Sq = T(0);
    for (int j = b * Mb; j < (b + 1) * Mb; ++j) {
      Sx += w.fxt[j];
      Sy += w.fyt[j];
      if (VARIANT == 1) Sq += w.rx[j] * w.fyt[j] - w.ry[j] * w.fxt[j];
    }
    const T Fhx = -Sx, Fhy = -Sy;
    T ax = Fhx + P.g_net, ay = Fhy + T(0);
    if (VARIANT == 2) {  // ops/moving_ibm.py barrier_forces, term for term
      const T reach = P.radius + P.radius + P.zeta;
      T px = T(0), py = T(0);
      for (int q = 0; q < B; ++q) {
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
           void* origin, void* st_out, void* scratch, int H, int W, int half, int wr, int cw,
           int Mb, int B, int n_iter, const double* d, cudaStream_t stream) {
  if (wr < 1 || cw < 1 || wr > H || cw > W || Mb < 1 || B < 1 || B > THREADS || n_iter < 0 ||
      (VARIANT != 2 && B != 1) || (VARIANT == 2 && cw != W))
    return static_cast<int>(cudaErrorInvalidValue);
  Consts<T> P;
  P.g_net = T(d[0]); P.m_eff = T(d[1]); P.i_eff = T(d[2]);
  P.radius = T(d[3]); P.zeta = T(d[4]); P.eps = T(d[5]); P.eps_w = T(d[6]);
  P.Hm = T(d[7]); P.Wm = T(d[8]);
  size_t smem = 0;
  if (scratch == nullptr) {
    const long long bytes = work_bytes(wr * cw, B * Mb, static_cast<int>(sizeof(T)));
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
  moving_kernel<T, VARIANT><<<1, THREADS, smem, stream>>>(
      static_cast<const T*>(fin), static_cast<const T*>(st_in), static_cast<const T*>(dx),
      static_cast<const T*>(dy), static_cast<T*>(Fout), static_cast<int*>(origin),
      static_cast<T*>(st_out), static_cast<T*>(scratch), H, W, half, wr, cw, Mb, B, n_iter, P);
  return static_cast<int>(cudaGetLastError());
}

template <int VARIANT>
int dispatch(const void* fin, const void* st_in, const void* dx, const void* dy, void* Fout,
             void* origin, void* st_out, void* scratch, int H, int W, int half, int wr, int cw,
             int Mb, int B, int n_iter, const double* consts, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double, VARIANT>(fin, st_in, dx, dy, Fout, origin, st_out, scratch, H,
                                          W, half, wr, cw, Mb, B, n_iter, consts, s)
                : launch<float, VARIANT>(fin, st_in, dx, dy, Fout, origin, st_out, scratch, H,
                                         W, half, wr, cw, Mb, B, n_iter, consts, s);
}

}  // namespace

// One forcing step on `stream`: f_in (9, H, W), the body states st_in (B,
// 10), the body-frame marker offsets dx, dy (Mb,) in the state's type ->
// F_out (2, wr, cw), origin (2,) int32, st_out (B, 10).  scratch is null
// when the working set fits in shared memory, else a buffer of at least
// kernels/moving_ibm.py::scratch_bytes bytes.  `consts` holds the 9 scalars
// of kernels/moving_ibm.py::_consts, already rounded to the state's type.
// Returns the cudaError_t of the launch (0 = accepted).
#define LBM_MOVING_ENTRY(name, variant)                                                       \
  extern "C" int name(const void* fin, const void* st_in, const void* dx, const void* dy,    \
                      void* Fout, void* origin, void* st_out, void* scratch, int H, int W,   \
                      int half, int wr, int cw, int Mb, int B, int n_iter,                   \
                      const double* consts, int is_f64, void* stream) {                      \
    return dispatch<variant>(fin, st_in, dx, dy, Fout, origin, st_out, scratch, H, W, half,  \
                             wr, cw, Mb, B, n_iter, consts, is_f64, stream);                 \
  }

LBM_MOVING_ENTRY(lbm_moving_forcing, 0)  // kernel 19
LBM_MOVING_ENTRY(lbm_moving_rot, 1)      // kernel 20
LBM_MOVING_ENTRY(lbm_moving_bodies, 2)   // kernel 21
