// Kernel 16: the static immersed boundary's multi-direct forcing over its
// marker ROI, in one launch of one block.
//
// Replaces the TPU kernel lbm_tpu/kernels/ibm_pallas.py:39
// make_ibm_forcing_step (pallas_call at :117).  Its plain version is
// ops/ibm.py::IBM.force_from_populations: the ROI's rho and u = m1 / rho,
// rho_j at the markers, then m_max - 1 iterations of
//   u_j = interp(u), f_j = -2 rho_j u_j, F_n = spread(f_j),
//   u += 0.5 F_n / rho, F += F_n
// (src/ibm.cpp:158-190).  The output is F over the ROI, (2, roi_r, roi_c);
// kernel 15 reads it at the ROI's origin.  lbm_tpu's kernel instead
// rewrote the window of a full-grid, input-output-aliased F carry, so the
// zeros-outside-the-window invariant and the (2, R, C) buffer are gone.
//
// Design.  The markers are static, so the wrapper builds every table once
// (kernels/ibm.py forcing_tables): the support, the cells any marker's 4x4
// box covers, in ascending ROI order (sup); per marker and tap, the tap's
// support index and weight (tap, w16); per support cell its (marker,
// weight) entries in ascending marker, the weight stored inline (cell_ptr,
// ent_j, ent_w).  Only the support's macroscopics matter: about 450 cells
// of the Strouhal ROI's 1369.  One block of `threads` threads (8 lanes a
// marker or a thread a support cell, whichever is more; 512 at the
// Strouhal ring):
//   A. every thread zeroes its ROI cells of F, stages the spread's entries
//      into shared memory by cp.async, loads its lane's two taps and
//      weights, and one thread per support cell loads the 9 planes there
//      and keeps rho, ux, uy;  barrier;
//   B. per iteration, one marker per 8 lanes, two taps a lane: a fixed xor
//      butterfly of 3 shuffles sums the 8 lanes' terms (every lane ends
//      with the same sum, so rho_j stays in registers); lane 0 stores f_j;
//      barrier;  one thread per support cell gathers sum_j w f_j over its
//      entries in ascending j, one dependent shared load an entry, and
//      updates u and F (the last iteration writes F to the output);
//      barrier.
// 2 (m_max - 1) barriers in all.  The spread is a gather in ascending
// marker order and every sum has a fixed order, with no float atomics, so
// two runs are bit-identical.  The working set (5 values per support cell,
// 3 per marker, 16 entries of a value and an int per marker, the entry
// pointers) lives in dynamic shared memory when it fits the 227 KB a block
// may take (the Strouhal ROI: 20 KB in float32; the opt-in is set at the
// first launch), else in a global scratch buffer the wrapper allocates,
// which stays in L2 (1200 markers in float64).
//
// Numbers: the plain version's matmuls sum in another order (BLAS on the
// CPU, cuBLAS on the card), so kernel and plain version agree within
// chip_smoke.py's TOL (2e-6 in float32, 1e-13 in float64), not bit for bit.
//
// Where the time went (`chip_smoke.py --ibm-breakdown` on an H100 80GB
// HBM3 at 700 W, the Strouhal ROI in float32, CUDA graphs; PERF.md section
// 6): the earlier design took 15.96 us, 3.68 with 0 iterations, so 3.07 an
// iteration (its marker phases on 64 threads, 16 serial taps a field, and
// four dependent shared loads a spread entry over the whole ROI); without
// its table staging 15.35, without its macroscopic load 16.02.  An empty
// one-block kernel's dependent launch takes 0.8-1.0 us.
//
// Bound: latency.  One block runs on one SM of 132: the launch's floor,
// one round trip to L2 for the support's planes, then 2 (m_max - 1) - 1
// barrier-separated phases of shared-memory work.  Of this design's 6.98
// us in float32, 2.37 go before the iterations, and with both phases'
// work left out the iterations still take 2.60 (the barriers and the
// cells' updates).  Bytes (9 planes in over the support, 2 out over the
// ROI) and operations are tiny next to that; chip_smoke.py forcing_work
// states the roofline bound from both.

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "d2q9.cuh"

namespace {

constexpr int MAX_THREADS = 1024;
// The dynamic shared memory a block may opt into on Hopper (sm_90).
constexpr long long SMEM_LIMIT = 232448;

// The sum over an 8-lane group by a fixed xor butterfly: a + b == b + a, so
// every lane of the group ends with the same bits.  All 32 lanes call it.
template <typename T>
__device__ __forceinline__ T sum8(T v) {
#pragma unroll
  for (int m = 4; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// A lane's two taps of its marker's interpolation of a support field.
template <typename T>
__device__ __forceinline__ T taps2(const T* field, const int tp[2], const T wt[2]) {
  return wt[0] * field[tp[0]] + wt[1] * field[tp[1]];
}

// The working set, carved from one buffer: values first, then ints.
template <typename T>
struct Work {
  T *rho, *ux, *uy, *Fx, *Fy;  // per support cell
  T *rho_j, *fx, *fy;          // per marker
  T* ent_w;                    // per entry
  int *ent_j, *cell_ptr;

  __device__ Work(void* base, int nS, int M) {
    T* v = static_cast<T*>(base);
    rho = v; ux = rho + nS; uy = ux + nS; Fx = uy + nS; Fy = Fx + nS;
    rho_j = Fy + nS; fx = rho_j + M; fy = fx + M; ent_w = fy + M;
    ent_j = reinterpret_cast<int*>(ent_w + 16 * M);
    cell_ptr = ent_j + 16 * M;
  }
};

__host__ __device__ inline long long work_bytes(int nS, int M, int itemsize) {
  return (5LL * nS + 19LL * M) * itemsize + 4LL * (16LL * M + nS + 1);
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    ibm_forcing_kernel(const T* __restrict__ fin, T* __restrict__ Fout, int64_t R, int64_t C,
                       int r0, int c0, int rw, int cw, int M, int n_iter, int nS,
                       const T* __restrict__ w16, const int* __restrict__ tap,
                       const int* __restrict__ sup, const int* __restrict__ ptr_in,
                       const int* __restrict__ entj_in, const T* __restrict__ entw_in,
                       T* scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bool in_smem = scratch == nullptr;
  Work<T> w(in_smem ? static_cast<void*>(smem_raw) : static_cast<void*>(scratch), nS, M);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n = rw * cw;
  const int E = 16 * M;
  const int64_t plane = R * C;
  const int groups = nt >> 3;  // marker groups of 8 lanes a pass, 2 taps a lane
  const int gid = tid >> 3;
  const int lane = tid & 7;

  // A. zeros over the ROI (the support's cells are rewritten after the
  // last barrier), the spread's entries staged, the first pass's taps, the
  // support's macroscopics
  for (int i = tid; i < n; i += nt) {
    Fout[i] = T(0);
    Fout[n + i] = T(0);
  }
  if (in_smem) {
    for (int e = tid; e < E; e += nt) {
      lbm::async_copy(w.ent_w + e, entw_in + e);
      lbm::async_copy(w.ent_j + e, entj_in + e);
    }
    for (int s = tid; s <= nS; s += nt) lbm::async_copy(w.cell_ptr + s, ptr_in + s);
    lbm::async_commit();
  } else {
    for (int e = tid; e < E; e += nt) {
      w.ent_w[e] = entw_in[e];
      w.ent_j[e] = entj_in[e];
    }
    for (int s = tid; s <= nS; s += nt) w.cell_ptr[s] = ptr_in[s];
  }
  const int sup0 = tid < nS ? sup[tid] : 0;  // the first pass's support cell
  int tap0[2] = {0, 0};
  T wt0[2] = {T(0), T(0)};
  if (gid < M) {
    tap0[0] = tap[gid * 16 + lane];
    tap0[1] = tap[gid * 16 + lane + 8];
    wt0[0] = w16[gid * 16 + lane];
    wt0[1] = w16[gid * 16 + lane + 8];
  }
  for (int s = tid; s < nS; s += nt) {
    const int i = s == tid ? sup0 : sup[s];
    const int rr = i / cw;
    const int cc = i - rr * cw;
    T rh, mx, my;
    T f[9];
    lbm::load9(fin, plane, static_cast<int64_t>(r0 + rr) * C + (c0 + cc), f);
    lbm::moments(f, rh, mx, my);
    w.rho[s] = rh;
    w.ux[s] = mx / rh;
    w.uy[s] = my / rh;
    w.Fx[s] = T(0);
    w.Fy[s] = T(0);
  }
  if (in_smem) lbm::async_wait_all();
  __syncthreads();

  for (int it = 0; it < n_iter; ++it) {
    // B1. the markers: rho_j (first iteration), u_j and f_j = -2 rho_j u_j
    for (int base = 0; base < M; base += groups) {
      const int g = base + gid;
      const bool on = g < M;
      int tp[2] = {tap0[0], tap0[1]};
      T wt[2] = {wt0[0], wt0[1]};
      if (base > 0 && on) {
        tp[0] = tap[g * 16 + lane];
        tp[1] = tap[g * 16 + lane + 8];
        wt[0] = w16[g * 16 + lane];
        wt[1] = w16[g * 16 + lane + 8];
      }
      T rj;
      if (it == 0) {
        rj = sum8(on ? taps2(w.rho, tp, wt) : T(0));
        if (on && lane == 0) w.rho_j[g] = rj;
      } else {
        rj = on ? w.rho_j[g] : T(0);
      }
      const T uxj = sum8(on ? taps2(w.ux, tp, wt) : T(0));
      const T uyj = sum8(on ? taps2(w.uy, tp, wt) : T(0));
      if (on && lane == 0) {
        const T m2rho = T(-2.0) * rj;
        w.fx[g] = m2rho * uxj;
        w.fy[g] = m2rho * uyj;
      }
    }
    __syncthreads();
    // B2. the support cells: the spread as a gather in ascending marker
    const bool last = it == n_iter - 1;
    for (int s = tid; s < nS; s += nt) {
      T sx = T(0), sy = T(0);
      const int e1 = w.cell_ptr[s + 1];
      for (int e = w.cell_ptr[s]; e < e1; ++e) {
        const int j = w.ent_j[e];
        const T wt = w.ent_w[e];
        sx += w.fx[j] * wt;
        sy += w.fy[j] * wt;
      }
      if (last) {
        const int i = s == tid ? sup0 : sup[s];
        Fout[i] = w.Fx[s] + sx;
        Fout[n + i] = w.Fy[s] + sy;
      } else {
        const T rh = w.rho[s];
        w.ux[s] = w.ux[s] + T(0.5) * sx / rh;
        w.uy[s] = w.uy[s] + T(0.5) * sy / rh;
        w.Fx[s] = w.Fx[s] + sx;
        w.Fy[s] = w.Fy[s] + sy;
      }
    }
    if (!last) __syncthreads();
  }
}

template <typename T>
int launch(const void* fin, void* Fout, long long R, long long C, int r0, int c0, int rw,
           int cw, int M, int n_iter, int nS, const void* w16, const int* tap, const int* sup,
           const int* cell_ptr, const int* ent_j, const void* ent_w, void* scratch,
           int threads, cudaStream_t stream) {
  if (rw <= 0 || cw <= 0 || r0 < 0 || c0 < 0 || r0 + rw > R || c0 + cw > C || M < 1 ||
      n_iter < 0 || nS < 1 || nS > rw * cw || threads < 32 || threads > MAX_THREADS ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  if (scratch == nullptr) {
    const long long bytes = work_bytes(nS, M, static_cast<int>(sizeof(T)));
    if (bytes > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
    smem = static_cast<size_t>(bytes);
    // the opt-in above 48 KB, once per type and device
    static bool opted_in[lbm::MAX_DEVICES] = {};
    if (smem > 48 * 1024) {
      const cudaError_t e = lbm::smem_opt_in(ibm_forcing_kernel<T>,
                                             static_cast<int>(SMEM_LIMIT), opted_in);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  ibm_forcing_kernel<T><<<1, threads, smem, stream>>>(
      static_cast<const T*>(fin), static_cast<T*>(Fout), R, C, r0, c0, rw, cw, M, n_iter, nS,
      static_cast<const T*>(w16), tap, sup, cell_ptr, ent_j, static_cast<const T*>(ent_w),
      static_cast<T*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// F over the ROI [r0, r0 + rw) x [c0, c0 + cw) of the state f_in (9, R, C)
// into F_out (2, rw, cw), on `stream`, by one block of `threads` threads.
// The tables (kernels/ibm.py forcing_tables): w16 (M, 16) the weights in
// the state's type and tap (M, 16) int32 each tap's support index; sup
// (nS,) int32 the support cells' ROI indices, ascending; cell_ptr (nS + 1),
// ent_j (16 M) int32 and ent_w (16 M, the state's type) each support cell's
// (marker, weight) entries in ascending marker.  scratch is null when the
// working set fits in shared memory, else a buffer of at least
// (5 nS + 19 M) values of the state's type and 4 (16 M + nS + 1) bytes.
// Returns the cudaError_t of the launch (0 = accepted).
extern "C" int lbm_ibm_forcing(const void* fin, void* Fout, long long R, long long C,
                               int r0, int c0, int rw, int cw, int M, int n_iter, int nS,
                               const void* w16, const void* tap, const void* sup,
                               const void* cell_ptr, const void* ent_j, const void* ent_w,
                               void* scratch, int threads, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tap);
  const int* u = static_cast<const int*>(sup);
  const int* p = static_cast<const int*>(cell_ptr);
  const int* j = static_cast<const int*>(ent_j);
  return is_f64 ? launch<double>(fin, Fout, R, C, r0, c0, rw, cw, M, n_iter, nS, w16, t, u, p,
                                 j, ent_w, scratch, threads, s)
                : launch<float>(fin, Fout, R, C, r0, c0, rw, cw, M, n_iter, nS, w16, t, u, p,
                                j, ent_w, scratch, threads, s);
}
