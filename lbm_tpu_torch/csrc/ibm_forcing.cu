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
// Design: the ROI is small (37x37 cells and 64 markers in the Strouhal
// run, 45x45 at the scene's defaults), so one block of THREADS threads does
// it all, its phases separated by __syncthreads():
//   1. one thread per ROI cell reads the 9 planes and keeps rho, ux, uy
//      (and zeroed Fx, Fy) in the window fields;
//   2. one thread per marker interpolates rho_j: the 16-term sum over its
//      support box, rows then columns, in a fixed order;
//   3. per iteration, one thread per marker interpolates u and sets
//      f_j; then one thread per cell gathers the spread of f_j from the
//      markers whose box covers it, in marker order, and updates u and F.
// The spread is a gather, not a scatter with atomics, so the float32
// result does not depend on the order in which threads run.  The weights
// are row_w[j, a] col_w[j, b], taken as the (M, 16) table the wrapper
// builds from the separable factors (each entry the one float64 product
// ops/ibm.py's dense operator holds, rounded to T).  Each cell finds its
// markers in a compressed table the wrapper builds (cell_ptr, and per
// cell the entries 16 j + slot in ascending j), so a cell visits only the
// 16 M / (ROI cells) weights that touch it, not every marker.
//
// The window fields (5 per cell), the marker values (3 per marker) and a
// copy of the tables (16 weights and 18 ints per marker, an int per cell)
// live in dynamic shared memory when they fit the 227 KB a block may take
// (45x45 cells: 103 KB in float64; the opt-in is set at the first launch),
// else in a global scratch buffer the wrapper allocates, which stays
// resident in L2.  So the kernel runs at any ROI size that fits the grid.
//
// Numbers: the plain version's matmuls sum in another order (BLAS on the
// CPU, cuBLAS on the card), so kernel and plain version agree within
// chip_smoke.py's TOL (2e-6 in float32, 1e-13 in float64), not bit for bit.
//
// Bound: latency.  One block runs on one SM of 132; the work is
// m_max - 1 = 4 rounds of two dependent phases over a few thousand cells,
// each a barrier apart.  Bytes (9 planes in and 2 out over the ROI) and
// operations are tiny next to that; chip_smoke.py states the bound from
// both.  Left on the table: the interpolation keeps only M of the block's
// threads busy, and the launch of one block costs a few microseconds of its
// own.

#include <cuda_runtime.h>

#include "d2q9.cuh"

namespace {

constexpr int THREADS = 1024;
// The dynamic shared memory a block may opt into on Hopper (sm_90).
constexpr long long SMEM_LIMIT = 232448;

// The 16-term interpolation of a window field at marker j.
template <typename T>
__device__ __forceinline__ T interp(const T* field, int cw, const T* w16, const int* rows0,
                                    const int* cols0, int j) {
  const int base = rows0[j] * cw + cols0[j];
  T acc = T(0);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) acc += w16[j * 16 + a * 4 + b] * field[base + a * cw + b];
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ibm_forcing_kernel(const T* __restrict__ fin, T* __restrict__ Fout, int64_t R,
                       int64_t C, int r0, int c0, int rw, int cw, int M, int n_iter,
                       const T* __restrict__ w16_in, const int* __restrict__ rows0_in,
                       const int* __restrict__ cols0_in, const int* __restrict__ ptr_in,
                       const int* __restrict__ ent_in, T* scratch) {
  extern __shared__ unsigned char smem_raw[];
  T* base = scratch != nullptr ? scratch : reinterpret_cast<T*>(smem_raw);
  const int n = rw * cw;
  T* rho = base;
  T* ux = rho + n;
  T* uy = ux + n;
  T* Fx = uy + n;
  T* Fy = Fx + n;
  T* rho_j = Fy + n;
  T* fx_j = rho_j + M;
  T* fy_j = fx_j + M;
  T* w16 = fy_j + M;
  int* rows0 = reinterpret_cast<int*>(w16 + 16 * M);
  int* cols0 = rows0 + M;
  int* cell_ptr = cols0 + M;
  int* cell_ent = cell_ptr + n + 1;
  const int64_t plane = R * C;

  // 0. the tables, staged
  for (int i = threadIdx.x; i < 16 * M; i += blockDim.x) {
    w16[i] = w16_in[i];
    cell_ent[i] = ent_in[i];
  }
  for (int j = threadIdx.x; j < M; j += blockDim.x) {
    rows0[j] = rows0_in[j];
    cols0[j] = cols0_in[j];
  }
  for (int i = threadIdx.x; i <= n; i += blockDim.x) cell_ptr[i] = ptr_in[i];

  // 1. the ROI's macroscopics
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int rr = i / cw;
    const int cc = i - rr * cw;
    T f[9];
    lbm::load9(fin, plane, static_cast<int64_t>(r0 + rr) * C + (c0 + cc), f);
    T rh, mx, my;
    lbm::moments(f, rh, mx, my);
    rho[i] = rh;
    ux[i] = mx / rh;
    uy[i] = my / rh;
    Fx[i] = T(0);
    Fy[i] = T(0);
  }
  __syncthreads();

  // 2. the density at the markers
  for (int j = threadIdx.x; j < M; j += blockDim.x)
    rho_j[j] = interp(rho, cw, w16, rows0, cols0, j);
  __syncthreads();

  // 3. the forcing iterations
  for (int it = 0; it < n_iter; ++it) {
    for (int j = threadIdx.x; j < M; j += blockDim.x) {
      const T m2rho = T(-2.0) * rho_j[j];
      fx_j[j] = m2rho * interp(ux, cw, w16, rows0, cols0, j);
      fy_j[j] = m2rho * interp(uy, cw, w16, rows0, cols0, j);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      T sx = T(0), sy = T(0);
      for (int e = cell_ptr[i]; e < cell_ptr[i + 1]; ++e) {
        const int ent = cell_ent[e];  // 16 j + slot
        const T w = w16[ent];
        sx += fx_j[ent >> 4] * w;
        sy += fy_j[ent >> 4] * w;
      }
      ux[i] = ux[i] + T(0.5) * sx / rho[i];
      uy[i] = uy[i] + T(0.5) * sy / rho[i];
      Fx[i] = Fx[i] + sx;
      Fy[i] = Fy[i] + sy;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    Fout[i] = Fx[i];
    Fout[n + i] = Fy[i];
  }
}

template <typename T>
int launch(const void* fin, void* Fout, long long R, long long C, int r0, int c0, int rw,
           int cw, int M, int n_iter, const void* w16, const int* rows0, const int* cols0,
           const int* cell_ptr, const int* cell_ent, void* scratch, cudaStream_t stream) {
  if (rw <= 0 || cw <= 0 || r0 < 0 || c0 < 0 || r0 + rw > R || c0 + cw > C || M < 0 ||
      n_iter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = (5LL * rw * cw + 19LL * M) * static_cast<long long>(sizeof(T)) +
                          4LL * (18LL * M + rw * cw + 1);
  size_t smem = 0;
  if (scratch == nullptr) {
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
  ibm_forcing_kernel<T><<<1, THREADS, smem, stream>>>(
      static_cast<const T*>(fin), static_cast<T*>(Fout), R, C, r0, c0, rw, cw, M, n_iter,
      static_cast<const T*>(w16), rows0, cols0, cell_ptr, cell_ent,
      static_cast<T*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// F over the ROI [r0, r0 + rw) x [c0, c0 + cw) of the state f_in (9, R, C)
// into F_out (2, rw, cw), on `stream`.  w16 (M, 16) holds the weights in
// the state's type, rows0 / cols0 (M,) int32 each support box's first row
// and column relative to the ROI, cell_ptr (rw cw + 1) and cell_ent (16 M)
// int32 the compressed cell -> (marker, slot) table; scratch is null when
// the window fields and tables fit in shared memory, else a buffer of at
// least (5 rw cw + 19 M) values of the state's type and 4 (18 M + rw cw + 1)
// bytes.  Returns the cudaError_t of the launch (0 = accepted).
extern "C" int lbm_ibm_forcing(const void* fin, void* Fout, long long R, long long C,
                               int r0, int c0, int rw, int cw, int M, int n_iter,
                               const void* w16, const void* rows0, const void* cols0,
                               const void* cell_ptr, const void* cell_ent, void* scratch,
                               int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows0);
  const int* c = static_cast<const int*>(cols0);
  const int* p = static_cast<const int*>(cell_ptr);
  const int* e = static_cast<const int*>(cell_ent);
  return is_f64 ? launch<double>(fin, Fout, R, C, r0, c0, rw, cw, M, n_iter, w16, r, c, p, e,
                                 scratch, s)
                : launch<float>(fin, Fout, R, C, r0, c0, rw, cw, M, n_iter, w16, r, c, p, e,
                                scratch, s);
}
