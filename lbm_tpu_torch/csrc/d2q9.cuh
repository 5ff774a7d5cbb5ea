// D2Q9 lattice for the port's CUDA kernels.
//
// The numbers mirror lbm_tpu/core/lattice.py (the single source the Python
// side loads); the card tests hold every kernel to the plain PyTorch
// version built on that file.  Velocity set, column k:
//   c = [(0,0),(1,0),(0,1),(-1,0),(0,-1),(1,1),(-1,1),(-1,-1),(1,-1)]
// axis 0 of the grid is x/rows, axis 1 is y/cols; opposite pairs (1,3),
// (2,4), (5,7), (6,8); W = [4/9, 1/9 x4, 1/36 x4].
//
// State layout: planes (9, R, C), plane k at offset k*R*C, row-major inside
// a plane.  Offsets are 64-bit: a 4096x2048 plane set has 75M entries.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace lbm {

// The opt-in of `kernel` to `bytes` of dynamic shared memory, once per
// device: the attribute belongs to the device, so a process that launches
// on several cards sets it on each.  `done` holds a flag per device id.
// The first call on a device must not fall inside a CUDA graph's capture
// (the callers' warm-up launches come first).
constexpr int MAX_DEVICES = 64;

template <typename K>
inline cudaError_t smem_opt_in(K kernel, int bytes, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

// The number of SMs of the current device, read once per device (a process
// may launch on several cards, not all alike).
inline cudaError_t sm_count(int& sms) {
  static int cached[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    e = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  sms = cached[dev];
  return cudaSuccess;
}

// Programmatic dependent launch (Hopper): a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may be scheduled while
// the kernel before it in the stream still runs.  `grid_wait` (what
// cudaGridDependencySynchronize compiles to) holds the calling thread until
// that grid has finished and its stores are visible, so a kernel calls it
// before its first load or store of device memory; `grid_release`
// (cudaTriggerProgrammaticLaunchCompletion) lets the next such launch be
// scheduled once every thread of the block has called it or exited.  Both
// are no-ops in a launch without the attribute and off the card.
__device__ __forceinline__ void grid_wait() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

__device__ __forceinline__ void grid_release() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#endif
}

// The launch of the one-thread-a-cell kernels (2, 4, 9, 23 and 24), sized to
// the card.  A small grid (128x128 is 16,384 cells, 64 blocks of 256 threads)
// would leave half of an H100's 132 SMs idle, so a block takes the most of
// 256, 128 and 64 threads that still gives every SM two blocks (64 at
// 128x128: 256 blocks); 4096x2048 keeps 256.
inline int block_threads(int64_t n, int sms) {
  for (int t = 256; t > 64; t /= 2)
    if ((n + t - 1) / t >= 2 * static_cast<int64_t>(sms)) return t;
  return 64;
}

// Whether `blocks` blocks of `threads` threads and `smem` bytes of dynamic
// shared memory fit the current device in one wave: KERNEL's resident
// blocks per SM times `sms`.  The occupancy is read once per device and
// block size (a kernel instance asks for one size of shared memory); each
// kernel instance has its own cache.
template <auto KERNEL>
inline cudaError_t one_wave(int threads, size_t smem, int64_t blocks, int sms, bool& fits) {
  static int cached[MAX_DEVICES][256 / 64 + 1] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int& per_sm = cached[dev][threads / 64];
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERNEL, threads, smem);
    if (e != cudaSuccess) return e;
  }
  fits = blocks <= static_cast<int64_t>(per_sm) * sms;
  return cudaSuccess;
}

// The programmatic dependent launches that launch_grid has made in this
// process (lbm_dependent_launches, csrc/thermal.cu, reads it).
inline std::atomic<long long> dependent_launches{0};

// Launches KERNEL(args...) on `grid` blocks of `threads` threads with `smem`
// bytes of dynamic shared memory (the kernel opted in to them) on `stream`,
// a programmatic dependent launch where the grid fits the card in one wave,
// so that launch n+1's ramp overlaps launch n's tail (its threads call
// grid_wait before their first load or store; kernels 2, 4, 9, 23 and 24
// call grid_release once their loads are issued, kernels 14, 32, 35 and 37
// release at each block's exit).  A grid of many waves launches plainly:
// there the dependent launch cost kernel 4 3.5% at 4096x2048 in float64
// (H100).  Returns the launch's cudaError_t.
template <auto KERNEL, typename... Args>
inline cudaError_t launch_grid(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                               Args... args) {
  int sms = 0;
  cudaError_t e = sm_count(sms);
  if (e != cudaSuccess) return e;
  bool pdl = false;
  e = one_wave<KERNEL>(threads, smem, static_cast<int64_t>(grid.x) * grid.y * grid.z, sms, pdl);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  // grid, block, dynamic shared memory, stream, attributes, their count
  const cudaLaunchConfig_t cfg = {grid, dim3(static_cast<unsigned>(threads)), smem, stream, attr,
                                  pdl ? 1u : 0u};
  e = cudaLaunchKernelEx(&cfg, KERNEL, args...);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e == cudaSuccess && pdl) ++dependent_launches;
  return e;
}

// Launches KERNEL(args...) over `n` cells, one thread a cell (kernels 2, 4,
// 9, 17, 23 and 24): `block_threads` threads a block, at most MAX_THREADS,
// through `launch_grid`.
template <auto KERNEL, int MAX_THREADS = 256, typename... Args>
inline cudaError_t launch_cells(int64_t n, cudaStream_t stream, Args... args) {
  if (n == 0) return cudaSuccess;
  int sms = 0;
  cudaError_t e = sm_count(sms);
  if (e != cudaSuccess) return e;
  const int fit = block_threads(n, sms);
  const int threads = fit < MAX_THREADS ? fit : MAX_THREADS;
  const int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  return launch_grid<KERNEL>(dim3(static_cast<unsigned>(blocks)), threads, 0, stream, args...);
}

__host__ __device__ constexpr int cx(int k) {
  return (k == 1 || k == 5 || k == 8) ? 1 : (k == 3 || k == 6 || k == 7) ? -1 : 0;
}

__host__ __device__ constexpr int cy(int k) {
  return (k == 2 || k == 5 || k == 6) ? 1 : (k == 4 || k == 7 || k == 8) ? -1 : 0;
}

__host__ __device__ constexpr int opp(int k) {
  return k == 0 ? 0 : (k <= 4 ? (k + 1) % 4 + 1 : (k - 3) % 4 + 5);
}

__host__ __device__ constexpr double weight(int k) {
  return k == 0 ? 4.0 / 9.0 : (k <= 4 ? 1.0 / 9.0 : 1.0 / 36.0);
}

// c_k . u with the integer velocities written out, so each projection is
// exactly the one addition the plain version does (ops/d2q9.py::_cu).
template <typename T>
__device__ __forceinline__ T cu(int k, T ux, T uy) {
  switch (k) {
    case 1: return ux;
    case 2: return uy;
    case 3: return -ux;
    case 4: return -uy;
    case 5: return ux + uy;
    case 6: return -ux + uy;
    case 7: return -ux - uy;
    case 8: return ux - uy;
    default: return T(0);
  }
}

// The planes moving up and down each axis, as bit masks over k: c_x = +1,
// c_x = -1, c_y = +1, c_y = -1.  A halfway wall on the low side of an axis
// writes the planes that move up it (the reversed outgoing populations),
// and one on the high side those that move down it.
constexpr unsigned PX = (1u << 1) | (1u << 5) | (1u << 8);
constexpr unsigned MX = (1u << 3) | (1u << 6) | (1u << 7);
constexpr unsigned PY = (1u << 2) | (1u << 5) | (1u << 6);
constexpr unsigned MY = (1u << 4) | (1u << 7) | (1u << 8);

// Periodic wrap of an index that is at most one cell out of [0, n).
__device__ __forceinline__ int64_t wrap(int64_t i, int64_t n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// Periodic wrap of any index into [0, n) (a halo may be wider than a small
// grid).
__device__ __forceinline__ int64_t wrap_any(int64_t i, int64_t n) {
  const int64_t m = i % n;
  return m < 0 ? m + n : m;
}

// The tile of the stencil kernels (6-8, 12-14): a block of TY x TX threads,
// one output cell each.
constexpr int TY = 8;
constexpr int TX = 32;
constexpr int THREADS = TY * TX;

template <typename T>
__device__ __forceinline__ void load9(const T* __restrict__ f, int64_t plane,
                                      int64_t cell, T out[9]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = f[k * plane + cell];
}

// Zeroth and first moments as explicit 9-term sums (the order of
// ops/d2q9.py calc_rho / calc_momentum).
template <typename T>
__device__ __forceinline__ void moments(const T f[9], T& rho, T& mx, T& my) {
  rho = f[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) rho += f[k];
  mx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8];
  my = f[2] - f[4] + f[5] + f[6] - f[7] - f[8];
}

// Shared subexpressions of the paired-direction equilibrium
// (kernels/collide_stream.py::d2q9_pairs): the even base t0 = 1 - 1.5|u|^2
// and, for each opposite pair (kp, km) in (1,3), (2,4), (5,7), (8,6),
// cu = c_kp . u and its square.
template <typename T>
struct Pairs {
  T t0;
  T cu[4];
  T cc[4];
};

__host__ __device__ constexpr int pair_kp(int i) { return i == 0 ? 1 : i == 1 ? 2 : i == 2 ? 5 : 8; }
__host__ __device__ constexpr int pair_km(int i) { return i == 0 ? 3 : i == 1 ? 4 : i == 2 ? 7 : 6; }

template <typename T>
__device__ __forceinline__ Pairs<T> d2q9_pairs(T ux, T uy) {
  Pairs<T> p;
  const T uxx = ux * ux;
  const T uyy = uy * uy;
  p.t0 = T(1.0) - T(1.5) * (uxx + uyy);
  const T s = ux + uy;
  const T d = ux - uy;
  p.cu[0] = ux; p.cc[0] = uxx;
  p.cu[1] = uy; p.cc[1] = uyy;
  p.cu[2] = s;  p.cc[2] = s * s;
  p.cu[3] = d;  p.cc[3] = d * d;
  return p;
}

// ops/d2q9.py equilibrium at (rho, ux, uy), term for term:
// rho (1 + 3 cu + 4.5 cu cu - 1.5 |u|^2) w_k.
template <typename T>
__device__ __forceinline__ void equilibrium(T rho, T ux, T uy, T feq[9]) {
  const T uu = ux * ux + uy * uy;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const T c = cu(k, ux, uy);
    T t = T(1.0) + T(3.0) * c;
    t = t + T(4.5) * c * c;
    t = t - T(1.5) * uu;
    feq[k] = rho * t * T(weight(k));
  }
}

// ops/d2q9.py abb_coefficient of plane k at the wall velocity (uwx, uwy):
// (2 + 9 cu cu - 3 |u_w|^2) w_k.
template <typename T>
__device__ __forceinline__ T abb_coefficient(int k, T uwx, T uwy) {
  const T c = cu(k, uwx, uwy);
  const T uu = uwx * uwx + uwy * uwy;
  return (T(2.0) + T(9.0) * c * c - T(3.0) * uu) * T(weight(k));
}

}  // namespace lbm
