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

#include <cstdint>

namespace lbm {

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

// Periodic wrap of an index that is at most one cell out of [0, n).
__device__ __forceinline__ int64_t wrap(int64_t i, int64_t n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

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

}  // namespace lbm
