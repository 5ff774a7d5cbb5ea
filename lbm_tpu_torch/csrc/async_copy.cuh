// Asynchronous copies from device memory into shared memory (cp.async, one
// element a copy: 4 bytes in float32, 8 in float64), for the MRT-CG strip
// engine (csrc/mrtcg.cuh), kernel 12's tile (csrc/rk_cg.cu) and the IBM
// kernels' tables.  A thread issues its copies, commits them as a
// group, and waits for its own groups; a barrier then shows every thread's
// copies to the block.
#pragma once

#include <cuda_pipeline_primitives.h>

namespace lbm {

template <typename T>
__device__ __forceinline__ void async_copy(T* smem_dst, const T* gmem_src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async copies 4, 8 or 16 bytes");
  __pipeline_memcpy_async(smem_dst, gmem_src, sizeof(T));
}

__device__ __forceinline__ void async_commit() { __pipeline_commit(); }

__device__ __forceinline__ void async_wait_all() { __pipeline_wait_prior(0); }

// Wait for this thread's groups but the newest N.
template <int N>
__device__ __forceinline__ void async_wait_prior() {
  __pipeline_wait_prior(N);
}

}  // namespace lbm
