// Kernel 7: one MRT colour-gradient step that takes the reduced state and
// writes the per-colour populations, (10, R, C) -> (18, R, C), or
// (12, R, C) -> (20, R, C) in CSF mode (fst last).
//
// Replaces the TPU kernel lbm_tpu/kernels/mrtcg_pallas.py:1129
// make_mrtcg_split_step (split_out=True of make_mrtcg_body :644); the step
// body is csrc/mrtcg.cuh.  The last step of every MRT-CG scene runs here.
//
// Bytes per cell: 112 in float32 (10 planes in, 18 out), 128 in CSF mode;
// twice that in float64; bound by those bytes (0.280 ms at 4096x2048 f32
// at 3.35 TB/s).  Same work as kernel 6 and the same limits (see its
// note): 0.625 ms in float32, 1.06 ms in float64 at 4096x2048 on an H100
// 80GB HBM3 (700 W).

#include "mrtcg.cuh"

extern "C" int lbm_mrtcg_split(const void* in, void* out, long long R, long long C,
                               const double* params, int csf, int is_f64, void* stream) {
  return lbm::mrtcg::dispatch<true, false>(in, out, R, C, params, csf, is_f64, stream);
}
