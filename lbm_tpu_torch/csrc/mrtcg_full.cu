// Kernel 8: one MRT colour-gradient step on the full per-colour state,
// (18, R, C) -> (18, R, C), or (20, R, C) in CSF mode (fst last).
//
// Replaces the TPU kernels lbm_tpu/kernels/mrtcg_pallas.py:876
// make_mrtcg_fused_step and :915 make_csf_fused_step (make_mrtcg_body
// :644); the step body is csrc/mrtcg.cuh.  lbm_tpu's tests and sharded
// checks drive this layout; the scenes run kernels 6 and 7.
//
// Bytes per cell: 144 in float32 (18 planes in, 18 out), 160 in CSF mode;
// twice that in float64; bound by those bytes (0.361 ms at 4096x2048 f32
// at 3.35 TB/s).  Same work as kernel 6 (see its note) with 18 loads per
// window cell: 0.703 ms in float32, 1.24 ms in float64 at 4096x2048 on an
// H100 80GB HBM3 (700 W).

#include "mrtcg.cuh"

extern "C" int lbm_mrtcg_full(const void* in, void* out, long long R, long long C,
                              const double* params, int csf, int is_f64, void* stream) {
  return lbm::mrtcg::dispatch<false, false>(in, out, R, C, params, csf, is_f64, stream);
}
