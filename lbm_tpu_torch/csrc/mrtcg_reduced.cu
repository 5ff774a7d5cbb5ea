// Kernel 6: one MRT colour-gradient step on the reduced state,
// (10, R, C) -> (10, R, C), or (12, R, C) in CSF mode.
//
// Replaces the TPU kernel lbm_tpu/kernels/mrtcg_pallas.py:1004
// make_mrtcg_reduced_step (_make_reduced_pipeline :966 on make_mrtcg_body
// :644); the step body is csrc/mrtcg.cuh.  Every step but the last of the
// four MRT-CG scenes runs here.
//
// Bytes per cell (each input read once, each output written once): 80 in
// float32 (10 planes in, 10 out), 96 in CSF mode; twice that in float64.
// Operations per cell, counted on the plain version: 524 (perturbation),
// 727 (CSF).  At 4096x2048 on an H100 80GB HBM3 (700 W) the least time is
// set by the bytes, 0.200 ms (0.240 CSF) at 3.35 TB/s; the kernel takes
// 0.591 ms in float32 (1.25 ms CSF), 0.98 ms in float64 (2.67 ms CSF).
// What holds it back is issue and latency, not bytes: each output cell
// pays ~2.2 (CSF ~3.3) evaluations of the window scalars and 1.33
// collisions (the halo and the ring), three barriers per tile, 79-100
// registers in float32 (2-3 blocks of 256 per SM), 128-178 in float64, and
// no fused multiply-add.  The simple, exact design is the point of this
// version; the levers are in PERF.md.  At the reference's 256x128 one
// step takes ~6 us on the card and ~30 us to issue from the host.

#include "mrtcg.cuh"

extern "C" int lbm_mrtcg_reduced(const void* in, void* out, long long R, long long C,
                                 const double* params, int csf, int is_f64,
                                 void* stream) {
  return lbm::mrtcg::dispatch<true, true>(in, out, R, C, params, csf, is_f64, stream);
}
