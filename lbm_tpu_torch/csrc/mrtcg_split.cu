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
// at 3.35 TB/s).  Same work as kernel 6 on the same engines (see its
// note), strips of whole 32-byte sectors of its 18 output rows: at
// 4096x2048 on an H100 80GB HBM3 (700 W) the plan keeps the float32
// perturbation step on the tile, 0.6259 ms (the strip 0.6316: its 18
// stores a cell bind it), and gives the strip the others: CSF 0.9843,
// float64 0.9418 (CSF 1.5267), against the tile's 1.2764, 1.0874 (2.8239)
// in the same run (chip_smoke.py --parent, phase 6).

#include "mrtcg.cuh"

extern "C" int lbm_mrtcg_split(const void* in, void* out, long long R, long long C,
                               const double* params, int csf, int is_f64, void* stream) {
  return lbm::mrtcg::dispatch<true, false>(in, out, R, C, params, csf, is_f64, stream);
}

// Instance i of this unit's engine kernels (kernel 7), both engines
// (mrtcg::describe_unit).
extern "C" int lbm_mrtcg_split_instances(int i, long long* out) {
  using namespace lbm::mrtcg;
  return describe_unit<true, false, FLAT>(i, out);
}
