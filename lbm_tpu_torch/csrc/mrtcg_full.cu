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
// at 3.35 TB/s).  Same work as kernel 6 on the same engines (see its note)
// with 18 planes staged per window cell and strips of whole 32-byte
// sectors of its output rows: at 4096x2048 on an H100 80GB HBM3 (700 W)
// the plan keeps the float32 perturbation step on the tile, 0.7154 ms
// (the strip 0.7597: its 18 stores a cell bind it; without its pull it
// took 0.606 ms, PERF.md section 6), and gives the strip CSF 1.0971,
// float64 1.1469 (CSF 2.4735), against the tile's 1.3727, 1.2431 (2.9898)
// in the same run (chip_smoke.py --parent, phase 6).
//
// This source also holds kernel 31, lbm_halo_mrtcg_full: the same step on
// a row shard of the full state with halo inputs (csrc/halo.cuh,
// kernels/sharded.py make_sharded_mrtcg_step), kernel 29's geometry on
// this layout: the engines with their memory by global row
// (lbm::halo::ShardIO), the fst planes of CSF mode read from the halos
// like the populations.  It replaces lbm_tpu/kernels/sharded_pallas.py:406
// make_sharded_mrtcg_step.  Bytes per sweep: 144 B (160 CSF) per cell of
// its band in float32, plus the halo rows it reads.
//
// And kernel 38, lbm_halo2d_mrtcg_full: the step on a rows x cols shard of
// the full state, both modes (csrc/halo2d.cuh, kernels/sharded2d.py
// make_sharded2d_mrtcg_step), the engines with their rows by global index
// (lbm::halo2d::Shard2DIO) and its columns the shard's padded ones
// (mrtcg::BandCols: every value read in the padded block, the 5x5
// stencils' replicate clamp and the column repair of the stream at the
// grid's global columns 0 and C-1).  It replaces
// lbm_tpu/kernels/sharded2d_pallas.py:455 make_sharded2d_mrtcg_step on
// make_local_2d_body_step (:392, its pallas_call at :411).

#include "mrtcg.cuh"

extern "C" int lbm_mrtcg_full(const void* in, void* out, long long R, long long C,
                              const double* params, int csf, int is_f64, void* stream) {
  return lbm::mrtcg::dispatch<false, false>(in, out, R, C, params, csf, is_f64, stream);
}

// Kernel 31: one sweep of the full step on a row shard, geometry `geom`
// (csrc/halo.cuh), `params` those of lbm_mrtcg_full.
extern "C" int lbm_halo_mrtcg_full(const long long* geom, const double* params, int csf, int,
                                   int is_f64, void* stream) {
  return lbm::mrtcg::dispatch_halo<false, false>(geom, params, csf, is_f64, stream);
}

// Kernel 38: one sweep of the full step on a rows x cols shard, geometry
// `geom` (csrc/halo2d.cuh), `params` those of lbm_mrtcg_full.
extern "C" int lbm_halo2d_mrtcg_full(const long long* geom, const double* params, int csf,
                                     int, int is_f64, void* stream) {
  return lbm::mrtcg::dispatch_halo2d<false, false>(geom, params, csf, is_f64, stream);
}

// Instance i of this unit's engine kernels (kernels 8, 31, 38), both
// engines (mrtcg::describe_unit).
extern "C" int lbm_mrtcg_full_instances(int i, long long* out) {
  using namespace lbm::mrtcg;
  return describe_unit<false, false, FLAT, SHARD_EDGE, SHARD, SHARD2D_EDGE, SHARD2D>(i, out);
}
