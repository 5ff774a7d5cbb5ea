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
// set by the bytes, 0.200 ms (0.240 CSF) at 3.35 TB/s.  There its plan
// (csrc/strip_plan.cuh) takes the strip engine (csrc/mrtcg.cuh: ~1.1
// scalar evaluations and ~1.03 collisions an output cell, where the 8 x 32
// tile pays ~2.1 (CSF ~3.0, and ~2.1 normals) and 1.33): 0.5695 ms in
// float32 (0.8952 CSF), 0.8412 in float64 (1.3906 CSF), against the tile's
// 0.5946 (1.2546), 1.0110 (2.6516) in the same run (chip_smoke.py
// --parent, phase 6).  What holds it back is not bytes: its collisions and
// its pull's stores each take about the whole step and overlap
// (csrc/mrtcg.cuh's note), 110-128 registers in float32 leave 2 blocks of
// 256 threads an SM, and no multiply-add is fused.  At the scenes' 256x128
// a strip block would walk one group, so the plan takes the tile: one
// step takes 5.8 us on the card (the strip 7.9) and ~40 us to issue from
// the host.
//
// This source also holds kernel 29, lbm_halo_mrtcg_reduced: the same step
// on a row shard with halo inputs (csrc/halo.cuh, kernels/sharded.py),
// from the same engines with their memory by global row
// (lbm::halo::ShardIO): the row loader maps the rows beyond the shard to
// the halo buffers or the scratch slab, the replicate padding and the wall
// rows stay at the grid's global rows 0 and R-1, and interior ranks run
// the instance without row clamps or wall rows.  It replaces
// lbm_tpu/kernels/sharded_pallas.py:453 make_sharded_mrtcg_reduced_step.
//
// And kernel 39, lbm_mrtcg_reduced_lanes: the same step over lane blocks of
// lb columns of one grid (kernels/mrtcg.py make_mrtcg_reduced_lanes_step),
// replacing lbm_tpu/kernels/mrtcg_pallas.py:1033
// make_mrtcg_reduced_lanes_step.  A call of s steps is s sweeps, each one
// grid over every lane block (blockIdx.z) on the engines with their
// columns a block's window (mrtcg::LaneCols, mrtcg::LaneIO): sweep k reads
// the window [j lb - m_k-1, (j + 1) lb + m_k-1) of wrapped global columns
// and writes its middle, m_k = (s - k) H, H the columns a sweep consumes
// (3, CSF 5); a window is at most 2C wide (the host refuses a deeper call,
// kernels/mrtcg.py check_lane_window).  The first sweep reads the state in
// place, the last writes the middle lb columns of each block into the
// output state.  The margins
// are the step's reach, not lbm_tpu's 128-lane Mosaic tiles: the first
// sweep computes (lb + 2 (s - 1) H) / lb cells per kept cell.  The per-cell
// code is kernel 6's, so a call equals kernel 6 run s times bit for bit.
// Bytes: each sweep reads and writes its window band once, (lb + 2 m_k-1)
// and (lb + 2 m_k) columns of 10 planes (12 CSF) per block, where
// lbm_tpu's kernel runs the s steps of a block on the chip and moves the
// state once a call; its time against kernel 6 run s times is PERF.md's
// answer to the lane-blocking question on this card.

#include "mrtcg.cuh"

extern "C" int lbm_mrtcg_reduced(const void* in, void* out, long long R, long long C,
                                 const double* params, int csf, int is_f64,
                                 void* stream) {
  return lbm::mrtcg::dispatch<true, true>(in, out, R, C, params, csf, is_f64, stream);
}

// Kernel 29: one sweep of the reduced step on a row shard, geometry `geom`
// (csrc/halo.cuh), `params` those of lbm_mrtcg_reduced.
extern "C" int lbm_halo_mrtcg_reduced(const long long* geom, const double* params, int csf,
                                      int, int is_f64, void* stream) {
  return lbm::mrtcg::dispatch_halo<true, true>(geom, params, csf, is_f64, stream);
}

// Kernel 39: one sweep of the reduced step over the C / lb lane blocks, the
// input's margin `margin` (in_state: the input is the state; out_state: the
// output is the state, margin == 3, CSF 5), `params` those of
// lbm_mrtcg_reduced.
extern "C" int lbm_mrtcg_reduced_lanes(const void* in, void* out, long long R, long long C,
                                       long long lb, long long margin, int in_state,
                                       int out_state, const double* params, int csf,
                                       int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using lbm::mrtcg::launch_lanes;
  if (is_f64)
    return csf ? launch_lanes<double, true>(in, out, R, C, lb, margin, in_state, out_state,
                                            params, s)
               : launch_lanes<double, false>(in, out, R, C, lb, margin, in_state, out_state,
                                             params, s);
  return csf ? launch_lanes<float, true>(in, out, R, C, lb, margin, in_state, out_state, params,
                                         s)
             : launch_lanes<float, false>(in, out, R, C, lb, margin, in_state, out_state, params,
                                          s);
}

// The plan of a launch (csrc/strip_plan.cuh plan_by_layout), for the tests:
// `rin` / `rout` the reduced input / output layout, `sharded` a shard's
// memory, out[0..6] as plan_into writes them.
extern "C" void lbm_mrtcg_plan(long long width, long long nrows, long long held,
                               long long sms, long long lanes, int sharded, int csf,
                               int is_f64, int rin, int rout, long long* out) {
  lbm::mrtcg::plan_by_layout(width, nrows, held, sms, lanes, sharded, csf, is_f64, rin, rout,
                             out);
}

// The engine of every later MRT-CG launch (kernels 6-8, 29, 31, 38, 39): 0
// by its plan, 1 the tile, 2 the strip; for the tests and chip_smoke.py,
// which hold each engine at every shape.  Returns the previous setting.
extern "C" int lbm_mrtcg_force_engine(int engine) {
  const int was = lbm::mrtcg::forced_engine;
  lbm::mrtcg::forced_engine = engine;
  return was;
}

// Instance i of this unit's engine kernels (kernels 6, 29, 39), both
// engines (mrtcg::describe_unit).
extern "C" int lbm_mrtcg_reduced_instances(int i, long long* out) {
  using namespace lbm::mrtcg;
  return describe_unit<true, true, FLAT, SHARD_EDGE, SHARD, LANES>(i, out);
}
