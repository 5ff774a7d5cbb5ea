#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port, lbm_tpu_torch, once on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, no arguments
    python3 chip_smoke.py --parent DIR   # phase 6 also times the MRT-CG engine and
                                         # kernels 2, 4, 9, 12, 14, 16, 19-21, 23, 24,
                                         # 27, 28, 32-37 of the tree DIR (e.g. a git
                                         # archive of the parent commit) against this
                                         # one, and holds 2, 4, 9, 12, 14, 19-21, 23,
                                         # 24, 27, 28 and 32-37 to DIR's bits
    python3 chip_smoke.py --ibm-breakdown [--parent DIR]
                                         # build kernels 16, 19-21 alone, hold them,
                                         # time them whole and with parts left out
                                         # (and against DIR's), as a JSON line
    python3 chip_smoke.py --rk-breakdown [--parent DIR]
                                         # build kernel 12 whole, with parts left out
                                         # (and DIR's) and as its other designs
                                         # (RK_DESIGNS), time each, as a JSON line
    python3 chip_smoke.py --engine-sweep # build, then only the MRT-CG engines'
                                         # sweep (engine_sweep), as a JSON line
    python3 chip_smoke.py --k4-k33 [--parent DIR]
                                         # build, then only kernels 4 and 33 against
                                         # their other designs (and DIR's), held to
                                         # the same bits (k4_k33_times), as a JSON line
    python3 chip_smoke.py --k2-k9 [--parent DIR]
                                         # build, then only kernels 2 and 9 against
                                         # their other designs (and DIR's), held to
                                         # the same bits (k2_k9_times), as a JSON line
    python3 chip_smoke.py --k27-k34 [--parent DIR]
                                         # build, then only kernels 27 and 34 against
                                         # their other designs, the exchange alone (and
                                         # DIR's step and its first sweep alone), held
                                         # to the same bits (k27_k34_times), JSON line
    python3 chip_smoke.py --k32-k35 [--parent DIR]
                                         # build, then only kernels 32 and 35 against
                                         # their other designs (and DIR's), held to
                                         # the same bits (k32_k35_times), JSON line
    python3 chip_smoke.py --k37-k14 [--parent DIR]
                                         # build, then only kernels 37 and 14 against
                                         # their other designs (and DIR's), held to
                                         # the same bits (k37_k14_times), JSON line
    python3 chip_smoke.py --k23-k24 [--parent DIR]
                                         # build, then only kernels 23 and 24 against
                                         # their other designs (and DIR's, and 28
                                         # against DIR's), held to the same bits, with
                                         # their loss (k23_k24_times), JSON line
    python3 chip_smoke.py --k17-k30 [--parent DIR]
                                         # build, then only kernels 17 and 30 against
                                         # their other designs (and DIR's), held to
                                         # the same bits, with their loss
                                         # (k17_k30_times), JSON line

Builds the CUDA kernels from lbm_tpu_torch/csrc with nvcc, holds each
kernel to its plain PyTorch version on the card, drives the port's main path
through the entry points a user calls, times kernels and plain versions
with CUDA events, and prints as its last line

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}

Phases (each prints its results; an exception in any phase ends the run
with a nonzero exit code):
  1. toolchain: torch and CUDA versions, the card, nvcc, triton, nvidia-smi;
  2. build: the kernels from csrc/, timed, with ptxas' registers and spills
     per kernel (and those of kernels 25-26's four instances and of kernels
     31-39's instances on their own); for each of the 40 instances of the
     MRT-CG engines (csrc/mrtcg.cuh: kernels 6-8, 29, 31, 38, 39), the
     strip and the tile kernel's registers, local bytes, shared memory,
     threads and resident blocks per SM as the card reports them
     (``engine_instances``);
  3. the periodic kernels against their plain versions: kernel 1 (BGK) at
     4096x2048 float32 (1 and 8 steps; the 302 MB-per-buffer grid of
     bench.py), 1024x512 float64 and the reference's 21x21, 100x100 and
     101x101 in float64; kernel 3 (KBC) at 4096x2048 float32 (1 and 8
     steps), 1024x512 float64 and 128x128 float64 with both gamma
     implementations; kernel 5 (Smagorinsky LES) at 4096x2048 float32 (1
     and 8 steps) and 128x128 float64.  The KBC and LES states are off
     equilibrium (seeded_state(noisy=True)).  The MRT-CG kernels, both
     surface-tension modes, from the scenes' initial states: kernel 6
     (reduced) at 4096x2048 float32 (1 and 8 steps), 256x128 RT, 100x100
     droplet and 21x13 in float64 (8 steps); kernel 7 (split) at 4096x2048
     float32, 256x128 and 100x100 float64 (1 step); kernel 8 (full) at
     4096x2048 float32 (1 step), 256x128 and 21x13 float64 (4 steps); and
     reduced x7 + split == full x8 in float64 at 256x128 (<= 1e-12); and
     kernels 6-8 on each engine forced (tile, strip) at 515x387 float32 and
     100x100 float64, both modes;
     kernel 10 (TRT, bench.py's rates) on noisy states at 4096x2048 float32
     (1 and 8 steps) and 128x128 float64; kernel 11 (power law) from
     bench.py's double-shear state at 4096x2048 float32 (1 and 8 steps) and
     at 128x128 float64 in its three branches (n = 0.5, n = 1.5, and
     Newton with sigma_y = 5e-4, n = 0.8); kernel 12 (RK) from
     rk_rayleigh_taylor's initial state at 4096x2048 float32 (1 and 8 steps)
     and 1024x256 float32 and float64 (8 steps); kernel 13 (CSF droplet) from
     csf_static_droplet's at 4096x2048 float32 (3 steps), 100x100 and 41x41
     float64 (5 steps); kernel 14 (Shan-Chen) on lbm_tpu's noisy test states
     at 4096x2048, 256x256 and 256x128 float32 and 128x128 float64, 4
     steps, in all four eos/forcing instances;
  4. the channel kernels against their plain versions, 10 steps: kernel 2
     (BGK) at 4096x2048 float32, 21x21 and 101x101 float64; kernel 4 (KBC)
     at 4096x2048 float32, 128x128 and 24x24 float64, at
     ulbm_poiseuille's default relaxation and inlet density; kernel 9 in
     the gravity, specular, free-stream (faithful and corner-consistent),
     vertical (compressible and incompressible) and TRT configurations at
     4096x2048 float32 (twice, bit-identical: no entry has two writers)
     and at the reference's 21x21, 51x51 and 54x42 in float64; kernel 15
     (the IBM cylinder's grid step) at both Guo pairs, 10 steps from noisy
     states with a noisy force, at 1024x256 and 4096x2048 float32 and
     160x120 and 48x128 float64; kernel 16 (the IBM forcing, one block) at
     the Strouhal ROI, cylinder_flow's default ROI, the markers of
     configs/cylinder-markers.toml, a ROI two cells from the grid's edges
     and 1200 markers whose float64 working set takes the global scratch
     path, in both Peskin pairings and both types (``ibm_holds``); kernel
     17 (sedimentation) at
     256x320 in both types, 64x96 float64 and 4096x2048 float32, 10 steps
     from the scene's initial state with noise; each of kernels 15-17 twice,
     bit-identical; kernel 18 (the box grid step, the force window's origin
     read on the device) at 4096x2048 float32, 400x256 in both types,
     97x61 float64 and the phase-5 gates' 96x256, 800x128 and 800x256
     float32, 10 steps from noisy states with a noisy force window;
     kernels 19-21 (the moving-body forcing, one block each) at the falling
     scenes' default windows, at a window clipped at a grid edge, (19) at
     the falling gate's 26x26 window and (21) at the dkt gate's 228x128 and
     at two rings whose supports overlap (centres 2 r + 1.4 apart), in
     both types, 4 steps with the body state advancing (F within TOL; the
     state within TOL of max(1, |value|), in float32 against the float64
     plain version: no farther than the float32 plain version, plus TOL);
     each of kernels 18-21 twice, bit-identical; kernel 22 (the ring
     cavity) at L = 512 and 4096 float32 and L = 128 and 130 float64, and
     kernels 23 and 24 (the Rayleigh-Benard and heated-cavity steps) in both
     scalar lattices at 4096x2048 float32, at the gates' 64x128 and 128x128
     in both types and at an odd 97x61 float64, 10 steps from noisy states,
     twice, bit-identical; kernels 25 and 26 (the D3Q19 step in the planes
     and the lanes layout) in the four wall sets (periodic; the channel with
     a z force; the lid cavity with and without x walls) at 32x256x1024
     float32, 5x37x41 float64 and 8x64x128 in both types, and at every
     other shape, type and wall set that phase 5 gives them (d3q19_hold),
     10 steps from noisy states, kernel 25 twice bit-identical and kernel
     26, unpacked, equal to it; kernels 27-34 (the sharded halo-input
     steps of kernels/sharded.py and kernels/sharded2d.py) on shards of
     the card (``SHARDED_HOLDS``, ``sharded_hold``): 27 with BGK at
     4096x2048 float32 and 64x128 float64, n = 1, 2, 8, s = 1, 8, and with
     KBC, LES, TRT and the three power-law branches at 1024x512 float32 and
     64x128 float64; 28 at 4096x2048 and 64x128; 29 in both modes at
     4096x2048 and the RT 256x128, s up to 5 / 4; 30 at 4096x2048 and
     1024x256; 31 (the full MRT-CG state,
     both modes) against kernel 8 at 4096x2048 float32 and 256x128 float64,
     32 (Shan-Chen, all four instances) against 14 at 4096x2048 float32 and
     128x128 float64, 33 (D3Q19, Y sharded, periodic and the full cavity)
     against 25 at 32x256x1024 float32 and 8x64x128 float64, each on n = 1,
     2 and 8 shards, and 34 (the rows x cols collide-stream, every local
     collision) against 1/3/5/10/11 at 4096x2048 float32 and 128x256
     float64 on the (1, 1), (2, 4) and (4, 2) meshes; s = 1 and each
     family's deepest cadence, 10 steps (Shan-Chen 4), twice, bit for bit the
     single-device kernel (0.0 expected) and within TOL of the plain sharded
     version (8 shards; (4, 2) for 34-38); kernels 35-38 (the rows x cols
     body steps of kernels/sharded2d.py: Shan-Chen in all four instances,
     the Rayleigh-Benard step, RK, the full MRT-CG state in both modes)
     against 14, 23, 12 and 8 at 4096x2048 float32 and a small float64 grid
     on the (1, 2), (4, 2) and (2, 4) meshes, s = 1 and each family's cap;
     kernel 39 (the lane-blocked reduced MRT-CG step, ``LANES_HOLDS``,
     ``lanes_hold``) from bench.py's states in both modes at 4096x2048
     float32 (lane blocks 256, 512, 2048; s = 1, 2, 5, CSF 4), 1024x512
     float32 and 256x512 float64 (lane blocks 128, 256, 512), and the
     24x256 float64 where lbm_tpu's lanes step fails to trace (lane blocks
     256 and 128): bit for bit kernel 6 run s times, within TOL of its plain
     version;
  5. the main path, with every launch count set to 0 just before and read
     just after: the periodic BGK run at 4096x2048 float32 through
     kernels.bgk.make_fused_step; horizontal_poiseuille at the reference's
     defaults in float64 (L2 <= 1e-11, one kernel-2 launch per step); its
     CLI; validate_tpu.py poiseuille (128x128 float32, L2 <= 5e-4, kernel 2)
     and taylor_green (256x256 float32, kernel 1, decay ratio in [0.97,
     1.03]); the same scene at 4096x2048 float32, 1000 steps;
     ulbm_poiseuille at the reference's defaults in float64, 300k steps
     watched (lbm_tpu's hardware gates, one kernel-4 launch per step);
     ulbm_double_shear at the reference's defaults in float64 (10k steps,
     finite); the resolved KBC shear at 256x256 float32 and
     les_double_shear at 128x128 float32 with their gates; the
     ulbm_double_shear CLI; the MRT-CG scenes through kernels 6 (T-1
     launches) and 7 (one): the Laplace droplet at 128x128 for 40k steps
     in float64 and float32, the reference's RT horizon (256x128, 100k
     steps) in float32 and float64, RT growth and CSF growth in float32,
     each with lbm_tpu's hardware gates (scripts/validate_tpu.py laplace,
     laplace_df64's mass drift, rt_100k, rt_growth, csf_growth); the
     mrtcg_static_droplet CLI; the periodic TRT and power-law runs at
     4096x2048 float32 (kernels 10 and 11); the kernel-9 scenes with
     lbm_tpu's gates: vertical_poiseuille (incompressible, L2 <= 1e-11 in
     float64; compressible, watched to a stop), trt_poiseuille (L2 <= 1e-11
     in float64; 128x128 float32 for 200k steps, L2 <= 5e-4,
     validate_tpu.py trt), gravity_channel's parabola, specular_channel's
     flat accelerating plug, free_stream's bulk and walls, its
     corner-consistent fixed point in float64, and free_stream from
     configs/channel.toml in float64 (2700x2100, 1580 steps, 20 snapshot
     frames per field streamed to disk); power_law_channel (no kernel) on
     the card against the CPU; the vertical_poiseuille and free_stream CLIs;
     rk_rayleigh_taylor at 1024x256 for 100k steps in float32 and float64
     (validate_tpu.py rk_rt_100k, one kernel-12 launch per step);
     csf_static_droplet at the reference's 100x100, 100 steps, float64
     through kernel 13 (tests/test_multiphase.py's invariants);
     rk_static_droplet (no kernel) at its defaults on the card against the
     CPU; the Shan-Chen gates of validate_tpu.py shan_chen through kernel 14
     in float32, 4 steps per call; the rk_rayleigh_taylor and
     sc_flat_interface CLIs; the obstacle slice: validate_tpu.py strouhal
     (cylinder_flow 1024x256 float32, 200k steps, guo (3, 9), St in [0.15,
     0.20], lift rms in [0.02, 0.5], one launch each of kernels 16 and 15
     per step), cylinder_flow at its defaults in float64 (both weight
     pairings) and rectangle_sedimentation at its defaults in float64, each
     on the card against the CPU at 1e-12, rectangle_sedimentation in
     float32 for 20k steps with tests/test_sedimentation.py's invariants
     (both runs one kernel-17 launch a step, a dependent one where phase 2
     finds the grid in one wave),
     and the cylinder_flow (--markers) and rectangle_sedimentation CLIs
     (the CLIs run in one subprocess, each as ``python -m
     lbm_tpu_torch.run`` runs it, after the timed runs and beside the CPU
     references); the falling-body slice: validate_tpu.py falling
     (falling_cylinder 96x256 float32, 200 steps: descent, symmetry,
     reaction sign, the trajectory within 5e-4 of the CPU's), dkt
     (falling_cylinders at its defaults with row_slack=160, 30k steps, the
     draft gap and the tumble) and ellipse (falling_ellipse 800x256
     float32, 60k steps: final angle, overshoot, glide), each step one
     launch of kernel 18 and one of the scene's forcing kernel (19, 21,
     20); each scene at its defaults in float64 for 40 steps on the card
     against the CPU at 1e-12; the three CLIs (with the obstacle slice's);
     the cavity and thermal slice: validate_tpu.py cavity (ring_cavity
     L = 512 float32, 50k steps, F = 3e-5: max|u| and the arms'
     antisymmetry) and thermal (rayleigh_benard 64x128 float32, 30k steps:
     Nu and its saturation; heated_cavity 128x128 float32, 40k steps: Nu),
     the thermal gates in both scalar lattices, one launch of kernel 22, 23
     or 24 per step, each of 23 and 24's a programmatic dependent one
     (the library's count, ``lbm_dependent_launches``); each scene at a
     small size in float64 on the card against the CPU at 1e-12; the three
     CLIs; the D3Q19 slice, one
     kernel-25 launch per step: validate_tpu.py cavity3d (lid_cavity_3d
     8x64x128 float32, 20k steps, substeps 2: lid drag, return flow, max|u|,
     x mirror), the same cavity for 2000 steps in the lanes layout through
     kernel 26 (bit for bit the scene's), poiseuille_3d 24x8x8 float64 (20k
     steps, L2 <= 1e-10), taylor_green_3d at N = 32 float64 (400 steps) and
     the full-size N = 256 float32 (1000 steps; amplitude within 2.5% of the
     analytic decay, l2 < 1e-2), the three scenes in float64 on the card
     against the CPU at 1e-12, a checkpointed cavity interrupted and
     resumed on the card (bit-identical), and the three CLIs with a
     --checkpoint-dir run and its --resume; the row-sharded slice
     (``SHARDED_PATH``, through parallel.mesh and kernels/sharded.py on 8
     shards of the card): the periodic BGK at 4096x2048 with substeps
     "auto", kernel 27's other collisions at 1024x512, rayleigh_benard's
     64x128, the MRT-CG and CSF Rayleigh-Taylor 256x128 and the RK RT
     1024x256, each bit for bit its single-device kernel (27 and 30 one
     launch a call, counted, and no exchange copy); the plain
     sharded channel against horizontal_poiseuille at 24x24 float64;
     kernels 31-34 (``K31_34_PATH``, ``k31_34_path``, through
     kernels/sharded.py and kernels/sharded2d.py):
     the periodic BGK at 4096x2048 on a (4, 2) mesh with substeps "auto"
     and kernel 34's other collisions at 1024x512 on (2, 4) (27 and 34 one
     launch a call, counted), the MRT-CG and
     CSF Rayleigh-Taylor 256x128 in the full layout on 8 shards, each bit
     for bit its single-device kernel; sc_phase_separation 256x256 on 8
     shards, 4 steps per exchange, bit for bit the scene and within its
     gate, four kernel-32 launches a call and no exchange copy; the
     cavity3d gate with Y over 8 shards, bit for bit the scene
     and within the gate, two kernel-33 launches a call and no exchange
     copy; the dry run of parallel/dryrun.py; one shard per
     card for kernels 27-38 when there are several (``sharded_cards``; else
     logged as not run); kernels 35-38 (``K35_38_PATH``, ``k35_38_path``,
     through kernels/sharded2d.py's four body factories): the full MRT-CG
     state, CSF, RK, Shan-Chen and Rayleigh-Benard at 4096x2048 float32 on
     (4, 2), mrtcg_rayleigh_taylor's 256x128 on (4, 2), CSF on (2, 4),
     rk_rayleigh_taylor's 1024x256 on (4, 2), each bit for bit its
     single-device kernel; sc_phase_separation 256x256 on (4, 2), bit for
     bit the scene and within its gate, four kernel-35 launches a call and
     no exchange copy; rayleigh_benard 64x128 on (4, 2)
     (30k steps, 8 per exchange), bit for bit the scene and within the
     thermal gate's Nusselt band; kernel 39 (``LANES_PATH``, ``lanes_path``,
     through kernels/mrtcg.py make_mrtcg_reduced_lanes_step): bench.py's
     --lane-block path from its mrtcg and csf states, 200 steps each, at
     4096x2048 float32 with lane block 256 and lbm_tpu's wide cadences (5,
     CSF 4) and at the round-5 experiment's 1024x512 (s = 2 and 5, CSF 2),
     each bit for bit kernel 6 run the same steps, finite, its masses kept;
  6. times at 4096x2048 float32 of every kernel and its plain version:
     MLUPS, and effective bandwidth at the kernel's bytes per cell against
     a device-to-device copy of the same bytes, taken in turns; the kernels
     in float64; kernels 6 at 256x128, 12 at 1024x256 and 15 and 16 (and
     their step) at 1024x256 under a CUDA graph; kernels 19-21, kernel 18
     and their two-launch step at the falling scenes' defaults under CUDA
     graphs, with the host time per step of the phase-5 runs; kernel 22 at
     L = 4096 and kernels 23 and 24 in both lattices at 4096x2048, in both
     types, each in turns with its plain version, and the three gate runs'
     steps under CUDA graphs; kernels 25 and 26 at 32x256x1024 in both
     types and two wall sets, in turns with the plain version and a copy of
     the state, and the cavity3d gate's step under a CUDA graph; each
     kernel's bound (bytes over HBM3's rate against operations, counted on
     its plain version, over the fp32 peak; exp, log, expm1, clamp, where,
     maximum and minimum count one operation per element); kernels 27-34
     at n = 1 and 8 shards of the card (33 at 32x256x1024; 34 on the (1, 1),
     (4, 2) and (8, 1) meshes; 35-38 on (4, 2)) and s = 1 and each family's
     deepest cadence, against the single-device kernels, the exchange's
     copies alone and a copy of the state, under CUDA graphs
     (``sharded_times``); kernel 39 at 4096x2048 float32 in both modes, lane
     blocks 256, 512 and 2048, s = 1, 2, 5 (CSF 4), in turns with kernel 6
     run s times and with its plain version, under CUDA graphs, each with
     its bound (``lanes_times``, ``lanes_bound``); the MRT-CG engines'
     kernels 6, 7, 8, 29, 31, 38 (the step with exchange_2d and the shards'
     launches alone) and 39 and the control, kernel 12, at 4096x2048 in
     float32 and float64 and both modes, kernel 6 at 256x128 float32 and
     128x128 float64 under CUDA graphs, each on the tile and on the strip
     engine and on the engine of the tree that --parent names
     (``build_parent``), in turns, with the engine the plan picks
     (``engine_times``); with --parent also kernels 16 and 19-21 and their
     two-launch steps at the scenes' shapes in both types against the
     parent tree's design, in turns (``ibm_times``); kernel 12 at 1024x256
     and 4096x2048 and kernel 36 at the thermal gate's 64x128 and at
     4096x2048 on (4, 2), both types, under CUDA graphs, with --parent
     against the parent tree's in turns, kernel 12 bit for bit the parent's
     over 4 steps at 1024x256 and kernel 36 over 2 calls
     (``rk_k36_times``); kernel 4 at ulbm_poiseuille's 128x128 and at
     4096x2048 in both types, sized to the card (``K4_DESIGNS`` only
     under --k4-k33), and kernel 33 at the cavity3d gate's launch shape
     (both types) and 32x256x1024 on 8 shards (s = 1 and 8) beside the
     exchange of HALO rows alone, with --parent against the parent tree's
     in turns, every variant bit for bit the parent's (``k4_k33_times``); kernels 2
     and 9 (trt, gravity, vertical, free_stream_cc) at 128x128, 21x21 and
     4096x2048 in both types (``K2_K9_DESIGNS`` only under --k2-k9), with
     --parent against the parent tree's in turns, bit for bit
     (``k2_k9_times``); kernels 27 (8
     shards) and 34 ((4, 2)) at 4096x2048, s = 8 and 1, both types, BGK with
     the exchange alone, with --parent every collision against the parent
     tree's step (and BGK's first sweep alone) in turns, bit for bit
     (``k27_k34_times``); kernels 32 (8 shards) and 35 ((4, 2)) at their
     launch shape in both types and at 4096x2048, s = 1 and 4, with their
     launches a call and bound (``K32_K35_DESIGNS`` only under --k32-k35),
     with --parent against the parent tree's step in turns, bit for bit
     (``k32_k35_times``); kernel 37 ((4, 2)) at rk_rayleigh_taylor's
     1024x256 and at 4096x2048 and kernel 14 at sc_flat_interface's 256x128
     (4 a call) and at 4096x2048, both types, with their launches a call and
     bound (``K37_K14_DESIGNS`` only under --k37-k14), with --parent against
     the parent tree's step in turns, bit for bit (``k37_k14_times``);
     kernels 23 and 24 (all four instances) at their launch shapes
     (64x128, 128x128) and at 4096x2048, both types, with each float32
     launch shape's bound and loss (``K23_K24_DESIGNS`` only under
     --k23-k24), with --parent against the parent tree's (and kernel 28 at
     64x128 on 8 shards) in turns, bit for bit (``k23_k24_times``);
     kernel 17 at rectangle_sedimentation's 256x320 and at 4096x2048 and
     kernel 30 (8 shards, one step a call) at rk_rayleigh_taylor's 1024x256
     and at 4096x2048, both types, with each float32 launch shape's bound
     and loss (``K17_DESIGNS`` and ``K30_DESIGNS`` only under --k17-k30),
     with --parent against the parent tree's in turns, bit for bit
     (``k17_k30_times``); and the table of every
     kernel left at the shape its phase-5 launches run (``LAUNCH_SHAPES``,
     ``launch_shape_times``: us a launch under CUDA graphs of 100, its bound,
     its phase-5 launches and launches x (time - bound), ranked).
It exits nonzero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
TOL = {"float32": 2e-6, "float64": 1e-13}  # max abs error, kernel vs plain
BIG = (4096, 2048)
OMEGA = 1.0 / 0.8  # bench.py's BGK and KBC relaxation
LES = {"tau0": 0.5 + 3e-4, "cs_smag": 0.17}  # bench.py's LES constants
# ulbm_poiseuille's defaults (128x128, nu=1e-4, u_max=0.05): s2 and rho_inlet
ULBM_S2 = 1.0 / (0.5 + 3.0 * 1e-4)
ULBM_RHO_IN = 3.0 * 127 * (8.0 * 1e-4 * 0.05 / 128 ** 2) + 1.0
# the MRT-CG scenes' constants: Rayleigh-Taylor (mrtcg_rayleigh_taylor's
# defaults) and the Laplace droplet (mrtcg_static_droplet's)
RT = {"sigma": 1e-4, "gravity": (6.25e-7, 0.0)}
DROPLET = {"sigma": 0.1, "gravity": (0.0, -6.25e-6), "apply_gravity_source": False}
TRT_OMEGA = 1.0 / 0.9  # bench.py's TRT rate; the odd rate keeps Lambda = 3/16
PLAW = {"cons_K": 0.01, "n": 0.5}  # bench.py's power-law constants
TAU_MAGIC = (3.0 / 16.0) ** 0.5 + 0.5  # the reference's Poiseuille tau
# rk_rayleigh_taylor's defaults (kernel 12), csf_static_droplet's colours
# (kernel 13) and the Shan-Chen scenes' instances (kernel 14: G = -5, or the
# CS EOS at T/T_c = 0.7)
RK = {"r_alpha": 11.0 / 15.0, "b_alpha": 0.2, "r_nu": 0.04, "b_nu": 0.04, "sigma": 0.1,
      "beta": 0.7, "gravity": (-6.25e-6, 0.0)}
CSF_DROP = ({"rho_0": 1.0, "alpha": 0.2, "nu": 0.1667, "A": 0.5, "beta": 0.7},
            {"rho_0": 1.0, "alpha": 0.2, "nu": 0.1667, "A": 0.5, "beta": -0.7})
SC_INSTANCES = (("sc", "guo"), ("sc", "shift"), ("cs", "shift"), ("cs", "guo"))
T_RED = 0.7
# the obstacle scenes (kernels 15-17): rectangle_sedimentation's physics and
# its geometry (R23, C28, C38, inlet_rows) per grid; the Strouhal gate's
# cylinder (scripts/validate_tpu.py:333-350); the weak and standard Guo pairs
SED = {"omega": 1 / 0.55, "u_in": 0.02, "w_s": 3e-3, "C_w": 1e-3}
SED_GEOM = {(256, 320): (-151, 200, 250, 50), (64, 96): (-30, 50, 62, 16),
            (4096, 2048): (-151, 200, 250, 50)}
STROUHAL_CIRCLE = (300.0, 128.0, 16.0, 64)
GUO = ((1 / 3, 1 / 9), (3.0, 9.0))


def variants():
    """Kernel 9's configurations, those of lbm_tpu's scenes with a 0.1%
    pressure drop: name -> make_channel_variant_step keywords."""
    from lbm_tpu_torch.models.trt import omega_minus_from_magic

    om = 1.0 / TAU_MAGIC
    return {
        "gravity": dict(omega=om, incompressible=True, pressure=(1.0, 1.0, 0),
                        force=(-3e-4, 0.0), col_walls="bounce"),
        "specular": dict(omega=om, incompressible=False, pressure=(1.001, 1.0, 0),
                         col_walls="specular"),
        "free_stream": dict(omega=1 / 0.55, incompressible=True, row_walls="abb",
                            abb_u=(0.1, 0.0), col_walls="specular"),
        "free_stream_cc": dict(omega=1 / 0.55, incompressible=False, row_walls="abb",
                               abb_u=(0.1, 0.0), col_walls="specular",
                               corner_consistent=True),
        "vertical": dict(omega=om, incompressible=False, pressure=(1.001, 1.0, 1),
                         row_walls="bounce"),
        "vertical_incomp": dict(omega=om, incompressible=True, pressure=(1.001, 1.0, 1),
                                row_walls="bounce"),
        "trt": dict(omega=1 / 1.2, incompressible=True, pressure=(1.001, 1.0, 0),
                    col_walls="bounce", omega_minus=omega_minus_from_magic(1 / 1.2)),
    }


def shear_state(R, C, dtype, device, noisy_seed=None):
    """bench.py's power-law state, the double-shear equilibrium at u_max 0.05;
    with ``noisy_seed`` each population scaled by a seeded 1 + U(-3%, 3%)."""
    import numpy as np
    import torch

    from lbm_tpu_torch.ops import d2q9
    from lbm_tpu_torch.scenes.ulbm import double_shear_init

    m0, u = double_shear_init(R, C, 0.05, device=device, dtype=dtype)
    f = d2q9.equilibrium(u, m0)
    if noisy_seed is not None:
        rng = np.random.default_rng(noisy_seed)
        f = f * torch.as_tensor(rng.uniform(0.97, 1.03, (9, R, C)), dtype=dtype,
                                device=device)
    return f.contiguous()
# the cavity and thermal slice (kernels 22-24): ring_cavity's relaxation and
# the gate's force; rayleigh_benard's rates at its defaults (Ra 1e4, Pr 0.71,
# tau_g 0.8, H = 64)
CAVITY_OMEGA = 1.0 / ((3.0 / 16.0) ** 0.5 + 0.5)
THERMAL_PHYS = {"omega_f": 1.0 / (0.71 * 0.1 * 3.0 + 0.5), "omega_g": 1.25,
                "g_beta": 1e4 * 0.71 * 0.1 * 0.1 / 64 ** 3}
THERMAL_NAMES = ("thermal_rb_q9", "thermal_rb_q5", "heated_cavity_q9", "heated_cavity_q5")
# the D3Q19 slice (kernels 25-26): the four wall sets of the step, its timing
# grid (as many cells as 4096x2048) and validate_tpu.py cavity3d's cavity
# (:579-597; Re 100 at u_lid 0.05 on Z = 128)
D3Q19_OMEGA = 1.0 / 0.7
D3Q19_WALLS = {"periodic": {}, "channel": {"x_walls": True, "force_z": 1e-5},
               "cavity": {"x_walls": True, "y_walls": True, "z_walls": True, "lid_u": 0.05},
               "cavity_no_x": {"y_walls": True, "z_walls": True, "lid_u": 0.05}}
D3Q19_BIG = (32, 256, 1024)
CAVITY3D = {"X": 8, "Y": 64, "Z": 128, "Re": 100.0, "u_lid": 0.05, "x_walls": True,
            "substeps": 2}


# NVIDIA H100 SXM data sheet: HBM3 bytes/s; fp32 and fp64 FLOP/s outside the
# tensor cores (dense, at the 700 W limit)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def seeded_state(R, C, dtype, device, seed, incompressible=False, noisy=False):
    """An equilibrium at a numpy-seeded random flow (|u| <= 0.05, rho within
    1%), made on the card, so every population differs.  ``noisy`` scales
    each population by a seeded 1 + U(-0.03, 0.03): a state off
    equilibrium, where the KBC gamma ratio is well defined (at an
    equilibrium it is 0/0 and only its regulariser speaks)."""
    import numpy as np
    import torch

    from lbm_tpu_torch.ops import d2q9

    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.uniform(-0.05, 0.05, (2, R, C)), dtype=dtype, device=device)
    rho = torch.as_tensor(1.0 + rng.uniform(-0.01, 0.01, (R, C)), dtype=dtype, device=device)
    eq = d2q9.incomp_equilibrium if incompressible else d2q9.equilibrium
    f = eq(u, rho)
    if noisy:
        f = f * torch.as_tensor(rng.uniform(0.97, 1.03, (9, R, C)), dtype=dtype,
                                device=device)
    return f.contiguous()


def hold_periodic(name, kernel_step, plain_step, cases, device, seed, noisy=True):
    """Each case (dtype, (R, C), steps): ``kernel_step(R, C, dtype, steps)``
    against ``plain_step(...)`` from one seeded state, off equilibrium unless
    ``noisy`` is False.  Returns the max error per dtype."""
    errs = {}
    for dtype, (R, C), steps in cases:
        f = seeded_state(R, C, dtype, device, seed=seed + R + C, noisy=noisy)
        got = kernel_step(R, C, dtype, steps)(f)
        want = plain_step(R, C, dtype, steps)(f)
        e = compare(f"{name} {R}x{C} {dtype} {steps} step(s)", got, want, dtype)
        errs[dtype] = max(errs.get(dtype, 0.0), e)
        del f, got, want
    return errs


def compare(name, got, want, dtype):
    import torch

    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = TOL[str(dtype).removeprefix("torch.")]
    ok = err <= tol and bool(torch.isfinite(got).all())
    log(f"{name}: max_abs_err={err!r} tol={tol!r} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def check_gates(name, gates) -> None:
    """Each gate is (value, lo, hi), inclusive; log them all, then fail if
    any value lies outside its bounds."""
    bad = [k for k, (v, lo, hi) in gates.items() if not lo <= v <= hi]
    log(f"{name}: " + ", ".join(f"{k}={v!r} in [{lo!r}, {hi!r}]"
                                for k, (v, lo, hi) in gates.items())
        + (f" FAIL {bad}" if bad else " ok"))
    if bad:
        raise AssertionError(f"{name}: gates failed: {bad}")


def start_clis(argvs):
    """Start each argv as ``python -m lbm_tpu_torch.run *argv``, all in one
    subprocess (runpy runs the module as ``-m`` does), so the interpreter,
    torch and the kernel library start once; ``finish_clis`` waits."""
    code = ("import runpy, sys\n"
            f"for argv in {[list(a) for a in argvs]!r}:\n"
            "    sys.argv = ['lbm_tpu_torch.run', *argv]\n"
            "    try:\n"
            "        runpy.run_module('lbm_tpu_torch.run', run_name='__main__', alter_sys=True)\n"
            "        rc = 0\n"
            "    except SystemExit as e:\n"
            "        rc = e.code if isinstance(e.code, int) else int(e.code is not None)\n"
            "    print(f'CLI rc={rc}', file=sys.stderr, flush=True)\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    atexit.register(proc.kill)  # a failed phase must not leave it running
    return proc, list(argvs), time.perf_counter()


def finish_clis(started) -> str:
    """Wait for ``start_clis``'s process; fail unless each CLI exits with 0.
    Returns the process's standard error."""
    proc, argvs, t0 = started
    _, err = proc.communicate(timeout=900)
    lines = err.strip().splitlines()
    results = [(lines[i - 1] if i else "", line) for i, line in enumerate(lines)
               if line.startswith("CLI rc=")]
    for argv, (last, rc) in zip(argvs, results):
        log(f"[5] CLI {' '.join(argv)}: {rc} {last}")
    log(f"[5] {len(argvs)} CLI runs in one process: {time.perf_counter() - t0!r} s")
    if proc.returncode != 0 or len(results) != len(argvs) or \
            any(rc != "CLI rc=0" for _, rc in results):
        raise AssertionError(f"CLI failed:\n{err[-3000:]}")
    return err


def mrtcg_state(R, C, dtype, device, csf=False, droplet=False):
    """A scene's initial full MRT-CG state as flat planes (18, or 20 in CSF
    mode): the RT layers of init_rho_cosine (sign -1, or +1 with the fst0
    seed in CSF mode, as the scenes build them) or the Laplace droplet of
    radius R/4 at u = 0.5 Fg/rho."""
    import torch

    from lbm_tpu_torch.models.mrt_cg import MRTCGModel
    from lbm_tpu_torch.scenes import multiphase as mp

    red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
    if droplet:
        model = MRTCGModel(red=red, blue=blue, **DROPLET)
        st = model.init_state(mp.init_rho_droplet(R, C, red.rho_0, True, R / 4),
                              mp.init_rho_droplet(R, C, blue.rho_0, False, R / 4),
                              dtype=dtype, u_init_gravity_shift=True, device=device)
        return torch.cat([st.red.f, st.blue.f]).contiguous()
    sign = 1.0 if csf else -1.0
    model = MRTCGModel(red=red, blue=blue, **RT)
    st = model.init_state(mp.init_rho_cosine(R, C, red.rho_0, True, sign),
                          mp.init_rho_cosine(R, C, blue.rho_0, False, sign),
                          dtype=dtype, device=device)
    planes = [st.red.f, st.blue.f]
    if csf:
        fg = torch.as_tensor(RT["gravity"], dtype=dtype, device=device)[:, None, None]
        planes.append(fg * ((st.red.rho + st.blue.rho)[None] / red.rho_0 - 1.0))
    return torch.cat(planes).contiguous()


def mrtcg_steps(layout, R, C, dtype, csf, droplet=False):
    """(kernel step, plain step, input) of one MRT-CG kernel on flat planes:
    layout "reduced" (kernel 6), "split" (kernel 7) or "full" (kernel 8)."""
    from lbm_tpu_torch.kernels import mrtcg
    from lbm_tpu_torch.scenes import multiphase as mp

    red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
    mode = "csf" if csf else "perturbation"
    kw = DROPLET if droplet else RT
    plain = mrtcg.make_plain_step(red, blue, surface_tension=mode,
                                  reduced_in=layout != "full",
                                  reduced_out=layout == "reduced", **kw)
    if layout == "full":
        if csf:
            kstep = mrtcg.make_csf_fused_step(R, C, red, blue, dtype=dtype, **kw)
        else:
            full = mrtcg.make_mrtcg_fused_step(R, C, red, blue, dtype=dtype, **kw)
            kstep = lambda S: full(S.reshape(2, 9, R, C)).reshape(18, R, C)  # noqa: E731
        return kstep, plain
    factory = (mrtcg.make_mrtcg_reduced_step if layout == "reduced"
               else mrtcg.make_mrtcg_split_step)
    step = factory(R, C, red, blue, dtype=dtype, surface_tension=mode, **kw)
    return (lambda G: step(G).reshape(-1, R, C)), plain


def rk_state(R, C, dtype, device):
    """rk_rayleigh_taylor's initial state, [f (9), r_rho, b_rho]."""
    import torch

    from lbm_tpu_torch.models.rk_cg import RKMixtureModel
    from lbm_tpu_torch.scenes import multiphase as mp

    st = RKMixtureModel(r_rho_0=3.0, b_rho_0=1.0, **RK).init_state(
        mp.init_rho_cosine(R, C, 3.0, False, 1.0), mp.init_rho_cosine(R, C, 1.0, True, 1.0),
        dtype=dtype, device=device)
    return torch.cat([st.f, st.r_rho[None], st.b_rho[None]]).contiguous()


def csf_drop_colours():
    from lbm_tpu_torch.models.mrt_csf_droplet import CSFColour

    return tuple(CSFColour(**c) for c in CSF_DROP)


def csf_drop_state(R, C, dtype, device):
    """csf_static_droplet's initial state at radius min(R, C)/4, [red f,
    blue f, fs = 0]."""
    import torch

    from lbm_tpu_torch.models.mrt_csf_droplet import CSFDropletModel
    from lbm_tpu_torch.scenes import multiphase as mp

    radius = min(R, C) / 4.0
    st = CSFDropletModel(*csf_drop_colours()).init_state(
        mp.init_rho_droplet(R, C, 1.0, True, radius, 2.0),
        mp.init_rho_droplet(R, C, 1.0, False, radius, 2.0), dtype=dtype, device=device)
    return torch.cat([st.red.f, st.blue.f,
                      torch.zeros((2, R, C), dtype=dtype, device=device)]).contiguous()


@functools.cache
def cs_coexistence():
    """(T, rho_v, rho_l) of the CS EOS at T/T_c = T_RED (Maxwell)."""
    from lbm_tpu_torch.models.shan_chen import CS_TC, maxwell_coexistence

    return (T_RED * CS_TC, *maxwell_coexistence(T_RED * CS_TC))


def sc_kwargs(eos, forcing):
    """make_sc_fused_step keywords of one kernel-14 instance."""
    if eos == "cs":
        return {"omega": 1.0, "eos": "cs", "T": cs_coexistence()[0], "forcing": forcing}
    return {"omega": 1.0, "G": -5.0, "eos": "sc", "forcing": forcing}


def sc_state(R, C, dtype, device, eos, seed):
    """The equilibrium at rest of lbm_tpu's kernel-test density: 0.7 + 0.1
    N(0, 1) (tests/test_shan_chen.py:99-101), or for the CS EOS the
    coexistence midpoint with 0.2 (rho_l - rho_v) N(0, 1) noise (:186-188)."""
    import numpy as np
    import torch

    from lbm_tpu_torch.ops import d2q9

    rng = np.random.default_rng(seed)
    if eos == "cs":
        _, rv, rl = cs_coexistence()
        rho = 0.5 * (rv + rl) + 0.2 * (rl - rv) * rng.standard_normal((R, C))
    else:
        rho = 0.7 + 0.1 * rng.standard_normal((R, C))
    return d2q9.equilibrium(torch.zeros((2, R, C), dtype=dtype, device=device),
                            torch.as_tensor(rho, dtype=dtype, device=device)).contiguous()


def hold_steps(name, make_kernel, make_plain, make_state, cases, device):
    """Each case (dtype, (R, C), steps): ``make_kernel(R, C, dtype, steps)``
    (one call of ``steps`` launches) against ``steps`` calls of
    ``make_plain()`` from ``make_state(R, C, dtype, device)``.  Returns the
    max error per dtype."""
    errs = {}
    for dtype, (R, C), steps in cases:
        x = make_state(R, C, dtype, device)
        got = make_kernel(R, C, dtype, steps)(x)
        plain, want = make_plain(), x
        for _ in range(steps):
            want = plain(want)
        e = compare(f"{name} {R}x{C} {dtype} {steps} step(s)", got, want, dtype)
        errs[dtype] = max(errs.get(dtype, 0.0), e)
        del x, got, want
    return errs


def reduced_input(S, csf):
    from lbm_tpu_torch.kernels import mrtcg

    R, C = S.shape[1:]
    return mrtcg.reduce_mrtcg_state(S if csf else S.reshape(2, 9, R, C),
                                    "csf" if csf else "perturbation")


def hold_mrtcg(name, layout, csf, cases, device):
    """Each case (dtype, (R, C), steps, droplet): the kernel against its
    plain version from one scene state.  Returns the max error per dtype."""
    errs = {}
    for dtype, (R, C), steps, droplet in cases:
        S = mrtcg_state(R, C, dtype, device, csf, droplet)
        x = S if layout == "full" else reduced_input(S, csf)
        kstep, plain = mrtcg_steps(layout, R, C, dtype, csf, droplet)
        got, want = x, x
        for _ in range(steps):
            got, want = kstep(got), plain(want)
        what = "droplet" if droplet else "RT"
        e = compare(f"{name} {'CSF' if csf else 'perturbation'} {what} {R}x{C} {dtype} "
                    f"{steps} step(s)", got, want, dtype)
        errs[dtype] = max(errs.get(dtype, 0.0), e)
        del S, x, got, want
    return errs


def ptxas_entries(build_log: str, unit: str) -> list:
    """(mangled name, registers, spill line) of each entry function that
    ptxas reports for ``unit`` in the build's log (kernels/_build.py keeps
    nvcc's output of each source after a "== <unit>" line)."""
    import re

    section = build_log.split(f"== {unit}\n", 1)[1].split("\n== ", 1)[0]
    entries = []
    for line in section.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entries.append([m.group(1), None, ""])
        elif entries and "registers" in line:
            entries[-1][1] = int(re.search(r"Used (\d+) registers", line).group(1))
        elif entries and "spill" in line:
            entries[-1][2] = line.strip()
    return [tuple(e) for e in entries]


def ops_per_cell(fn, x) -> float:
    """Floating-point operations per cell of ``fn(x)``, a plain version on a
    small CPU state: the elements every arithmetic aten op writes (a sum
    over planes counts its adds), counted under a dispatch mode, over the
    cells.  The kernels do the same arithmetic.  A transcendental, a clip or
    a select counts one operation per element, as an add does."""
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {"add", "sub", "mul", "div", "neg", "sqrt", "reciprocal", "rsub", "pow",
             "exp", "log", "expm1", "clamp", "clamp_min", "clamp_max", "where",
             "maximum", "minimum"}
    count = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in arith and hasattr(out, "numel"):
                count[0] += out.numel()
            elif name == "sum" and hasattr(out, "numel"):
                count[0] += args[0].numel() - out.numel()
            return out

    with Count():
        fn(x)
    return count[0] / (x.shape[-2] * x.shape[-1])


def bound(bytes_per_cell, ops, cells, dtype):
    """(least ms, "bytes" or "operations") for ``cells`` cells: the larger of
    the bytes over HBM3's rate and the operations over the peak rate."""
    t_bytes = bytes_per_cell * cells / HBM_BYTES_S
    t_ops = ops * cells / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def thermal_state(q, R, C, dtype, device, seed):
    """[f, g] of the thermal steps off equilibrium: f a noisy seeded state, g
    the temperature's equilibrium populations at a seeded theta in [-0.5,
    0.5] (weights times theta; q = 9 or 5 planes), each times a seeded
    1 + U(-0.03, 0.03)."""
    import numpy as np
    import torch

    from lbm_tpu_torch.core import lattice as lat

    rng = np.random.default_rng(seed)
    w = lat.W if q == 9 else lat.W5
    g = w[:, None, None] * rng.uniform(-0.5, 0.5, (R, C)) * rng.uniform(0.97, 1.03, (q, R, C))
    return torch.cat([seeded_state(R, C, dtype, device, seed, noisy=True),
                      torch.as_tensor(g, dtype=dtype, device=device)]).contiguous()


def d3q19_state(X, Y, Z, dtype, device, seed):
    """The D3Q19 equilibrium at a numpy-seeded flow (|u| <= 0.05, rho within
    1%), made on the card, each population times a seeded 1 + U(-0.03,
    0.03): off equilibrium."""
    import numpy as np
    import torch

    from lbm_tpu_torch.ops import d3q19

    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.uniform(-0.05, 0.05, (3, X, Y, Z)), dtype=dtype, device=device)
    rho = torch.as_tensor(1.0 + rng.uniform(-0.01, 0.01, (X, Y, Z)), dtype=dtype,
                          device=device)
    f = d3q19.equilibrium(u, rho)
    f *= torch.as_tensor(rng.uniform(0.97, 1.03, (19, X, Y, Z)), dtype=dtype, device=device)
    return f.contiguous()


def hold_d3q19(X, Y, Z, dtype, walls, device, steps=10):
    """Kernel 25, ``steps`` launches from a noisy state, twice, and kernel 26
    as many on the lanes layout, against as many plain steps: each within
    TOL, the two kernel-25 runs bit-identical, and kernel 26, unpacked,
    equal to kernel 25 bit for bit.  Returns (err 25, err 26)."""
    import torch

    from lbm_tpu_torch.kernels import d3q19 as kd

    kw = dict(omega=D3Q19_OMEGA, **D3Q19_WALLS[walls])
    f = d3q19_state(X, Y, Z, dtype, device, seed=X + Y + Z + len(walls))
    step25 = kd.make_d3q19_fused_step(X, Y, Z, dtype=dtype, **kw)
    step26 = kd.make_d3q19_lanes_step(X, Y, Z, dtype=dtype, **kw)
    got, again, lanes, want = f, f, kd.pack_lanes(f), f
    for _ in range(steps):
        got, again, lanes = step25(got), step25(again), step26(lanes)
    for _ in range(steps):
        want = kd.plain_d3q19_step(want, **kw)
    got26 = kd.unpack_lanes(lanes, X, Y, Z)
    label = f"[4] {walls} {X}x{Y}x{Z} {dtype} {steps} steps"
    e25 = compare(f"{label} kernel 25", got, want, dtype)
    e26 = compare(f"{label} kernel 26", got26, want, dtype)
    same, same26 = bool(torch.equal(got, again)), bool(torch.equal(got26, got))
    log(f"{label}: kernel 25 twice bit-identical: {same}; kernel 26 unpacked == kernel 25: "
        f"{same26}")
    if not (same and same26):
        raise AssertionError(f"{label}: a race, or kernel 26 differs from kernel 25")
    return e25, e26


def thermal_kernel(name):
    """(make step, plain step, CudaKernel, q) of one thermal instance, by its
    name in THERMAL_NAMES."""
    from lbm_tpu_torch.kernels import thermal as kth

    q = int(name[-1])
    if name.startswith("thermal_rb"):
        return kth.make_thermal_fused_step, kth.plain_rb_step, kth.THERMAL[q], q
    return kth.make_heated_cavity_fused_step, kth.plain_heated_cavity_step, \
        kth.HEATED_CAVITY[q], q


def sediment_kwargs(R, C):
    """make_sediment_fused_step's physics and geometry at an (R, C) grid."""
    R23, C28, C38, inlet = SED_GEOM[(R, C)]
    return dict(SED, R23=R23, C28=C28, C38=C38, inlet_rows=inlet)


def sediment_state(R, C, dtype, device, seed):
    """rectangle_sedimentation's initial state at its geometry, each
    population scaled by a seeded 1 + U(-0.03, 0.03)."""
    import numpy as np
    import torch

    from lbm_tpu_torch.scenes.obstacles import sediment_initial_state

    kw = sediment_kwargs(R, C)
    S = sediment_initial_state(R, C, kw["u_in"], kw["C_w"], kw["inlet_rows"], device, dtype)
    rng = np.random.default_rng(seed)
    return (S * torch.as_tensor(rng.uniform(0.97, 1.03, S.shape), dtype=dtype,
                                device=device)).contiguous()


def sediment_describe(n, is_f64) -> list:
    """Kernel 17's instance of type ``is_f64`` launched over ``n`` cells as
    the card reports it (lbm_sediment_describe): registers, local bytes a
    thread, threads a block, resident blocks per SM, blocks, 1 where the
    grid fits the card in one wave (a dependent launch), and its index bits;
    raises on a spill, an error or no resident block."""
    import ctypes

    from lbm_tpu_torch.kernels import _build

    fn = _build.library().lbm_sediment_describe
    fn.argtypes, fn.restype = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_longlong * 7)()
    rc = fn(n, is_f64, out)
    if rc != 0 or out[1] != 0 or out[3] < 1:
        raise AssertionError(f"kernel 17 (float64 {bool(is_f64)}, {n} cells): cudaError_t "
                             f"{rc}, {out[1]} local bytes, {out[3]} blocks per SM")
    return list(out)


def cylinder_case(R, C, dtype, device, ib, seed):
    """(f, F_roi, origin): a noisy state and a force N(0, 1e-3) over ib's ROI."""
    import numpy as np
    import torch

    f = seeded_state(R, C, dtype, device, seed=seed, noisy=True)
    rng = np.random.default_rng(seed + 1)
    F = torch.as_tensor(rng.normal(0.0, 1e-3, (2,) + ib.roi_shape), dtype=dtype,
                        device=device)
    return f, F, (ib.roi_rows[0], ib.roi_cols[0])


def hold_twice(name, step, plain, x, steps, dtype):
    """``steps`` calls of ``step`` from ``x``, twice, against ``steps`` calls
    of ``plain``: the kernel within TOL of its plain version, and its two
    runs bit-identical (a second writer of an entry would race).  Returns
    the error."""
    import torch

    got, again, want = x, x, x
    for _ in range(steps):
        got = step(got)
    for _ in range(steps):
        again = step(again)
    for _ in range(steps):
        want = plain(want)
    e = compare(name, got, want, dtype)
    same = bool(torch.equal(got, again))
    log(f"{name}: second run bit-identical: {same}")
    if not same:
        raise AssertionError(f"{name}: two runs differ (a race)")
    return e


def forcing_work(ib, itemsize):
    """(bytes, operations) of one kernel-16 call at ``ib``: the 9 planes read
    over the support (the ROI cells some marker's 4x4 box covers, the only
    cells F is nonzero on) and the 2 force planes written over the ROI, the
    weights and indices read once; 20 operations per support cell for the
    moments, 32 per marker for rho_j, and per iteration 64 per marker to
    interpolate u, 3 for f_j, 64 to spread (two components, a multiply and
    an add per weight) and 8 per support cell to update u and F.  The count
    is the sparse work these markers need, not the plain version's dense
    matmuls."""
    from lbm_tpu_torch.kernels.ibm import forcing_tables

    n = ib.roi_shape[0] * ib.roi_shape[1]
    support = forcing_tables(ib)[2].size
    M = ib.row_w.shape[0]
    iters = ib.m_max - 1
    return ((9 * support + 2 * n) * itemsize + M * (16 * itemsize + 8),
            20 * support + 32 * M + iters * (131 * M + 8 * support))


def graph_ms(step, x, n: int = 100) -> float:
    """Device ms per step from a CUDA graph of ``n`` chained steps
    y = step(y) from ``x`` (one step issues on the host in more time than a
    small kernel runs, so events around eager launches would time the
    host)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(x)  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = x
        for _ in range(n):
            y = step(y)
    t = cuda_ms(graph.replay, 10) / n
    del graph, y
    return t


def cuda_ms(fn, n: int) -> float:
    """Device milliseconds per call of ``fn`` over ``n`` calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


# the moving-body scenes' defaults (lbm_tpu/scenes/obstacles.py): (H, W,
# radius or semi-axes, rho_s, gravity), and the DKT pair's centres
FALLING = (400, 256, 12.0, 1.25, 5e-5)
ELLIPSE = (800, 256, (16.0, 8.0), 1.25, 2e-4)
DKT = (800, 128, 12.0, 1.25, 2e-4)
DKT_CENTERS = ((96.0, 63.0), (130.0, 64.0))
# validate_tpu.py falling's falling_cylinder (:455-476), centre (24, 128)
FALLING_GATE = (96, 256, 8.0, 1.5, 1e-4)


def moving_case(variant, dtype, device, edge=False, rw=116, gate=False, m_max=5,
                overlap=False, km=None):
    """(step, f, state) of kernel 19 ("forcing"), 20 ("rot") or 21 ("bodies")
    at its scene's default grid, markers and rigid constants (19 with
    ``gate`` at the falling gate's), on a noisy fluid state, the body at its
    default centre or clipped at a grid edge; 21 with ``overlap`` at centres
    2 r + 1.4 apart, where the two rings' supports share cells (DKT's kissing
    gap is 1.407).  ``km``: the kernels' module (default this tree's)."""
    import numpy as np

    from lbm_tpu_torch.ops.moving_ibm import ellipse_markers

    if km is None:
        from lbm_tpu_torch.kernels import moving_ibm as km

    if variant == "rot":
        H, W, (a, b), rho_s, g = ELLIPSE
        dx, dy = ellipse_markers(a, b)
        area = np.pi * a * b
        step = km.make_moving_rot_step(
            H, W, dx, dy, half=int(np.ceil(a)) + 5, g_net=(rho_s - 1) * area * g,
            m_eff=rho_s * area, i_eff=rho_s * area * (a * a + b * b) / 4, m_max=m_max,
            dtype=dtype)
        state = km.pack_state_rot((19.5, 20.0) if edge else (200.0, 127.5),
                                  (np.cos(0.3), np.sin(0.3)), (0.003, 0.001), 1e-4,
                                  dtype=dtype, device=device)
    else:
        H, W, r, rho_s, g = (DKT if variant == "bodies" else FALLING_GATE if gate
                             else FALLING)
        th = np.linspace(0.0, 2.0 * np.pi, int(np.ceil(2 * np.pi * r)), endpoint=False)
        kw = dict(half=int(np.ceil(r)) + 5, g_net=(rho_s - 1) * np.pi * r * r * g,
                  m_eff=rho_s * np.pi * r * r, m_max=m_max, dtype=dtype)
        if variant == "forcing":
            step = km.make_moving_forcing_step(H, W, r * np.cos(th), r * np.sin(th), **kw)
            state = km.pack_state((16.0, 240.5) if edge else (24.0, 128.0) if gate
                                  else (100.0, 128.0), (0.002, -0.001), dtype=dtype,
                                  device=device)
        else:
            step = km.make_moving_bodies_step(H, W, r * np.cos(th), r * np.sin(th), n_bodies=2,
                                              rw=rw, radius=r, **kw)
            centers = (((785.0, 63.0), (770.0, 110.0)) if edge else
                       ((100.0, 63.0), (100.0 + 2 * r + 1.4, 63.3)) if overlap else DKT_CENTERS)
            state = km.pack_states(centers, ((0.003, 0.0), (0.004, 0.0005)), dtype=dtype,
                                   device=device)
    return step, seeded_state(H, W, dtype, device, seed=H + W + len(variant), noisy=True), state


def hold_forcing(name, step, f, state, steps, dtype, step64=None):
    """``steps`` forcing steps from ``state`` on the fixed fluid ``f``, twice,
    against the builder's plain version: F within TOL, the origin equal,
    the two runs bit-identical, and the state within TOL of max(1, |x|)
    (its lanes run from 1e-4 velocities to centres of several hundred).
    A float32 state is held to the float64 plain version ``step64`` on the
    same inputs instead: the kernel no farther from it than the float32
    plain version is, plus TOL.  Its hydrodynamic force and torque are sums
    over 76-152 markers of O(0.1-1) terms that cancel, which two float32
    summation orders round apart by a few 1e-6 (the torque of kernel 20:
    3.2e-6 between kernel and plain on the card, each 6-8e-6 from float64).
    Returns (F's max abs error, the state's error against the plain version
    of its own type, the float32 state's excess over the float32 plain
    version's error against the float64 plain version, or 0.0 in float64)."""
    import torch

    got, again, want = state, state, state
    for _ in range(steps):
        Fg, og, got = step(f, got)
        Fa, oa, again = step(f, again)
        Fw, ow, want = step.plain(f, want)
    torch.cuda.synchronize()
    e_F = (Fg - Fw).abs().max().item()
    e_raw = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
    e_s, e_excess, note = e_raw, 0.0, ""
    if step64 is not None:
        truth = state.double()
        for _ in range(steps):
            truth = step64.plain(f.double(), truth)[2]
        scale = truth.abs().clamp_min(1.0)
        excess = ((got.double() - truth).abs() - (want.double() - truth).abs()) / scale
        e_s = e_excess = max(excess.max().item(), 0.0)
        note = (f" (kernel vs plain {e_raw!r}; vs the float64 plain: kernel "
                f"{((got.double() - truth).abs() / scale).max().item()!r}, plain "
                f"{((want.double() - truth).abs() / scale).max().item()!r})")
    tol = TOL[str(dtype).removeprefix("torch.")]
    same = torch.equal(Fg, Fa) and torch.equal(og, oa) and torch.equal(got, again)
    ok = (e_F <= tol and e_s <= tol and og.tolist() == ow.tolist() and same
          and bool(torch.isfinite(Fg).all()))
    log(f"{name}: F max_abs_err={e_F!r}, state err/max(1,|x|)={e_s!r}{note} tol={tol!r}, "
        f"origin {og.tolist()} (plain {ow.tolist()}), window {tuple(Fg.shape[1:])}, "
        f"second run bit-identical: {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version or itself")
    return e_F, e_raw, e_excess


def moving_work(F, markers, bodies, iters, itemsize):
    """(bytes, operations) of one call of kernels 19-21 with the output F
    (2, wr, cw): the 9 planes read over the support (the cells F is nonzero
    on, counted from this run's data), the 2 force planes written over the
    window, the marker offsets and the states; 20 operations per support
    cell for the moments, 120 per marker for its position and 8 Peskin
    weights, 32 for rho_j, per iteration 131 per marker (interpolation,
    f_j, spread) and 8 per support cell, 40 per body for the rigid update."""
    support = int(((F[0] != 0) | (F[1] != 0)).sum().item())
    n = F.shape[1] * F.shape[2]
    return ((9 * support + 2 * n + 2 * markers + 20 * bodies) * itemsize,
            20 * support + 152 * markers + iters * (131 * markers + 8 * support) + 40 * bodies)


def d3q19_hold(dev):
    """Phase 4 of kernels 25 and 26: 10 steps from noisy states
    (``hold_d3q19``) in the four wall sets at the timing grid 32x256x1024
    float32, an odd 5x37x41 and the cavity3d gate's 8x64x128 in float64 and
    8x64x128 in float32; then at each shape, type and wall set that phase 5
    runs: poiseuille_3d's 24x8x8 and 12x4x6 channels in float64,
    taylor_green_3d's periodic N = 32 and 12 in float64, N = 256 and the
    CLI's 64 in float32, and the cavities 4x16x20 and 3x16x20 (x periodic)
    in float64.  Returns the max errors of kernel 25 and of kernel 26, by
    dtype."""
    import torch

    f32, f64 = torch.float32, torch.float64
    every = tuple(D3Q19_WALLS)
    err25, err26 = {}, {}
    for dtype, shape, wall_sets in (
            (f32, D3Q19_BIG, every), (f64, (5, 37, 41), every), (f64, (8, 64, 128), every),
            (f32, (8, 64, 128), every), (f64, (24, 8, 8), ("channel",)),
            (f64, (12, 4, 6), ("channel",)), (f64, (32, 32, 32), ("periodic",)),
            (f64, (12, 12, 12), ("periodic",)), (f32, (256, 256, 256), ("periodic",)),
            (f32, (64, 64, 64), ("periodic",)), (f64, (4, 16, 20), ("cavity",)),
            (f64, (3, 16, 20), ("cavity_no_x",))):
        for walls in wall_sets:
            e25, e26 = hold_d3q19(*shape, dtype, walls, dev)
            err25[dtype] = max(err25.get(dtype, 0.0), e25)
            err26[dtype] = max(err26.get(dtype, 0.0), e26)
        torch.cuda.empty_cache()
    return err25, err26


def cavity3d_gates(u) -> dict:
    """validate_tpu.py cavity3d's checks (:579-597) on the (3, X, Y, Z)
    velocity of the cavity3d run, as check_gates takes them."""
    import numpy as np

    u = u.cpu().numpy()
    uz_mid = u[2, 4]  # the mid-depth (Y, Z) slice
    return {"finite": (float(np.isfinite(u).all()), 1.0, 1.0),
            "lid drag": (float(uz_mid[-2].mean()), 0.01, 0.05),
            "return flow": (float(uz_mid[16].mean()), -0.05, -1e-3),
            "max|u|": (float(np.abs(u).max()), 0.0, 0.06),
            "x mirror dev": (float(np.abs(u[2] - u[2, ::-1]).max()), 0.0, 1e-3)}


def d3q19_path(dev, counted) -> dict:
    """Phase 5 of the D3Q19 slice: the 3-D scenes' gates through kernel 25
    (one launch per step), the cavity in the lanes layout through kernel
    26, the scenes on the card against the CPU, a checkpointed run resumed
    on the card and the CLIs.  Every launch count starts at 0 here and is
    read at the end.  Returns the host wall time of each run, by label."""
    import numpy as np
    import torch

    from lbm_tpu_torch.kernels import d3q19 as kd
    from lbm_tpu_torch.ops import d3q19
    from lbm_tpu_torch.scenes import three_d as t3

    f32, f64 = torch.float32, torch.float64
    for k in counted.values():
        k.launches = 0
    d3_wall = {}

    def d3_run(label, fn, **kw):
        """One 3-D scene run on the card, timed, with one kernel-25 launch per
        step."""
        before = kd.D3Q19.launches
        t0 = time.perf_counter()
        res = fn(device=dev, **kw)
        torch.cuda.synchronize()
        d3_wall[label] = time.perf_counter() - t0
        if kd.D3Q19.launches - before != kw["T"]:
            raise AssertionError(f"{label}: {kd.D3Q19.launches - before} launches for "
                                 f"{kw['T']} steps")
        return res

    # validate_tpu.py cavity3d (:579-597): 8x64x128 float32, T 20000,
    # substeps 2, with its five checks
    res = d3_run("cavity3d", t3.lid_cavity_3d, T=20000, dtype=f32, **CAVITY3D)
    check_gates(f"[5] validate_tpu.py cavity3d: lid_cavity_3d 8x64x128 float32 20000 steps "
                f"substeps 2 (host wall time {d3_wall['cavity3d']!r} s = "
                f"{d3_wall['cavity3d'] / 20000 * 1e6!r} us/step)", cavity3d_gates(res.u))
    # the same cavity in lbm_tpu's lanes layout through kernel 26
    # (make_d3q19_lanes_step), 2000 steps from rest, against the scene's
    # kernel-25 run: bit for bit
    X3, Y3, Z3 = CAVITY3D["X"], CAVITY3D["Y"], CAVITY3D["Z"]
    nu3 = 0.05 * Z3 / 100.0  # lid_cavity_3d's viscosity, rounded as there
    lanes_step = kd.make_d3q19_lanes_step(X3, Y3, Z3, omega=1.0 / (3.0 * nu3 + 0.5),
                                          x_walls=True, y_walls=True, z_walls=True,
                                          lid_u=0.05, substeps=2, dtype=f32)
    S = kd.pack_lanes(d3q19.equilibrium(torch.zeros((3, X3, Y3, Z3), dtype=f32, device=dev),
                                        torch.ones((X3, Y3, Z3), dtype=f32, device=dev)))
    before = kd.D3Q19_LANES.launches
    for _ in range(1000):
        S = lanes_step(S)
    res = d3_run("cavity3d 2000", t3.lid_cavity_3d, T=2000, dtype=f32, **CAVITY3D)
    same = bool(torch.equal(kd.unpack_lanes(S, X3, Y3, Z3), res.f))
    log(f"[5] lid cavity 8x64x128 float32 2000 steps in the lanes layout: "
        f"{kd.D3Q19_LANES.launches - before} kernel-26 launches, equal to the scene's "
        f"kernel-25 run bit for bit: {same}")
    if not (same and kd.D3Q19_LANES.launches - before == 2000):
        raise AssertionError("the lanes layout's run differs from the planes layout's")
    # poiseuille_3d's gate (tests/test_d3q19.py:56-60): 24x8x8 float64,
    # 20000 steps, L2 <= 1e-10 at the magic tau
    res = d3_run("poiseuille_3d", t3.poiseuille_3d, X=24, Y=8, Z=8, T=20000, dtype=f64)
    check_gates(f"[5] poiseuille_3d 24x8x8 float64 20000 steps (host wall time "
                f"{d3_wall['poiseuille_3d']!r} s)", {"L2": (res.l2, 0.0, 1e-10)})
    # taylor_green_3d's gates (:63-82) at N = 32 in float64, then the
    # full-size run, N = 256 in float32 (16.8M cells, 1.27 GB a buffer),
    # 1000 steps: the amplitude within 2.5% of u0 exp(-2 nu k^2 T), the field
    # within 1e-2 of the analytic one
    for N, T, dtype in ((32, 400, f64), (256, 1000, f32)):
        label = f"taylor_green_3d N={N}"
        res = d3_run(label, t3.taylor_green_3d, N=N, T=T, dtype=dtype)
        nu, k = (0.8 - 0.5) / 3.0, 2.0 * np.pi / N
        expected = 0.02 * np.exp(-2.0 * nu * k * k * T)
        amp = res.u[0].abs().max().item()
        gates = {"amplitude rel err": (abs(amp - expected) / expected, 0.0, 0.025),
                 "l2": (res.l2, 0.0, 1e-2)}
        if dtype == f64:
            gates["max|u_z|"] = (res.u[2].abs().max().item(), 0.0, 1e-12)
        check_gates(f"[5] {label} {dtype} {T} steps (host wall time {d3_wall[label]!r} s, "
                    f"amplitude {amp!r} against {expected!r})", gates)
    del res, S
    torch.cuda.empty_cache()
    # the CLIs, in one process beside the CPU references: the three scenes,
    # then a checkpointed cavity and its resumed continuation
    ckdir = tempfile.mkdtemp(prefix="lbm_tpu_torch_ck_")
    cli_ck = ("--checkpoint-dir", ckdir, "--checkpoint-every", "500")
    cli_run = start_clis([("poiseuille_3d", "--x64", "--device", "cuda"),
                          ("taylor_green_3d", "--device", "cuda", "--set", "N=64"),
                          ("lid_cavity_3d", "--device", "cuda", "--set", "T=2000",
                           "--set", "substeps=2"),
                          ("lid_cavity_3d", "--device", "cuda", "--set", "T=1200", *cli_ck),
                          ("lid_cavity_3d", "--device", "cuda", "--set", "T=2000", *cli_ck,
                           "--resume")])
    # each scene at a small size in float64 on the card against the CPU
    for label, fn, kw in (
            ("poiseuille_3d 12x4x6", t3.poiseuille_3d, dict(X=12, Y=4, Z=6, T=200, force=1e-5)),
            ("taylor_green_3d N=12", t3.taylor_green_3d, dict(N=12, T=200, substeps=4)),
            ("lid_cavity_3d 4x16x20", t3.lid_cavity_3d, dict(X=4, Y=16, Z=20, T=200)),
            ("lid_cavity_3d 3x16x20 x-periodic", t3.lid_cavity_3d,
             dict(X=3, Y=16, Z=20, T=200, x_walls=False, substeps=2))):
        got = d3_run(f"{label} f64", fn, dtype=f64, **kw)
        want = fn(device="cpu", dtype=f64, **kw)
        gates = {f"max|{name}_card - {name}_cpu|": (
            (getattr(got, name).cpu() - getattr(want, name)).abs().max().item(), 0.0, 1e-12)
            for name in ("f", "rho", "u")}
        if want.l2 is not None:
            gates["|l2_card - l2_cpu|"] = (abs(got.l2 - want.l2), 0.0, 1e-12)
        check_gates(f"[5] {label} float64 {kw['T']} steps on the card vs the CPU (card host "
                    f"wall time {d3_wall[f'{label} f64']!r} s)", gates)
    del got, want
    # checkpoint/resume on the card: the cavity3d cavity interrupted at step
    # 600 (checkpoints every 250 steps) and resumed to 1000 from its newest
    # checkpoint, against the uninterrupted run: bit for bit
    with tempfile.TemporaryDirectory(prefix="lbm_tpu_torch_ck_") as d:
        before = kd.D3Q19.launches
        ref = t3.lid_cavity_3d(T=1000, device=dev, dtype=f32, **CAVITY3D)
        t3.lid_cavity_3d(T=600, checkpoint_dir=d, checkpoint_every=250, device=dev,
                         dtype=f32, **CAVITY3D)
        files = sorted(p.name for p in Path(d).iterdir())
        res = t3.lid_cavity_3d(T=1000, checkpoint_dir=d, checkpoint_every=250, device=dev,
                               dtype=f32, **CAVITY3D)
        torch.cuda.synchronize()
        n_launch = kd.D3Q19.launches - before
        same = bool(torch.equal(res.f, ref.f))
    log(f"[5] lid_cavity_3d 8x64x128 float32 on the card: checkpoints {files} after 600 "
        f"steps; resumed to 1000: bit-identical to the uninterrupted run: {same}; "
        f"kernel-25 launches {n_launch} (1000 + 600 + 500)")
    if not (same and files == ["ckpt-250.npz", "ckpt-500.npz"] and n_launch == 2100):
        raise AssertionError("the resumed cavity differs from the uninterrupted one")
    del ref, res
    err = finish_clis(cli_run)
    shutil.rmtree(ckdir)
    if "resumed from" not in err:
        raise AssertionError("the --resume CLI run did not resume from its checkpoint")
    slice_launches = {name: counted[name].launches for name in ("d3q19", "d3q19_lanes")}
    log(f"[5] kernel 25-26 path launches: {slice_launches}")
    if not all(slice_launches.values()):
        raise AssertionError("a kernel of the D3Q19 path never launched")
    return d3_wall


def d3q19_times(dev, card: str, d3_wall: dict) -> dict:
    """Phase 6 of kernels 25 and 26 at 32x256x1024 (8,388,608 cells) in
    float32 and float64, in the periodic and the cavity wall sets, in turns
    with the plain version and a device-to-device copy of the state (median
    of 3): MLUPS, the fraction of copy at 152 B/cell (304 in float64), and
    the bound from this run's inputs (the bytes over HBM3's rate against the
    plain version's operations per cell, counted on the CPU at 4x8x16); then
    the cavity3d gate's step under a CUDA graph against the host time per
    step of its phase-5 run (``d3_wall``).  Returns the times, fractions,
    bounds and operations, by (kernel, wall set, dtype)."""
    import torch

    from lbm_tpu_torch.kernels import d3q19 as kd

    f32, f64 = torch.float32, torch.float64
    nu3 = 0.05 * CAVITY3D["Z"] / 100.0  # lid_cavity_3d's viscosity, rounded as there
    X3, Y3, Z3 = D3Q19_BIG
    cells3 = X3 * Y3 * Z3
    cpu = torch.device("cpu")
    ops3 = {walls: ops_per_cell(
        lambda S, kw=D3Q19_WALLS[walls]: kd.plain_d3q19_lanes_step(
            S, 4, 8, 16, omega=D3Q19_OMEGA, **kw),
        kd.pack_lanes(d3q19_state(4, 8, 16, f32, cpu, seed=3))) for walls in ("periodic", "cavity")}
    d3_ms, d3_bound, d3_frac = {}, {}, {}
    for dtype in (f32, f64):
        f3 = d3q19_state(X3, Y3, Z3, dtype, dev, seed=625)
        S3, dst3 = kd.pack_lanes(f3), torch.empty_like(f3)
        calls = {}
        for walls in ("periodic", "cavity"):
            kw = dict(omega=D3Q19_OMEGA, **D3Q19_WALLS[walls])
            k25 = kd.make_d3q19_fused_step(X3, Y3, Z3, dtype=dtype, **kw)
            k26 = kd.make_d3q19_lanes_step(X3, Y3, Z3, dtype=dtype, **kw)
            calls["d3q19", walls] = (lambda k=k25: k(f3), 30)
            calls["d3q19_lanes", walls] = (lambda k=k26: k(S3), 30)
            calls["plain", walls] = (lambda kw=kw: kd.plain_d3q19_step(f3, **kw), 3)
        calls["copy", None] = (lambda: dst3.copy_(f3), 30)
        runs = {c: [] for c in calls}
        for order in (list(calls), list(calls)[::-1], list(calls)):
            for c in order:
                fn, n = calls[c]
                runs[c].append(cuda_ms(fn, n))
        med = {c: sorted(v)[1] for c, v in runs.items()}
        b = 2 * 19 * f3.element_size()
        copy_rate = 2 * f3.numel() * f3.element_size() / (med["copy", None] * 1e-3)
        log(f"[6] {card}; copy of the {X3}x{Y3}x{Z3} {dtype} D3Q19 state "
            f"({f3.numel() * f3.element_size() / 1e6:.1f} MB): {med['copy', None]!r} ms = "
            f"{copy_rate / 1e9!r} GB/s (read + write)")
        for (name, walls), t in med.items():
            if name == "copy":
                continue
            d3_ms[name, walls, dtype] = t
            rate = b * cells3 / (t * 1e-3)
            d3_frac[name, walls, dtype] = rate / copy_rate
            d3_bound[walls, dtype] = bound(b, ops3[walls], cells3,
                                           str(dtype).removeprefix("torch."))
            log(f"[6] {name} {walls} {X3}x{Y3}x{Z3} {dtype}: {t!r} ms/step (runs "
                f"{runs[name, walls]}) = {cells3 / (t * 1e-3) / 1e6!r} MLUPS, "
                f"{rate / 1e9!r} GB/s at {b} B/cell = {rate / copy_rate!r} of copy; bound "
                f"{d3_bound[walls, dtype][0]!r} ms by {d3_bound[walls, dtype][1]} "
                f"({ops3[walls]!r} flops/cell)")
        del f3, S3, dst3, calls, runs
        torch.cuda.empty_cache()
    # the cavity3d gate's step (substeps 2) under a CUDA graph of 100 calls,
    # against the host time per step of the phase-5 run
    gate_step = kd.make_d3q19_fused_step(
        CAVITY3D["X"], CAVITY3D["Y"], CAVITY3D["Z"], omega=1.0 / (3.0 * nu3 + 0.5),
        x_walls=True, y_walls=True, z_walls=True, lid_u=0.05, substeps=2, dtype=f32)
    t = graph_ms(gate_step, d3q19_state(8, 64, 128, f32, dev, seed=4)) / 2
    d3_graph = (t, d3_wall["cavity3d"] / 20000 * 1e3)
    log(f"[6] cavity3d gate step 8x64x128 float32 (CUDA graph of 100 calls of 2 steps): "
        f"{t!r} device ms/step; host {d3_graph[1]!r} ms/step over the phase-5 run "
        f"({d3_wall['cavity3d']!r} s): device busy {t / d3_graph[1]!r}")

    return {"ms": d3_ms, "bound": d3_bound, "frac": d3_frac, "ops": ops3, "graph": d3_graph}


def d3q19_entries(launches: dict, err25: dict, err26: dict, tm: dict) -> list:
    """The kernels line's entries of kernels 25 and 26."""
    import torch

    f32, f64 = torch.float32, torch.float64
    d3_ms, d3_bound, d3_frac = tm["ms"], tm["bound"], tm["frac"]
    entries = []
    for name, replaces, errs in (("d3q19", "d3q19_pallas.py:101", err25),
                                 ("d3q19_lanes", "d3q19_lanes_pallas.py:153", err26)):
        entries.append({
            "name": name, "route": "cuda", "source": "lbm_tpu_torch/csrc/d3q19.cu",
            "replaces": f"lbm_tpu/kernels/{replaces}", "launches": launches[name],
            "max_abs_err": errs[f32], "max_abs_err_f64": errs[f64],
            "ms": d3_ms[name, "periodic", f32], "plain_ms": d3_ms["plain", "periodic", f32],
            "bound_ms": d3_bound["periodic", f32][0], "bound_by": d3_bound["periodic", f32][1],
            "library_ms": None, "ms_f64": d3_ms[name, "periodic", f64],
            "plain_ms_f64": d3_ms["plain", "periodic", f64],
            "bound_ms_f64": d3_bound["periodic", f64][0],
            "fraction_of_copy": d3_frac[name, "periodic", f32],
            "fraction_of_copy_f64": d3_frac[name, "periodic", f64],
            "ms_cavity": d3_ms[name, "cavity", f32], "ms_cavity_f64": d3_ms[name, "cavity", f64],
            "plain_ms_cavity": d3_ms["plain", "cavity", f32],
            "bound_ms_cavity": d3_bound["cavity", f32][0],
            "shape": "32x256x1024", "flops_per_cell": tm["ops"]["periodic"],
            **({"gate_graph_ms": tm["graph"][0], "gate_host_ms_per_step": tm["graph"][1]}
               if name == "d3q19" else {})})
    return entries


# the sharded slices (kernels 27-34): kernel 27's and 34's collisions, each a
# (collide function, single-device step) maker by dtype, the families'
# geometry, and the tables of the holds, the runs and the times
def k27_collisions():
    """name -> (collide_fn(dtype), single-device step(R, C, dtype, s), state
    maker(R, C, dtype, device, seed)): kernel 27's five collisions, the power
    law in its three branches (phase 3's), from noisy states."""
    from lbm_tpu_torch.kernels import bgk, collide_stream, les, power_law, trt
    from lbm_tpu_torch.models.trt import omega_minus_from_magic

    trt_minus = omega_minus_from_magic(TRT_OMEGA)
    plaw = {"power_law n=0.5": dict(PLAW), "power_law n=1.5": dict(cons_K=0.01, n=1.5),
            "power_law newton": dict(cons_K=0.01, n=0.8, sigma_y=5e-4)}
    noisy = lambda R, C, dt, dev, seed: seeded_state(R, C, dt, dev, seed, noisy=True)  # noqa: E731
    out = {
        "bgk": (lambda dt: bgk.bgk_collide_fn(OMEGA, dt),
                lambda R, C, dt, s: bgk.make_fused_step(R, C, OMEGA, dt, substeps=s), noisy),
        "kbc": (lambda dt: collide_stream.kbc_collide_fn(OMEGA),
                lambda R, C, dt, s: collide_stream.make_kbc_fused_step(R, C, OMEGA, dt,
                                                                        substeps=s), noisy),
        "les": (lambda dt: les.les_collide_fn(dtype=dt, **LES),
                lambda R, C, dt, s: les.make_les_fused_step(R, C, dtype=dt, substeps=s, **LES),
                noisy),
        "trt": (lambda dt: trt.trt_collide_fn(TRT_OMEGA, trt_minus, dt),
                lambda R, C, dt, s: trt.make_trt_fused_step(
                    R, C, omega_plus=TRT_OMEGA, omega_minus=trt_minus, dtype=dt, substeps=s),
                noisy)}
    for name, kw in plaw.items():
        out[name] = (
            lambda dt, kw=kw: power_law.power_law_collide_fn(tau_min=0.52, tau_max=50.0,
                                                             iters=8, dtype=dt, **kw),
            lambda R, C, dt, s, kw=kw: power_law.make_power_law_fused_step(
                R, C, dtype=dt, substeps=s, **kw),
            lambda R, C, dt, dev, seed: shear_state(R, C, dt, dev, noisy_seed=seed))
    return out


K34_KINDS = ("bgk", "kbc", "les", "trt", "power_law n=0.5")


def shard_geometry(family):
    """(planes, halo rows a sweep consumes, bands clipped to the grid's
    walls) of a row-sharded family; the rows from kernels/sharded.py
    ROWS_PER_SWEEP."""
    from lbm_tpu_torch.kernels import sharded as ksh

    if family.startswith("d3q19 "):
        return None, ksh.ROWS_PER_SWEEP["d3q19"], "y_walls" in D3Q19_WALLS[family[6:]]
    if family.startswith(("k27 ", "sc ")):
        planes, walls, key = 9, False, "bgk" if family.startswith("k27 ") else "shan_chen"
    else:
        planes = {"thermal": 18, "mrtcg": 10, "csf": 12, "rk": 11, "mrtcg_full": 18,
                  "csf_full": 20}[family]
        walls, key = True, family.removesuffix("_full")
    return planes, ksh.ROWS_PER_SWEEP[key], walls


def sharded_state(family, shape, dtype, dev):
    """The state of a family's cases, as its sharded step takes it (made on
    ``dev`` from a seed of the shape): kernel 27's and 34's state of the
    collision; the thermal noisy state with a D2Q9 temperature; the MRT-CG
    scenes' initial state, reduced (29) or full (31); RK's; lbm_tpu's
    Shan-Chen test densities (32); a noisy D3Q19 state as (19 X, Y, Z) (33)."""
    seed = sum(shape)
    if family.startswith(("k27 ", "k34 ")):
        return k27_collisions()[family[4:]][2](*shape, dtype, dev, seed)
    if family == "thermal":
        return thermal_state(9, *shape, dtype, dev, seed)
    if family in ("mrtcg", "csf"):
        csf = family == "csf"
        return reduced_input(mrtcg_state(*shape, dtype, dev, csf), csf)
    if family in ("mrtcg_full", "csf_full"):
        return mrtcg_state(*shape, dtype, dev, family == "csf_full")
    if family == "rk":
        return rk_state(*shape, dtype, dev)
    if family.startswith("sc "):
        return sc_state(*shape, dtype, dev, family[3:5], seed=seed)
    X, Y, Z = shape
    return d3q19_state(X, Y, Z, dtype, dev, seed=seed).reshape(19 * X, Y, Z)


def sharded_case(family, shape, dtype, dev, n, s, devices=None):
    """(sharded step, single-device step, mesh) of one case: ``family`` is
    "k27 <collision>" (kernel 27 against the collision's kernel), "thermal"
    (28 against 23), "mrtcg" or "csf" (29 against 6), "rk" (30 against 12),
    "mrtcg_full" or "csf_full" (31 against 8), "sc <eos>/<forcing>" (32
    against 14), "d3q19 <walls>" (33 against 25, ``shape`` (X, Y, Z), Y
    sharded) or "k34 <collision>" (34 against the collision's kernel, ``n``
    an (nx, ny) mesh shape); with ``n`` an (nx, ny) mesh shape, "sc ...",
    "thermal", "rk", "mrtcg_full" and "csf_full" take the rows x cols
    kernels 35, 36, 37 and 38 (kernels/sharded2d.py); the sharded step on
    ``n`` shards of ``dev`` (or on ``devices``), ``s`` steps per call, the
    single-device step as many, on the state as sharded_state makes it."""
    from lbm_tpu_torch.kernels import d3q19 as kd
    from lbm_tpu_torch.kernels import mrtcg, rk, shan_chen
    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.kernels import sharded2d as k2d
    from lbm_tpu_torch.kernels import thermal as kth
    from lbm_tpu_torch.parallel import mesh as pm
    from lbm_tpu_torch.scenes import multiphase as mp

    two_d = isinstance(n, tuple)
    mesh = pm.make_mesh(devices if devices is not None else [dev] * (n[0] * n[1] if two_d else n),
                        n if two_d else None)
    red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
    if family.startswith("d3q19 "):
        X, Y, Z = shape
        kw = dict(omega=D3Q19_OMEGA, **D3Q19_WALLS[family[6:]])
        one = kd.make_d3q19_fused_step(X, Y, Z, substeps=s, dtype=dtype, **kw)
        return (ksh.make_sharded_d3q19_step(mesh, X, Y, Z, substeps=s, dtype=dtype, **kw),
                lambda S: one(S.reshape(19, X, Y, Z)).reshape(19 * X, Y, Z), mesh)
    R, C = shape
    if family.startswith(("k27 ", "k34 ")):
        fn, single, _ = k27_collisions()[family[4:]]
        make = k2d.make_sharded_fused_step_2d if two_d else ksh.make_sharded_fused_step
        return make(mesh, R, C, fn(dtype), dtype, substeps=s), single(R, C, dtype, s), mesh
    if family == "thermal":
        make = k2d.make_sharded2d_thermal_step if two_d else ksh.make_sharded_thermal_step
        return (make(mesh, R, C, substeps=s, dtype=dtype, **THERMAL_PHYS),
                kth.make_thermal_fused_step(R, C, substeps=s, dtype=dtype, **THERMAL_PHYS), mesh)
    if family in ("mrtcg", "csf"):
        mode = "csf" if family == "csf" else "perturbation"
        return (ksh.make_sharded_mrtcg_reduced_step(mesh, R, C, red, blue, dtype=dtype,
                                                    surface_tension=mode, substeps=s, **RT),
                mrtcg.make_mrtcg_reduced_step(R, C, red, blue, dtype=dtype,
                                              surface_tension=mode, substeps=s, **RT), mesh)
    if family == "rk":
        make = k2d.make_sharded2d_rk_step if two_d else ksh.make_sharded_rk_step
        return (make(mesh, R, C, dtype=dtype, **RK),
                rk.make_rk_fused_step(R, C, dtype=dtype, substeps=s, **RK), mesh)
    mrtcg_make = k2d.make_sharded2d_mrtcg_step if two_d else ksh.make_sharded_mrtcg_step
    if family == "csf_full":
        return (mrtcg_make(mesh, R, C, red, blue, dtype=dtype, surface_tension="csf",
                           substeps=s, **RT),
                mrtcg.make_csf_fused_step(R, C, red, blue, dtype=dtype, substeps=s, **RT), mesh)
    if family == "mrtcg_full":
        full = mrtcg.make_mrtcg_fused_step(R, C, red, blue, dtype=dtype, substeps=s, **RT)
        return (mrtcg_make(mesh, R, C, red, blue, dtype=dtype, substeps=s, **RT),
                lambda S: full(S.reshape(2, 9, R, C)).reshape(18, R, C), mesh)
    kw = sc_kwargs(*family[3:].split("/"))
    make = k2d.make_sharded2d_sc_step if two_d else ksh.make_sharded_sc_step
    return (make(mesh, R, C, substeps=s, dtype=dtype, **kw),
            shan_chen.make_sc_fused_step(R, C, substeps=s, dtype=dtype, **kw), mesh)


# the meshes of one card's shards that phase 4 holds kernels 35-38 on
K35_38_MESHES = ((1, 2), (4, 2), (2, 4))
# (family, kernel, shapes and types, shard counts or meshes, cadences) of
# phase 4's sharded holds (kernels 35-38: the body families on the meshes)
SHARDED_HOLDS = (
    ("k27 bgk", 27, (("float32", BIG), ("float64", (64, 128))), (1, 2, 8), (1, 8)),
    *((f"k27 {c}", 27, (("float32", (1024, 512)), ("float64", (64, 128))), (8,), (1, 8))
      for c in ("kbc", "les", "trt", "power_law n=0.5", "power_law n=1.5",
                "power_law newton")),
    ("thermal", 28, (("float32", BIG), ("float32", (64, 128)), ("float64", (64, 128))),
     (8,), (1, 8)),
    ("mrtcg", 29, (("float32", BIG), ("float32", (256, 128)), ("float64", (256, 128))),
     (8,), (1, 2, 5)),
    ("csf", 29, (("float32", BIG), ("float32", (256, 128)), ("float64", (256, 128))),
     (8,), (1, 2, 4)),
    ("rk", 30, (("float32", BIG), ("float32", (1024, 256)), ("float64", (1024, 256))),
     (8,), (1,)),
    ("mrtcg_full", 31, (("float32", BIG), ("float64", (256, 128))), (1, 2, 8), (1, 5)),
    ("csf_full", 31, (("float32", BIG), ("float64", (256, 128))), (1, 2, 8), (1, 4)),
    *((f"sc {e}/{fo}", 32, (("float32", BIG), ("float64", (128, 128))), (1, 2, 8), (1, 4))
      for e, fo in SC_INSTANCES),
    *((f"d3q19 {w}", 33, (("float32", D3Q19_BIG), ("float64", (8, 64, 128))), (1, 2, 8),
       (1, 8)) for w in ("periodic", "cavity")),
    *((f"k34 {c}", 34, (("float32", BIG), ("float64", (128, 256))), ((1, 1), (2, 4), (4, 2)),
       (1, 8)) for c in K34_KINDS),
    *((f"sc {e}/{fo}", 35, (("float32", BIG), ("float64", (128, 128))), K35_38_MESHES, (1, 4))
      for e, fo in SC_INSTANCES),
    ("thermal", 36, (("float32", BIG), ("float64", (64, 128))), K35_38_MESHES, (1, 8)),
    ("rk", 37, (("float32", BIG), ("float64", (256, 256))), K35_38_MESHES, (1,)),
    ("mrtcg_full", 38, (("float32", BIG), ("float64", (256, 128))), K35_38_MESHES, (1, 2)),
    ("csf_full", 38, (("float32", BIG), ("float64", (256, 128))), K35_38_MESHES, (1,)),
)


def hold_case(name, step, mesh, x, calls, want, plain, dev):
    """Run the sharded kernel step ``calls`` times from ``x``, twice: bit for
    bit ``want``, the single-device kernel's result (0.0 expected, within
    TOL required), within TOL of ``plain``, the plain sharded version's, and
    the two runs bit-identical; logs, and raises otherwise.  Returns (error
    against the plain version, against the single-device kernel, whether
    bit-identical to it)."""
    import torch

    from lbm_tpu_torch.parallel import mesh as pm

    runs = []
    for _ in range(2):
        y = pm.shard_state(mesh, x)
        for _ in range(calls):
            y = step(y)
        runs.append(y.gather(dev).reshape(x.shape))
    torch.cuda.synchronize()
    e_single = (runs[0] - want).abs().max().item()
    same = bool(torch.equal(runs[0], want))
    twice = bool(torch.equal(runs[0], runs[1]))
    log(f"{name}: vs the single-device kernel max_abs_err={e_single!r} "
        f"bit-identical={same}; two runs bit-identical={twice}")
    e_plain = compare(f"{name} vs the plain sharded version", runs[0], plain, x.dtype)
    if not (e_single <= TOL[str(x.dtype).removeprefix("torch.")] and twice):
        raise AssertionError(f"{name}: differs from the single-device kernel or from itself")
    return e_plain, e_single, same


def sharded_hold(dev):
    """Phase 4 of kernels 27-38 (``SHARDED_HOLDS``).  For each family, shape
    and type one state; for each cadence s the single-device kernel and the
    plain sharded version (8 shards; (4, 2) for kernels 34-38) run 10 steps (the
    nearest multiple of s; Shan-Chen 4, the steps of kernel 14's phase-3
    hold on the same states: the Carnahan-Starling one, 8M float32 cells of
    0.2 (rho_l - rho_v) noise, turns non-finite within 10) from it once;
    then on each shard count or mesh the kernel step runs them twice: bit
    for bit the single-device kernel (0.0 expected, within TOL required),
    within TOL of the plain version, and the two runs bit-identical.  (The
    n-shard plain versions equal each other and the single-device plain
    step bit for bit: the CPU tests hold them so.)  Returns, by kernel, the
    max error against the plain version and against the single-device
    kernel by dtype, and whether every case was bit-identical to it."""
    import torch

    from lbm_tpu_torch.parallel import mesh as pm

    errs = {k: {"plain": {}, "single": {}, "all_equal": True} for k in range(27, 39)}
    for family, kernel, shapes, ns, ss in SHARDED_HOLDS:
        for dt_name, shape in shapes:
            dtype = getattr(torch, dt_name)
            x = sharded_state(family, shape, dtype, dev)
            for s in ss:
                calls = max(1, round((4 if family.startswith("sc ") else 10) / s))
                step, single, mesh = sharded_case(family, shape, dtype, dev,
                                                  (4, 2) if kernel >= 34 else 8, s)
                want, y = x, pm.shard_state(mesh, x)
                for _ in range(calls):
                    want, y = single(want), step.plain(y)
                plain = y.gather(dev).reshape(x.shape)
                for n in ns:
                    step, _, mesh = sharded_case(family, shape, dtype, dev, n, s)
                    name = (f"[4] kernel {kernel} {family} {'x'.join(map(str, shape))} {dtype} "
                            f"n={n} s={s} ({calls * s} steps)")
                    e_plain, e_single, same = hold_case(name, step, mesh, x, calls, want, plain,
                                                        dev)
                    rec = errs[kernel]
                    rec["plain"][dtype] = max(rec["plain"].get(dtype, 0.0), e_plain)
                    rec["single"][dtype] = max(rec["single"].get(dtype, 0.0), e_single)
                    rec["all_equal"] &= same
            del x, want, plain
            torch.cuda.empty_cache()
    for k, rec in errs.items():
        log(f"[4] kernel {k}: max error vs the plain sharded version {rec['plain']}, vs the "
            f"single-device kernel {rec['single']}, every case bit-identical to it: "
            f"{rec['all_equal']}")
    return errs


def sharded_cards(dev, cards=None) -> None:
    """One shard per card of ``cards`` (default: every card, where the
    machine has several): kernels 27 and 28 in float32, 29 (CSF) and 30 in
    float64 (their tiles then take over 48 KB of shared memory, opted in on
    each card), 31 (CSF, float64), 32, 33 (the cavity) and 34 (an (n/2, 2)
    mesh where n is even), each 10 steps (the nearest multiple of s), run
    twice (``hold_case``): bit for bit its single-device kernel on ``dev``
    and each other, within TOL of the plain sharded version on the same
    cards; where n is even also kernels 35-38 on the (n/2, 2) mesh
    (Shan-Chen and thermal in float32, RK and CSF in float64); then the dry
    run on them.  On one card, with no ``cards``, it logs that it did not
    run."""
    import torch

    from lbm_tpu_torch.parallel import dryrun
    from lbm_tpu_torch.parallel import mesh as pm

    if cards is None:
        if torch.cuda.device_count() < 2:
            log("[5] one shard per card: not run; this machine has 1 CUDA device (the "
                "n-shard runs put every shard on cuda:0)")
            return
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n_cards = len(cards)
    mesh34 = (n_cards // 2, 2) if n_cards % 2 == 0 else (n_cards, 1)
    rows = (256 * n_cards, 512)
    for family, shape, n, s, dtype in (
            ("k27 bgk", rows, n_cards, 8, torch.float32),
            ("thermal", rows, n_cards, 8, torch.float32),
            ("csf", rows, n_cards, 4, torch.float64), ("rk", rows, n_cards, 1, torch.float64),
            ("csf_full", rows, n_cards, 4, torch.float64),
            ("sc sc/guo", rows, n_cards, 4, torch.float32),
            ("d3q19 cavity", (4, 32 * n_cards, 128), n_cards, 8, torch.float32),
            ("k34 bgk", (256 * mesh34[0], 256 * mesh34[1]), mesh34, 8, torch.float32),
            *((("sc sc/guo", (256 * mesh34[0], 256 * mesh34[1]), mesh34, 4, torch.float32),
               ("thermal", (256 * mesh34[0], 256 * mesh34[1]), mesh34, 8, torch.float32),
               ("rk", (256 * mesh34[0], 256 * mesh34[1]), mesh34, 1, torch.float64),
               ("csf_full", (256 * mesh34[0], 256 * mesh34[1]), mesh34, 1, torch.float64))
              if mesh34[1] == 2 else ())):
        x = sharded_state(family, shape, dtype, dev)
        step, single, mesh = sharded_case(family, shape, dtype, dev, n, s, devices=cards)
        calls = max(1, round(10 / s))
        want, y = x, pm.shard_state(mesh, x)
        for _ in range(calls):
            want, y = single(want), step.plain(y)
        name = (f"[5] {family} {shape} {dtype}, one shard per card on a {mesh.shape} mesh, "
                f"{calls * s} steps")
        same = hold_case(name, step, mesh, x, calls, want, y.gather(dev).reshape(x.shape),
                         dev)[2]
        check_gates(name, {"bit-identical to the single-device kernel": (float(same), 1.0,
                                                                         1.0)})
    res = dryrun.dryrun_multichip(n_cards, devices=cards)
    log(f"[5] dryrun_multichip({n_cards}) on {[str(c) for c in cards]}: "
        f"{ {k: tuple(v.shape) for k, v in res.items()} }, finite")


def run_sharded_cases(table, dev) -> list:
    """The cases of a phase-5 table ((label, family, shape, shards or mesh,
    substeps, steps), float32 on shards of ``dev``) with their references:
    (label, shape, n, s, steps, sharded step, mesh, state, the
    single-device kernel's result, family), the sharded step built through
    the factories a user calls, "auto" included."""
    import torch

    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.kernels import sharded2d as k2d

    f32, cases = torch.float32, []
    for label, family, shape, n, s, steps in table:
        s_int = ksh.resolve_substeps(s, "bgk")  # "auto": the collide-stream families only
        step, single, mesh = sharded_case(family, shape, f32, dev, n, s_int)
        if s == "auto":
            make = k2d.make_sharded_fused_step_2d if isinstance(n, tuple) \
                else ksh.make_sharded_fused_step
            step = make(mesh, *shape, k27_collisions()[family[4:]][0](f32), f32,
                        substeps="auto")
        x = sharded_state(family, shape, f32, dev)
        want = x
        for _ in range(steps // s_int):
            want = single(want)
        cases.append((label, shape, n, s_int, steps, step, mesh, x, want, family))
    return cases


def drive_sharded(cases, wall, counted) -> None:
    """Run each case of ``run_sharded_cases`` through shard_state, its step
    and gather, timed on the host into ``wall``; each must be finite and
    bit for bit its single-device kernel's result, and kernels 27, 34, 30
    and 37 (families "k27 ...", "k34 ..." and "rk" on row shards or an (nx,
    ny) mesh) launch once a call for every MAX_SHARDS shards of the card
    (``counted``: the kernel objects by name) and make no exchange copy."""
    import torch

    from lbm_tpu_torch.parallel import halo as ph
    from lbm_tpu_torch.parallel import mesh as pm

    for label, shape, n, s_int, steps, step, mesh, x, want, family in cases:
        kernel = None
        if family.startswith(("k27 ", "k34 ")):
            kind = family[4:].split()[0]
            kernel = counted[f"halo_{kind}" if family.startswith("k27 ") else f"halo2d_{kind}"]
        elif family == "rk":
            kernel = counted["halo2d_rk" if isinstance(n, tuple) else "halo_rk"]
        if kernel is not None:
            before = kernel.launches
        copies, copy_to = [], ph.copy_to  # the exchange copies of the run
        ph.copy_to = lambda src, device: copies.append(1) or copy_to(src, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            y = pm.shard_state(mesh, x)
            for _ in range(steps // s_int):
                y = step(y)
            got = y.gather()
            torch.cuda.synchronize()
        finally:
            ph.copy_to = copy_to
        wall[label] = time.perf_counter() - t0
        gates = {"finite": (float(torch.isfinite(got).all()), 1.0, 1.0),
                 "bit-identical to the single-device kernel": (
                     float(torch.equal(got.reshape(want.shape), want)), 1.0, 1.0)}
        if kernel is not None:
            shards = n[0] * n[1] if isinstance(n, tuple) else n
            calls = steps // s_int * -(-shards // 8)
            gates["launches (one a call)"] = (float(kernel.launches - before), calls, calls)
            gates["exchange copies"] = (float(len(copies)), 0.0, 0.0)
        check_gates(f"[5] {label} {'x'.join(map(str, shape))} float32 on {n} shards of the "
                    f"card, {steps} steps, {s_int} per call (host wall time "
                    f"{wall[label]!r} s = {wall[label] / steps * 1e6!r} us/step)", gates)


# (label, family, shape, shards or mesh, substeps, steps) of phase 5's
# sharded runs, float32 on one card's shards: kernels 27-30, then 31-34
SHARDED_PATH = (
    ("periodic BGK", "k27 bgk", BIG, 8, "auto", 1000),
    *((f"periodic {c}", f"k27 {c}", (1024, 512), 8, "auto", 80)
      for c in ("kbc", "les", "trt", "power_law n=0.5", "power_law n=1.5",
                "power_law newton")),
    ("rayleigh_benard", "thermal", (64, 128), 8, 8, 2000),
    ("mrtcg_rayleigh_taylor", "mrtcg", (256, 128), 8, 5, 2000),
    ("mrt_csf_rayleigh_taylor", "csf", (256, 128), 8, 4, 1000),
    ("rk_rayleigh_taylor", "rk", (1024, 256), 8, 1, 1000),
)
K31_34_PATH = (
    ("periodic BGK, rows x cols", "k34 bgk", BIG, (4, 2), "auto", 1000),
    *((f"periodic {c}, rows x cols", f"k34 {c}", (1024, 512), (2, 4), "auto", 80)
      for c in K34_KINDS[1:]),
    ("mrtcg_rayleigh_taylor, full state", "mrtcg_full", (256, 128), 8, 5, 2000),
    ("mrt_csf_rayleigh_taylor, full state", "csf_full", (256, 128), 8, 4, 1000),
)
# kernels 35-38: the body families at full width on (4, 2), then the
# scenes' states on rows x cols meshes
K35_38_PATH = (
    ("MRT-CG full state, rows x cols", "mrtcg_full", BIG, (4, 2), 2, 20),
    ("CSF full state, rows x cols", "csf_full", BIG, (4, 2), 1, 10),
    ("RK, rows x cols", "rk", BIG, (4, 2), 1, 10),
    ("Shan-Chen sc/guo, rows x cols", "sc sc/guo", BIG, (4, 2), 4, 16),
    ("Rayleigh-Benard, rows x cols", "thermal", BIG, (4, 2), 8, 16),
    ("mrtcg_rayleigh_taylor, rows x cols", "mrtcg_full", (256, 128), (4, 2), 2, 2000),
    ("mrt_csf_rayleigh_taylor, rows x cols", "csf_full", (256, 128), (2, 4), 1, 1000),
    ("rk_rayleigh_taylor, rows x cols", "rk", (1024, 256), (4, 2), 1, 1000),
)
# the phase-5 gates that kernels 35 and 36 run on a (4, 2) mesh:
# sc_phase_separation as SC_GATE, rayleigh_benard (H, W, steps)
RB_GATE = (64, 128, 30000)
# the phase-5 gates that kernels 32 and 33 run sharded: sc_phase_separation
# (H, W, steps) and the cavity3d gate's steps
SC_GATE = (256, 256, 4000)
CAVITY3D_STEPS = 20000


def sharded_path(dev, counted) -> dict:
    """Phase 5 of kernels 27-30, through the user's entry points
    (parallel.mesh make_mesh / shard_state / gather and the factories of
    kernels/sharded.py) on 8 shards of one card (``SHARDED_PATH``): the
    periodic BGK at 4096x2048 float32 with substeps="auto" (1000 steps),
    kernel 27's other collisions at 1024x512 (80 steps), Rayleigh-Benard at
    the thermal gate's 64x128 (2000 steps, 8 per exchange), the MRT-CG
    Rayleigh-Taylor at 256x128 (2000 steps, 5 per exchange) and in CSF mode
    (1000 steps, 4 per exchange), and the RK Rayleigh-Taylor at 1024x256
    (1000 steps), each bit for bit against its single-device kernel; the
    plain sharded channel on 8 shards of the card against
    horizontal_poiseuille at 24x24 float64.  The single-device references
    (and the scene the channel is held to) run first; then every launch
    count starts at 0 and is read at the end, so the counts are the sharded
    runs' alone.  Returns the host wall time of each run, by label."""
    import torch

    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.parallel import mesh as pm
    from lbm_tpu_torch.parallel import sharded as psh
    from lbm_tpu_torch.scenes import channel as chs

    f64 = torch.float64
    mesh8 = pm.make_mesh([dev] * 8)
    cases = run_sharded_cases(SHARDED_PATH, dev)
    H = W = 24
    ref_card = chs.horizontal_poiseuille(H=H, W=W, T=300, device=dev, dtype=f64)
    ref_cpu = chs.horizontal_poiseuille(H=H, W=W, T=300, device="cpu", dtype=f64)

    for k in counted.values():
        k.launches = 0
    wall = {}
    drive_sharded(cases, wall, counted)
    del cases
    torch.cuda.empty_cache()

    # the plain sharded channel (8 shards of the card) against the scene
    # horizontal_poiseuille at 24x24 float64, 300 steps (tests/test_parallel.py:111)
    tau = chs.TAU_DEFAULT
    rho_in = chs._inlet_density(H, W, 1.030985714e-1, tau)
    f0 = chs._equilibrium_state(H, W, True, dev, f64)
    chan = psh.make_channel_bgk_step(mesh8, 1.0 / tau, rho_in, 1.0)
    y = pm.shard_state(mesh8, f0)
    for _ in range(300):
        y = chan(y)
    got = y.gather()
    check_gates("[5] sharded channel 24x24 float64 on 8 shards of the card, 300 steps, "
                "against horizontal_poiseuille", {
        "steps of the scene": (ref_card.steps, 300, 300),
        "max|f - f_scene card (kernel 2)|": ((got - ref_card.f).abs().max().item(), 0.0,
                                              1e-13),
        "max|f - f_scene cpu (plain)|": ((got.cpu() - ref_cpu.f).abs().max().item(), 0.0,
                                         1e-13)})

    names = (*(f"halo_{k}" for k in ksh.COLLIDE_KINDS), "halo_thermal",
             "halo_mrtcg_reduced", "halo_rk")
    slice_launches = {name: counted[name].launches for name in names}
    log(f"[5] kernel 27-30 path launches: {slice_launches}")
    if not all(slice_launches.values()):
        raise AssertionError("a kernel of the sharded path never launched")
    return wall


def k31_34_path(dev, counted) -> dict:
    """Phase 5 of kernels 31-34, through the user's entry points (the
    factories of kernels/sharded.py and kernels/sharded2d.py) on one card's
    shards, each run bit for bit its single-device run (``K31_34_PATH``):
    the periodic BGK at 4096x2048 on a (4, 2) mesh with substeps="auto"
    (1000 steps) and kernel 34's other collisions at 1024x512 on (2, 4) (80
    steps); mrtcg_rayleigh_taylor's 256x128 initial state in the full
    layout on 8 shards (2000 steps, 5 per exchange; CSF mode 1000, 4);
    sc_phase_separation's 256x256 initial state on 8 shards, 4 steps per
    exchange, 4000 steps, against the scene and with its gate, one kernel-32
    launch a sweep and no exchange copy; the cavity3d
    gate's cavity (8x64x128, 20000 steps, 2 per exchange) with Y over 8
    shards, against the scene and with the gate, one kernel-33 launch a
    sweep and no exchange copy (its shards share the card); the dry run on 8 shards
    (every sharded path); one shard per card where there are several
    (``sharded_cards``, kernels 27-34).  The references run first; then
    every launch count starts at 0, and is read at the end.  Returns the
    host wall time of each run, by label."""
    import numpy as np
    import torch

    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.ops import d2q9, d3q19
    from lbm_tpu_torch.parallel import dryrun
    from lbm_tpu_torch.parallel import halo as ph
    from lbm_tpu_torch.parallel import mesh as pm
    from lbm_tpu_torch.scenes import shan_chen as scs
    from lbm_tpu_torch.scenes import three_d as t3

    f32 = torch.float32
    cases = run_sharded_cases(K31_34_PATH, dev)
    H, W, T_sc = SC_GATE
    rho0 = 0.7 + 0.02 * np.random.default_rng(0).standard_normal((H, W))  # the scene's
    f_sc = d2q9.equilibrium(torch.zeros((2, H, W), dtype=f32, device=dev),
                            torch.as_tensor(rho0, dtype=f32, device=dev)).contiguous()
    ref_sc = scs.sc_phase_separation(H=H, W=W, T=T_sc, G=-5.0, substeps=4, device=dev,
                                     dtype=f32)
    X3, Y3, Z3 = CAVITY3D["X"], CAVITY3D["Y"], CAVITY3D["Z"]
    nu3 = 0.05 * Z3 / 100.0  # lid_cavity_3d's viscosity, rounded as there
    ref_3d = t3.lid_cavity_3d(T=CAVITY3D_STEPS, device=dev, dtype=f32, **CAVITY3D)
    mesh8 = pm.make_mesh([dev] * 8)
    torch.cuda.synchronize()

    for k in counted.values():
        k.launches = 0
    wall = {}
    drive_sharded(cases, wall, counted)
    del cases

    def timed(label, step, x, calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = pm.shard_state(mesh8, x)
        for _ in range(calls):
            y = step(y)
        out = y.gather()
        torch.cuda.synchronize()
        wall[label] = time.perf_counter() - t0
        return out

    # sc_phase_separation's state on 8 shards, 4 steps per exchange, against
    # the scene (kernel 14) and with the phase-5 gate
    label = "sc_phase_separation"
    step = ksh.make_sharded_sc_step(mesh8, H, W, omega=1.0, G=-5.0, substeps=4, dtype=f32)
    copies, copy_to = [], ph.copy_to  # the exchange copies the run makes: none on one card
    ph.copy_to = lambda src, device: copies.append(1) or copy_to(src, device)
    before = ksh.HALO_SHAN_CHEN.launches
    try:
        got = timed(label, step, f_sc, T_sc // 4)
    finally:
        ph.copy_to = copy_to
    rho = d2q9.calc_rho(got)
    check_gates(f"[5] {label} {H}x{W} float32 on 8 shards of the card, {T_sc} steps, 4 per "
                f"exchange (host wall time {wall[label]!r} s)", {
        "bit-identical to the scene": (float(torch.equal(got, ref_sc.f)), 1.0, 1.0),
        "rho_l / rho_v": (rho.max().item() / max(rho.min().item(), 1e-6), 4.0, 50.0),
        "exchange copies": (float(len(copies)), 0.0, 0.0),
        "kernel 32 launches a call": (
            (ksh.HALO_SHAN_CHEN.launches - before) / (T_sc // 4), 4.0, 4.0)})

    # the cavity3d gate's cavity with Y over 8 shards, 2 steps per exchange,
    # against the scene (kernel 25) and with the gate
    label = "cavity3d"
    step = ksh.make_sharded_d3q19_step(mesh8, X3, Y3, Z3, omega=1.0 / (3.0 * nu3 + 0.5),
                                       x_walls=True, y_walls=True, z_walls=True, lid_u=0.05,
                                       substeps=2, dtype=f32)
    f3 = t3._at_rest(X3, Y3, Z3, dev, f32).reshape(19 * X3, Y3, Z3)
    copies, copy_to = [], ph.copy_to  # the exchange copies the run makes: none on one card
    ph.copy_to = lambda src, device: copies.append(1) or copy_to(src, device)
    try:
        got = timed(label, step, f3, CAVITY3D_STEPS // 2).reshape(19, X3, Y3, Z3)
    finally:
        ph.copy_to = copy_to
    gates = cavity3d_gates(d3q19.calc_u(got, d3q19.calc_rho(got)))
    gates["bit-identical to the scene"] = (float(torch.equal(got, ref_3d.f)), 1.0, 1.0)
    gates["exchange copies"] = (float(len(copies)), 0.0, 0.0)
    check_gates(f"[5] validate_tpu.py cavity3d with Y over 8 shards of the card: "
                f"{X3}x{Y3}x{Z3} float32 {CAVITY3D_STEPS} steps, 2 per exchange (host wall "
                f"time {wall[label]!r} s = {wall[label] / CAVITY3D_STEPS * 1e6!r} us/step)",
                gates)
    del got, ref_3d, ref_sc

    res = dryrun.dryrun_multichip(8, devices=[dev] * 8)
    log(f"[5] dryrun_multichip(8, devices=['cuda:0'] * 8): "
        f"{ {k: tuple(v.shape) for k, v in res.items()} }, finite")
    sharded_cards(dev)
    torch.cuda.empty_cache()

    names = (*(f"halo2d_{k}" for k in ksh.COLLIDE_KINDS), "halo_mrtcg_full", "halo_shan_chen",
             "halo_d3q19")
    slice_launches = {name: counted[name].launches for name in names}
    log(f"[5] kernel 31-34 path launches: {slice_launches}")
    if not all(slice_launches.values()):
        raise AssertionError("a kernel of the kernel 31-34 path never launched")
    return wall


def k35_38_path(dev, counted) -> dict:
    """Phase 5 of kernels 35-38, through the user's entry points (the
    factories of kernels/sharded2d.py) on rows x cols meshes of one card's
    shards, each run bit for bit its single-device run (``K35_38_PATH``):
    the full MRT-CG state (2 steps per exchange), CSF, RK, Shan-Chen (4)
    and Rayleigh-Benard (8) at 4096x2048 on (4, 2); mrtcg_rayleigh_taylor's
    256x128 initial state on (4, 2) (2000 steps, 2 per exchange), CSF mode
    on (2, 4) (1000 steps) and rk_rayleigh_taylor's 1024x256 on (4, 2) (1000
    steps); sc_phase_separation's 256x256 initial state on (4, 2), 4 steps
    per exchange, 4000 steps, bit for bit the scene and within its gate,
    one kernel-35 launch a sweep and no exchange copy;
    rayleigh_benard 64x128 (Ra 1e4, amp 1e-2) on (4, 2), 8 steps per
    exchange, 30000 steps, bit for bit the scene and within the thermal
    gate's Nusselt band.  The references run first; then every launch count
    starts at 0, and is read at the end.  Returns the host wall time of each
    run, by label."""
    import numpy as np
    import torch

    from lbm_tpu_torch.kernels import sharded2d as k2d
    from lbm_tpu_torch.kernels import thermal as kth
    from lbm_tpu_torch.ops import d2q9
    from lbm_tpu_torch.parallel import halo as ph
    from lbm_tpu_torch.parallel import mesh as pm
    from lbm_tpu_torch.scenes import shan_chen as scs
    from lbm_tpu_torch.scenes import thermal as ths

    f32 = torch.float32
    cases = run_sharded_cases(K35_38_PATH, dev)
    H, W, T_sc = SC_GATE
    rho0 = 0.7 + 0.02 * np.random.default_rng(0).standard_normal((H, W))  # the scene's
    f_sc = d2q9.equilibrium(torch.zeros((2, H, W), dtype=f32, device=dev),
                            torch.as_tensor(rho0, dtype=f32, device=dev)).contiguous()
    ref_sc = scs.sc_phase_separation(H=H, W=W, T=T_sc, G=-5.0, substeps=4, device=dev,
                                     dtype=f32)
    Hr, Wr, T_rb = RB_GATE
    ref_rb = ths.rayleigh_benard(H=Hr, W=Wr, T=T_rb, Ra=1e4, Pr=0.71, amp=1e-2, substeps=8,
                                 device=dev, dtype=f32)
    # the scene's rates and initial state (scenes/thermal.py rayleigh_benard)
    kappa = ths.CS2 * (0.8 - 0.5)
    nu = 0.71 * kappa
    rb = dict(omega_f=1.0 / (nu / ths.CS2 + 0.5), omega_g=1.0 / 0.8,
              g_beta=1e4 * nu * kappa / float(Hr) ** 3)
    x = (np.arange(Hr) + 0.5) / Hr
    y = np.arange(Wr) / Wr
    theta0 = (ths.conduction_profile(Hr)[:, None]
              + 1e-2 * np.sin(np.pi * x)[:, None] * np.cos(2.0 * np.pi * y)[None, :])
    S_rb = ths._initial_state(theta0, "d2q9", dev, f32)
    mesh42 = pm.make_mesh([dev] * 8, (4, 2))
    torch.cuda.synchronize()

    for k in counted.values():
        k.launches = 0
    wall = {}
    drive_sharded(cases, wall, counted)
    del cases

    def timed(label, step, x, calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = pm.shard_state(mesh42, x)
        for _ in range(calls):
            y = step(y)
        out = y.gather()
        torch.cuda.synchronize()
        wall[label] = time.perf_counter() - t0
        return out

    label = "sc_phase_separation, rows x cols"
    step = k2d.make_sharded2d_sc_step(mesh42, H, W, omega=1.0, G=-5.0, substeps=4, dtype=f32)
    copies, copy_to = [], ph.copy_to  # the exchange copies the run makes: none on one card
    ph.copy_to = lambda src, device: copies.append(1) or copy_to(src, device)
    before = k2d.HALO2D_SHAN_CHEN.launches
    try:
        got = timed(label, step, f_sc, T_sc // 4)
    finally:
        ph.copy_to = copy_to
    rho = d2q9.calc_rho(got)
    check_gates(f"[5] {label} {H}x{W} float32 on a (4, 2) mesh of the card, {T_sc} steps, 4 "
                f"per exchange (host wall time {wall[label]!r} s)", {
        "bit-identical to the scene": (float(torch.equal(got, ref_sc.f)), 1.0, 1.0),
        "rho_l / rho_v": (rho.max().item() / max(rho.min().item(), 1e-6), 4.0, 50.0),
        "exchange copies": (float(len(copies)), 0.0, 0.0),
        "kernel 35 launches a call": (
            (k2d.HALO2D_SHAN_CHEN.launches - before) / (T_sc // 4), 4.0, 4.0)})

    label = "rayleigh_benard, rows x cols"
    step = k2d.make_sharded2d_thermal_step(mesh42, Hr, Wr, substeps=8, dtype=f32, **rb)
    got = timed(label, step, S_rb, T_rb // 8)
    _, theta, u, _ = kth.buoyant_velocity(got[:9], got[9:], rb["g_beta"])
    nusselt = float(ths.nusselt_number(u[0], theta, kappa, Hr))
    check_gates(f"[5] validate_tpu.py thermal on a (4, 2) mesh of the card: rayleigh_benard "
                f"{Hr}x{Wr} d2q9 float32 {T_rb} steps, 8 per exchange (host wall time "
                f"{wall[label]!r} s = {wall[label] / T_rb * 1e6!r} us/step)", {
        "bit-identical to the scene": (float(torch.equal(got, torch.cat([ref_rb.f, ref_rb.g]))),
                                       1.0, 1.0),
        "Nu": (nusselt, 2.60, 2.72),
        "|Nu - Nu_scene|": (abs(nusselt - ref_rb.nusselt), 0.0, 0.0)})
    del got, ref_sc, ref_rb
    torch.cuda.empty_cache()

    names = ("halo2d_shan_chen", "halo2d_thermal", "halo2d_rk", "halo2d_mrtcg_full")
    slice_launches = {name: counted[name].launches for name in names}
    log(f"[5] kernel 35-38 path launches: {slice_launches}")
    if not all(slice_launches.values()):
        raise AssertionError("a kernel of the kernel 35-38 path never launched")
    return wall


def sharded_bound(family, shape, n, s, itemsize, ops):
    """(least ms, "bytes" or "operations", bytes, design bytes) of one call
    of a sharded kernel step of kernels 27-38 (``s`` steps per exchange) at
    ``shape`` (R, C), or (X, Y, Z) for "d3q19 <walls>", on ``n`` shards
    (kernels 34-38: an (nx, ny) mesh).  The function's bytes: each shard
    reads its first sweep's input band and writes its last sweep's output
    band once (kernels/sharded.py sweep_bands, sharded2d.py sweep_bands_2d),
    and the exchange reads and writes once each halo line that the first
    band reads beyond the shard (s r rows per side, r the lines a sweep
    consumes, clipped at a wall; kernels 34-38: s r rows and s r columns),
    not the whole 8-aligned strip the step sends.  Kernels 27, 32-35 and 37
    ("k27 ...", "sc ...", "d3q19 <walls>", "k34 ...", "rk" on an (nx, ny)
    mesh) make no exchange where
    their shards share a card, as every case here does: they read the
    neighbours' lines in place (parallel/halo.py ring_rows, ring_2d), lines
    their input bands already count, so their bytes are the bands' alone.  ``ops``
    operations per cell and step over the type's peak (``itemsize`` 8:
    float64).  The design bytes count what the port's launches move: every
    sweep's bands where it launches a sweep at a time (lbm_tpu's kernels run
    a call's s steps on the chip, sharded_pallas.py make_local_halo_step, so
    the bound counts one pass); for kernels 27 and 34, which run a call's s
    steps in one pass too, the tile engine's boxes read and its tiles
    written once (``block_design``)."""
    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.kernels import sharded2d as k2d

    # the tile engine's box of the long collisions in float32 (design bytes)
    tall = itemsize == 4 and family[4:].startswith(("kbc", "power_law"))
    if isinstance(n, tuple):
        (R, C), (nx, ny), h = shape, n, ksh.HALO
        k34 = family.startswith("k34")
        planes, r, walls = (9, 1, False) if k34 else shard_geometry(family)
        R_loc, C_loc = R // nx, C // ny
        moved = design = strips = 0
        for i in range(nx):
            bands = k2d.sweep_bands_2d(R_loc, C_loc, h, s, r, i * R_loc, R, walls)
            area = [((ri_hi - ri_lo) * (ci_hi - ci_lo), (ro_hi - ro_lo) * (co_hi - co_lo))
                    for (ri_lo, ri_hi, ro_lo, ro_hi), (ci_lo, ci_hi, co_lo, co_hi) in bands]
            moved += ny * (area[0][0] + area[-1][1])
            design += ny * (block_design(R_loc, C_loc, s, tall) if k34 else
                            sum(a_in + a_out for a_in, a_out in area))
            if not (k34 or family.startswith("sc ") or family == "rk"):
                strips += ny * (area[0][0] - R_loc * C_loc)
        nbytes = (moved + 2 * strips) * planes * itemsize
        design_bytes = (design + 2 * strips) * planes * itemsize
        n_ops = ops * R * C * s
    else:
        planes, r, walls = shard_geometry(family)
        if family.startswith("d3q19 "):
            X, R, C = shape
            planes, per_cell = 19 * X, X
        else:
            (R, C), per_cell = shape, 1
        halo = ksh.halo_for(s, r)
        R_loc = R // n
        k27 = family.startswith("k27 ")
        in_place = k27 or family.startswith(("d3q19 ", "sc "))
        rows_moved = rows_design = strip_rows = 0
        for i in range(n):
            bands = ksh.sweep_bands(R_loc, halo, i * R_loc, R, s, r, walls)
            rows_moved += (bands[0][1] - bands[0][0]) + (bands[-1][3] - bands[-1][2])
            rows_design += sum((i_hi - i_lo) + (o_hi - o_lo) for i_lo, i_hi, o_lo, o_hi in bands)
            i_lo, i_hi = bands[0][:2]
            if not in_place:
                strip_rows += max(0, halo - i_lo) + max(0, i_hi - halo - R_loc)
        nbytes = (rows_moved + 2 * strip_rows) * planes * C * itemsize
        design_bytes = (rows_design + 2 * strip_rows) * planes * C * itemsize
        if k27:
            design_bytes = n * block_design(R_loc, C, s, tall) * planes * itemsize
        n_ops = ops * R * C * per_cell * s
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = n_ops / PEAK_FLOPS["float64" if itemsize == 8 else "float32"]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes,
            design_bytes)


def block_design(R_loc, C_loc, s, tall=False) -> int:
    """The cells that kernels 27 and 34 read and write on one R_loc x C_loc
    shard in a call of s steps (csrc/collide_stream.cuh): the tile engine's
    box, (h + 2 s)(w + 2 s) cells read for each tile of h x w cells written
    (tiles of (ROWS - 2 s) x (COLS - 2 s), ``Box``'s 48 x 64, or 96 x 64
    where ``tall``: the long collisions in float32), or, at one step, the
    shard and a one-line ring read."""
    if s == 1:
        return (R_loc + 2) * (C_loc + 2) + R_loc * C_loc
    tr, tc = (96 if tall else 48) - 2 * s, 64 - 2 * s
    cells = 0
    for r0 in range(0, R_loc, tr):
        for c0 in range(0, C_loc, tc):
            h, w = min(tr, R_loc - r0), min(tc, C_loc - c0)
            cells += (h + 2 * s) * (w + 2 * s) + h * w
    return cells


def plain_ops(family) -> float:
    """Operations per cell of the family's plain single-device step
    (``ops_per_cell`` on a small CPU state, float32)."""
    import torch

    from lbm_tpu_torch.kernels import bgk, collide_stream, mrtcg, rk, shan_chen
    from lbm_tpu_torch.kernels import d3q19 as kd
    from lbm_tpu_torch.kernels import thermal as kth
    from lbm_tpu_torch.scenes import multiphase as mp

    f32, cpu, small = torch.float32, torch.device("cpu"), 64
    if family in ("k27 bgk", "k34 bgk"):
        return ops_per_cell(collide_stream.make_fused_step(
            small, small, bgk.bgk_collide_fn(OMEGA, f32), f32),
            seeded_state(small, small, f32, cpu, seed=1))
    if family == "thermal":
        return ops_per_cell(lambda S: kth.plain_rb_step(S, **THERMAL_PHYS),
                            thermal_state(9, small, small, f32, cpu, seed=2))
    if family == "rk":
        return ops_per_cell(rk.make_plain_step(**RK), rk_state(small, small, f32, cpu))
    if family.startswith("sc "):
        return ops_per_cell(shan_chen.make_plain_step(**sc_kwargs(*family[3:].split("/"))),
                            sc_state(small, small, f32, cpu, family[3:5], seed=1))
    if family.startswith("d3q19 "):
        return ops_per_cell(
            lambda S: kd.plain_d3q19_lanes_step(S, 4, 8, 16, omega=D3Q19_OMEGA,
                                                **D3Q19_WALLS[family[6:]]),
            kd.pack_lanes(d3q19_state(4, 8, 16, f32, cpu, seed=3)))
    csf, full = family.startswith("csf"), family.endswith("_full")
    S = mrtcg_state(small, small, f32, cpu, csf)
    return ops_per_cell(
        mrtcg.make_plain_step(mp.DEFAULT_RED, mp.DEFAULT_BLUE,
                              surface_tension="csf" if csf else "perturbation",
                              reduced_in=not full, reduced_out=not full, **RT),
        S if full else reduced_input(S, csf))


# (family, shape, shard counts or meshes, deepest cadence) of phase 6's
# times of the sharded kernels 27-38, float32 (35-38: the body families on
# (4, 2), keyed "<family> 2d")
SHARDED_TIMES = (
    ("k27 bgk", BIG, (1, 8), 8), ("thermal", BIG, (1, 8), 8), ("mrtcg", BIG, (1, 8), 5),
    ("csf", BIG, (1, 8), 4), ("rk", BIG, (1, 8), 1), ("mrtcg_full", BIG, (1, 8), 5),
    ("csf_full", BIG, (1, 8), 4), ("sc sc/guo", BIG, (1, 8), 4),
    ("d3q19 periodic", D3Q19_BIG, (1, 8), 8), ("k34 bgk", BIG, ((1, 1), (4, 2), (8, 1)), 8),
    ("sc sc/guo", BIG, ((4, 2),), 4), ("thermal", BIG, ((4, 2),), 8), ("rk", BIG, ((4, 2),), 1),
    ("mrtcg_full", BIG, ((4, 2),), 2), ("csf_full", BIG, ((4, 2),), 1),
)


def sharded_times(dev, card: str) -> dict:
    """Phase 6 of kernels 27-38 at 4096x2048 float32 (kernel 33 at
    32x256x1024): for each family (``SHARDED_TIMES``) the sharded step on 1
    and 8 shards of one card (kernel 34: the (1, 1), (4, 2) and (8, 1)
    meshes; 35-38: (4, 2)) at s = 1 and the family's deepest cadence, the single-device
    kernel at the same s, the exchange's copies alone (8 shards, the
    deepest cadence's strips) and a device-to-device copy of the state,
    each as device ms per step from a CUDA graph of 5 calls (CUDA events
    around its replays, median of 3 rounds in turns), so the host's launch
    time is not in them; the plain sharded version eagerly (8 shards, s =
    1); each configuration's bound (``sharded_bound``, operations counted
    on the plain single-device step).  One card measures no interconnect:
    the exchange is a copy within the card's memory."""
    import torch

    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.parallel import halo as ph
    from lbm_tpu_torch.parallel import mesh as pm

    f32 = torch.float32
    out = {"ms": {}, "single_ms": {}, "exchange_ms": {}, "plain_ms": {}, "bound": {},
           "frac": {}, "ops": {}}
    for family, shape, ns, s_max in SHARDED_TIMES:
        two_d = isinstance(ns[0], tuple)
        tag = f"{family} 2d" if two_d and not family.startswith("k34") else family
        ops = out["ops"][tag] = plain_ops(family)
        x = sharded_state(family, shape, f32, dev)
        cells = x.numel() // x.shape[0] * (shape[0] if family.startswith("d3q19") else 1)
        n8 = (4, 2) if two_d else 8
        calls = {}
        for n in ns:
            for s in sorted({1, s_max}):
                step, single, mesh = sharded_case(family, shape, f32, dev, n, s)
                calls["sharded", n, s] = (step, pm.shard_state(mesh, x), s)
                calls.setdefault(("single", 1, s), (single, x, s))
        shards8 = pm.shard_state(sharded_case(family, shape, f32, dev, n8, 1)[2], x).shards
        strip = ksh.HALO if two_d else ksh.halo_for(s_max, shard_geometry(family)[1])

        def exchange(y, two_d=two_d, strip=strip):
            if two_d:  # the (4, 2) mesh's blocks, row-major
                ph.exchange_2d([y[i * 2:(i + 1) * 2] for i in range(4)], strip)
            else:
                ph.exchange_rows(y, strip)
            return y

        dst = torch.empty_like(x)
        runs = {c: [] for c in calls}
        runs["exchange", n8, s_max] = []
        runs["copy", 0, 0] = []
        for order in (0, 1, 2):
            for key in (list(runs) if order != 1 else list(runs)[::-1]):
                if key[0] == "exchange":
                    t = graph_ms(exchange, shards8, 5) / key[2]
                elif key[0] == "copy":
                    t = cuda_ms(lambda: dst.copy_(x), 20)
                else:
                    fn, arg, s = calls[key]
                    t = graph_ms(fn, arg, 5) / s
                runs[key].append(t)
        med = {key: sorted(v)[1] for key, v in runs.items()}
        copy_rate = 2 * x.numel() * x.element_size() / (med["copy", 0, 0] * 1e-3)
        b_cell = 2 * x.numel() // cells * x.element_size()
        step8, _, mesh8 = sharded_case(family, shape, f32, dev, n8, 1)
        sx8 = pm.shard_state(mesh8, x)
        out["plain_ms"][tag] = cuda_ms(lambda: step8.plain(sx8), 3)
        out["exchange_ms"][tag] = med["exchange", n8, s_max] * s_max
        log(f"[6] {card}; {tag} {'x'.join(map(str, shape))} float32 ({x.shape[0]} planes): "
            f"copy of the state {med['copy', 0, 0]!r} ms; the exchange's copies alone, "
            f"{n8} shards, {strip}-line strips: {out['exchange_ms'][tag]!r} ms per exchange "
            f"(runs {runs['exchange', n8, s_max]}); plain sharded ({n8}, s=1) "
            f"{out['plain_ms'][tag]!r} ms/step")
        for key, t in sorted(med.items(), key=lambda kv: kv[0][0] != "single"):
            kind, n, s = key
            if kind in ("exchange", "copy"):
                continue
            if kind == "single":
                out["single_ms"][tag, s] = t
                log(f"[6] {tag} single-device kernel s={s}: {t!r} ms/step (runs "
                    f"{runs[key]})")
                continue
            out["ms"][tag, n, s] = t
            b = sharded_bound(family, shape, n, s, 4, ops)
            out["bound"][tag, n, s] = b
            rate = b_cell * cells / (t * 1e-3)
            out["frac"][tag, n, s] = rate / copy_rate
            log(f"[6] {tag} n={n} s={s}: {t!r} ms/step (runs {runs[key]}) = "
                f"{cells / (t * 1e-3) / 1e6!r} MLUPS, {rate / copy_rate!r} of copy at "
                f"{b_cell} B/cell; bound {b[0] / s!r} ms/step by {b[1]} ({b[2] / s!r} B/step, "
                f"{ops!r} flops/cell; the design moves {b[3] / s!r} B/step); over the "
                f"single-device kernel "
                f"{t / out['single_ms'].get((tag, s), float('nan')) - 1.0!r}")
        del calls, x, dst, shards8, sx8, step8
        torch.cuda.empty_cache()
    return out


def sharded_entries(launches: dict, errs: dict, tm: dict) -> list:
    """The kernels line's entries of kernels 27-38: ``ms`` and ``bound_ms`` on
    8 shards of one card ((4, 2) for kernels 34-38), s = 1, per step; the
    other configurations beside them."""
    import torch

    from lbm_tpu_torch.kernels import sharded as ksh

    f32, f64 = torch.float32, torch.float64
    rows = (
        ("halo_collide_stream", 27, "k27 bgk", "collide_stream.cuh", "sharded_pallas.py:171",
         "4096x2048 float32, 8 shards"),
        ("halo_thermal", 28, "thermal", "thermal.cu", "sharded_pallas.py:503",
         "4096x2048 float32, 8 shards"),
        ("halo_mrtcg_reduced", 29, "mrtcg", "mrtcg.cuh", "sharded_pallas.py:453",
         "4096x2048 float32, 8 shards"),
        ("halo_rk", 30, "rk", "rk_cg.cu", "sharded_pallas.py:486", "4096x2048 float32, 8 shards"),
        ("halo_mrtcg_full", 31, "mrtcg_full", "mrtcg_full.cu", "sharded_pallas.py:406",
         "4096x2048 float32, 8 shards"),
        ("halo_shan_chen", 32, "sc sc/guo", "shan_chen.cu", "shan_chen_pallas.py:138",
         "4096x2048 float32, 8 shards, sc/guo"),
        ("halo_d3q19", 33, "d3q19 periodic", "d3q19.cu", "d3q19_pallas.py:173",
         "32x256x1024 float32, Y over 8 shards, periodic"),
        ("halo2d_collide_stream", 34, "k34 bgk", "collide_stream.cuh",
         "sharded2d_pallas.py:223", "4096x2048 float32, (4, 2) mesh, BGK"),
        ("halo2d_shan_chen", 35, "sc sc/guo 2d", "shan_chen.cu", "sharded2d_pallas.py:392",
         "4096x2048 float32, (4, 2) mesh, sc/guo"),
        ("halo2d_thermal", 36, "thermal 2d", "thermal.cu", "sharded2d_pallas.py:392",
         "4096x2048 float32, (4, 2) mesh"),
        ("halo2d_rk", 37, "rk 2d", "rk_cg.cu", "sharded2d_pallas.py:392",
         "4096x2048 float32, (4, 2) mesh"),
        ("halo2d_mrtcg_full", 38, "mrtcg_full 2d", "mrtcg_full.cu", "sharded2d_pallas.py:392",
         "4096x2048 float32, (4, 2) mesh"))
    entries = []
    for name, k, fam, src, replaces, shape in rows:
        n8 = (4, 2) if k >= 34 else 8
        n_launch = sum(launches[f"{name.split('_')[0]}_{c}"] for c in ksh.COLLIDE_KINDS) \
            if k in (27, 34) else launches[name]
        b = tm["bound"][fam, n8, 1]
        e = {"name": name, "route": "cuda", "source": f"lbm_tpu_torch/csrc/{src}",
             "replaces": f"lbm_tpu/kernels/{replaces}", "launches": n_launch,
             "max_abs_err": errs[k]["plain"][f32], "max_abs_err_f64": errs[k]["plain"][f64],
             "max_abs_err_vs_single_device": errs[k]["single"][f32],
             "max_abs_err_vs_single_device_f64": errs[k]["single"][f64],
             "bit_identical_to_single_device": errs[k]["all_equal"],
             "ms": tm["ms"][fam, n8, 1], "plain_ms": tm["plain_ms"][fam], "bound_ms": b[0],
             "bound_by": b[1], "library_ms": None, "shape": shape,
             "single_device_ms": tm["single_ms"][fam, 1], "exchange_ms": tm["exchange_ms"][fam],
             "fraction_of_copy": tm["frac"][fam, n8, 1], "flops_per_cell": tm["ops"][fam]}
        csf = {29: "csf", 31: "csf_full", 38: "csf_full 2d"}.get(k)
        for fm in (fam, csf) if csf else (fam,):
            for (f_, n, s), t in tm["ms"].items():
                if f_ == fm:
                    where = f"{n[0]}x{n[1]}" if isinstance(n, tuple) else n
                    tag = f"{'csf_' if fm == csf else ''}n{where}_s{s}"
                    e[f"ms_{tag}"] = t
                    e[f"bound_ms_{tag}"] = tm["bound"][f_, n, s][0] / s
        entries.append(e)
    return entries


# kernel 39, the lane-blocked reduced MRT-CG step, on bench.py's --lane-block
# path (bench.py:103-110 mrtcg, :140-148 csf): (mode, shape, lane block,
# substeps) of phase 5's runs, float32, LANES_STEPS steps each: bench.py's
# WIDE_GRID (BIG) at lbm_tpu's wide cadences (mrtcg_pallas.py:807 _WIDE_OPT: 5,
# CSF 4, bench.py's cap) and the round-5 experiment's 1024x512
# (docs/BENCHMARKS.md:18-24)
LANES_PATH = (("perturbation", BIG, 256, 5), ("csf", BIG, 256, 4),
              ("perturbation", (1024, 512), 256, 2), ("perturbation", (1024, 512), 256, 5),
              ("csf", (1024, 512), 256, 2))
LANES_STEPS = 200
# (mode, dtype, shape, lane blocks, cadences) of phase 4's holds of kernel 39;
# (24, 256) are the shapes where lbm_tpu's lanes step fails to trace
LANES_HOLDS = (
    ("perturbation", "float32", BIG, (256, 512, 2048), (1, 2, 5)),
    ("csf", "float32", BIG, (256, 512, 2048), (1, 2, 4)),
    ("perturbation", "float32", (1024, 512), (256,), (2, 5)),
    ("csf", "float32", (1024, 512), (256,), (2,)),
    ("perturbation", "float64", (256, 512), (128, 256, 512), (1, 2, 5)),
    ("csf", "float64", (256, 512), (128, 256, 512), (1, 2, 5)),
    ("perturbation", "float64", (24, 256), (256, 128), (2,)),
    ("csf", "float64", (24, 256), (256, 128), (2,)),
)
# (mode, lane blocks, cadences) of phase 6's times at BIG float32; the plain
# version at the phase-5 configuration (LANES_PATH's first two)
LANES_TIMES = (("perturbation", (256, 512, 2048), (1, 2, 5)),
               ("csf", (256, 512, 2048), (1, 2, 4)))


def lanes_state(R, C, csf, dtype, device):
    """bench.py's reduced MRT-CG state (:89-96 mrtcg: init_rho_cosine's
    layers of sign -1; :123-129 csf: sign +1 with two zero fst planes), at
    rest, reduced (:108, :147)."""
    import torch

    from lbm_tpu_torch.models.mrt_cg import MRTCGModel
    from lbm_tpu_torch.scenes import multiphase as mp

    red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
    sign = 1.0 if csf else -1.0
    st = MRTCGModel(red=red, blue=blue, **RT).init_state(
        mp.init_rho_cosine(R, C, red.rho_0, True, sign),
        mp.init_rho_cosine(R, C, blue.rho_0, False, sign), dtype=dtype, device=device)
    planes = [st.red.f, st.blue.f]
    if csf:
        planes.append(torch.zeros((2, R, C), dtype=dtype, device=device))
    return reduced_input(torch.cat(planes).contiguous(), csf)


def lanes_steps(mode, R, C, dtype, lane_block, s):
    """(kernel 39's step, kernel 6's step of ``s`` launches, kernel 39's plain
    version) at bench.py's constants, each ``s`` steps a call."""
    from lbm_tpu_torch.kernels import mrtcg
    from lbm_tpu_torch.scenes import multiphase as mp

    red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
    kw = dict(dtype=dtype, surface_tension=mode, substeps=s, **RT)
    lanes = mrtcg.make_mrtcg_reduced_lanes_step(R, C, red, blue, lane_block=lane_block, **kw)
    k6 = mrtcg.make_mrtcg_reduced_step(R, C, red, blue, **kw)
    plain_step = mrtcg.make_plain_step(red, blue, surface_tension=mode, **RT)
    rps = mrtcg.rows_per_sweep(mode)
    return lanes, k6, lambda G: mrtcg.plain_mrtcg_reduced_lanes_step(G, plain_step, lane_block,
                                                                     s, rps)


def lanes_hold(dev) -> dict:
    """Phase 4 of kernel 39 (``LANES_HOLDS``): from bench.py's state, for each
    cadence s kernel 6 runs s steps once; then for each lane block one call
    of kernel 39 (s launches), bit for bit that result (required: the
    per-cell code is kernel 6's) and within TOL of its plain version.
    Returns the max error against the plain version and against kernel 6 by
    dtype, and whether every case was bit-identical to kernel 6."""
    import torch

    errs = {"plain": {}, "k6": {}, "all_equal": True}
    for mode, dt_name, (R, C), lbs, ss in LANES_HOLDS:
        dtype = getattr(torch, dt_name)
        G = lanes_state(R, C, mode == "csf", dtype, dev)
        for s in ss:
            want = None
            for lb in lbs:
                lanes, k6, plain = lanes_steps(mode, R, C, dtype, lb, s)
                want = k6(G) if want is None else want
                got = lanes(G)
                name = f"[4] kernel 39 {mode} {R}x{C} {dtype} lane_block={lb} s={s}"
                e_plain = compare(f"{name} vs its plain version", got, plain(G), dtype)
                e6 = (got - want).abs().max().item()
                same = bool(torch.equal(got, want))
                log(f"{name} vs kernel 6 x {s}: max_abs_err={e6!r}, bit-identical {same}")
                if not same:
                    raise AssertionError(f"{name}: kernel 39 is not kernel 6 run {s} times")
                errs["plain"][dtype] = max(errs["plain"].get(dtype, 0.0), e_plain)
                errs["k6"][dtype] = max(errs["k6"].get(dtype, 0.0), e6)
                errs["all_equal"] &= same
                del got
            del want
        del G
        torch.cuda.empty_cache()
    log(f"[4] kernel 39: max error vs its plain version {errs['plain']}, vs kernel 6 "
        f"{errs['k6']}, every case bit-identical to kernel 6: {errs['all_equal']}")
    return errs


def lanes_path(dev, counted) -> dict:
    """Phase 5 of kernel 39: bench.py's --lane-block path through
    ``make_mrtcg_reduced_lanes_step`` (``LANES_PATH``), LANES_STEPS steps from
    bench.py's state each, bit for bit the same steps through
    ``make_mrtcg_reduced_step`` (kernel 6, run first), finite, the red and
    the total mass kept within 1e-5.  Every launch count starts at 0 after
    the references and is read at the end.  Returns the host wall time of
    each run, by label."""
    import torch

    from lbm_tpu_torch.kernels import mrtcg
    from lbm_tpu_torch.scenes import multiphase as mp

    f32 = torch.float32
    runs = []
    for mode, (R, C), lb, s in LANES_PATH:
        G = lanes_state(R, C, mode == "csf", f32, dev)
        k6 = mrtcg.make_mrtcg_reduced_step(R, C, mp.DEFAULT_RED, mp.DEFAULT_BLUE, dtype=f32,
                                           surface_tension=mode, substeps=s, **RT)
        want = G
        for _ in range(LANES_STEPS // s):
            want = k6(want)
        runs.append((mode, R, C, lb, s, G, want))
    torch.cuda.synchronize()

    for k in counted.values():
        k.launches = 0
    wall = {}
    for mode, R, C, lb, s, G, want in runs:
        step = mrtcg.make_mrtcg_reduced_lanes_step(R, C, mp.DEFAULT_RED, mp.DEFAULT_BLUE,
                                                   dtype=f32, surface_tension=mode, substeps=s,
                                                   lane_block=lb, **RT)
        label = f"lanes {mode} {R}x{C} lane_block={lb} s={s}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = G
        for _ in range(LANES_STEPS // s):
            y = step(y)
        torch.cuda.synchronize()
        wall[label] = time.perf_counter() - t0
        red0, red = G[9].double().sum().item(), y[9].double().sum().item()
        tot0, tot = G[:9].double().sum().item(), y[:9].double().sum().item()
        check_gates(f"[5] bench.py --model {'csf' if mode == 'csf' else 'mrtcg'} --lane-block "
                    f"{lb} --substeps {s}: {R}x{C} float32, {LANES_STEPS} steps (host wall "
                    f"time {wall[label]!r} s = {wall[label] / LANES_STEPS * 1e6!r} us/step)", {
            "finite": (float(torch.isfinite(y).all()), 1.0, 1.0),
            "bit-identical to kernel 6": (float(torch.equal(y, want)), 1.0, 1.0),
            "red mass drift": (abs(red / red0 - 1.0), 0.0, 1e-5),
            "mass drift": (abs(tot / tot0 - 1.0), 0.0, 1e-5)})
    del runs, y
    torch.cuda.empty_cache()
    n = counted["mrtcg_reduced_lanes"].launches
    log(f"[5] kernel 39 path launches: {n} (kernel 6: {counted['mrtcg_reduced'].launches})")
    if n != sum(LANES_STEPS for _ in LANES_PATH):
        raise AssertionError("kernel 39 did not launch once per step of its path")
    return wall


def lanes_bound(R, C, lane_block, s, csf, itemsize, ops):
    """(least ms, "bytes" or "operations", bytes, design bytes) of one call
    of kernel 39's function, ``s`` steps of the reduced state: it reads the
    state once and writes it once (lbm_tpu's kernel runs a block's s steps
    on the chip and moves the state once a call, mrtcg_pallas.py:1063-1126)
    and does ``ops`` operations per cell and step over the fp32 peak.  The
    design bytes are what kernel 39 moves: each of its ``s`` sweeps reads
    its input windows and writes its output windows once, C / LB blocks of
    R rows, sweep k's LB + 2 (m - (k-1) rps) columns in and LB + 2 (m - k
    rps) out (the margins counted exactly, (LB + 2 m) / LB columns per kept
    column in the first sweep, m = s rps)."""
    rps, planes = (5, 12) if csf else (3, 10)
    lanes, m = C // lane_block, s * rps
    design = 0
    for k in range(1, s + 1):
        design += lanes * R * (2 * lane_block + 2 * (m - (k - 1) * rps) + 2 * (m - k * rps))
    nbytes, design_bytes = 2 * R * C * planes * itemsize, design * planes * itemsize
    t_bytes, t_ops = nbytes / HBM_BYTES_S, R * C * s * ops / PEAK_FLOPS["float32"]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes,
            design_bytes)


def lanes_times(dev, card: str) -> dict:
    """Phase 6 of kernel 39 at 4096x2048 float32 (``LANES_TIMES``): for each
    mode, lane block and cadence s, kernel 39 (s launches a call) and kernel
    6 run s times on the same state, each as device ms per step from a CUDA
    graph of 5 calls (CUDA events around its replays, median of 3 rounds in
    turns), so the host's launch time is not in them; the plain version
    eagerly at the phase-5 configuration (lane block 256, s = 5, CSF 4), in
    the same turns; each configuration's bound (``lanes_bound``, operations
    counted on the plain reduced step) per step, and the first window's
    cells per kept cell."""
    import torch

    from lbm_tpu_torch.kernels import mrtcg

    f32, (R, C) = torch.float32, BIG
    out = {"ms": {}, "k6_ms": {}, "plain_ms": {}, "bound": {}, "ops": {}, "overhead": {},
           "design_bytes": {}}
    for mode, lbs, ss in LANES_TIMES:
        csf = mode == "csf"
        ops = out["ops"][mode] = plain_ops("csf" if csf else "mrtcg")
        G = lanes_state(R, C, csf, f32, dev)
        calls = {}
        for s in ss:
            for lb in lbs:
                lanes, k6, plain = lanes_steps(mode, R, C, f32, lb, s)
                calls["lanes", lb, s] = lanes
                if s == max(ss) and lb == 256:
                    calls["plain", lb, s] = plain
            calls["k6", 0, s] = k6
        runs = {key: [] for key in calls}
        for order in (0, 1, 2):
            for key in (list(runs) if order != 1 else list(runs)[::-1]):
                kind, _, s = key
                if kind == "plain":
                    t = cuda_ms(lambda fn=calls[key]: fn(G), 2) / s
                else:
                    t = graph_ms(calls[key], G, 5) / s
                runs[key].append(t)
        med = {key: sorted(v)[1] for key, v in runs.items()}
        for (kind, lb, s), t in med.items():
            if kind == "k6":
                out["k6_ms"][mode, s] = t
                log(f"[6] {card}; kernel 6 {mode} {R}x{C} float32 x {s}: {t!r} ms/step (runs "
                    f"{runs[kind, lb, s]})")
            elif kind == "plain":
                out["plain_ms"][mode] = t
                log(f"[6] kernel 39 plain version {mode} lane_block={lb} s={s}: {t!r} ms/step "
                    f"(runs {runs[kind, lb, s]})")
        for (kind, lb, s), t in med.items():
            if kind != "lanes":
                continue
            b = lanes_bound(R, C, lb, s, csf, 4, ops)
            out["ms"][mode, lb, s] = t
            out["bound"][mode, lb, s] = (b[0] / s, b[1])
            out["design_bytes"][mode, lb, s] = b[3] / s
            out["overhead"][mode, lb, s] = mrtcg.lane_overhead(lb, s * mrtcg.rows_per_sweep(mode))
            log(f"[6] kernel 39 {mode} {R}x{C} float32 lane_block={lb} s={s}: {t!r} ms/step "
                f"(runs {runs[kind, lb, s]}) = {R * C / (t * 1e-3) / 1e6!r} MLUPS; over kernel 6 "
                f"x {s} {t / out['k6_ms'][mode, s] - 1.0!r}; bound {b[0] / s!r} ms/step by "
                f"{b[1]} ({b[2] / s!r} B/step, {ops!r} flops/cell); the design moves "
                f"{b[3] / s!r} B/step ({b[3] / HBM_BYTES_S * 1e3 / s!r} ms/step at the HBM "
                f"rate); first window {out['overhead'][mode, lb, s]!r} cells per kept cell")
        del calls, G
        torch.cuda.empty_cache()
    return out


def lanes_entry(launches: dict, errs: dict, tm: dict) -> dict:
    """The kernels line's entry of kernel 39: ``ms`` and ``bound_ms`` per step at
    the phase-5 configuration (4096x2048 float32, lane block 256, 5 steps a
    call), every other configuration beside them."""
    import torch

    f32, f64, key = torch.float32, torch.float64, ("perturbation", 256, 5)
    e = {"name": "mrtcg_reduced_lanes", "route": "cuda",
         "source": "lbm_tpu_torch/csrc/mrtcg_reduced.cu",
         "replaces": "lbm_tpu/kernels/mrtcg_pallas.py:1033",
         "launches": launches["mrtcg_reduced_lanes"], "max_abs_err": errs["plain"][f32],
         "max_abs_err_f64": errs["plain"][f64], "max_abs_err_vs_kernel_6": errs["k6"][f32],
         "max_abs_err_vs_kernel_6_f64": errs["k6"][f64],
         "bit_identical_to_kernel_6": errs["all_equal"], "ms": tm["ms"][key],
         "plain_ms": tm["plain_ms"]["perturbation"], "bound_ms": tm["bound"][key][0],
         "bound_by": tm["bound"][key][1], "library_ms": None,
         "shape": "4096x2048 float32, lane_block 256, 5 steps a call; per step",
         "kernel_6_ms": tm["k6_ms"]["perturbation", 5],
         "design_bytes_per_step": tm["design_bytes"][key],
         "plain_ms_csf_s4": tm["plain_ms"]["csf"],
         "flops_per_cell": tm["ops"]["perturbation"], "flops_per_cell_csf": tm["ops"]["csf"]}
    for (mode, lb, s), t in tm["ms"].items():
        tag = f"{'csf_' if mode == 'csf' else ''}lb{lb}_s{s}"
        e[f"ms_{tag}"] = t
        e[f"kernel_6_ms_{tag}"] = tm["k6_ms"][mode, s]
        e[f"bound_ms_{tag}"] = tm["bound"][mode, lb, s][0]
        e[f"design_bytes_per_step_{tag}"] = tm["design_bytes"][mode, lb, s]
        e[f"first_window_cells_per_kept_{tag}"] = tm["overhead"][mode, lb, s]
    return e


# --- the MRT-CG engines (csrc/mrtcg.cuh): the strip and the tile, by the plan ---------

ENGINE_UNITS = ("mrtcg_reduced", "mrtcg_split", "mrtcg_full")
# the library a --parent tree builds: its MRT-CG units and kernel 12's, which
# shares their header
PARENT_UNITS = (*ENGINE_UNITS, "rk_cg")
MEMORIES = ("flat", "row shard with walls", "row shard", "rows x cols shard with walls",
            "rows x cols shard", "lanes")
ENGINES = {"tile": 1, "strip": 2}


def force_engine(engine) -> None:
    """Every later MRT-CG launch on one engine ("tile", "strip"), or by its
    plan (None): csrc/mrtcg_reduced.cu lbm_mrtcg_force_engine."""
    import ctypes

    from lbm_tpu_torch.kernels import _build

    fn = _build.library().lbm_mrtcg_force_engine
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    fn(ENGINES.get(engine, 0))


def engine_instances() -> list:
    """Phase 2 of the MRT-CG engines: each instance of each unit (type, mode,
    memory) as the library reports it on this card (csrc/mrtcg.cuh
    describe_unit): for the strip and the tile kernel, registers, local bytes
    a thread, shared memory, threads and the blocks an SM holds by CUDA's
    occupancy calculator.  Rows (unit, float64, csf, memory, strip, tile)."""
    import ctypes

    from lbm_tpu_torch.kernels import _build

    rows = []
    for unit in ENGINE_UNITS:
        fn = getattr(_build.library(), f"lbm_{unit}_instances")
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
        i = 0
        while True:
            out = (ctypes.c_longlong * 13)()
            rc = fn(i, out)
            if rc == -1:
                break
            if rc != 0:
                raise RuntimeError(f"{unit} instance {i}: cudaError_t {rc}")
            strip, tile = tuple(out[0:5]), tuple(out[5:10])
            rows.append((unit, bool(out[10]), bool(out[11]), MEMORIES[out[12]], strip, tile))
            for name, (regs, local, smem, threads, blocks) in (("strip", strip), ("tile", tile)):
                log(f"[2] MRT-CG {name} engine {unit}.cu "
                    f"{'float64' if out[10] else 'float32'} "
                    f"{'CSF' if out[11] else 'perturbation'}, {MEMORIES[out[12]]}: {regs} "
                    f"registers; {local} local bytes a thread; {smem} B shared; {threads} "
                    f"threads; {blocks} resident blocks per SM")
            i += 1
    return rows


def engine_plan(width, nrows, csf, f64, rin, rout, blocks_per_sm, lanes=1, sharded=False):
    """The library's plan of one launch on this card (csrc/strip_plan.cuh):
    (W, n, groups, per, blocks, shared memory, strips)."""
    import ctypes

    import torch

    from lbm_tpu_torch.kernels import _build

    fn = _build.library().lbm_mrtcg_plan
    fn.argtypes = [ctypes.c_longlong] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = (ctypes.c_longlong * 7)()
    fn(width, nrows, blocks_per_sm * sms, sms, lanes, int(sharded), int(csf), int(f64), int(rin),
       int(rout), out)
    return tuple(out)


def build_parent(parent: Path, units=PARENT_UNITS) -> object:
    """``units`` of a parent tree's csrc/ (default its MRT-CG units) built
    into one library with this tree's flags, its namespace lbm renamed
    lbm_parent (a template's static flags, the shared-memory opt-ins, are
    unique symbols that the dynamic linker would merge with this tree's
    across the two libraries)."""
    import ctypes

    from lbm_tpu_torch.kernels import _build

    src = parent / "lbm_tpu_torch" / "csrc"
    work = Path(tempfile.mkdtemp(prefix="parent-csrc-"))
    atexit.register(shutil.rmtree, work, True)
    for f in src.iterdir():
        if f.suffix in (".cu", ".cuh"):
            text = f.read_text().replace("namespace lbm {", "namespace lbm_parent {")
            (work / f.name).write_text(text.replace("lbm::", "lbm_parent::"))
    nvcc = _build.find_nvcc()
    procs = {u: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, *_build.UNIT_FLAGS.get(u, ()), "-c",
                                  "-o", str(work / f"{u}.o"), str(work / f"{u}.cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for u in units}
    for u, proc in procs.items():
        out = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the parent's {u}.cu:\n{out}")
    lib = work / "libparent.so"
    subprocess.run([nvcc, *_build.NVCC_FLAGS[:2], "-shared", "-o", str(lib),
                    *(str(work / f"{u}.o") for u in units)], check=True, timeout=600,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


def engine_kernels() -> list:
    """The kernel objects of the MRT-CG units (6-8, 29, 31, 38, 39) and of
    kernel 12's (12, 37; kernel 30's wrapper takes a batch of shards, which
    a parent tree's lbm_halo_rk may not)."""
    from lbm_tpu_torch.kernels import mrtcg, rk
    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.kernels import sharded2d as k2d

    return [mrtcg.MRTCG_REDUCED, mrtcg.MRTCG_SPLIT, mrtcg.MRTCG_FULL,
            mrtcg.MRTCG_REDUCED_LANES, ksh.HALO_MRTCG, ksh.HALO_MRTCG_FULL,
            k2d.HALO2D_MRTCG_FULL, rk.RK_CG, k2d.HALO2D_RK]


def bind_kernels(kernels, lib) -> None:
    """Point the kernel objects at ``lib`` (None: this tree's own library,
    bound again at the next launch)."""
    import ctypes

    for k in kernels:
        if lib is None:
            k._fn = None
            continue
        fn = getattr(lib, k.symbol)
        fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
        k._fn = fn


def in_turns(fns: dict, rounds: int = 3) -> tuple[dict, dict]:
    """Each of ``fns`` (label -> a callable that returns a time) ``rounds``
    times (odd) in turns, in the orders a..z, z..a, a..z, ..., so that a
    drift of the card's clocks falls on every label alike: (the median of
    each, its runs)."""
    names = list(fns)
    runs = {k: [] for k in names}
    for r in range(rounds):
        for k in (names[::-1] if r % 2 else names):
            runs[k].append(fns[k]())
    return {k: sorted(v)[rounds // 2] for k, v in runs.items()}, runs


def strip_blocks(rows, unit, f64, csf, memory) -> int:
    """The strip kernel's resident blocks per SM of one instance
    (``engine_instances``' rows)."""
    for u, f, c, m, strip, _ in rows:
        if (u, f, c, m) == (unit, f64, csf, memory):
            return strip[4]
    raise KeyError((unit, f64, csf, memory))


def engine_times(dev, card: str, parent_lib, rows) -> dict:
    """Phase 6 of the MRT-CG engines: device ms per step of kernels 6, 7, 8
    (4096x2048), 29 and 31 (8 shards), 38 ((4, 2): the step with
    ``exchange_2d``, and its kernels alone, CUDA events around the shards'
    launches), 39 (lane block 256, s = 1) and the control, kernel 12, in
    float32 and float64 and both modes; kernel 6 at 256x128 float32 and
    128x128 float64 under CUDA graphs of 100 steps.  Each on the tile and
    on the strip engine (``force_engine``) and, with ``parent_lib``
    (``build_parent``), the parent tree's engine, in turns on the same state
    (orders a b c, c b a, a b c; the median of each three), and the engine
    that the plan (``engine_plan``) gives the cell.  ``rows``:
    ``engine_instances``'."""
    import torch

    from lbm_tpu_torch.kernels import _build, mrtcg, rk
    from lbm_tpu_torch.kernels import sharded2d as k2d
    from lbm_tpu_torch.parallel import halo as ph
    from lbm_tpu_torch.parallel import mesh as pm
    from lbm_tpu_torch.scenes import multiphase as mp

    engines = ("tile", "strip", "parent") if parent_lib is not None else ("tile", "strip")
    R, C = BIG
    out = {}

    def turns(label, fn, plan=None):
        def on(e):
            def run():
                bind_kernels(engine_kernels(), parent_lib if e == "parent" else None)
                force_engine(None if e == "parent" else e)
                return fn()
            return run
        med, runs = in_turns({e: on(e) for e in engines})
        bind_kernels(engine_kernels(), None)
        force_engine(None)
        if plan is not None:
            med["plan"] = "strip" if engine_plan(*plan)[6] else "tile"
            med["new"] = med[med["plan"]]
        rel = (f"; the plan's {med['plan']} over the parent's {med['new'] / med['parent'] - 1.0!r}"
               if "parent" in med and "plan" in med else "")
        out[label] = med
        log(f"[6] {card}; MRT-CG engines {label}: " + ", ".join(
            f"{e} {t!r}" + (" ms" if isinstance(t, float) else "") for e, t in med.items())
            + f"{rel} (runs {runs})")

    def chained(step, x, n=5):
        return lambda: graph_ms(step, x, n)

    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).removeprefix("torch.")
        f64 = dtype == torch.float64
        for csf in (False, True):
            mode = "csf" if csf else "perturbation"
            S = mrtcg_state(R, C, dtype, dev, csf)
            G = reduced_input(S, csf)
            held = {u: strip_blocks(rows, f"mrtcg_{u}", f64, csf, "flat")
                    for u in ("reduced", "split", "full")}
            turns(f"kernel 6 {mode} {dt}", chained(mrtcg_steps("reduced", R, C, dtype, csf)[0], G),
                  (C, R, csf, f64, 1, 1, held["reduced"]))
            split = mrtcg_steps("split", R, C, dtype, csf)[0]
            turns(f"kernel 7 {mode} {dt}", chained(lambda y: (split(G), y)[1], G),
                  (C, R, csf, f64, 1, 0, held["split"]))
            turns(f"kernel 8 {mode} {dt}", chained(mrtcg_steps("full", R, C, dtype, csf)[0], S),
                  (C, R, csf, f64, 0, 0, held["full"]))
            lanes = lanes_steps(mode, R, C, dtype, 256, 1)[0]
            turns(f"kernel 39 {mode} {dt} lane block 256 s=1", chained(lanes, G),
                  (256, R, csf, f64, 1, 1, strip_blocks(rows, "mrtcg_reduced", f64, csf, "lanes"),
                   C // 256))
            del S, G
            full = "csf_full" if csf else "mrtcg_full"
            for family, n in (("csf" if csf else "mrtcg", 8), (full, 8), (full, (4, 2))):
                x = sharded_state(family, BIG, dtype, dev)
                step, _, mesh = sharded_case(family, BIG, dtype, dev, n, 1)
                sx = pm.shard_state(mesh, x)
                k = 38 if n == (4, 2) else (31 if family.endswith("full") else 29)
                unit = "mrtcg_reduced" if k == 29 else "mrtcg_full"
                memory = "rows x cols shard" if k == 38 else "row shard"
                shape = (C // 2, R // 4) if k == 38 else (C, R // 8)
                plan = (*shape, csf, f64, int(k == 29), int(k == 29),
                        strip_blocks(rows, unit, f64, csf, memory), 1, True)
                turns(f"kernel {k} {mode} {dt} on {n} shards, the step", chained(step, sx), plan)
                if k == 38:
                    nx, ny = n
                    grid = [sx.shards[i * ny:(i + 1) * ny] for i in range(nx)]
                    strips = ph.exchange_2d(grid, k2d.HALO)
                    params = _build.c_doubles(mrtcg.kernel_params(
                        mp.DEFAULT_RED, mp.DEFAULT_BLUE, RT["sigma"], RT["gravity"], 0.1, True))
                    launch = k2d._body_launch(k2d.HALO2D_MRTCG_FULL, mode if csf else "mrtcg", 1,
                                              params, True, int(csf))

                    def shards(sx=sx, strips=strips, launch=launch, nx=nx, ny=ny):
                        for b, (f, st) in enumerate(zip(sx.shards, strips)):
                            i, j = divmod(b, ny)
                            launch(f, *st, off=(i * (R // nx), j * (C // ny)), shape=(R, C),
                                   edge=i in (0, nx - 1))
                    turns(f"kernel 38 {mode} {dt} on (4, 2), the shards' launches alone",
                          lambda: cuda_ms(shards, 10), plan)
                del x, sx, step
                torch.cuda.empty_cache()
        xr = rk_state(R, C, dtype, dev)
        turns(f"kernel 12 (control) {dt}",
              chained(rk.make_rk_fused_step(R, C, dtype=dtype, **RK), xr))
        del xr
        torch.cuda.empty_cache()
    for dtype, (r, c) in ((torch.float32, (256, 128)), (torch.float64, (128, 128))):
        f64 = dtype == torch.float64
        G = reduced_input(mrtcg_state(r, c, dtype, dev), False)
        turns(f"kernel 6 perturbation {str(dtype).removeprefix('torch.')} {r}x{c}, graph of 100",
              chained(mrtcg_steps("reduced", r, c, dtype, False)[0], G, 100),
              (c, r, False, f64, 1, 1, strip_blocks(rows, "mrtcg_reduced", f64, False, "flat")))
    return out


# the grids of the engine sweep (--engine-sweep): kernel 6's by (float64, CSF),
# and kernel 8's
SWEEP_K6 = {(False, False): [(256, 128), (512, 256), (512, 512), (1024, 512), (1024, 1024),
                             (512, 2048), (1024, 2048), (2048, 2048), (4096, 2048)],
            (False, True): [(256, 128), (512, 512), (1024, 1024), (512, 2048), (1024, 2048),
                            (4096, 2048)],
            (True, False): [(128, 128), (256, 256), (512, 512), (1024, 1024), (512, 2048),
                            (1024, 2048), (4096, 2048)],
            (True, True): [(128, 128), (512, 512), (1024, 1024), (512, 2048), (4096, 2048)]}
SWEEP_K8 = [(512, 512), (1024, 1024), (512, 2048), (2048, 2048), (4096, 2048)]


def engine_sweep(dev, card: str, rows) -> list:
    """Where each engine wins: kernel 6 (reduced) over the grids of SWEEP_K6
    and kernel 8 (full) over SWEEP_K8 in both types and modes, and the
    sharded kernels 29 and 31 on 2 and 8 row shards and 38 on (1, 2) and
    (4, 2) meshes of 4096x2048, each on the tile and on the strip engine in
    turns (t s s t t s, the medians), under CUDA graphs, with the strip
    plan's groups a block (``per``) and the engine the plan gives it: the
    measurements behind csrc/strip_plan.cuh min_groups."""
    import torch

    from lbm_tpu_torch.parallel import mesh as pm

    table = []

    def both(label, fn, plan):
        med, _ = in_turns({e: (lambda e=e: (force_engine(e), fn())[1]) for e in ("tile", "strip")})
        force_engine(None)
        p = engine_plan(*plan)
        table.append({"cell": label, "per": p[3], "blocks": p[4], "plan": "strip" if p[6] else
                      "tile", **med, "strip_over_tile": med["strip"] / med["tile"] - 1.0})
        log(f"[sweep] {card}; {label}: per {p[3]}, {p[4]} blocks, plan "
            f"{table[-1]['plan']}: tile {med['tile']!r} ms, strip {med['strip']!r} ms, strip "
            f"over tile {table[-1]['strip_over_tile']!r}")

    def steps(R, C):
        return 5 if R * C >= 2 ** 22 else (20 if R * C >= 2 ** 18 else 100)

    for (f64, csf), shapes in SWEEP_K6.items():
        dtype = torch.float64 if f64 else torch.float32
        blocks = strip_blocks(rows, "mrtcg_reduced", f64, csf, "flat")
        for R, C in shapes:
            G = reduced_input(mrtcg_state(R, C, dtype, dev, csf), csf)
            step = mrtcg_steps("reduced", R, C, dtype, csf)[0]
            both(f"kernel 6 {dtype} csf={csf} {R}x{C}",
                 lambda: graph_ms(step, G, steps(R, C)), (C, R, csf, f64, 1, 1, blocks))
            del G
    for f64 in (False, True):
        dtype = torch.float64 if f64 else torch.float32
        for csf in (False, True):
            blocks = strip_blocks(rows, "mrtcg_full", f64, csf, "flat")
            for R, C in SWEEP_K8:
                S = mrtcg_state(R, C, dtype, dev, csf)
                step = mrtcg_steps("full", R, C, dtype, csf)[0]
                both(f"kernel 8 {dtype} csf={csf} {R}x{C}",
                     lambda: graph_ms(step, S, steps(R, C)), (C, R, csf, f64, 0, 0, blocks))
                del S
            torch.cuda.empty_cache()
    R, C = BIG
    for f64 in (False, True):
        dtype = torch.float64 if f64 else torch.float32
        for csf in (False, True):
            full = "csf_full" if csf else "mrtcg_full"
            for family, n in (("csf" if csf else "mrtcg", 2), ("csf" if csf else "mrtcg", 8),
                              (full, 2), (full, 8), (full, (1, 2)), (full, (4, 2))):
                k = 38 if isinstance(n, tuple) else (31 if family.endswith("full") else 29)
                unit = "mrtcg_reduced" if k == 29 else "mrtcg_full"
                memory = "rows x cols shard" if k == 38 else "row shard"
                shape = (C // n[1], R // n[0]) if k == 38 else (C, R // n)
                x = sharded_state(family, BIG, dtype, dev)
                step, _, mesh = sharded_case(family, BIG, dtype, dev, n, 1)
                sx = pm.shard_state(mesh, x)
                both(f"kernel {k} {dtype} csf={csf} on {n} shards of {R}x{C}",
                     lambda: graph_ms(step, sx, 5),
                     (*shape, csf, f64, int(k == 29), int(k == 29),
                      strip_blocks(rows, unit, f64, csf, memory), 1, True))
                del x, sx, step
                torch.cuda.empty_cache()
    return table


# --- the one-block IBM forcing kernels (16, 19-21): where the time goes -----------------

# What each probe build of csrc/ibm_forcing.cu and csrc/moving_ibm.cu leaves
# out: edits of a copy of the source, (text, its replacement), every
# occurrence replaced.  A text the source no longer holds stops the run
# (``probe_source``), so that an edit of a kernel cannot quietly void a probe.
_NO_LOAD = [("lbm::load9(", "if (false) lbm::load9("),
            ("lbm::moments(f, rh, mx, my);",
             "rh = T(1) + T(1e-3) * T(rr & 7); mx = T(1e-3) * T(cc & 7); "
             "my = T(-1e-3) * T(rr & 3);")]
_NO_MARKERS_16 = [("rj = sum8(on ? taps2(w.rho, tp, wt) : T(0));", "rj = T(1);"),
                  ("const T uxj = sum8(on ? taps2(w.ux, tp, wt) : T(0));",
                   "const T uxj = T(1e-3);"),
                  ("const T uyj = sum8(on ? taps2(w.uy, tp, wt) : T(0));", "const T uyj = T(0);")]
_NO_SPREAD_16 = [("const int e1 = w.cell_ptr[s + 1];\n"
                  "      for (int e = w.cell_ptr[s]; e < e1; ++e)",
                  "for (int e = 0, e1 = 0; e < e1; ++e)")]
_NO_MARKERS_MOV = [("if (on) {\n        if (it == 0) prho = interp_row(",
                    "if (false) {\n        if (it == 0) prho = interp_row(")]
_NO_SPREAD_MOV = [("if (it == 0) {\n        for_cover(", "if (false) {\n        for_cover(")]
IBM_PROBES = {
    "ibm_forcing": {
        "full": [],
        "entries read in place (no staging)": [
            ("const int E = 16 * M;", "const int E = 0;"),
            ("for (int s = tid; s <= nS; s += nt)", "for (int s = tid; s < 0; s += nt)"),
            ("  const int sup0 =", "  w.ent_w = const_cast<T*>(entw_in);\n"
             "  w.ent_j = const_cast<int*>(entj_in);\n"
             "  w.cell_ptr = const_cast<int*>(ptr_in);\n  const int sup0 =")],
        "no macroscopic load": _NO_LOAD,
        "no spread": _NO_SPREAD_16,
        "no marker phase": _NO_MARKERS_16,
        "neither phase (the iterations' barriers)": _NO_MARKERS_16 + _NO_SPREAD_16},
    "moving_ibm": {
        "full": [],
        "stops after the markers and the loads": [
            ("  // B. the forcing iterations:",
             "  for (int l = tid; l < g.B * LANES; l += nt) st_out[l] = st_in[l];\n"
             "  return;\n  // B. the forcing iterations:")],
        "no macroscopic load": _NO_LOAD,
        "no zeros off the boxes": [("if (!boxed) {", "if (false) {")],
        "no spread": _NO_SPREAD_MOV,
        "no marker phase": _NO_MARKERS_MOV,
        "neither phase (the iterations' barriers)": _NO_MARKERS_MOV + _NO_SPREAD_MOV}}
EMPTY_CU = """#include <cuda_runtime.h>
__global__ void lbm_empty_kernel() {}
extern "C" int lbm_empty(int threads, int smem, void* stream) {
  lbm_empty_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def probe_source(unit: str, label: str) -> str:
    """csrc/<unit>.cu with the edits of its probe ``label`` (``IBM_PROBES``)."""
    text = (ROOT / "lbm_tpu_torch" / "csrc" / f"{unit}.cu").read_text()
    for old, new in IBM_PROBES[unit][label]:
        if old not in text:
            raise RuntimeError(f"probe {label!r} of csrc/{unit}.cu: the source no longer "
                               f"holds {old!r}")
        text = text.replace(old, new)
    return text


def build_probes() -> dict:
    """Each probe of ``IBM_PROBES`` built from its edited copy of the source
    into a library of its own, cylinder.cu (kernels 15 and 18) alone, and an
    empty one-block kernel: {(unit, label): CDLL, "cylinder": CDLL, "empty":
    CDLL}.  ptxas' report of each is logged."""
    import ctypes

    from lbm_tpu_torch.kernels import _build

    work = Path(tempfile.mkdtemp(prefix="probe-csrc-"))
    atexit.register(shutil.rmtree, work, True)
    (work / "empty.cu").write_text(EMPTY_CU)
    jobs = {"empty": [str(work / "empty.cu")],
            "cylinder": [*_build.UNIT_FLAGS["cylinder"], str(_build.CSRC / "cylinder.cu")]}
    for unit, probes in IBM_PROBES.items():
        for i, label in enumerate(probes):
            src = work / f"{unit}_{i}.cu"
            src.write_text(probe_source(unit, label))
            jobs[unit, label] = [*_build.UNIT_FLAGS.get(unit, ()), f"-I{_build.CSRC}", str(src)]
    nvcc = _build.find_nvcc()
    libs = {key: work / f"lib{i}.so" for i, key in enumerate(jobs)}
    procs = {key: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(libs[key]),
                                    *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True)
             for key, args in jobs.items()}
    for key, proc in procs.items():
        out = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on probe {key}:\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"[probe] {key}: {line.strip()}")
    return {key: ctypes.CDLL(str(lib)) for key, lib in libs.items()}


def ibm_breakdown(dev, card: str, parent=None) -> dict:
    """--ibm-breakdown: kernels 16 and 19-21 and cylinder.cu built alone
    (``build_probes``), held to their plain versions (``ibm_holds``), then
    where they spend their time: each built whole and with parts left out
    (``IBM_PROBES``), and with 0 forcing iterations (m_max = 1), under CUDA
    graphs of 100 launches, in turns (``in_turns``); the empty one-block
    kernel under the same graph is the card's floor for one dependent
    launch.  Kernel 16 at the Strouhal ROI (1024x256), 19-21 at their
    scenes' default windows and 21 at the dkt gate's 228-row window, in both
    types.  With ``parent`` (a tree), ``ibm_times`` against it too."""
    import ctypes

    import torch

    from lbm_tpu_torch.kernels import _build, cylinder
    from lbm_tpu_torch.kernels import ibm as kibm
    from lbm_tpu_torch.kernels import moving_ibm as kmov
    from lbm_tpu_torch.ops.ibm import IBM

    libs = build_probes()
    empty = libs.pop("empty").lbm_empty
    empty.argtypes, empty.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    bind_kernels([cylinder.CYLINDER, cylinder.BOX], libs.pop("cylinder"))
    movers = [kmov.MOVING_FORCING, kmov.MOVING_ROT, kmov.MOVING_BODIES]
    bind_kernels([kibm.IBM_FORCING], libs["ibm_forcing", "full"])
    bind_kernels(movers, libs["moving_ibm", "full"])
    ibm_holds(dev)
    out = {}
    if parent is not None:
        out["times"] = {" ".join(k): v for k, v in
                        ibm_times(dev, card, load_parent_ibm(parent)).items()}

    def turns(label, cases):
        def bound_to(lib, kernels, fn):
            return lambda: (bind_kernels(kernels, lib), fn())[1] * 1e3
        med, _ = in_turns({c: bound_to(*case) for c, case in cases.items()})
        out[label] = med
        log(f"[breakdown] {card}; {label} (us per launch, CUDA graphs of 100, median of 3): "
            + ", ".join(f"{c} {t!r}" for c, t in med.items()))

    x = torch.zeros(1, device=dev)

    def floor(threads, smem):
        def launch(y):
            err = empty(threads, smem, _build.stream_handle(y))
            if err:
                raise RuntimeError(f"lbm_empty: cudaError_t {err}")
            return y
        return lambda: graph_ms(launch, x)

    turns("empty one-block kernel", {"1024 threads": (None, [], floor(1024, 0)),
                                     "32 threads": (None, [], floor(32, 0)),
                                     "1024 threads, 40 KiB shared": (None, [],
                                                                     floor(1024, 40960))})
    whole = ("full", "no macroscopic load")  # the probes also timed at 1 and 0 iterations
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).removeprefix("torch.")
        f = seeded_state(1024, 256, dtype, dev, seed=616, noisy=True)
        cases = {}
        for m_max in (5, 2, 1):
            ib = IBM.circle(*STROUHAL_CIRCLE, m_max=m_max)
            step = kibm.make_ibm_forcing_step(1024, 256, ib, dtype)

            def forcing_only(y, step=step):
                step(y)
                return y
            for what in IBM_PROBES["ibm_forcing"]:
                if m_max < 5 and what not in whole:
                    continue
                label = what if m_max == 5 else f"{what}, {m_max - 1} iterations"
                cases[label] = (libs["ibm_forcing", what], [kibm.IBM_FORCING],
                                lambda s=forcing_only: graph_ms(s, f))
        turns(f"kernel 16 Strouhal ROI 37x37, 64 markers, {dt}", cases)
        for variant, extra in (("forcing", {}), ("rot", {}), ("bodies", {}),
                               ("bodies", {"rw": 228})):
            cases = {}
            for m_max in (5, 2, 1):
                step, fl, state = moving_case(variant, dtype, dev, m_max=m_max, **extra)
                for what in IBM_PROBES["moving_ibm"]:
                    if m_max < 5 and what not in whole:
                        continue
                    label = what if m_max == 5 else f"{what}, {m_max - 1} iterations"
                    cases[label] = (libs["moving_ibm", what], movers,
                                    lambda s=step, fl=fl, st=state: graph_ms(
                                        lambda s_: s(fl, s_)[2], st))
            turns(f"kernel {19 + ('forcing', 'rot', 'bodies').index(variant)} {variant} "
                  f"{tuple(fl.shape[1:])} window rows {extra.get('rw', 'default')}, {dt}", cases)
        del f
    return out


IBM16_HOLDS = (("Strouhal", (1024, 256), STROUHAL_CIRCLE),
               ("default", (160, 120), (60.0, 60.0, 20.0, 64)),
               ("cylinder-markers.toml", (160, 120), "cylinder-a"),
               ("edge", (40, 40), (20.0, 20.0, 15.0, 48)),
               ("past shared memory in float64", (160, 160), (80.0, 80.0, 70.0, 1200)))
MOVING_HOLDS = (
    ("forcing", "falling_cylinder 400x256, window 34x34, 76 markers", {}),
    ("forcing", "falling_cylinder, window clipped at row 0 and the last column",
     dict(edge=True)),
    ("forcing", "falling gate 96x256, r 8, window 26x26, 51 markers", dict(gate=True)),
    ("rot", "falling_ellipse 800x256, window 42x42, 78 markers", {}),
    ("rot", "falling_ellipse, window clipped at row 0 and column 0", dict(edge=True)),
    ("bodies", "falling_cylinders 800x128, window 116x128, 2x76 markers", {}),
    ("bodies", "falling_cylinders row_slack=160, window 228x128", dict(rw=228)),
    ("bodies", "falling_cylinders, window 116x128 clipped at the last row", dict(edge=True)),
    ("bodies", "falling_cylinders, centres 2 r + 1.4 apart: the supports overlap",
     dict(overlap=True)))


def ibm_holds(dev) -> tuple:
    """Phase 4 of kernels 16 and 19-21.  Kernel 16, one call at m_max 5 on
    noisy states, in both Peskin pairings (``IBM16_HOLDS``): the Strouhal
    ROI, cylinder_flow's default ROI, the markers of
    configs/cylinder-markers.toml, a ROI two cells from every edge (where
    lbm_tpu's 8x128-aligned window does not fit) and 1200 markers whose
    float64 working set takes the global scratch path.  Kernels 19-21
    (``MOVING_HOLDS``), 4 steps at the scenes' default windows and clipped
    at a grid edge, in both types (19 also at the falling gate's 26x26
    window, 21 at the dkt gate's 228 rows and at overlapping supports).
    Returns (err16 by type, err_mov: per variant and type the largest (F
    error, state error vs the plain version, f32 state excess vs the f64
    plain version))."""
    import torch

    from lbm_tpu_torch.kernels import ibm as kibm
    from lbm_tpu_torch.ops.ibm import IBM

    f32, f64 = torch.float32, torch.float64
    markers = str(ROOT / "configs" / "cylinder-markers.toml")
    err16, err_mov = {}, {}
    for ref in (False, True):
        for label, (R, C), spec in IBM16_HOLDS:
            ib = (IBM.from_toml(markers, spec, reference_transposed_weights=ref)
                  if isinstance(spec, str) else
                  IBM.circle(*spec, reference_transposed_weights=ref))
            for dtype in (f32, f64):
                f = seeded_state(R, C, dtype, dev, seed=R * C + 16, noisy=True)
                e = hold_twice(
                    f"[4] kernel 16 {label} ROI {ib.roi_shape} at ({ib.roi_rows[0]}, "
                    f"{ib.roi_cols[0]}) of {R}x{C}, {ib.row_w.shape[0]} markers, "
                    f"transposed={ref} {dtype}",
                    kibm.make_ibm_forcing_step(R, C, ib, dtype), ib.force_from_populations,
                    f, 1, dtype)
                err16[dtype] = max(err16.get(dtype, 0.0), e)
    for variant, label, case in MOVING_HOLDS:
        for dtype in (f32, f64):
            step, f, state = moving_case(variant, dtype, dev, **case)
            step64 = moving_case(variant, f64, dev, **case)[0] if dtype == f32 else None
            e = hold_forcing(f"[4] kernel {19 + ('forcing', 'rot', 'bodies').index(variant)} "
                             f"{label} {dtype}", step, f, state, 4, dtype, step64)
            old = err_mov.setdefault(variant, {}).get(dtype, (0.0, 0.0, 0.0))
            err_mov[variant][dtype] = tuple(max(a, b) for a, b in zip(old, e))
            del f
    torch.cuda.empty_cache()
    return err16, err_mov


@functools.cache
def parent_package(parent: Path) -> None:
    """The parent tree's lbm_tpu_torch package copied as lbm_tpu_torch_parent
    (the package imports itself only relatively) onto the import path, once."""
    work = Path(tempfile.mkdtemp(prefix="parent-pkg-"))
    atexit.register(shutil.rmtree, work, True)
    shutil.copytree(parent / "lbm_tpu_torch", work / "lbm_tpu_torch_parent",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    sys.path.insert(0, str(work))


def load_parent_ibm(parent: Path) -> tuple:
    """The parent tree's kernels 16 and 19-21 with its own wrappers (the copy
    of ``parent_package``), its ibm_forcing.cu and moving_ibm.cu built by
    ``build_parent`` and bound to that copy's kernel objects.  Returns the
    copy's (kernels.ibm, kernels.moving_ibm, ops.ibm.IBM)."""
    import importlib

    parent_package(parent)
    kibm = importlib.import_module("lbm_tpu_torch_parent.kernels.ibm")
    kmov = importlib.import_module("lbm_tpu_torch_parent.kernels.moving_ibm")
    ibm = importlib.import_module("lbm_tpu_torch_parent.ops.ibm")
    lib = build_parent(parent, ("ibm_forcing", "moving_ibm"))
    bind_kernels([kibm.IBM_FORCING, kmov.MOVING_FORCING, kmov.MOVING_ROT, kmov.MOVING_BODIES],
                 lib)
    return kibm, kmov, ibm.IBM


# kernel 16's timed shapes (grid, circle) and kernels 19-21's (variant, case)
IBM16_TIMES = (("Strouhal", (1024, 256), STROUHAL_CIRCLE),
               ("cylinder_flow", (160, 120), (60.0, 60.0, 20.0, 64)))
MOVING_TIMES = (("forcing", "falling gate 96x256", dict(gate=True)),
                ("forcing", "falling_cylinder 400x256", {}),
                ("rot", "falling_ellipse 800x256", {}),
                ("bodies", "dkt 800x128, 116 rows", {}),
                ("bodies", "dkt 800x128, 228 rows", dict(rw=228)))


def ibm_times(dev, card: str, parent) -> dict:
    """Kernels 16 and 19-21 on this tree's design against the parent's
    (``load_parent_ibm``), each alone and in its two-launch step (16 + 15;
    19, 20 or 21 + 18), at the scenes' shapes (``IBM16_TIMES``,
    ``MOVING_TIMES``) in float32 and float64: us per call under CUDA graphs
    of 100 calls, in turns (``in_turns``).  Kernels 19-21 must give the
    parent design's bits in F, the origin and the state at each of phase
    4's 4 steps (this tree's design keeps its terms and their order): it
    raises where they differ.  Keys (label, type, "kernel" | "step ...") ->
    {new, parent, change}."""
    import torch

    from lbm_tpu_torch.kernels import cylinder
    from lbm_tpu_torch.kernels import ibm as kibm
    from lbm_tpu_torch.ops.ibm import IBM

    kibm_p, kmov_p, IBM_p = parent
    out = {}

    def turns(label, fns):
        med, runs = in_turns({v: (lambda fn=fns[v]: fn() * 1e3) for v in ("new", "parent")})
        med["change"] = med["new"] / med["parent"] - 1.0
        out[label] = med
        log(f"[6] {card}; {' '.join(label)} (us per call, CUDA graphs of 100, median of 3 in "
            f"turns): new {med['new']!r}, parent {med['parent']!r}, change {med['change']!r} "
            f"(runs {runs})")

    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).removeprefix("torch.")
        for label, (R, C), circle in IBM16_TIMES:
            f, F, origin = cylinder_case(R, C, dtype, dev, IBM.circle(*circle), seed=616)
            grid = cylinder.make_cylinder_fused_step(R, C, 1 / 0.55, (0.05, 0.0), (3.0, 9.0),
                                                     dtype)
            force = {"new": kibm.make_ibm_forcing_step(R, C, IBM.circle(*circle), dtype),
                     "parent": kibm_p.make_ibm_forcing_step(R, C, IBM_p.circle(*circle), dtype)}

            def alone(x, fn):
                fn(x)
                return x
            turns((f"kernel 16 {label} {R}x{C}", dt, "kernel"),
                  {v: (lambda fn=fn: graph_ms(lambda x: alone(x, fn), f))
                   for v, fn in force.items()})
            turns((f"kernel 16 {label} {R}x{C}", dt, "step 16 + 15"),
                  {v: (lambda fn=fn: graph_ms(lambda x: grid(x, fn(x), origin), f))
                   for v, fn in force.items()})
            del f, F
        for variant, label, case in MOVING_TIMES:
            k = 19 + ("forcing", "rot", "bodies").index(variant)
            steps = {"new": moving_case(variant, dtype, dev, **case),
                     "parent": moving_case(variant, dtype, dev, km=kmov_p, **case)}
            f, state = steps["new"][1], steps["new"][2]
            box = cylinder.make_box_fused_step(f.shape[1], f.shape[2], 1 / 0.6, dtype=dtype)
            a = b = state
            for i in range(4):  # phase 4's steps
                got = steps["new"][0](f, a), steps["parent"][0](f, b)
                if not all(torch.equal(x, y) for x, y in zip(*got)):
                    raise AssertionError(f"kernel {k} {label} {dt}: step {i} differs from the "
                                         f"parent design's in F, the origin or the state")
                a, b = got[0][2], got[1][2]
            log(f"[6] kernel {k} {label} {dt}: F, origin and state bit for bit the parent "
                f"design's over 4 steps")

            def two(c, step):
                F2, o2, s2 = step(*c)
                return box(c[0], F2, o2), s2
            turns((f"kernel {k} {label}", dt, "kernel"),
                  {v: (lambda st=st[0]: graph_ms(lambda s_: st(f, s_)[2], state))
                   for v, st in steps.items()})
            turns((f"kernel {k} {label}", dt, f"step {k} + 18"),
                  {v: (lambda st=st[0]: graph_ms(lambda c: two(c, st), (f, state)))
                   for v, st in steps.items()})
            del f, steps
        torch.cuda.empty_cache()
    return out


# Phase 6's table of the kernels at the shapes their phase-5 launches run
# (the most launches of each; kernels 6-8, 16, 19-21, 29, 31, 38 and 39,
# redesigned earlier, and the kernels of fewer than 1,000 launches are not
# in it): (kernel, its name in main's ``counted``, label, float64, shape,
# shards or mesh (None: one device), substeps a call).  Every case runs a
# user's factory under a CUDA graph of 100 calls; a call's launches are read
# off the kernel's count.
LAUNCH_SHAPES = (
    (12, "rk_cg", "rk_rayleigh_taylor 1024x256", False, (1024, 256), None, 1),
    (12, "rk_cg", "rk_rayleigh_taylor 1024x256", True, (1024, 256), None, 1),
    (4, "channel_kbc", "ulbm_poiseuille 128x128", True, (128, 128), None, 1),
    (2, "channel_bgk", "poiseuille 128x128", False, (128, 128), None, 1),
    (9, "channel_variant", "trt_poiseuille 128x128", False, (128, 128), None, 1),
    (3, "collide_stream_kbc", "ulbm_double_shear 128x128", True, (128, 128), None, 1),
    (5, "collide_stream_les", "les_double_shear 128x128, 8 a call", False, (128, 128), None, 8),
    (14, "shan_chen", "sc_flat_interface 256x128, 4 a call", False, (256, 128), None, 4),
    (15, "cylinder", "Strouhal 1024x256", False, (1024, 256), None, 1),
    (17, "sediment", "rectangle_sedimentation 256x320", False, (256, 320), None, 1),
    (18, "box", "falling_ellipse 800x256", False, (800, 256), None, 1),
    (22, "cavity", "ring_cavity 512x512", False, (512, 512), None, 1),
    (23, "thermal_rb_q9", "rayleigh_benard 64x128 d2q9", False, (64, 128), None, 1),
    (23, "thermal_rb_q5", "rayleigh_benard 64x128 d2q5", False, (64, 128), None, 1),
    (24, "heated_cavity_q9", "heated_cavity 128x128 d2q9", False, (128, 128), None, 1),
    (24, "heated_cavity_q5", "heated_cavity 128x128 d2q5", False, (128, 128), None, 1),
    (25, "d3q19", "cavity3d 8x64x128, 2 a call", False, (8, 64, 128), None, 2),
    (26, "d3q19_lanes", "cavity3d 8x64x128 lanes, 2 a call", False, (8, 64, 128), None, 2),
    (27, "halo_bgk", "periodic BGK 4096x2048, 8 shards", False, BIG, 8, 8),
    (28, "halo_thermal", "rayleigh_benard 64x128, 8 shards", False, (64, 128), 8, 8),
    (30, "halo_rk", "rk_rayleigh_taylor 1024x256, 8 shards", False, (1024, 256), 8, 1),
    (32, "halo_shan_chen", "sc_phase_separation 256x256, 8 shards", False, (256, 256), 8, 4),
    (33, "halo_d3q19", "cavity3d 8x64x128, Y over 8 shards", False, (8, 64, 128), 8, 2),
    (34, "halo2d_bgk", "periodic BGK 4096x2048, (4, 2)", False, BIG, (4, 2), 8),
    (35, "halo2d_shan_chen", "sc_phase_separation 256x256, (4, 2)", False, (256, 256), (4, 2),
     4),
    (36, "halo2d_thermal", "rayleigh_benard 64x128, (4, 2)", False, (64, 128), (4, 2), 8),
    (37, "halo2d_rk", "rk_rayleigh_taylor 1024x256, (4, 2)", False, (1024, 256), (4, 2), 1),
)
# the sharded families of LAUNCH_SHAPES' kernels 27-37 (sharded_case)
SHARDED_FAMILY = {27: "k27 bgk", 28: "thermal", 30: "rk", 32: "sc sc/guo",
                  33: "d3q19 cavity", 34: "k34 bgk", 35: "sc sc/guo", 36: "thermal", 37: "rk"}


def launch_shape_case(entry, dev):
    """(step, x, ops per cell, bytes per cell) of one LAUNCH_SHAPES entry:
    ``graph_ms(step, x)`` times a call; the bytes and operations (plain
    version, float32) are those of one step of one cell."""
    import numpy as np
    import torch

    from lbm_tpu_torch.kernels import cavity, channel, collide_stream, cylinder, les, rk
    from lbm_tpu_torch.kernels import d3q19 as kd
    from lbm_tpu_torch.kernels import sediment, shan_chen
    from lbm_tpu_torch.ops.ibm import IBM
    from lbm_tpu_torch.scenes.obstacles import sediment_initial_state

    k, name, _, f64, shape, n, s = entry
    dtype = torch.float64 if f64 else torch.float32
    cpu, small = torch.device("cpu"), 64
    if n is not None:
        family = SHARDED_FAMILY[k]
        x = sharded_state(family, shape, dtype, dev)
        step, _, mesh = sharded_case(family, shape, dtype, dev, n, s)
        from lbm_tpu_torch.parallel import mesh as pm
        return step, pm.shard_state(mesh, x), plain_ops(family), None
    R, C = shape[-2:]
    if name == "rk_cg":
        return (rk.make_rk_fused_step(R, C, dtype=dtype, **RK), rk_state(R, C, dtype, dev),
                ops_per_cell(rk.make_plain_step(**RK), rk_state(small, small, torch.float32, cpu)),
                88)
    if name in ("channel_kbc", "channel_bgk"):
        kbc = name == "channel_kbc"
        step = channel.make_channel_fused_step(
            R, C, ULBM_S2 if kbc else 1 / TAU_MAGIC, ULBM_RHO_IN if kbc else 1.001, 1.0, dtype,
            "kbc" if kbc else "bgk")
        x = seeded_state(R, C, dtype, dev, seed=11, noisy=kbc, incompressible=not kbc)
        plain = channel.make_channel_fused_step(small, small, ULBM_S2 if kbc else 1 / TAU_MAGIC,
                                                1.001, 1.0, torch.float32,
                                                "kbc" if kbc else "bgk")
        return step, x, ops_per_cell(plain, seeded_state(small, small, torch.float32, cpu,
                                                          seed=4, noisy=True)), 72
    if name == "channel_variant":
        kw = variants()["trt"]
        step = channel.make_channel_variant_step(R, C, dtype=dtype, **kw)
        plain = channel.make_channel_variant_step(small, small, dtype=torch.float32, **kw)
        return (step, seeded_state(R, C, dtype, dev, seed=9, incompressible=True),
                ops_per_cell(plain, seeded_state(small, small, torch.float32, cpu, seed=6,
                                                 incompressible=True)), 72)
    if name in ("collide_stream_kbc", "collide_stream_les"):
        if name == "collide_stream_kbc":
            step = collide_stream.make_kbc_fused_step(R, C, OMEGA, dtype, substeps=s)
            fn = collide_stream.kbc_collide_fn(OMEGA)
        else:
            step = les.make_les_fused_step(R, C, dtype=dtype, substeps=s, **LES)
            fn = les.les_collide_fn(dtype=torch.float32, **LES)
        plain = collide_stream.make_fused_step(small, small, fn, torch.float32)
        return (step, seeded_state(R, C, dtype, dev, seed=3, noisy=True),
                ops_per_cell(plain, seeded_state(small, small, torch.float32, cpu, seed=3,
                                                 noisy=True)), 72)
    if name == "shan_chen":
        kw = sc_kwargs("sc", "guo")
        return (shan_chen.make_sc_fused_step(R, C, substeps=s, dtype=dtype, **kw),
                sc_state(R, C, dtype, dev, "sc", seed=15),
                ops_per_cell(shan_chen.make_plain_step(**kw),
                             sc_state(small, small, torch.float32, cpu, "sc", seed=1)), 72)
    if name == "cylinder":
        ib = IBM.circle(*STROUHAL_CIRCLE)
        f, F, origin = cylinder_case(R, C, dtype, dev, ib, seed=615)
        grid = cylinder.make_cylinder_fused_step(R, C, 1 / 0.55, (0.05, 0.0), (3.0, 9.0), dtype)
        return (lambda x: grid(x, F, origin), f,
                ops_per_cell(lambda x: cylinder.plain_cylinder_step(
                    x, torch.full((2, 2, 2), 1e-3), (10, 10), 1 / 0.55, (0.05, 0.0),
                    (3.0, 9.0)), seeded_state(small, small, torch.float32, cpu, seed=15)), 72)
    if name == "box":
        F = torch.as_tensor(np.random.default_rng(618).normal(0.0, 1e-3, (2, 42, 42)),
                            dtype=dtype, device=dev)
        origin = torch.tensor([379, 107], dtype=torch.int32, device=dev)
        grid = cylinder.make_box_fused_step(R, C, 1 / 0.6, dtype=dtype)
        return (lambda x: grid(x, F, origin), seeded_state(R, C, dtype, dev, seed=18, noisy=True),
                ops_per_cell(lambda x: cylinder.plain_box_step(
                    x, torch.full((2, 2, 2), 1e-3), torch.tensor([10, 10], dtype=torch.int32),
                    1 / 0.6), seeded_state(small, small, torch.float32, cpu, seed=18)), 72)
    if name == "sediment":
        kw = sediment_kwargs(R, C)
        return (sediment.make_sediment_fused_step(R, C, dtype=dtype, **kw),
                sediment_state(R, C, dtype, dev, seed=617),
                ops_per_cell(lambda x: sediment.plain_sediment_step(
                    x, **dict(SED, R23=40, C28=20, C38=30, inlet_rows=16)),
                    sediment_initial_state(small, small, 0.02, 1e-3, 16, cpu, torch.float32)),
                144)
    if name == "cavity":
        plain = lambda x: cavity.plain_cavity_step(x, omega=CAVITY_OMEGA, force=3e-5)
        return (cavity.make_cavity_fused_step(R, omega=CAVITY_OMEGA, force=3e-5, dtype=dtype),
                seeded_state(R, C, dtype, dev, seed=622, noisy=True),
                ops_per_cell(plain, seeded_state(small, small, torch.float32, cpu, seed=1)), 72)
    if name in THERMAL_NAMES:
        make, plain, _, q = thermal_kernel(name)
        return (make(R, C, dtype=dtype, scalar_lattice=f"d2q{q}", **THERMAL_PHYS),
                thermal_state(q, R, C, dtype, dev, seed=623 + q),
                ops_per_cell(lambda x: plain(x, **THERMAL_PHYS),
                             thermal_state(q, small, small, torch.float32, cpu, seed=2)),
                8 * (9 + q))
    X, Y, Z = shape
    kw = dict(omega=D3Q19_OMEGA, **D3Q19_WALLS["cavity"])
    ops = ops_per_cell(lambda S: kd.plain_d3q19_lanes_step(S, 4, 8, 16, **kw),
                       kd.pack_lanes(d3q19_state(4, 8, 16, torch.float32, cpu, seed=3)))
    f3 = d3q19_state(X, Y, Z, dtype, dev, seed=4)
    if name == "d3q19":
        return kd.make_d3q19_fused_step(X, Y, Z, substeps=s, dtype=dtype, **kw), f3, ops, 152
    return (kd.make_d3q19_lanes_step(X, Y, Z, substeps=s, dtype=dtype, **kw),
            kd.pack_lanes(f3), ops, 152)


def launch_shape_times(dev, card: str, launches: dict, counted: dict) -> list:
    """Phase 6's table of LAUNCH_SHAPES: each case's device us per launch
    under CUDA graphs of 100 calls (median of 3, all cases in turns), its
    bound per launch (the larger of the bytes each input and output moves
    once over HBM3's rate and the plain version's operations over the peak;
    a sharded call's from ``sharded_bound``, over its launches), the phase-5
    launches of the kernel and the loss, launches x (time - bound).  Rows
    ranked by loss."""
    import torch

    from lbm_tpu_torch.kernels import sharded as ksh

    cases, per_call = {}, {}
    for entry in LAUNCH_SHAPES:
        k, name, label, f64, shape, n, s = entry
        step, x, ops, b32 = launch_shape_case(entry, dev)
        kernel = counted[name]
        before = kernel.launches
        step(x)
        torch.cuda.synchronize()
        per_call[entry] = kernel.launches - before
        cases[entry] = (step, x, ops, b32)
    med, runs = in_turns({e: (lambda c=cases[e]: graph_ms(c[0], c[1]))
                          for e in LAUNCH_SHAPES})
    rows = []
    for entry in LAUNCH_SHAPES:
        k, name, label, f64, shape, n, s = entry
        _, x, ops, b32 = cases[entry]
        dt = "float64" if f64 else "float32"
        m = per_call[entry]
        if n is None:
            cells = shape[0] * shape[1] * (shape[2] if len(shape) == 3 else 1)
            b_ms, by = bound(b32 * (2 if f64 else 1), ops, cells, dt)
            b_ms *= s / m
        else:
            b_ms, by = sharded_bound(SHARDED_FAMILY[k], shape, n, s, 8 if f64 else 4, ops)[:2]
            b_ms /= m
        us, b_us = med[entry] / m * 1e3, b_ms * 1e3
        if k in (27, 34):  # the instances of every local collision
            total = sum(launches[name.removesuffix("bgk") + c] for c in ksh.COLLIDE_KINDS)
        else:  # kernel 12's phase-5 launches are half float32, half float64
            total = launches[name] // sum(e[1] == name for e in LAUNCH_SHAPES)
        loss = total * (us - b_us) * 1e-6
        rows.append({"kernel": k, "name": name, "shape": label, "dtype": dt,
                     "launches_per_call": m, "us": us, "bound_us": b_us, "bound_by": by,
                     "fraction": b_us / us, "launches": total, "loss_s": loss,
                     "runs_ms": runs[entry]})
    rows.sort(key=lambda r: -r["loss_s"])
    for r in rows:
        log(f"[6] {card}; launch shape: kernel {r['kernel']} {r['name']} {r['shape']} "
            f"{r['dtype']}: {r['us']!r} us a launch ({r['launches_per_call']} a call, CUDA "
            f"graphs of 100 calls, median of 3 in turns), bound {r['bound_us']!r} us by "
            f"{r['bound_by']} ({r['fraction']!r}), {r['launches']} phase-5 launches, loss "
            f"{r['loss_s']!r} s")
    return rows


# kernel 12's timed shapes; kernel 36's cases (shape, mesh, sweeps a call):
# the thermal gate's grid and the big grid on (4, 2), eight sweeps a call
RK_TIMES = ((1024, 256), BIG)
K36_TIMES = (((64, 128), (4, 2), 8), (BIG, (4, 2), 8))


def load_parent_rk_k36(parent: Path) -> tuple:
    """The parent tree's kernels 12 and 36 with its own wrappers (the copy of
    ``parent_package``), its rk_cg.cu and thermal.cu built by
    ``build_parent``.  Returns the copy's (kernels.rk, kernels.sharded2d)."""
    import importlib

    parent_package(parent)
    rk_p = importlib.import_module("lbm_tpu_torch_parent.kernels.rk")
    k2d_p = importlib.import_module("lbm_tpu_torch_parent.kernels.sharded2d")
    bind_kernels([rk_p.RK_CG, k2d_p.HALO2D_THERMAL], build_parent(parent, ("rk_cg", "thermal")))
    return rk_p, k2d_p


def rk_k36_times(dev, card: str, parent=None) -> dict:
    """Kernel 12 at rk_rayleigh_taylor's 1024x256 and at 4096x2048 and kernel
    36 at K36_TIMES' cases, float32 and float64: us per step (kernel 36: per
    step of a call of its sweeps, with the exchange) under CUDA graphs of
    100, in turns (``in_turns``), of this tree's kernel and with ``parent``
    (``load_parent_rk_k36``) the parent's.  Kernel 12 must give the parent's bits over 4 steps at
    1024x256 and one at 4096x2048, kernel 36 over 2 calls, in both types:
    it raises where they differ.  Keys (kernel, shape, dtype) -> {variant:
    us}."""
    import torch

    from lbm_tpu_torch.kernels import rk
    from lbm_tpu_torch.kernels import sharded2d as k2d
    from lbm_tpu_torch.parallel import mesh as pm

    rk_p, k2d_p = load_parent_rk_k36(parent) if parent is not None else (None, None)
    out = {}

    def turns(key, fns):
        med, runs = in_turns({v: (lambda fn=fn: fn() * 1e3) for v, fn in fns.items()})
        if "parent" in med:
            med["change"] = med["new"] / med["parent"] - 1.0
        out[key] = med
        log(f"[6] {card}; kernel {key[0]} {key[1]} {key[2]} (us per step, CUDA graphs of 100, "
            f"median of 3 in turns): " + ", ".join(f"{v} {t!r}" for v, t in med.items())
            + f" (runs {runs})")

    def same_bits(label, new, old, x, steps):
        a = b = x
        for i in range(steps):
            a, b = new(a), old(b)
            same = (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else all(torch.equal(u, v) for u, v in zip(a.shards, b.shards)))
            if not same:
                raise AssertionError(f"{label}: step {i} differs from the parent's bits")
        log(f"[6] {label}: bit for bit the parent's over {steps} step(s)")

    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).removeprefix("torch.")
        for R, C in RK_TIMES:
            S = rk_state(R, C, dtype, dev)
            new = rk.make_rk_fused_step(R, C, dtype=dtype, **RK)
            fns = {"new": lambda: graph_ms(new, S)}
            if rk_p is not None:
                old = rk_p.make_rk_fused_step(R, C, dtype=dtype, **RK)
                same_bits(f"kernel 12 {R}x{C} {dt}", new, old, S,
                          4 if (R, C) == (1024, 256) else 1)
                fns["parent"] = lambda old=old: graph_ms(old, S)
            turns((12, f"{R}x{C}", dt), fns)
            del S
            torch.cuda.empty_cache()
        for (R, C), shape, s in K36_TIMES:
            mesh = pm.make_mesh([dev] * (shape[0] * shape[1]), shape)
            x = pm.shard_state(mesh, thermal_state(9, R, C, dtype, dev, seed=36))
            new = k2d.make_sharded2d_thermal_step(mesh, R, C, substeps=s, dtype=dtype,
                                                  **THERMAL_PHYS)
            fns = {"new": lambda: graph_ms(new, x) / s}
            if k2d_p is not None:
                old = k2d_p.make_sharded2d_thermal_step(mesh, R, C, substeps=s, dtype=dtype,
                                                        **THERMAL_PHYS)
                same_bits(f"kernel 36 {R}x{C} on {shape} {dt}", new, old, x, 2)
                fns["parent"] = lambda old=old: graph_ms(old, x) / s
            turns((36, f"{R}x{C} on {shape}, {s} sweeps a call", dt), fns)
            del x
            torch.cuda.empty_cache()
    return out


# kernel 4's timed shapes (ulbm_poiseuille's 128x128 and the big grid) and
# kernel 33's cases (label, (X, Y, Z), walls, shards, sweeps a call, types):
# the cavity3d gate's launch shape and 32x256x1024 at s = 1 and 8
K4_TIMES = ((128, 128), BIG)
K33_TIMES = (("cavity3d launch shape", (8, 64, 128), "cavity", 8, 2, ("float32", "float64")),
             ("32x256x1024", D3Q19_BIG, "periodic", 8, 1, ("float32",)),
             ("32x256x1024", D3Q19_BIG, "periodic", 8, 8, ("float32",)))
# kernel 4's other designs (edits of csrc/, label -> {file: edits}, built
# whole and timed against it in ``k4_k33_times``): its blocks sized to the
# card as plain launches (lever (a) left out; the launch policy lives in
# d2q9.cuh, shared with kernels 2 and 9), and lever (b), a register cap that
# lets four 256-thread blocks share an SM (72 registers hold three)
K4_DESIGNS = {
    "without PDL": {"d2q9.cuh": [("pdl ? 1u : 0u}", "0u}")]},
    "64 registers": {"channel_kbc.cu": [
        ("template <typename T>\n__global__ void channel_kbc_kernel(",
         "template <typename T>\n__global__ void __launch_bounds__(256, 4) channel_kbc_kernel(")]}}
# kernels 2 and 9's other designs (timed against the tree in
# ``k2_k9_times``): plain launches of the sized blocks; 256-thread blocks (a
# dependent launch all the same in one wave); a virtual line's thread
# colliding its own cell before its source, as the parent design did (two
# rounds of loads); kernel 9's wall tests only in the threads near a wall
# line (the redesign's first tree; the tree tests them in every thread, as
# the parent did)
K2_K9_DESIGNS = {
    "without PDL": {"d2q9.cuh": [("pdl ? 1u : 0u}", "0u}")]},
    "256-thread blocks": {"d2q9.cuh": [
        ("inline int block_threads(int64_t n, int sms) {\n",
         "inline int block_threads(int64_t n, int sms) {\n  if (n >= 0) return 256;\n")]},
    "own collision kept": {
        "channel_bgk.cu": [
            ("  collide(fin, n, src, omega, one_m_omega, coll, feq, ux, uy);\n",
             "  collide(fin, n, cell, omega, one_m_omega, coll, feq, ux, uy);\n"
             "  if (virtual_row) collide(fin, n, src, omega, one_m_omega, coll, feq, ux, "
             "uy);\n")],
        "channel_variant.cu": [
            ("  collide<T, INCOMP, TRT, FORCE>(fin, n, src, P, coll, feq, ux, uy);\n",
             "  collide<T, INCOMP, TRT, FORCE>(fin, n, cell, P, coll, feq, ux, uy);\n"
             "  if (virtual_line) collide<T, INCOMP, TRT, FORCE>(fin, n, src, P, coll, feq, ux, "
             "uy);\n")]},
    "near walls only": {"channel_variant.cu": [
        ("  // 7. the periodic push, less the entries a wall rule owns\n",
         "  const bool edge = (P.row_walls != NONE && (r <= 1 || r >= R - 2)) ||\n"
         "                    (P.col_walls != NONE && (c <= 1 || c >= C - 2));\n"
         "  // 7. the periodic push, less the entries a wall rule owns\n"),
        ("    if (!owned(k, rr, cc, R, C, P)) fout[k * n + rr * C + cc] = coll[k];\n  }\n",
         "    if (!edge || !owned(k, rr, cc, R, C, P)) fout[k * n + rr * C + cc] = coll[k];\n"
         "  }\n  if (!edge) return;\n")]}}


def source_edits(text: str, edits, where: str) -> str:
    """``text`` with each (old, new) of ``edits`` applied; an edit that no
    longer finds its text stops the run."""
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{where}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def design_sources(csrc: Path, designs: dict) -> dict:
    """label -> {file name: the text of that file of the tree ``csrc`` with
    the design's edits} for each of ``designs`` (label -> {file name:
    edits}); an edit that no longer finds its text stops the run."""
    return {label: {name: source_edits((csrc / name).read_text(), edits,
                                       f"design {label!r} of {csrc}/{name}")
                    for name, edits in files.items()}
            for label, files in designs.items()}


def build_designs(sources: dict, units, what: str, mark: str | None = None) -> dict:
    """Each design of ``sources`` (label -> {file name: text}, as
    ``design_sources`` gives) built: csrc/'s ``units``, each with its flags,
    the design's files in place of the tree's, namespace lbm renamed (as
    ``build_parent`` does), into a library of its own, every unit of every
    design compiled at once: {label: the library}.  ptxas' report of each
    design is logged (with ``mark``, only the kernels whose names hold it)."""
    import ctypes

    from lbm_tpu_torch.kernels import _build

    rename = [("namespace lbm {", "namespace lbm_design {"), ("lbm::", "lbm_design::")]
    nvcc, procs, works = _build.find_nvcc(), {}, {}
    for i, (label, files) in enumerate(sources.items()):
        work = works[label] = Path(tempfile.mkdtemp(prefix=f"design{i}-"))
        atexit.register(shutil.rmtree, work, True)
        for f in (*_build.CSRC.glob("*.cuh"), *(_build.CSRC / f"{u}.cu" for u in units)):
            text = files.get(f.name) or f.read_text()
            for old, new in rename:
                text = text.replace(old, new)
            (work / f.name).write_text(text)
        for u in units:
            procs[label, u] = subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, *_build.UNIT_FLAGS.get(u, ()), "-c", "-o",
                 str(work / f"{u}.o"), str(work / f"{u}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for (label, u), proc in procs.items():
        text = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {u}.cu of {what}'s design {label!r}:\n{text}")
        if mark is None:
            lines = [line.strip() for line in text.splitlines()
                     if "registers" in line or "spill" in line]
        else:
            lines = [f"{name}: {regs} registers; {spill}" for name, regs, spill
                     in ptxas_entries(f"== {u}.cu\n{text}", f"{u}.cu") if mark in name]
        for line in lines:
            log(f"[6] {what} design {label!r}, {u}.cu: {line}")
    out = {}
    for label, work in works.items():
        so = work / "libdesign.so"
        subprocess.run([nvcc, *_build.NVCC_FLAGS[:2], "-shared", "-o", str(so),
                        *(str(work / f"{u}.o") for u in units)], check=True, timeout=600,
                       capture_output=True)
        out[label] = ctypes.CDLL(str(so))
    return out


def build_k4_designs() -> dict:
    """Each of ``K4_DESIGNS`` built with csrc/channel_kbc.cu
    (``build_designs``): {label: its lbm_channel_kbc}."""
    import ctypes

    from lbm_tpu_torch.kernels import _build, channel

    out = {}
    for label, lib in build_designs(design_sources(_build.CSRC, K4_DESIGNS), ("channel_kbc",),
                                    "kernel 4").items():
        fn = lib.lbm_channel_kbc
        fn.argtypes, fn.restype = channel.CHANNEL_KBC.argtypes, ctypes.c_int
        out[label] = fn
    return out


def k4_k33_times(dev, card: str, parent=None, designs=False) -> dict:
    """Kernel 4 at K4_TIMES' shapes in both types: us per step under CUDA
    graphs of 100 chained steps, in turns (7 rounds at 4096x2048), of this
    tree's launch (blocks sized to the card, a programmatic dependent
    launch where the grid fits in one wave), with ``designs`` also
    ``K4_DESIGNS``' builds (the same without the dependent launch; a
    register cap) and, with ``parent``, the parent tree's kernel (built by
    ``build_parent``); kernel 33 at K33_TIMES' cases: us per call (graphs of
    100 calls; 32x256x1024 of 5) of this tree's sharded step (one launch a
    sweep, the neighbours' rows in place), the exchange of HALO rows alone
    (the copies the row-sharded steps make, ``exchange_rows``) and with
    ``parent`` the parent tree's step (its package copied, its d3q19.cu
    bound).  Every variant must give the same bits (the parent's, where
    there is one) over 4 steps of kernel 4 and 2 calls of kernel 33: it
    raises where they differ.  Keys (kernel, case, dtype) -> {variant: us}."""
    import ctypes
    import importlib

    import torch

    from lbm_tpu_torch.kernels import _build, channel
    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.parallel import halo as ph
    from lbm_tpu_torch.parallel import mesh as pm

    designs = build_k4_designs() if designs else {}
    parent_kbc = ksh_p = None
    if parent is not None:
        parent_package(parent)
        ksh_p = importlib.import_module("lbm_tpu_torch_parent.kernels.sharded")
        lib = build_parent(parent, ("channel_kbc", "d3q19"))
        bind_kernels([ksh_p.HALO_D3Q19], lib)
        parent_kbc = lib.lbm_channel_kbc
        parent_kbc.argtypes, parent_kbc.restype = channel.CHANNEL_KBC.argtypes, ctypes.c_int
    out = {}

    def turns(key, fns, unit, rounds=3):
        med, runs = in_turns({v: (lambda fn=fn: fn() * 1e3) for v, fn in fns.items()}, rounds)
        if "parent" in med:
            med["change"] = med["new"] / med["parent"] - 1.0
        out[key] = med
        log(f"[6] {card}; kernel {key[0]} {key[1]} {key[2]} ({unit}, CUDA graphs, median of "
            f"{rounds} in turns): " + ", ".join(f"{v} {t!r}" for v, t in med.items())
            + f" (runs {runs})")

    def same_bits(label, steps, x, n):
        want = None
        for v, step in steps.items():
            y = x
            for _ in range(n):
                y = step(y)
            y = y if isinstance(y, torch.Tensor) else y.gather()
            torch.cuda.synchronize()
            if want is None:
                want = (v, y)
            elif not torch.equal(y, want[1]):
                raise AssertionError(f"{label}: {v} differs from {want[0]}'s bits")
        log(f"[6] {label}: {', '.join(steps)} bit for bit alike over {n} step(s) or call(s)")

    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).removeprefix("torch.")
        for R, C in K4_TIMES:
            x = seeded_state(R, C, dtype, dev, seed=11, noisy=True)
            args = (ULBM_S2, ULBM_RHO_IN, 1.0)
            new = channel.make_channel_fused_step(R, C, *args, dtype, "kbc")

            def raw(fn, R=R, C=C, f64=int(dtype == torch.float64)):
                def step(f):
                    y = torch.empty_like(f)
                    err = fn(f.data_ptr(), y.data_ptr(), R, C, *args, f64,
                             _build.stream_handle(f))
                    if err:
                        raise RuntimeError(f"kernel 4 launch failed: cudaError_t {err}")
                    return y
                return step

            steps = {"new": new, **{label: raw(fn) for label, fn in designs.items()}}
            if parent_kbc is not None:
                steps = {"parent": raw(parent_kbc), **steps}
            same_bits(f"kernel 4 {R}x{C} {dt}", steps, x, 4)
            # the big grid's f64 steps swing by 4% between runs: seven rounds there
            turns((4, f"{R}x{C}", dt), {v: (lambda st=st: graph_ms(st, x))
                                       for v, st in steps.items()}, "us per step",
                  3 if R * C < 1 << 20 else 7)
            del x
            torch.cuda.empty_cache()
    for label, (X, Y, Z), walls, n, s, dts in K33_TIMES:
        for dt in dts:
            dtype = getattr(torch, dt)
            mesh = pm.make_mesh([dev] * n)
            x = pm.shard_state(mesh, d3q19_state(X, Y, Z, dtype, dev, seed=33)
                               .reshape(19 * X, Y, Z))
            kw = dict(omega=D3Q19_OMEGA, substeps=s, dtype=dtype, **D3Q19_WALLS[walls])
            steps = {"new": ksh.make_sharded_d3q19_step(mesh, X, Y, Z, **kw)}
            if ksh_p is not None:
                steps = {"parent": ksh_p.make_sharded_d3q19_step(mesh, X, Y, Z, **kw), **steps}
            same_bits(f"kernel 33 {label} on {n} shards, s={s} {dt}", steps, x, 2)

            def exchange(y):
                ph.exchange_rows(y.shards, ksh.HALO)
                return y
            calls = 100 if X * Y * Z < 1 << 20 else 5
            fns = {v: (lambda st=st: graph_ms(st, x, calls)) for v, st in steps.items()}
            fns["exchange alone"] = lambda: graph_ms(exchange, x, calls)
            turns((33, f"{label}, {n} shards, {s} sweeps a call", dt), fns, "us per call")
            del x, steps
            torch.cuda.empty_cache()
    return out


class DesignCase(NamedTuple):
    """One case of ``design_times``: kernel ``k`` of csrc/``unit``.cu through
    its wrapper ``kernel`` (bound to each variant's library while a step
    runs), named ``label``, in ``dtype``; ``make()`` gives (this tree's step,
    its input); a CUDA graph of ``calls`` chained calls times a call, the
    median of ``rounds`` in turns; the builds of the designs run it where
    ``designs`` (else only the parent's)."""
    k: int
    unit: str
    kernel: object
    label: str
    dtype: object
    make: object
    calls: int = 100
    designs: bool = True
    rounds: int = 3


def design_times(dev, card: str, cases, table: dict, what: str, parent=None,
                 designs=False) -> dict:
    """Each of ``cases`` (``DesignCase``s): us per call under CUDA graphs of
    its calls, median of its rounds in turns (``in_turns``), of this tree's kernel,
    with ``designs`` also the builds of ``table`` (label -> {file: edits},
    ``design_sources``, ``build_designs``) that edit the case's unit or
    d2q9.cuh, and with ``parent`` the parent tree's kernel (built by
    ``build_parent``).  Every variant must give the same bits (the
    parent's, where there is one) over 4 calls: it raises where they
    differ.  Keys (kernel, label, dtype) -> {variant: us}, with the change
    against the parent."""
    import ctypes

    import torch

    from lbm_tpu_torch.kernels import _build

    cases = list(cases)
    units = sorted({c.unit for c in cases})
    libs = {}
    if parent is not None:
        libs["parent"] = (build_parent(parent, units), None)
    if designs:
        sources = design_sources(_build.CSRC, table)
        for label, lib in build_designs(sources, units, what).items():
            libs[label] = (lib, set(sources[label]))

    def bound_to(kernel, lib, step):
        """``step`` with ``kernel`` bound to ``lib``'s entry point while it
        runs (a graph records the function it was captured with)."""
        fn = getattr(lib, kernel.symbol)
        fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int

        def run(f):
            saved, kernel._fn = kernel._fn, fn
            try:
                return step(f)
            finally:
                kernel._fn = saved
        return run

    out = {}
    for case in cases:
        dt = str(case.dtype).removeprefix("torch.")
        new, x = case.make()
        steps = {}
        for v, (lib, files) in libs.items():
            if v == "parent":
                steps[v] = bound_to(case.kernel, lib, new)
            elif case.designs and (f"{case.unit}.cu" in files or "d2q9.cuh" in files):
                steps[v] = bound_to(case.kernel, lib, new)
        steps = {**({"parent": steps.pop("parent")} if "parent" in steps else {}), "new": new,
                 **steps}
        want = None
        for v, step in steps.items():
            y = x
            for _ in range(4):
                y = step(y)
            y = y if isinstance(y, torch.Tensor) else y.gather()
            torch.cuda.synchronize()
            if want is None:
                want = (v, y)
            elif not torch.equal(y, want[1]):
                raise AssertionError(f"kernel {case.k} {case.label} {dt}: {v} differs from "
                                     f"{want[0]}'s bits")
        med, runs = in_turns({v: (lambda st=st: graph_ms(st, x, case.calls) * 1e3)
                              for v, st in steps.items()}, case.rounds)
        if "parent" in med:
            med["change"] = med["new"] / med["parent"] - 1.0
        out[case.k, case.label, dt] = med
        log(f"[6] {card}; kernel {case.k} {case.label} {dt} (us per call, CUDA graphs of "
            f"{case.calls}, median of {case.rounds} in turns; {', '.join(steps)} bit for bit "
            f"alike over 4 calls): " + ", ".join(f"{v} {us!r}" for v, us in med.items())
            + f" (runs {runs})")
        del x, want, new, steps
        torch.cuda.empty_cache()
    return out


# kernels 2 and 9's timed shapes (the validation runs' 128x128, the Poiseuille
# gate's 21x21, the big grid) and kernel 9's timed scenes (variants()): trt
# (its launch shape), gravity (force), vertical (pressure on the columns,
# bounce-back rows) and free_stream_cc (anti-bounce-back rows, the specular
# rule skipping them)
K2_K9_SHAPES = ((128, 128), (21, 21), BIG)
K9_SCENES = ("trt", "gravity", "vertical", "free_stream_cc")


def k2_k9_times(dev, card: str, parent=None, designs=False) -> dict:
    """Kernel 2 (poiseuille's constants) and kernel 9 (each of K9_SCENES) at
    K2_K9_SHAPES in both types through ``design_times`` (us per step under
    CUDA graphs of 100 steps; ``K2_K9_DESIGNS`` with ``designs``), bit for
    bit the parent's where ``parent`` names one.  Keys (kernel, case,
    dtype) -> {variant: us}."""
    import torch

    from lbm_tpu_torch.kernels import channel

    def make(k, scene, R, C, dtype):
        if k == 2:
            return (channel.make_channel_fused_step(R, C, 1 / TAU_MAGIC, 1.001, 1.0, dtype),
                    seeded_state(R, C, dtype, dev, seed=11, incompressible=True))
        return (channel.make_channel_variant_step(R, C, dtype=dtype, **variants()[scene]),
                seeded_state(R, C, dtype, dev, seed=9, incompressible=True, noisy=True))

    cases = [DesignCase(k, unit, kernel, f"{scene or 'poiseuille'} {R}x{C}", dtype,
                        functools.partial(make, k, scene, R, C, dtype))
             for k, unit, kernel in ((2, "channel_bgk", channel.CHANNEL_BGK),
                                     (9, "channel_variant", channel.CHANNEL_VARIANT))
             for scene in ((None,) if k == 2 else K9_SCENES) for R, C in K2_K9_SHAPES
             for dtype in (torch.float32, torch.float64)]
    return design_times(dev, card, cases, K2_K9_DESIGNS, "kernels 2 and 9", parent, designs)


# kernels 23 and 24's other designs (edits of csrc/, timed against the tree in
# ``k23_k24_times``): plain launches of the sized blocks; 256-thread blocks (a
# dependent launch all the same in one wave); the 32-bit instance where the
# state's offsets fit in 31 bits (the redesign's first tree); the dependent
# launch released at each block's exit (as kernels 14, 32, 35 and 37 do);
# the push's owned() tests only in the threads within one cell of a wall
# line, one uniform branch for the interior's warps; and the last two, each
# with the 32-bit instance
_K23_32_BIT = [(
    "  return static_cast<int>(lbm::launch_cells<thermal_kernel<T, QG, CAVITY, int64_t>>(\n",
    "  if ((9 + QG) * n <= INT32_MAX)\n"
    "    return static_cast<int>(lbm::launch_cells<thermal_kernel<T, QG, CAVITY, int32_t>>(\n"
    "        n, stream, static_cast<const T*>(fin), static_cast<T*>(fout),\n"
    "        static_cast<int32_t>(R), static_cast<int32_t>(C), params<T>(d)));\n"
    "  return static_cast<int>(lbm::launch_cells<thermal_kernel<T, QG, CAVITY, int64_t>>(\n")]
_K23_RELEASE_AT_EXIT = [("  lbm::grid_release();\n", "")]
_K23_NEAR_WALLS = [(
    "  // 3. the periodic push, less the entries a wall rule writes\n",
    "  // 3. the periodic push, less the entries a wall rule writes\n"
    "  if (!(r <= 1 || r >= R - 2 || (CAVITY && (c <= 1 || c >= C - 2)))) {\n"
    "#pragma unroll\n"
    "    for (int k = 0; k < 9; ++k) {\n"
    "      const I dst = wrap<I>(r + lbm::cx(k), R) * C + wrap<I>(c + lbm::cy(k), C);\n"
    "      fout[k * n + dst] = fc[k];\n"
    "      if (k < QG) fout[(9 + k) * n + dst] = gc[k];\n"
    "    }\n"
    "    return;\n"
    "  }\n")]
K23_K24_DESIGNS = {
    "without PDL": K2_K9_DESIGNS["without PDL"],
    "256-thread blocks": K2_K9_DESIGNS["256-thread blocks"],
    "32-bit indices": {"thermal.cu": _K23_32_BIT},
    "release at block exit": {"thermal.cu": _K23_RELEASE_AT_EXIT},
    "near walls only": {"thermal.cu": _K23_NEAR_WALLS},
    "near walls only, 32-bit indices": {"thermal.cu": _K23_NEAR_WALLS + _K23_32_BIT},
    "near walls only, release at block exit": {
        "thermal.cu": _K23_NEAR_WALLS + _K23_RELEASE_AT_EXIT}}
# each thermal instance's launch shape (the phase-5 gates' grids) and its
# launches there in phase 5: the gate run's steps and the float64 scene's 200
K23_K24_SHAPES = {"thermal_rb": ((64, 128), 30200), "heated_cavity": ((128, 128), 40200)}


def k23_k24_times(dev, card: str, parent=None, designs=False) -> dict:
    """Kernels 23 and 24, every instance of THERMAL_NAMES at its launch
    shape (K23_K24_SHAPES) and at 4096x2048 in both types, through
    ``design_times`` (us per step under CUDA graphs of 100 steps, median of
    5 in turns; 10 steps and 3 at 4096x2048; ``K23_K24_DESIGNS`` with
    ``designs``), and with ``parent``
    also kernel 28 at rayleigh_benard's 64x128 on 8 shards, 8 steps a call
    (it shares csrc/thermal.cu's wall functions), every variant bit for bit
    the parent's.  At each float32 launch shape the bound of a launch (its
    bytes over HBM3's rate against the plain version's operations) and
    each variant's loss, phase-5 launches x (us - bound); the four
    instances' sum under the key (0, "23 and 24, launch shapes", "loss
    s").  Keys (kernel, case, dtype) -> {variant: us}."""
    import torch

    cpu = torch.device("cpu")
    f32 = torch.float32

    def make(name, R, C, dtype):
        mk, _, _, q = thermal_kernel(name)
        return (mk(R, C, dtype=dtype, scalar_lattice=f"d2q{q}", **THERMAL_PHYS),
                thermal_state(q, R, C, dtype, dev, seed=R + C + q))

    def make28(dtype):
        from lbm_tpu_torch.parallel import mesh as pm

        step, _, mesh = sharded_case("thermal", (64, 128), dtype, dev, 8, 8)
        return step, pm.shard_state(mesh, sharded_state("thermal", (64, 128), dtype, dev))

    cases, shapes = [], {}
    for name in THERMAL_NAMES:
        (R, C), launches = K23_K24_SHAPES[name[:-3]]
        k, kernel = (23 if name.startswith("thermal_rb") else 24), thermal_kernel(name)[2]
        shapes[k, f"{name} {R}x{C}"] = (name, R * C, launches)
        for (Rs, Cs), dtype in ((s, dt) for s in ((R, C), BIG) for dt in (f32, torch.float64)):
            small = Rs * Cs < 1 << 20
            cases.append(DesignCase(k, "thermal", kernel, f"{name} {Rs}x{Cs}", dtype,
                                    functools.partial(make, name, Rs, Cs, dtype),
                                    100 if small else 10, rounds=5 if small else 3))
    if parent is not None:
        from lbm_tpu_torch.kernels import sharded as ksh

        cases += [DesignCase(28, "thermal", ksh.HALO_THERMAL,
                             "halo_thermal 64x128, 8 shards, 8 a call", dtype,
                             functools.partial(make28, dtype), designs=False)
                  for dtype in (f32, torch.float64)]
    out = design_times(dev, card, cases, K23_K24_DESIGNS, "kernels 23 and 24", parent,
                       designs)
    total = {}
    for (k, label), (name, cells, launches) in shapes.items():
        _, plain, _, q = thermal_kernel(name)
        ops = ops_per_cell(lambda x: plain(x, **THERMAL_PHYS),
                           thermal_state(q, 64, 64, f32, cpu, seed=2))
        b_us = bound(8 * (9 + q), ops, cells, "float32")[0] * 1e3
        med = out[k, label, "float32"]
        loss = {v: launches * (us - b_us) * 1e-6 for v, us in med.items() if v != "change"}
        med.update(bound_us=b_us, fraction=b_us / med["new"], launches=launches, loss_s=loss)
        for v, s in loss.items():
            total[v] = total.get(v, 0.0) + s
        log(f"[6] {card}; kernel {k} {label} float32: bound {b_us!r} us a launch ("
            f"{b_us / med['new']!r} of new), {launches} phase-5 launches, loss s: "
            + ", ".join(f"{v} {s!r}" for v, s in loss.items()))
    out[0, "23 and 24, launch shapes", "loss s"] = total
    log(f"[6] {card}; kernels 23 and 24, the four instances' loss at their launch shapes, "
        f"float32 (s): " + ", ".join(f"{v} {s!r}" for v, s in total.items()))
    return out


# kernel 17's other designs (edits of csrc/, timed against the tree in
# ``k17_k30_times``): plain launches of the sized blocks; 128-thread blocks
# in float32 too (640 blocks at 256x320 where the tree's 320 of 256 threads
# leave 56 of 132 SMs a third block); blocks sized from 256 threads in
# float64 too (the tree's float64 blocks take at most 128); column C-2's velocity and scalar
# handed to column C-1 by ``__shfl_up_sync`` from the lane before, loaded
# only where cell C-1 of the row is lane 0 of its warp; the push's owned()
# mask of each destination from the wall flags of the 3 destination rows
# and the 3 destination columns, computed once, in place of 9 calls; the
# int64_t instance at every size (the tree takes int32_t where the offsets
# fit); a wall cell's neighbour loads issued after its own collisions, as
# the first design did (a second round trip for the edge lanes)
_K17_SHUFFLE = [
    ("  const bool near = r == 0 || outlet;\n",
     "  const unsigned wl = threadIdx.x & 31u;\n"
     "  const bool near = r == 0 || (outlet && wl == 0);\n"),
    ("  // 2. the zero-gradient outflows on g (row 0 first, then column C-1), and\n",
     "  // the lane before's velocity and scalar (column C-2's where this is C-1)\n"
     "  const I w0 = cell - static_cast<I>(wl);\n"
     "  const unsigned live = n - w0 >= 32 ? 0xffffffffu : (1u << (n - w0)) - 1u;\n"
     "  const T sux = __shfl_up_sync(live, ux, 1), suy = __shfl_up_sync(live, uy, 1);\n"
     "  T sg[9];\n"
     "#pragma unroll\n"
     "  for (int k = 0; k < 9; ++k) sg[k] = __shfl_up_sync(live, gc[k], 1);\n"
     "  // 2. the zero-gradient outflows on g (row 0 first, then column C-1), and\n"),
    ("  T ux2 = T(0), uy2 = T(0);\n  if (near) {\n",
     "  T ux2 = sux, uy2 = suy;\n"
     "  if (outlet && lane && wl != 0) {\n"
     "#pragma unroll\n"
     "    for (int k = 0; k < 9; ++k) gc[k] = sg[k];\n"
     "  }\n"
     "  if (near) {\n"),
    ("    ux2 = vx;\n    uy2 = vy;\n    if (r == 0 && outlet) {",
     "    if (wl == 0) {\n      ux2 = vx;\n      uy2 = vy;\n    }\n"
     "    if (r == 0 && outlet && wl == 0) {")]
_K17_OWNED_ONCE = [
    ("// Kernel 17: one thread a cell, its index arithmetic in I.\n",
     "// owned() of a cell from its row's flags rb (1 lane, 2 row 0, 4 row R-1,\n"
     "// 8 the side walls' rows, 16 row R23) and its column's cb (1 column 0,\n"
     "// 2 column C-1, 4 C28, 8 C38, 16 C28..C38).\n"
     "template <typename T, typename I>\n"
     "__device__ __forceinline__ unsigned row_flags(I r, I R, const Params<T>& P) {\n"
     "  return (r >= 1 && r <= R - 2 ? 1u : 0u) | (r == 0 ? 2u : 0u) | (r == R - 1 ? 4u : 0u) |\n"
     "         (r >= P.R23 + 1 ? 8u : 0u) | (r == P.R23 ? 16u : 0u);\n"
     "}\n"
     "template <typename T, typename I>\n"
     "__device__ __forceinline__ unsigned col_flags(I c, I C, const Params<T>& P) {\n"
     "  return (c == 0 ? 1u : 0u) | (c == C - 1 ? 2u : 0u) | (c == P.C28 ? 4u : 0u) |\n"
     "         (c == P.C38 ? 8u : 0u) | (c >= P.C28 && c <= P.C38 ? 16u : 0u);\n"
     "}\n"
     "__device__ __forceinline__ unsigned owned_by(unsigned rb, unsigned cb) {\n"
     "  const bool lane = rb & 1u, walls = rb & 8u, ceil = (rb & 16u) && (cb & 16u);\n"
     "  unsigned m = 0, g = 0;\n"
     "  if ((cb & 1u) && lane) m |= 0x1FEu;\n"
     "  if (cb & 2u) m |= 0x1FEu;\n"
     "  if (rb & 2u) m |= (1u << 1) | (1u << 5) | (1u << 8);\n"
     "  if (rb & 4u) m |= (1u << 3) | (1u << 7) | (1u << 6);\n"
     "  if (walls && lane && (cb & 4u)) m |= (1u << 8) | (1u << 4) | (1u << 7);\n"
     "  if (ceil) m |= (1u << 6) | (1u << 3) | (1u << 7);\n"
     "  if (walls && lane && (cb & 8u)) m |= (1u << 5) | (1u << 2) | (1u << 6);\n"
     "  if ((cb & 1u) && lane) g |= 0x1FEu;\n"
     "  if (walls && (cb & 4u)) g |= (1u << 8) | (1u << 4) | (1u << 7);\n"
     "  if (ceil) g |= (1u << 6) | (1u << 3) | (1u << 7);\n"
     "  if (walls && lane && (cb & 8u)) g |= (1u << 5) | (1u << 2) | (1u << 6);\n"
     "  if (rb & 4u) g |= (1u << 3) | (1u << 7) | (1u << 6);\n"
     "  return m | (g << 9);\n"
     "}\n\n"
     "// Kernel 17: one thread a cell, its index arithmetic in I.\n"),
    ("  // 3. the periodic push, less the entries a wall rule writes\n",
     "  // 3. the periodic push, less the entries a wall rule writes\n"
     "  unsigned rbs[3], cbs[3];\n"
     "#pragma unroll\n"
     "  for (int d = 0; d < 3; ++d) {\n"
     "    rbs[d] = row_flags(wrap<I>(r + d - 1, R), R, P);\n"
     "    cbs[d] = col_flags(wrap<I>(c + d - 1, C), C, P);\n"
     "  }\n"),
    ("    const unsigned m = owned(rd, cd, R, C, P);\n",
     "    const unsigned m = owned_by(rbs[1 + lbm::cx(k)], cbs[1 + lbm::cy(k)]);\n")]
_K17_64_BIT = [("  if (fits32(n))\n", "  if (false)\n")]
_K17_LOADS_AFTER = [
    ("  load9(fin + 9 * n, n, cell, g);\n  if (near) {\n    load9(fin, n, nb, fn);\n"
     "    load9(fin + 9 * n, n, nb, gn);\n  }\n  lbm::grid_release();\n",
     "  load9(fin + 9 * n, n, cell, g);\n  lbm::grid_release();\n"),
    ("  if (near) {\n    T rho2, vx, vy;\n",
     "  if (near) {\n    load9(fin, n, nb, fn);\n    load9(fin + 9 * n, n, nb, gn);\n"
     "    T rho2, vx, vy;\n")]
K17_DESIGNS = {
    "without PDL": K2_K9_DESIGNS["without PDL"],
    "128-thread blocks": {"d2q9.cuh": [
        ("inline int block_threads(int64_t n, int sms) {\n",
         "inline int block_threads(int64_t n, int sms) {\n  if (n >= 0) return 128;\n")]},
    "256-thread blocks in float64": {"sediment.cu": [
        ("constexpr int KERNEL17_MAX_THREADS = sizeof(T) == 8 ? 128 : 256;",
         "constexpr int KERNEL17_MAX_THREADS = 256;")]},
    "outlet by shuffle": {"sediment.cu": _K17_SHUFFLE},
    "owned mask once": {"sediment.cu": _K17_OWNED_ONCE},
    "64-bit indices": {"sediment.cu": _K17_64_BIT},
    "neighbour loads after the collisions": {"sediment.cu": _K17_LOADS_AFTER}}
# kernel 30's other designs, timed against the tree in ``k17_k30_times``:
# the tree's kernel fed by the exchange's copies (``exchange_copies_kept``,
# no source edit: the parent's copies with the tree's one launch); the
# tree's kernel launched a shard at a time (``launch_per_shard``, no source
# edit: the parent's 8 launches a call with the tree's reads in place); the
# masked instance for every shard in float32 too, which gives the mask-free
# one's bits on interior shards (the tree branches per block in float32);
# float32's registers left uncapped (80, three blocks an SM; the tree asks
# for five, 48 registers)
K30_DESIGNS = {
    "exchange copies kept": {},
    "launch per shard": {},
    "masked instance in float32 too": {"rk_cg.cu": [
        ("  const IO io{L.in, L.out, L.off};\n  if (L.edge || sizeof(T) == 8)\n",
         "  const IO io{L.in, L.out, L.off};\n  if (true)\n")]},
    "no register cap in float32": {"rk_cg.cu": [
        ("constexpr int KERNEL30_MIN_BLOCKS = sizeof(T) == 8 ? 3 : 5;",
         "constexpr int KERNEL30_MIN_BLOCKS = sizeof(T) == 8 ? 3 : 1;")]}}
# kernel 17's timed grids, with its launches at the launch shape in phase 5
# (the float32 gate's 20,000 steps and the float64 scene's 500); kernel 30's
# cases (grid, shards), with its phase-5 calls at the launch shape (the
# sharded rk_rayleigh_taylor run, one step a call)
K17_TIMES = ((256, 320), BIG)
K17_LAUNCHES = 20500
K30_TIMES = (((1024, 256), 8), (BIG, 8))
K30_CALLS = 1000


def build_k30_designs() -> dict:
    """K30_DESIGNS' source edits built for the card with csrc/rk_cg.cu:
    {label: library}."""
    from lbm_tpu_torch.kernels import _build

    k30 = {label: files for label, files in K30_DESIGNS.items() if files}
    return build_designs(design_sources(_build.CSRC, k30), ("rk_cg",), "kernel 30",
                         mark="rk_halo_shards")


def load_parent_k30(parent: Path):
    """The parent tree's kernel 30 with its own wrappers (the copy of
    ``parent_package``: its ``make_sharded_rk_step``, whatever the signature
    of its ``lbm_halo_rk``), its rk_cg.cu built by ``build_parent``.
    Returns the copy's kernels.sharded."""
    import importlib

    parent_package(parent)
    ksh_p = importlib.import_module("lbm_tpu_torch_parent.kernels.sharded")
    bind_kernels([ksh_p.HALO_RK], build_parent(parent, ("rk_cg",)))
    return ksh_p


def k17_k30_times(dev, card: str, parent=None, designs=False) -> dict:
    """Kernel 17 (rectangle_sedimentation's physics, K17_TIMES' grids) and
    kernel 30 (RK on row shards, K30_TIMES' cases, one step a call) in both
    types: us per call under CUDA graphs (of 100 calls at the launch shapes,
    10 at 4096x2048; kernel 17 through ``design_times``, median of 5 at its
    launch shape), in turns, of this tree's step, with ``designs`` also
    ``K17_DESIGNS`` and ``K30_DESIGNS`` and with ``parent`` the parent
    tree's step (kernel 17 bound to DIR's build; kernel 30 DIR's own
    wrappers, ``load_parent_k30``).  Every variant must give the same bits
    (the parent's, where there is one) over 4 calls: it raises where they
    differ.  Beside each kernel-30 case the launches a call of this tree's
    step and the call's bound (``sharded_bound``); at each float32 launch
    shape the bound and each variant's loss (kernel 17: K17_LAUNCHES x (us
    - bound); kernel 30: K30_CALLS x (us a call - bound a call)).  Keys
    (kernel, case, dtype) -> {variant: us}."""
    import torch

    from lbm_tpu_torch.kernels import _build, sediment
    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.parallel import mesh as pm
    from lbm_tpu_torch.scenes.obstacles import sediment_initial_state

    f32, cpu = torch.float32, torch.device("cpu")
    libs = build_k30_designs() if designs else {}

    def make17(R, C, dtype):
        kw = sediment_kwargs(R, C)
        return (sediment.make_sediment_fused_step(R, C, dtype=dtype, **kw),
                sediment_state(R, C, dtype, dev, seed=R + C + 17))

    cases = []
    for (R, C), dtype in ((s, dt) for s in K17_TIMES for dt in (f32, torch.float64)):
        small = R * C < 1 << 20
        cases.append(DesignCase(17, "sediment", sediment.SEDIMENT,
                                f"rectangle_sedimentation {R}x{C}", dtype,
                                functools.partial(make17, R, C, dtype),
                                100 if small else 10, rounds=5 if small else 3))
    out = design_times(dev, card, cases, K17_DESIGNS, "kernel 17", parent, designs)
    ops17 = ops_per_cell(lambda x: sediment.plain_sediment_step(
        x, **dict(SED, R23=40, C28=20, C38=30, inlet_rows=16)),
        sediment_initial_state(64, 64, 0.02, 1e-3, 16, cpu, f32))
    R, C = K17_TIMES[0]
    b_us = bound(144, ops17, R * C, "float32")[0] * 1e3
    med = out[17, f"rectangle_sedimentation {R}x{C}", "float32"]
    loss = {v: K17_LAUNCHES * (us - b_us) * 1e-6 for v, us in med.items() if v != "change"}
    med.update(bound_us=b_us, fraction=b_us / med["new"], launches=K17_LAUNCHES, loss_s=loss)
    log(f"[6] {card}; kernel 17 rectangle_sedimentation {R}x{C} float32: bound {b_us!r} us a "
        f"launch ({b_us / med['new']!r} of new), {K17_LAUNCHES} phase-5 launches, loss s: "
        + ", ".join(f"{v} {s!r}" for v, s in loss.items()))

    ksh_p = load_parent_k30(parent) if parent is not None else None
    ops30 = plain_ops("rk")
    for (R, C), n in K30_TIMES:
        calls = 100 if R * C < 1 << 20 else 10
        label = f"rk_rayleigh_taylor {R}x{C}, {n} shards" if (R, C) == (1024, 256) \
            else f"{R}x{C}, {n} shards"
        for dt in ("float32", "float64"):
            dtype = getattr(torch, dt)
            mesh = pm.make_mesh([dev] * n)
            x = pm.shard_state(mesh, sharded_state("rk", (R, C), dtype, dev))

            def build(module, mesh=mesh, dtype=dtype, R=R, C=C):
                return module.make_sharded_rk_step(mesh, R, C, dtype=dtype, **RK)
            steps = {"new": build(ksh)}
            before = ksh.HALO_RK.launches
            steps["new"](x)
            torch.cuda.synchronize()
            per_call = ksh.HALO_RK.launches - before
            if designs:
                with exchange_copies_kept():
                    kept = build(ksh)

                def exchanged(y, st=kept):
                    with exchange_copies_kept():
                        return st(y)

                def per_shard(y, st=steps["new"]):
                    with launch_per_shard():
                        return st(y)
                steps["exchange copies kept"] = exchanged
                steps["launch per shard"] = per_shard
                for v, lib in libs.items():
                    if v not in K30_DESIGNS or (dt == "float64" and "float32" in v):
                        continue

                    def designed(y, lib=lib, st=steps["new"]):
                        bind_kernels([ksh.HALO_RK], lib)
                        try:
                            return st(y)
                        finally:
                            bind_kernels([ksh.HALO_RK], None)
                    steps[v] = designed
            if ksh_p is not None:
                steps = {"parent": build(ksh_p), **steps}
            want = None
            for v, st in steps.items():
                y = x
                for _ in range(4):
                    y = st(y)
                got = y.gather()
                torch.cuda.synchronize()
                if want is None:
                    want = (v, got)
                elif not torch.equal(got, want[1]):
                    raise AssertionError(f"kernel 30 {label} {dt}: {v} differs from "
                                         f"{want[0]}'s bits")
            log(f"[6] kernel 30 {label} {dt}: {', '.join(steps)} bit for bit alike over 4 "
                f"calls")
            del want, got, y
            med, runs = in_turns({v: (lambda st=st: graph_ms(st, x, calls) * 1e3)
                                  for v, st in steps.items()})
            if "parent" in med:
                med["change"] = med["new"] / med["parent"] - 1.0
            b_ms, by = sharded_bound("rk", (R, C), n, 1, 8 if dt == "float64" else 4, ops30)[:2]
            med.update(launches_per_call=per_call, us_a_launch=med["new"] / per_call,
                       bound=b_ms * 1e3, bound_by=by, fraction=b_ms * 1e3 / med["new"])
            if dt == "float32" and (R, C) == (1024, 256):
                med["loss_s"] = {v: K30_CALLS * (us - b_ms * 1e3) * 1e-6
                                 for v, us in med.items()
                                 if v in steps}
            out[30, label, dt] = med
            log(f"[6] {card}; kernel 30 {label}, 1 step a call, {dt} (us per call, CUDA graphs "
                f"of {calls} calls, median of 3 in turns; the bound in us a call): "
                + ", ".join(f"{v} {t!r}" for v, t in med.items()) + f" (runs {runs})")
            del x, steps
            torch.cuda.empty_cache()
    return out


# kernels 27 and 34's timed cases at 4096x2048, both types, every collision
# of K34_KINDS: (kernel, shards or mesh, steps a call): the launch shape
# (phase 5's periodic BGK runs, s = 8) and one step a call
K27_K34_TIMES = ((27, 8, 8), (34, (4, 2), 8), (27, 8, 1), (34, (4, 2), 1))
# kernels 27 and 34's other designs (edits of csrc/collide_stream.cuh, built
# with the five collide-stream units and timed against the tree in
# ``k27_k34_times``): plain loads into the box instead of cp.async; the
# float32 box of the light collisions (48 rows, two blocks an SM) or of the
# long ones (96 rows, 1024 threads) for every collision; a float32 box of 64
# rows at one block an SM for the light ones (the first design: fewer halo
# collisions, half the warps); float64 at 512 threads (fewer warps, no cap
# of 64 registers); the tile engine at one step too
K27_K34_DESIGNS = {
    "plain loads": [("for (int k = 0; k < 9; ++k) async_copy(dst + k * PLANE, src + k * plane);",
                     "for (int k = 0; k < 9; ++k) dst[k * PLANE] = src[k * plane];")],
    "float32 box 48 rows, two blocks an SM, every collision": [
        ("TALL = F32 && HEAVY;", "TALL = false;")],
    "float32 box 96 rows, 1024 threads, every collision": [("TALL = F32 && HEAVY;", "TALL = F32;")],
    "float32 box 64 rows, one block an SM": [
        ("ROWS = TALL ? 96 : 48;", "ROWS = TALL ? 96 : (F32 ? 64 : 48);"),
        ("MIN_BLOCKS = F32 && !TALL ? 2 : 1;", "MIN_BLOCKS = 1;")],
    "float64 512 threads": [("THREADS = TALL || !(F32 || WIDE) ? 1024 : 512;",
                             "THREADS = TALL ? 1024 : 512;")],
    "tile at one step": [("return steps >= 2;", "return steps >= 1;")]}


def k27_k34_design_sources(csrc: Path) -> dict:
    """label -> csrc/collide_stream.cuh of the tree ``csrc`` with the edits of
    each of ``K27_K34_DESIGNS``."""
    text = (csrc / "collide_stream.cuh").read_text()
    return {label: source_edits(text, edits, f"design {label!r} of collide_stream.cuh")
            for label, edits in K27_K34_DESIGNS.items()}


def build_k27_k34_designs() -> dict:
    """Each of ``K27_K34_DESIGNS`` built with the five collide-stream units
    (csrc/collide_stream_{bgk,kbc,les,trt,power_law}.cu, ``build_designs``):
    {label: the library}; ptxas' report of the tile engine's kernels is
    logged."""
    from lbm_tpu_torch.kernels import _build
    from lbm_tpu_torch.kernels import sharded as ksh

    sources = {label: {"collide_stream.cuh": header}
               for label, header in k27_k34_design_sources(_build.CSRC).items()}
    return build_designs(sources, [f"collide_stream_{k}" for k in ksh.COLLIDE_KINDS],
                         "kernels 27/34", mark="tile_steps")


def load_parent_k27_k34(parent: Path) -> tuple:
    """The parent tree's kernels 27 and 34 with its own wrappers (the copy of
    ``parent_package``), its five collide-stream units built by
    ``build_parent``.  Returns the copy's (kernels.sharded,
    kernels.sharded2d)."""
    import importlib

    parent_package(parent)
    ksh_p = importlib.import_module("lbm_tpu_torch_parent.kernels.sharded")
    k2d_p = importlib.import_module("lbm_tpu_torch_parent.kernels.sharded2d")
    lib = build_parent(parent, tuple(f"collide_stream_{k}" for k in ksh_p.COLLIDE_KINDS))
    bind_kernels([*ksh_p.HALO_COLLIDE_STREAM.values(), *k2d_p.HALO2D_COLLIDE_STREAM.values()], lib)
    return ksh_p, k2d_p


def k27_k34_times(dev, card: str, parent=None, designs=False) -> dict:
    """Kernels 27 and 34 at K27_K34_TIMES' cases (4096x2048, both types;
    every collision of K34_KINDS with ``parent`` or ``designs``, else BGK
    alone): us per call under CUDA graphs of 5 calls, in
    turns (``in_turns``), of this tree's step (a call's steps in one launch
    over the card's shards, the neighbours' lines in place) and, with
    ``parent`` (``load_parent_k27_k34``), the parent tree's; for BGK also the
    exchange alone (``exchange_rows`` / ``exchange_2d``: the copies the
    parent makes a call), the parent's first sweep alone (its launch on each
    shard from the exchanged halos) and, with ``designs``,
    ``K27_K34_DESIGNS``' builds.  Every variant must give the same bits (the
    parent's, where there is one) over 2 calls: it raises where they differ.
    Keys (kernel, case, dtype) -> {variant: us}."""
    import torch

    from lbm_tpu_torch.kernels import _build
    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.kernels import sharded2d as k2d
    from lbm_tpu_torch.parallel import halo as ph
    from lbm_tpu_torch.parallel import mesh as pm

    design_libs = build_k27_k34_designs() if designs else {}
    ksh_p, k2d_p = load_parent_k27_k34(parent) if parent is not None else (None, None)
    own = [*ksh.HALO_COLLIDE_STREAM.values(), *k2d.HALO2D_COLLIDE_STREAM.values()]
    build_log = _build.build().with_suffix(".log").read_text()
    for u in (f"collide_stream_{k}" for k in ksh.COLLIDE_KINDS):
        for name, regs, spill in ptxas_entries(build_log, f"{u}.cu"):
            if "tile_steps" in name or "push_step" in name:
                log(f"[6] kernels 27/34: {name}: {regs} registers; {spill}")
    collisions = k27_collisions()
    kinds = K34_KINDS if parent is not None or designs else ("bgk",)
    ops = {kind: collision_ops(kind) for kind in kinds}
    out = {}
    R, C = BIG
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).removeprefix("torch.")
        for kernel, n, s in K27_K34_TIMES:
            two_d = isinstance(n, tuple)
            shards = n[0] * n[1] if two_d else n
            mesh = pm.make_mesh([dev] * shards, n if two_d else None)
            for kind in kinds:
                make_fn, _, make_state = collisions[kind]
                fn = make_fn(dtype)
                x = pm.shard_state(mesh, make_state(R, C, dtype, dev, R + C))
                make = (k2d.make_sharded_fused_step_2d if two_d else ksh.make_sharded_fused_step)
                steps = {"new": make(mesh, R, C, fn, dtype, substeps=s)}
                if ksh_p is not None:
                    make_p = (k2d_p.make_sharded_fused_step_2d if two_d
                              else ksh_p.make_sharded_fused_step)
                    steps = {"parent": make_p(mesh, R, C, fn, dtype, substeps=s), **steps}
                fns = {v: (lambda st=st: graph_ms(st, x, 5) * 1e3) for v, st in steps.items()}
                for label, lib in design_libs.items():
                    if (label == "tile at one step") != (s == 1):
                        continue  # the other designs change the tile engine only
                    def designed(y, lib=lib, st=steps["new"]):
                        bind_kernels(own, lib)
                        try:
                            return st(y)
                        finally:
                            bind_kernels(own, None)
                    steps[label] = designed
                    fns[label] = lambda d=designed: graph_ms(d, x, 5) * 1e3
                if kind == "bgk":
                    grid = [x.shards[i * n[1]:(i + 1) * n[1]] for i in range(n[0])] if two_d \
                        else None

                    def exchange(y, grid=grid):
                        if grid is not None:
                            ph.exchange_2d(grid, ksh.HALO)
                        else:
                            ph.exchange_rows(y.shards, ksh.HALO)
                        return y
                    fns["exchange alone"] = lambda ex=exchange: graph_ms(ex, x, 5) * 1e3
                    sweep = (parent_first_sweep(ksh_p, k2d_p, x, grid, R, s, fn)
                             if ksh_p is not None else None)
                    if sweep is not None:
                        fns["parent's first sweep alone"] = (
                            lambda sweep=sweep: graph_ms(sweep, x, 5) * 1e3)
                label = f"{kind} {R}x{C}, {n} {'mesh' if two_d else 'shards'}, {s} a call"
                want = None
                for v, st in steps.items():
                    y = x
                    for _ in range(2):
                        y = st(y)
                    got = y.gather()
                    torch.cuda.synchronize()
                    if want is None:
                        want = (v, got)
                    elif not torch.equal(got, want[1]):
                        raise AssertionError(f"kernel {kernel} {label} {dt}: {v} differs from "
                                             f"{want[0]}'s bits")
                log(f"[6] kernel {kernel} {label} {dt}: {', '.join(steps)} bit for bit alike "
                    f"over 2 calls")
                del want, got, y
                med, runs = in_turns(fns)
                if "parent" in med:
                    med["change"] = med["new"] / med["parent"] - 1.0
                b = sharded_bound(f"k{kernel} {kind}", BIG, n, s, x.shards[0].element_size(),
                                  ops[kind])
                med.update(bound=b[0] * 1e3, bound_by=b[1], fraction=b[0] * 1e3 / med["new"],
                           design_bytes_over_bound_bytes=b[3] / b[2])
                out[kernel, label, dt] = med
                log(f"[6] {card}; kernel {kernel} {label} {dt} (us per call, CUDA graphs of 5 "
                    f"calls, median of 3 in turns; the bound in us a call): "
                    + ", ".join(f"{v} {t!r}" for v, t in med.items()) + f" (runs {runs})")
                del x, steps, fns
                torch.cuda.empty_cache()
    return out


# kernels 32 and 35's timed cases (kernel, shards or mesh, grid, sweeps a
# call, types): their launch shape, phase 5's sc_phase_separation gates
# (256x256, 4 a call), one sweep a call there, and 4096x2048 at 1 and 4
# sweeps a call; CUDA graphs of 100 calls at 256x256, of 10 at 4096x2048
K32_K35_TIMES = ((32, 8, (256, 256), 4, ("float32", "float64")),
                 (35, (4, 2), (256, 256), 4, ("float32", "float64")),
                 (32, 8, (256, 256), 1, ("float32",)), (35, (4, 2), (256, 256), 1, ("float32",)),
                 (32, 8, BIG, 1, ("float32",)), (32, 8, BIG, 4, ("float32",)),
                 (35, (4, 2), BIG, 1, ("float32",)), (35, (4, 2), BIG, 4, ("float32",)))
# kernels 32 and 35's other designs (label -> {file: edits}), timed against
# the tree in ``k32_k35_times``: the tree's launches without the dependent
# launch (an edit of d2q9.cuh); the dependent launch released by each thread
# once its loads are issued (kernel 4's choice, the redesign's first tree)
# or at its start, where the tree releases at each block's exit; kernel 32's
# columns wrapped by 64-bit remainders, as first built; and the tree's
# kernels fed by the exchanges' copies (no source edit:
# ``exchange_copies_kept``), which separates the one launch a sweep from the
# reads in place
K32_K35_DESIGNS = {
    "without PDL": {"d2q9.cuh": [("pdl ? 1u : 0u}", "0u}")]},
    "release after loads": {"shan_chen.cu": [(
        "  for (int k = 0; k < 9; ++k) f[k] = src[k * plane];\n  sc_collide",
        "  for (int k = 0; k < 9; ++k) f[k] = src[k * plane];\n  lbm::grid_release();\n"
        "  sc_collide")]},
    "release first": {"shan_chen.cu": [
        ("  lbm::grid_wait();\n", "  lbm::grid_wait();\n  lbm::grid_release();\n")]},
    "64-bit wraps": {"shan_chen.cu": [
        ("in.locate(pr, wrap_window(c0 - 1 + i % WC, C), plane)",
         "in.locate(pr, wrap_any(c0 - 1 + i % WC, C), plane)"),
        ("out.at(pd, lbm::wrap(gc + cy(k), C))", "out.at(pd, wrap_any(gc + cy(k), C))")]},
    "exchange copies kept": {}}


@contextlib.contextmanager
def exchange_copies_kept():
    """While it runs, the sharded steps that read their neighbours' lines in
    place (kernels 27, 32-35 and 37) are built and run on ``exchange_rows``' and
    ``exchange_2d``'s copies instead (``strip_parts``' views of the strips),
    as the exchanges fed them before."""
    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.kernels import sharded2d as k2d
    from lbm_tpu_torch.parallel import halo as ph

    saved = ksh.ring_rows, k2d.ring_2d
    ksh.ring_rows = ph.exchange_rows
    k2d.ring_2d = lambda grid, w: [ph.strip_parts(f, *st) for f, st in
                                   zip((f for row in grid for f in row), ph.exchange_2d(grid, w))]
    try:
        yield
    finally:
        ksh.ring_rows, k2d.ring_2d = saved


def load_parent_k32_k35(parent: Path) -> tuple:
    """The parent tree's kernels 32 and 35 with its own wrappers (the copy of
    ``parent_package``), its shan_chen.cu built by ``build_parent``.
    Returns the copy's (kernels.sharded, kernels.sharded2d)."""
    import importlib

    parent_package(parent)
    ksh_p = importlib.import_module("lbm_tpu_torch_parent.kernels.sharded")
    k2d_p = importlib.import_module("lbm_tpu_torch_parent.kernels.sharded2d")
    bind_kernels([ksh_p.HALO_SHAN_CHEN, k2d_p.HALO2D_SHAN_CHEN],
                 build_parent(parent, ("shan_chen",)))
    return ksh_p, k2d_p


def k32_k35_times(dev, card: str, parent=None, designs=False) -> dict:
    """Kernels 32 (8 shards) and 35 ((4, 2)) at K32_K35_TIMES' cases, sc/guo
    on the Shan-Chen test state: us per call under CUDA graphs (of 100
    calls at 256x256, 10 at 4096x2048), median of 3 in turns (``in_turns``),
    of this tree's step (one launch a sweep over the card's shards, the
    neighbours' lines read in place), with ``designs`` also
    ``K32_K35_DESIGNS`` (a build of d2q9.cuh without the dependent launch;
    the tree fed by the exchanges' copies) and with ``parent`` the parent
    tree's step (``load_parent_k32_k35``); beside them the launches a call
    of this tree's step and the call's bound (``sharded_bound``).  Every
    variant must give the same bits (the parent's, where there is one) over
    4 calls: it raises where they differ.  Keys (kernel, case, dtype) ->
    {variant: us}."""
    import torch

    from lbm_tpu_torch.kernels import _build
    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.kernels import sharded2d as k2d
    from lbm_tpu_torch.parallel import mesh as pm

    own = [ksh.HALO_SHAN_CHEN, k2d.HALO2D_SHAN_CHEN]
    libs = {}
    if designs:
        sources = design_sources(_build.CSRC, K32_K35_DESIGNS)
        libs = build_designs({label: files for label, files in sources.items() if files},
                             ("shan_chen",), "kernels 32 and 35", mark="shan_chen_halo")
    ksh_p, k2d_p = load_parent_k32_k35(parent) if parent is not None else (None, None)
    family = "sc sc/guo"
    kw, ops = sc_kwargs("sc", "guo"), plain_ops(family)
    out = {}
    for k, n, (R, C), s, dts in K32_K35_TIMES:
        two_d = isinstance(n, tuple)
        shards = n[0] * n[1] if two_d else n
        mesh = pm.make_mesh([dev] * shards, n if two_d else None)
        factory = "make_sharded2d_sc_step" if two_d else "make_sharded_sc_step"
        label = (f"{'sc_phase_separation ' if R == 256 else ''}{R}x{C}, "
                 f"{n if two_d else f'{n} shards'}, {s} a call")
        calls = 100 if R * C < 1 << 20 else 10
        for dt in dts:
            dtype = getattr(torch, dt)
            x = pm.shard_state(mesh, sharded_state(family, (R, C), dtype, dev))

            def build(module):
                return getattr(module, factory)(mesh, R, C, substeps=s, dtype=dtype, **kw)
            steps = {"new": build(k2d if two_d else ksh)}
            kernel = own[1] if two_d else own[0]
            before = kernel.launches
            steps["new"](x)
            torch.cuda.synchronize()
            per_call = kernel.launches - before
            for v, lib in libs.items():
                def designed(y, lib=lib, st=steps["new"]):
                    bind_kernels(own, lib)
                    try:
                        return st(y)
                    finally:
                        bind_kernels(own, None)
                steps[v] = designed
            if designs:
                with exchange_copies_kept():
                    kept = build(k2d if two_d else ksh)

                def exchanged(y, st=kept):
                    with exchange_copies_kept():
                        return st(y)
                steps["exchange copies kept"] = exchanged
            if ksh_p is not None:
                steps = {"parent": build(k2d_p if two_d else ksh_p), **steps}
            want = None
            for v, st in steps.items():
                y = x
                for _ in range(4):
                    y = st(y)
                got = y.gather()
                torch.cuda.synchronize()
                if want is None:
                    want = (v, got)
                elif not torch.equal(got, want[1]):
                    raise AssertionError(f"kernel {k} {label} {dt}: {v} differs from "
                                         f"{want[0]}'s bits")
            log(f"[6] kernel {k} {label} {dt}: {', '.join(steps)} bit for bit alike over 4 calls")
            del want, got, y
            med, runs = in_turns({v: (lambda st=st: graph_ms(st, x, calls) * 1e3)
                                  for v, st in steps.items()})
            if "parent" in med:
                med["change"] = med["new"] / med["parent"] - 1.0
            b = sharded_bound(family, (R, C), n, s, x.shards[0].element_size(), ops)
            med.update(launches_per_call=per_call, bound=b[0] * 1e3, bound_by=b[1],
                       fraction=b[0] * 1e3 / med["new"])
            out[k, label, dt] = med
            log(f"[6] {card}; kernel {k} {label} {dt} (us per call, CUDA graphs of {calls} "
                f"calls, median of 3 in turns; the bound in us a call): "
                + ", ".join(f"{v} {t!r}" for v, t in med.items()) + f" (runs {runs})")
            del x, steps
            torch.cuda.empty_cache()
    return out


# kernels 37 and 14's timed cases (kernel, label, grid, mesh or None, steps a
# call), each in both types: kernel 37 on (4, 2) at rk_rayleigh_taylor's
# launch shape and at 4096x2048, one step a call; kernel 14 at
# sc_flat_interface's launch shape, 4 steps a call, and at 4096x2048
K37_K14_TIMES = ((37, "rk_rayleigh_taylor 1024x256", (1024, 256), (4, 2), 1),
                 (37, "4096x2048", BIG, (4, 2), 1),
                 (14, "sc_flat_interface 256x128", (256, 128), None, 4),
                 (14, "4096x2048", BIG, None, 1))
# kernels 37 and 14's other designs (label -> {file: edits}), timed against
# the tree in ``k37_k14_times``.  Kernel 37: the tree's kernel fed by the
# exchange's copies (``exchange_copies_kept``, no source edit: the parent's
# copies with the tree's one launch); the tree's kernel launched a shard at a
# time (``launch_per_shard``, no source edit: the parent's 8 launches a call
# with the tree's reads in place); the masked instance for every shard in
# float32 too, which gives the mask-free one's bits on interior row ranks,
# and the branch per block on its shard's edge flag in float64 too (the tree
# branches in float32 and runs the masked instance in float64); no register
# cap (the tree caps float64 at three blocks an SM, kernel 12's occupancy);
# a cap of five blocks an SM in float32 too.  Kernel 14: its 64-bit
# remainders for every load and push, as built before; its launches without
# the dependent launch (an edit of d2q9.cuh); the dependent launch released
# by each thread once its loads are issued, where the tree releases at each
# block's exit
K37_K14_DESIGNS = {
    "exchange copies kept": {},
    "launch per shard": {},
    "masked instance in float32 too": {"rk_cg.cu": [
        ("  const IO io{L};\n  if (L.edge || sizeof(T) == 8)\n",
         "  const IO io{L};\n  if (true)\n")]},
    "branch per block in float64 too": {"rk_cg.cu": [
        ("  const IO io{L};\n  if (L.edge || sizeof(T) == 8)\n",
         "  const IO io{L};\n  if (L.edge)\n")]},
    "no register cap in float64": {"rk_cg.cu": [
        ("__launch_bounds__(mc::THREADS, sizeof(T) == 8 ? 3 : 1)\n    rk_cg_shards(",
         "__launch_bounds__(mc::THREADS)\n    rk_cg_shards(")]},
    "five blocks an SM in float32": {"rk_cg.cu": [
        ("__launch_bounds__(mc::THREADS, sizeof(T) == 8 ? 3 : 1)\n    rk_cg_shards(",
         "__launch_bounds__(mc::THREADS, sizeof(T) == 8 ? 3 : 5)\n    rk_cg_shards(")]},
    "64-bit wraps": {"shan_chen.cu": [
        ("gr = wrap_window(r0 - 1 + i / WC, R), gc = wrap_window(c0 - 1 + i % WC, C);",
         "gr = wrap_any(r0 - 1 + i / WC, R), gc = wrap_any(c0 - 1 + i % WC, C);"),
        ("fout[k * n + lbm::wrap(gr + cx(k), R) * C + lbm::wrap(gc + cy(k), C)]",
         "fout[k * n + wrap_any(gr + cx(k), R) * C + wrap_any(gc + cy(k), C)]")]},
    "without PDL": {"d2q9.cuh": [("pdl ? 1u : 0u}", "0u}")]},
    "release after loads": {"shan_chen.cu": [
        ("  lbm::load9(fin, n, gr * C + gc, f);\n",
         "  lbm::load9(fin, n, gr * C + gc, f);\n  lbm::grid_release();\n")]}}
K37_DESIGNS = ("exchange copies kept", "launch per shard", "masked instance in float32 too",
               "branch per block in float64 too", "no register cap in float64",
               "five blocks an SM in float32")
K14_DESIGNS = ("64-bit wraps", "without PDL", "release after loads")


@contextlib.contextmanager
def launch_per_shard():
    """While it runs, the batched halo kernels launch one shard at a time
    (``_build.MAX_SHARDS`` = 1: ``shard_batches`` makes a batch of each
    shard)."""
    from lbm_tpu_torch.kernels import _build

    saved = _build.MAX_SHARDS
    _build.MAX_SHARDS = 1
    try:
        yield
    finally:
        _build.MAX_SHARDS = saved


def build_k37_k14_designs() -> dict:
    """K37_K14_DESIGNS' source edits built for the card: {label: library},
    kernel 37's with csrc/rk_cg.cu, kernel 14's with csrc/shan_chen.cu."""
    from lbm_tpu_torch.kernels import _build

    sources = design_sources(_build.CSRC, {label: files for label, files in
                                           K37_K14_DESIGNS.items() if files})
    return {**build_designs({k: v for k, v in sources.items() if k in K37_DESIGNS}, ("rk_cg",),
                            "kernel 37", mark="rk_cg_shards"),
            **build_designs({k: v for k, v in sources.items() if k in K14_DESIGNS},
                            ("shan_chen",), "kernel 14", mark="shan_chen_kernel")}


def load_parent_k37_k14(parent: Path) -> tuple:
    """The parent tree's kernels 37 and 14 with its own wrappers (the copy of
    ``parent_package``), its rk_cg.cu and shan_chen.cu built by
    ``build_parent``.  Returns the copy's (kernels.sharded2d,
    kernels.shan_chen)."""
    import importlib

    parent_package(parent)
    k2d_p = importlib.import_module("lbm_tpu_torch_parent.kernels.sharded2d")
    shc_p = importlib.import_module("lbm_tpu_torch_parent.kernels.shan_chen")
    bind_kernels([k2d_p.HALO2D_RK, shc_p.SHAN_CHEN],
                 build_parent(parent, ("rk_cg", "shan_chen")))
    return k2d_p, shc_p


def k37_k14_times(dev, card: str, parent=None, designs=False) -> dict:
    """Kernels 37 (RK on (4, 2), one step a call) and 14 (Shan-Chen sc/guo)
    at K37_K14_TIMES' cases, both types: us per call under CUDA graphs (of
    100 calls at the launch shapes, 10 at 4096x2048), median of 3 in turns
    (``in_turns``), of this tree's step, with ``designs`` also
    ``K37_K14_DESIGNS`` and with ``parent`` the parent tree's step
    (``load_parent_k37_k14``); beside them the launches a call of this
    tree's step, us a launch, and the call's bound (kernel 37:
    ``sharded_bound``; kernel 14: 72 B a cell and step in float32, 144 in
    float64, against its plain version's operations).  Every variant must
    give the same bits (the parent's, where there is one) over 4 calls: it
    raises where they differ.  Keys (kernel, case, dtype) -> {variant: us}."""
    import torch

    from lbm_tpu_torch.kernels import _build
    from lbm_tpu_torch.kernels import shan_chen as shc
    from lbm_tpu_torch.kernels import sharded2d as k2d
    from lbm_tpu_torch.parallel import mesh as pm

    libs = build_k37_k14_designs() if designs else {}
    if designs:  # the tree's instances beside the designs'
        build_log = _build.build().with_suffix(".log").read_text()
        for unit, mark in (("rk_cg", "12rk_cg_shards"), ("shan_chen", "16shan_chen_kernel")):
            for name, regs, spill in ptxas_entries(build_log, f"{unit}.cu"):
                if mark in name:
                    log(f"[6] the tree's {unit}.cu: {name}: {regs} registers; {spill}")
    k2d_p, shc_p = load_parent_k37_k14(parent) if parent is not None else (None, None)
    kw = sc_kwargs("sc", "guo")
    ops = {37: plain_ops("rk"), 14: plain_ops("sc sc/guo")}
    out = {}
    for k, label, (R, C), mesh_shape, s in K37_K14_TIMES:
        calls = 100 if R * C < 1 << 20 else 10
        for dt in ("float32", "float64"):
            dtype = getattr(torch, dt)
            if k == 37:
                mesh = pm.make_mesh([dev] * (mesh_shape[0] * mesh_shape[1]), mesh_shape)
                x = pm.shard_state(mesh, sharded_state("rk", (R, C), dtype, dev))
                kernel, own = k2d.HALO2D_RK, K37_DESIGNS

                def build(module, mesh=mesh):
                    return module.make_sharded2d_rk_step(mesh, R, C, dtype=dtype, **RK)
            else:
                x = sc_state(R, C, dtype, dev, "sc", seed=15)
                kernel, own = shc.SHAN_CHEN, K14_DESIGNS

                def build(module):
                    return module.make_sc_fused_step(R, C, substeps=s, dtype=dtype, **kw)
            steps = {"new": build(k2d if k == 37 else shc)}
            before = kernel.launches
            steps["new"](x)
            torch.cuda.synchronize()
            per_call = kernel.launches - before
            for v, lib in libs.items():
                if v not in own:
                    continue

                def designed(y, lib=lib, st=steps["new"], kernel=kernel):
                    bind_kernels([kernel], lib)
                    try:
                        return st(y)
                    finally:
                        bind_kernels([kernel], None)
                steps[v] = designed
            if designs and k == 37:
                with exchange_copies_kept():
                    kept = build(k2d)

                def exchanged(y, st=kept):
                    with exchange_copies_kept():
                        return st(y)

                def per_shard(y, st=steps["new"]):
                    with launch_per_shard():
                        return st(y)
                steps["exchange copies kept"] = exchanged
                steps["launch per shard"] = per_shard
            if k2d_p is not None:
                steps = {"parent": build(k2d_p if k == 37 else shc_p), **steps}
            want = None
            for v, st in steps.items():
                y = x
                for _ in range(4):
                    y = st(y)
                got = y.gather() if k == 37 else y
                torch.cuda.synchronize()
                if want is None:
                    want = (v, got)
                elif not torch.equal(got, want[1]):
                    raise AssertionError(f"kernel {k} {label} {dt}: {v} differs from "
                                         f"{want[0]}'s bits")
            log(f"[6] kernel {k} {label} {dt}: {', '.join(steps)} bit for bit alike over 4 calls")
            del want, got, y
            med, runs = in_turns({v: (lambda st=st: graph_ms(st, x, calls) * 1e3)
                                  for v, st in steps.items()})
            if "parent" in med:
                med["change"] = med["new"] / med["parent"] - 1.0
            itemsize = 8 if dt == "float64" else 4
            if k == 37:
                b = sharded_bound("rk", (R, C), mesh_shape, s, itemsize, ops[k])[:2]
            else:
                b_ms, by = bound(18 * itemsize, ops[k], R * C, dt)
                b = (b_ms * s, by)
            med.update(launches_per_call=per_call, us_a_launch=med["new"] / per_call,
                       bound=b[0] * 1e3, bound_by=b[1], fraction=b[0] * 1e3 / med["new"])
            out[k, label, dt] = med
            log(f"[6] {card}; kernel {k} {label}, {s} a call, {dt} (us per call, CUDA graphs "
                f"of {calls} calls, median of 3 in turns; the bound in us a call): "
                + ", ".join(f"{v} {t!r}" for v, t in med.items()) + f" (runs {runs})")
            del x, steps
            torch.cuda.empty_cache()
    return out


def collision_ops(kind) -> float:
    """Operations per cell of one step of ``kind``'s plain single-device step
    (``ops_per_cell`` at 64x64 on the CPU, float32, from the collision's
    phase-4 state)."""
    import torch

    from lbm_tpu_torch.kernels import collide_stream

    f32, cpu = torch.float32, torch.device("cpu")
    make_fn, _, make_state = k27_collisions()[kind]
    return ops_per_cell(collide_stream.make_fused_step(64, 64, make_fn(f32), f32),
                        make_state(64, 64, f32, cpu, 1))


def parent_first_sweep(ksh_p, k2d_p, x, grid, R, s, fn):
    """The parent tree's first sweep of an s-step call on each shard of the
    sharded state ``x`` (``grid``: its rows x cols blocks, None for row
    shards), each shard one launch of its kernel 27 or 34 from halos
    exchanged once, outside the timing; returns ``sweep(y) -> y``, or None
    where the parent already runs a call in one launch over the card's
    shards (its ``launch_collide_shards``: no sweep of its own to time)."""
    import ctypes

    import torch

    from lbm_tpu_torch.kernels import _build
    from lbm_tpu_torch.parallel import halo as ph

    if hasattr(ksh_p, "launch_collide_shards"):
        return None
    kind, doubles, (i0, i1) = fn.halo_kernel
    params = _build.c_doubles(doubles)
    shards = x.shards
    n = len(shards)
    if grid is None:
        kernel, names = ksh_p.HALO_COLLIDE_STREAM[kind], ksh_p.GEOM
        R_loc = R // n
        halos = ph.exchange_rows(shards, ksh_p.HALO)
        plans = [ksh_p._sweep_geoms(f, top, bot, i * R_loc, i in (0, n - 1), R, substeps=s,
                                    rows_per_sweep=1, walls=False)
                 for i, (f, (top, bot)) in enumerate(zip(shards, halos))]
    else:
        kernel, names = k2d_p.HALO2D_COLLIDE_STREAM[kind], k2d_p.GEOM
        halos = ph.exchange_2d(grid, ksh_p.HALO)
        plans = [k2d_p._sweep_geoms(f, *strips, substeps=s, rows_per_sweep=1, walls=False,
                                    off=(0, 0), shape=(0, 0), edge=False)
                 for f, strips in zip(shards, halos)]
    f64 = int(shards[0].dtype == torch.float64)

    def sweep(y, plans=plans, halos=halos):  # the launches read the halos: held here
        for _, geoms, _ in plans:
            kernel.launch((ctypes.c_longlong * len(names))(*geoms[0]), params, i0, i1, f64,
                          _build.stream_handle(shards[0]))
        return y

    return sweep


# What each probe build of csrc/rk_cg.cu (this tree's and a --parent tree's
# tile) leaves out: edits of a copy of the source, (text, its replacement).
# Stage 1 alone (r_rho / rho on the window; on the staged tile with stage
# 0's copies of the ring's planes), stages 1 and 2 (no pull), the output
# stores (behind a test no value passes), the collisions (replaced by a
# read of the cell's planes and one window scalar).
RK_PROBES = {
    "whole": [],
    "stage 1 alone": [("  // stage 2: the collision on the tile plus a 1-cell ring",
                       "  return;\n  // stage 2: the collision on the tile plus a 1-cell ring")],
    "stages 1 and 2": [("  // stage 3: pull, add the colours",
                        "  return;\n  // stage 3: pull, add the colours")],
    "no pull stores": [("    q[k * plane] = r + b;",
                        "    if (r + b == T(-1.5e30)) q[k * plane] = r + b;"),
                       ("  q[9 * plane] = r_sum;\n  q[10 * plane] = b_sum;",
                        "  if (r_sum == T(-1.5e30)) q[9 * plane] = r_sum + b_sum;")],
    "no collision": [("    collide_cell<T, EDGE>(q, plane, 0, p, s_af, w, gr, gc, R, cols, coll);",
                      "    for (int k = 0; k < 18; ++k)\n"
                      "      coll[k] = q[(k % 11) * plane] * s_af[w.slot(gr, gc)];")]}


# Other designs of this tree's kernel 12, as edits of a copy of
# csrc/rk_cg.cu: the tile staged by cp.async in float32 too, or loading
# into registers in float64 too; the window loop of stages 0-1 unrolled 3
# times or the collision loop twice (the loads of a thread's cells issued
# together); every copy of a staged tile in one group
# (stage 1 waits for the ring's planes too); the 5x5 stencils on taps
# computed once a cell (w.slot's row and column parts) instead of w.slot at
# every tap.  Built whole and held to this tree's bits (``rk_breakdown``).
RK_DESIGNS = {
    "staged in float32 too": [("bool STAGED = sizeof(T) == 8;", "bool STAGED = true;")],
    "loads in float64 too": [("bool STAGED = sizeof(T) == 8;", "bool STAGED = false;")],
    "stage 1 unrolled": [
        ("    for (int i = tid; i < Win::ROWS * Win::MAIN; i += mc::THREADS) {",
         "#pragma unroll 3\n    for (int i = tid; i < Win::ROWS * Win::MAIN; i += mc::THREADS) {")],
    "stage 2 unrolled": [
        ("  for (int i = tid; i < RING_N; i += mc::THREADS) {\n    const int ri",
         "#pragma unroll 2\n  for (int i = tid; i < RING_N; i += mc::THREADS) {\n    const int ri")],
    "one copy group": [
        ("    lbm::async_commit();\n    const int64_t nrows", "    const int64_t nrows"),
        ("    lbm::async_wait_prior<1>();", "    lbm::async_wait_all();"),
        ("    lbm::async_wait_all();\n  } else {", "  } else {")],
    "taps once a cell": [
        ("// The collision of one cell (kernels/rk.py::make_collide)",
         "template <bool EDGE, typename Cols>\n"
         "__device__ __forceinline__ mc::Taps window_taps(const Win& w, int64_t gr, int64_t gc,\n"
         "                                                int64_t R, const Cols cols) {\n"
         "  mc::Taps t;\n"
         "#pragma unroll\n"
         "  for (int a = 0; a < 5; ++a) {\n"
         "    const int64_t rr = EDGE ? mc::clamp_index(gr + a - 2, R) : gr + a - 2;\n"
         "    t.row[a] = static_cast<int>((rr - (w.r0 - H)) * Win::COLS);\n"
         "  }\n"
         "#pragma unroll\n"
         "  for (int b = 0; b < 5; ++b) {\n"
         "    const int64_t tc = cols.tap(gc, b - 2);\n"
         "    const int64_t rel = tc - (w.c0 - H);\n"
         "    t.col[b] = static_cast<int>(rel >= 0 && rel < Win::MAIN ? rel\n"
         "                                                             : Win::MAIN + (tc - w.seam_lo));\n"
         "  }\n"
         "  return t;\n"
         "}\n\n"
         "// The collision of one cell (kernels/rk.py::make_collide)"),
        ("  const T Fx = mc::corr5<0, T, H, EDGE>(s_af, w, gr, gc, R, cols);\n"
         "  const T Fy = mc::corr5<1, T, H, EDGE>(s_af, w, gr, gc, R, cols);",
         "  const mc::Taps taps = window_taps<EDGE>(w, gr, gc, R, cols);\n"
         "  const T Fx = mc::corr5_at<0>(s_af, taps);\n"
         "  const T Fy = mc::corr5_at<1>(s_af, taps);")]}


def rk_probe_sources(csrc: Path, probes: dict = RK_PROBES) -> dict:
    """label -> csrc/rk_cg.cu of the tree ``csrc`` with the edits of each
    entry of ``probes``; an edit that no longer finds its text stops the
    run."""
    text = (csrc / "rk_cg.cu").read_text()
    out = {}
    for label, edits in probes.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"probe {label!r} of {csrc}/rk_cg.cu: the source no longer "
                                   f"holds {old!r}")
            src = src.replace(old, new)
        out[label] = src
    return out


def rk_breakdown(dev, card: str, parent=None) -> dict:
    """Kernel 12 whole and with parts left out (``RK_PROBES``), this tree's
    and, with ``parent``, the parent tree's, and this tree's other designs
    (``RK_DESIGNS``, built whole): each copy built alone with its headers
    into a library of its own (namespace lbm renamed, as ``build_parent``
    does), called through ctypes on one state and one output buffer at
    RK_TIMES' shapes in both types, us per call under CUDA graphs of 100
    calls, every build of a shape and type
    in turns.  Each build's output after one step must equal this tree's
    whole build's bits (a probe's need not).  Keys (tree, probe, shape,
    dtype) -> us."""
    import ctypes

    import torch

    from lbm_tpu_torch.kernels import _build, rk

    nvcc = _build.find_nvcc()
    trees = {"this tree": ROOT / "lbm_tpu_torch" / "csrc"}
    if parent is not None:
        trees["parent"] = parent / "lbm_tpu_torch" / "csrc"
    work = Path(tempfile.mkdtemp(prefix="rk-probes-"))
    atexit.register(shutil.rmtree, work, True)
    builds = [(tree, label, src, csrc) for tree, csrc in trees.items()
              for label, src in rk_probe_sources(csrc).items()]
    builds += [(label, "whole", src, trees["this tree"])
               for label, src in rk_probe_sources(trees["this tree"], RK_DESIGNS).items()]
    jobs = {}
    for b_i, (tree, label, src, csrc) in enumerate(builds):
        d = work / f"b{b_i}"
        d.mkdir()
        ns = f"lbm_p{b_i}"
        for f in csrc.iterdir():
            if f.suffix == ".cuh":
                (d / f.name).write_text(f.read_text().replace("namespace lbm {", f"namespace {ns} {{")
                                        .replace("lbm::", f"{ns}::"))
        (d / "rk_cg.cu").write_text(src.replace("namespace lbm {", f"namespace {ns} {{")
                                    .replace("lbm::", f"{ns}::"))
        so = d / "librk.so"
        jobs[tree, label] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *_build.UNIT_FLAGS["rk_cg"], "-shared", "-o", str(so),
             str(d / "rk_cg.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in jobs.items():
        text = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the probe {key}:\n{text}")
        lib = ctypes.CDLL(str(so))
        lib.lbm_rk_cg.argtypes = rk.RK_CG.argtypes
        lib.lbm_rk_cg.restype = ctypes.c_int
        libs[key] = lib.lbm_rk_cg
    params = _build.c_doubles(rk.kernel_params(**RK))
    out = {}
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).removeprefix("torch.")
        for R, C in RK_TIMES:
            S = rk_state(R, C, dtype, dev)
            dst = torch.empty_like(S)

            def launch(fn, out, S=S, R=R, C=C, f64=int(dtype == torch.float64)):
                err = fn(S.data_ptr(), out.data_ptr(), R, C, params, f64, _build.stream_handle(S))
                if err:
                    raise RuntimeError(f"probe launch failed: cudaError_t {err}")

            def call(fn):
                def step(x):
                    launch(fn, dst)
                    return x
                return lambda: graph_ms(step, S) * 1e3
            want = torch.empty_like(S)
            launch(libs["this tree", "whole"], want)
            for (tree, label), fn in libs.items():
                if label == "whole":
                    launch(fn, dst)
                    if not torch.equal(dst, want):
                        raise AssertionError(f"kernel 12 {R}x{C} {dt}: {tree}'s build differs "
                                             f"from this tree's bits")
            med, runs = in_turns({key: call(fn) for key, fn in libs.items()})
            for (tree, label), us in med.items():
                out[tree, label, f"{R}x{C}", dt] = us
                log(f"[6] {card}; kernel 12 breakdown {R}x{C} {dt}, {tree}, {label}: {us!r} us "
                    f"per call (CUDA graphs of 100, median of 3 in turns; runs "
                    f"{runs[tree, label]})")
            del S, dst, want
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description="Drive lbm_tpu_torch once on one NVIDIA card.")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier tree whose MRT-CG engine and IBM forcing "
                         "kernels (16, 19-21) phase 6 (or --ibm-breakdown) times the current "
                         "ones against, in turns (e.g. a git archive of it)")
    ap.add_argument("--engine-sweep", action="store_true",
                    help="build, then only time the MRT-CG tile and strip engines against each "
                         "other over grid sizes and shard counts (engine_sweep) and print the "
                         "table as a JSON line")
    ap.add_argument("--rk-breakdown", action="store_true",
                    help="build kernel 12 whole and with parts left out (this tree's design "
                         "and, with --parent, the parent's) and as this tree's other designs "
                         "(RK_DESIGNS), time each under CUDA graphs (rk_breakdown), print the "
                         "table as a JSON line, and stop")
    ap.add_argument("--k4-k33", action="store_true",
                    help="build, then only time kernels 4 and 33 against their other designs "
                         "(and, with --parent, the parent's), holding each to the same bits "
                         "(k4_k33_times), print the table as a JSON line, and stop")
    ap.add_argument("--k2-k9", action="store_true",
                    help="build, then only time kernels 2 and 9 against their other designs "
                         "(K2_K9_DESIGNS) and, with --parent, the parent's, holding each to "
                         "the same bits (k2_k9_times), print the table as a JSON line, and "
                         "stop")
    ap.add_argument("--k27-k34", action="store_true",
                    help="build, then only time kernels 27 and 34 against their other designs "
                         "(K27_K34_DESIGNS), the exchange alone and, with --parent, the "
                         "parent's step and its first sweep alone, holding each to the same "
                         "bits (k27_k34_times), print the table as a JSON line, and stop")
    ap.add_argument("--k32-k35", action="store_true",
                    help="build, then only time kernels 32 and 35 against their other designs "
                         "(K32_K35_DESIGNS) and, with --parent, the parent's, holding each to "
                         "the same bits (k32_k35_times), print the table as a JSON line, and "
                         "stop")
    ap.add_argument("--k37-k14", action="store_true",
                    help="build, then only time kernels 37 and 14 against their other designs "
                         "(K37_K14_DESIGNS) and, with --parent, the parent's, holding each to "
                         "the same bits (k37_k14_times), print the table as a JSON line, and "
                         "stop")
    ap.add_argument("--k23-k24", action="store_true",
                    help="build, then only time kernels 23 and 24 (all four instances) against "
                         "their other designs (K23_K24_DESIGNS) and, with --parent, the "
                         "parent's (and kernel 28 against the parent's), holding each to the "
                         "same bits, with each instance's loss against its bound "
                         "(k23_k24_times), print the table as a JSON line, and stop")
    ap.add_argument("--k17-k30", action="store_true",
                    help="build, then only time kernels 17 and 30 against their other designs "
                         "(K17_DESIGNS, K30_DESIGNS) and, with --parent, the parent's, holding "
                         "each to the same bits, with each launch shape's loss against its "
                         "bound (k17_k30_times), print the table as a JSON line, and stop")
    ap.add_argument("--ibm-breakdown", action="store_true",
                    help="build kernels 16 and 19-21 whole and with parts left out, time "
                         "each and an empty one-block kernel under CUDA graphs "
                         "(ibm_breakdown), print the table as a JSON line, and stop")
    args = ap.parse_args(argv)
    parent = args.parent

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2
    if not (ROOT / "lbm_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(no lbm_tpu_torch/csrc)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from lbm_tpu_torch.kernels import (_build, bgk, cavity, channel, collide_stream,
                                       csf_droplet, cylinder, les, mrtcg, power_law, rk,
                                       sediment, shan_chen, trt)
    from lbm_tpu_torch.kernels import d3q19 as kd
    from lbm_tpu_torch.kernels import ibm as kibm
    from lbm_tpu_torch.kernels import sharded as ksh
    from lbm_tpu_torch.kernels import sharded2d as k2d
    from lbm_tpu_torch.kernels import moving_ibm as kmov
    from lbm_tpu_torch.models import kbc
    from lbm_tpu_torch.models.mrt_cg import phase_field
    from lbm_tpu_torch.models.trt import omega_minus_from_magic
    from lbm_tpu_torch.scenes import multiphase as mp
    from lbm_tpu_torch.scenes import shan_chen as scs
    from lbm_tpu_torch.ops import d2q9
    from lbm_tpu_torch.ops.ibm import IBM
    from lbm_tpu_torch.scenes import channel as chs
    from lbm_tpu_torch.scenes import obstacles as obs
    from lbm_tpu_torch.scenes import cavity as cavs
    from lbm_tpu_torch.scenes import thermal as ths
    from lbm_tpu_torch.scenes import ulbm
    from lbm_tpu_torch.scenes.channel import TAU_DEFAULT, horizontal_poiseuille

    f32, f64 = torch.float32, torch.float64
    k1, k2 = collide_stream.COLLIDE_STREAM_BGK, channel.CHANNEL_BGK
    k3, k4, k5 = collide_stream.COLLIDE_STREAM_KBC, channel.CHANNEL_KBC, les.COLLIDE_STREAM_LES
    k6, k7, k8 = mrtcg.MRTCG_REDUCED, mrtcg.MRTCG_SPLIT, mrtcg.MRTCG_FULL
    k9, k10 = channel.CHANNEL_VARIANT, trt.COLLIDE_STREAM_TRT
    k11 = power_law.COLLIDE_STREAM_POWER_LAW
    k12, k13, k14 = rk.RK_CG, csf_droplet.CSF_DROPLET, shan_chen.SHAN_CHEN
    k15, k16, k17 = cylinder.CYLINDER, kibm.IBM_FORCING, sediment.SEDIMENT
    k18, k19, k20, k21 = (cylinder.BOX, kmov.MOVING_FORCING, kmov.MOVING_ROT,
                          kmov.MOVING_BODIES)
    counted = {"collide_stream_bgk": k1, "channel_bgk": k2, "collide_stream_kbc": k3,
               "channel_kbc": k4, "collide_stream_les": k5, "mrtcg_reduced": k6,
               "mrtcg_split": k7, "mrtcg_full": k8, "channel_variant": k9,
               "collide_stream_trt": k10, "collide_stream_power_law": k11, "rk_cg": k12,
               "csf_droplet": k13, "shan_chen": k14, "cylinder": k15, "ibm_forcing": k16,
               "sediment": k17, "box": k18, "moving_forcing": k19, "moving_rot": k20,
               "moving_bodies": k21, "cavity": cavity.CAVITY,
               **{name: thermal_kernel(name)[2] for name in THERMAL_NAMES},
               "d3q19": kd.D3Q19, "d3q19_lanes": kd.D3Q19_LANES,
               **{f"halo_{kind}": k for kind, k in ksh.HALO_COLLIDE_STREAM.items()},
               "halo_thermal": ksh.HALO_THERMAL, "halo_mrtcg_reduced": ksh.HALO_MRTCG,
               "halo_rk": ksh.HALO_RK, "halo_mrtcg_full": ksh.HALO_MRTCG_FULL,
               "halo_shan_chen": ksh.HALO_SHAN_CHEN, "halo_d3q19": ksh.HALO_D3Q19,
               **{f"halo2d_{kind}": k for kind, k in k2d.HALO2D_COLLIDE_STREAM.items()},
               "halo2d_shan_chen": k2d.HALO2D_SHAN_CHEN, "halo2d_thermal": k2d.HALO2D_THERMAL,
               "halo2d_rk": k2d.HALO2D_RK, "halo2d_mrtcg_full": k2d.HALO2D_MRTCG_FULL,
               "mrtcg_reduced_lanes": mrtcg.MRTCG_REDUCED_LANES}
    markers = str(ROOT / "configs" / "cylinder-markers.toml")
    trt_minus = omega_minus_from_magic(TRT_OMEGA)
    VARIANTS = variants()
    card = nvidia_smi("name,power.limit")

    # 1. toolchain
    log(f"[1] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    log(f"[1] device {torch.cuda.get_device_name(0)}  capability "
        f"{torch.cuda.get_device_capability(0)}  count {torch.cuda.device_count()}")
    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    log(f"[1] nvcc {nvcc}: {ver[-1]}")
    try:
        import triton
        log(f"[1] triton {triton.__version__} imports")
    except ImportError as e:
        log(f"[1] triton does not import: {e}")
    log(f"[1] nvidia-smi name,power.limit: {card}")

    if args.ibm_breakdown:
        print(json.dumps({"ibm_breakdown": ibm_breakdown(dev, card, parent), "card": card}),
              flush=True)
        return 0
    if args.rk_breakdown:
        table = rk_breakdown(dev, card, parent)
        print(json.dumps({"rk_breakdown": [[*key, us] for key, us in table.items()],
                          "card": card}), flush=True)
        return 0
    if args.k4_k33:
        table = k4_k33_times(dev, card, parent, designs=True)
        print(json.dumps({"k4_k33": [[*key, us] for key, us in table.items()], "card": card}),
              flush=True)
        return 0
    if args.k2_k9:
        table = k2_k9_times(dev, card, parent, designs=True)
        print(json.dumps({"k2_k9": [[*key, us] for key, us in table.items()], "card": card}),
              flush=True)
        return 0
    if args.k27_k34:
        table = k27_k34_times(dev, card, parent, designs=True)
        print(json.dumps({"k27_k34": [[*key, us] for key, us in table.items()], "card": card}),
              flush=True)
        return 0
    if args.k32_k35:
        table = k32_k35_times(dev, card, parent, designs=True)
        print(json.dumps({"k32_k35": [[*key, us] for key, us in table.items()], "card": card}),
              flush=True)
        return 0
    if args.k37_k14:
        table = k37_k14_times(dev, card, parent, designs=True)
        print(json.dumps({"k37_k14": [[*key, us] for key, us in table.items()], "card": card}),
              flush=True)
        return 0
    if args.k23_k24:
        table = k23_k24_times(dev, card, parent, designs=True)
        print(json.dumps({"k23_k24": [[*key, us] for key, us in table.items()], "card": card}),
              flush=True)
        return 0
    if args.k17_k30:
        table = k17_k30_times(dev, card, parent, designs=True)
        print(json.dumps({"k17_k30": [[*key, us] for key, us in table.items()], "card": card}),
              flush=True)
        return 0

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"[2] built {lib.relative_to(ROOT)} from lbm_tpu_torch/csrc "
        f"({' '.join(_build.NVCC_FLAGS)}) in {time.perf_counter() - t0:.3f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"[2]   {line.strip()}")
    # kernels 25-26: the four instances of csrc/d3q19.cu's single-device step
    # (float and double, planes and lanes); kernels 31-38: their instances
    # (type x mode, collision or eos x forcing, x edge; kernel 36 one a
    # type, its shards' walls a parameter); kernel 39: type x mode; with their
    # registers and spills (a mark is a length-prefixed part of the mangled
    # name, so that "shan_chen_halo" does not also take "shan_chen_halo2d")
    build_log = lib.with_suffix(".log").read_text()
    for kernel, units, mark, expected in (
            ("25-26", ("d3q19",), "d3q19_kernel", 4),
            (31, ("mrtcg_full",), "7ShardIO", 16), (32, ("shan_chen",), "14shan_chen_halo", 8),
            (33, ("d3q19",), "d3q19_halo", 2),
            ("27 and 34, the tile engine", tuple(f"collide_stream_{k}" for k in ksh.COLLIDE_KINDS),
             "10tile_steps", 16),
            ("27 and 34, one step", tuple(f"collide_stream_{k}" for k in ksh.COLLIDE_KINDS),
             "9push_step", 16),
            (35, ("shan_chen",), "16shan_chen_halo2d", 8),
            ("23-24", ("thermal",), "14thermal_kernel", 8),
            (36, ("thermal",), "21thermal_halo2d_kernel", 2),
            (30, ("rk_cg",), "14rk_halo_shards", 2), (37, ("rk_cg",), "12rk_cg_shards", 2),
            (38, ("mrtcg_full",), "9Shard2DIO", 16), (17, ("sediment",), "15sediment_kernel", 4),
            (39, ("mrtcg_reduced",), "6LaneIO", 8)):
        found = [e for u in units for e in ptxas_entries(build_log, f"{u}.cu") if mark in e[0]]
        for name, regs, spill in found:
            log(f"[2] kernel(s) {kernel}: {name}: {regs} registers; {spill}")
        if len(found) != expected:
            raise AssertionError(f"kernel(s) {kernel}: ptxas reports {len(found)} instances, "
                                 f"not {expected}")
    # the MRT-CG engines (kernels 6-8, 29, 31, 38, 39: 31, 38 and 39 above
    # count both engines' instances): every instance's registers, local
    # bytes, shared memory and resident blocks per SM as the card reports
    # them, and ptxas' spill line of each of the 80 kernels
    engine_rows = engine_instances()
    spills = [e for u in ENGINE_UNITS for e in ptxas_entries(build_log, f"{u}.cu")
              if "strip_kernel" in e[0] or "tile_kernel" in e[0]]
    if (len(engine_rows) != 40 or len(spills) != 80
            or any("0 bytes spill stores" not in e[2] for e in spills)
            or any(k[1] != 0 or k[4] < 1 for r in engine_rows for k in r[4:])):
        raise AssertionError(f"the MRT-CG engines: {len(engine_rows)} instances (not 40), "
                             f"{len(spills)} kernels (not 80), or one spills or fits no SM")
    # kernel 12: its flat instances as the card reports them
    import ctypes
    describe = _build.library().lbm_rk_describe
    describe.argtypes, describe.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    for is_f64 in (0, 1):
        out = (ctypes.c_longlong * 5)()
        rc = describe(is_f64, out)
        if rc != 0 or out[1] != 0 or out[4] < 1:
            raise AssertionError(f"kernel 12 (float64 {bool(is_f64)}): cudaError_t {rc}, "
                                 f"{out[1]} local bytes, {out[4]} blocks per SM")
        log(f"[2] kernel 12 {'float64' if is_f64 else 'float32'}: {out[0]} registers; {out[1]} "
            f"local bytes a thread; {out[2]} B shared; {out[3]} threads; {out[4]} resident "
            f"blocks per SM")
    # kernel 30's instances (one launch a call over a card's row shards) and
    # kernel 17's at the grids phase 5 and phase 6 launch it on, as the card
    # reports them
    describe30 = _build.library().lbm_rk_halo_describe
    describe30.argtypes, describe30.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    for is_f64 in (0, 1):
        out = (ctypes.c_longlong * 5)()
        rc = describe30(is_f64, out)
        if rc != 0 or out[1] != 0 or out[4] < 1:
            raise AssertionError(f"kernel 30 (float64 {bool(is_f64)}): cudaError_t {rc}, "
                                 f"{out[1]} local bytes, {out[4]} blocks per SM")
        log(f"[2] kernel 30 {'float64' if is_f64 else 'float32'}: {out[0]} registers; {out[1]} "
            f"local bytes a thread; {out[2]} B shared; {out[3]} threads; {out[4]} resident "
            f"blocks per SM")
    k17_wave = {}
    for R, C in K17_TIMES:
        for is_f64 in (0, 1):
            out = sediment_describe(R * C, is_f64)
            k17_wave[R, C, is_f64] = bool(out[5])
            log(f"[2] kernel 17 {R}x{C} {'float64' if is_f64 else 'float32'}: {out[0]} "
                f"registers; {out[1]} local bytes a thread; {out[2]} threads a block; {out[3]} "
                f"resident blocks per SM; {out[4]} blocks; one wave (a dependent launch): "
                f"{bool(out[5])}; {out[6]}-bit indices")
    if args.engine_sweep:
        print(json.dumps({"engine_sweep": engine_sweep(dev, card, engine_rows),
                          "card": card}), flush=True)
        return 0

    # 3. the periodic kernels against their plain versions
    err1 = hold_periodic(
        "[3] kernel 1",
        lambda R, C, dt, n: bgk.make_fused_step(R, C, OMEGA, dt, substeps=n),
        lambda R, C, dt, n: collide_stream.make_fused_step(
            R, C, bgk.bgk_collide_fn(OMEGA, dt), dt, substeps=n),
        [(f32, BIG, 1), (f32, BIG, 8), (f64, (1024, 512), 1), (f64, (1024, 512), 8),
         (f64, (21, 21), 8), (f64, (100, 100), 8), (f64, (101, 101), 8)],
        dev, seed=0, noisy=False)
    err3 = {}
    for gamma_impl, cases in (
            ("factored", [(f32, BIG, 1), (f32, BIG, 8), (f64, (1024, 512), 8),
                          (f64, (128, 128), 8)]),
            ("direct", [(f32, BIG, 1), (f64, (128, 128), 8)])):
        e = hold_periodic(
            f"[3] kernel 3 ({gamma_impl} gamma)",
            lambda R, C, dt, n, g=gamma_impl: collide_stream.make_kbc_fused_step(
                R, C, OMEGA, dt, substeps=n, gamma_impl=g),
            lambda R, C, dt, n, g=gamma_impl: collide_stream.make_fused_step(
                R, C, collide_stream.kbc_collide_fn(OMEGA, g), dt, substeps=n),
            cases, dev, seed=1000)
        for dt, v in e.items():
            err3[dt] = max(err3.get(dt, 0.0), v)
    err5 = hold_periodic(
        "[3] kernel 5",
        lambda R, C, dt, n: les.make_les_fused_step(R, C, dtype=dt, substeps=n, **LES),
        lambda R, C, dt, n: collide_stream.make_fused_step(
            R, C, les.les_collide_fn(dtype=dt, **LES), dt, substeps=n),
        [(f32, BIG, 1), (f32, BIG, 8), (f64, (128, 128), 8)], dev, seed=2000)

    # the MRT-CG kernels 6-8, both modes, from the scenes' initial states
    mrt_cases = {
        ("reduced", False): [(f32, BIG, 1, False), (f32, BIG, 8, False),
                             (f64, (256, 128), 8, False), (f64, (100, 100), 8, True),
                             (f64, (21, 13), 8, False)],
        ("reduced", True): [(f32, BIG, 1, False), (f32, BIG, 8, False),
                            (f64, (256, 128), 8, False), (f64, (21, 13), 8, False)],
        ("split", False): [(f32, BIG, 1, False), (f64, (256, 128), 1, False),
                           (f64, (100, 100), 1, True)],
        ("split", True): [(f32, BIG, 1, False), (f64, (256, 128), 1, False),
                          (f64, (100, 100), 1, False)],
        ("full", False): [(f32, BIG, 1, False), (f64, (256, 128), 4, False),
                          (f64, (21, 13), 4, False)],
        ("full", True): [(f32, BIG, 1, False), (f64, (256, 128), 4, False),
                         (f64, (21, 13), 4, False)],
    }
    err_mrt = {}
    for (layout, csf), cases in mrt_cases.items():
        kernel = {"reduced": 6, "split": 7, "full": 8}[layout]
        e = hold_mrtcg(f"[3] kernel {kernel}", layout, csf, cases, dev)
        for dt, v in e.items():
            err_mrt.setdefault(layout, {})
            err_mrt[layout][dt] = max(err_mrt[layout].get(dt, 0.0), v)
        torch.cuda.empty_cache()
    # the plan gives 4096x2048 to the strip engine (but in float32
    # perturbation mode with 18 output planes) and the small grids to the
    # tile: each engine forced, every layout and mode, at a ragged grid
    for engine in ENGINES:
        force_engine(engine)
        for layout, csf in mrt_cases:
            kernel = {"reduced": 6, "split": 7, "full": 8}[layout]
            n = 1 if layout == "split" else 2
            e = hold_mrtcg(f"[3] kernel {kernel} on the {engine} engine", layout, csf,
                           [(f32, (515, 387), n, False), (f64, (100, 100), n, False)], dev)
            for dt, v in e.items():
                err_mrt[layout][dt] = max(err_mrt[layout][dt], v)
    force_engine(None)

    # reduced^(T-1) then the split step == the full step T times
    # (lbm_tpu tests/test_mrtcg_pallas.py:137-206), f64 at 256x128, T = 8:
    # 1e-12 in the perturbation mode; in CSF mode lbm_tpu's own 1e-6 (the
    # two layouts round rho differently, and the normal turns that into a
    # noise direction where grad(psi) vanishes) with each colour's mass at
    # 1e-12 relative
    for csf in (False, True):
        S = mrtcg_state(256, 128, f64, dev, csf)
        full, _ = mrtcg_steps("full", 256, 128, f64, csf)
        red_step, _ = mrtcg_steps("reduced", 256, 128, f64, csf)
        split, _ = mrtcg_steps("split", 256, 128, f64, csf)
        G = reduced_input(S, csf)
        for _ in range(7):
            G = red_step(G)
        for _ in range(8):
            S = full(S)
        out = split(G)
        torch.cuda.synchronize()
        err = (out - S).abs().max().item()
        mass = max(abs(out[a:a + 9].sum().item() / S[a:a + 9].sum().item() - 1.0)
                   for a in (0, 9))
        limit = 1e-6 if csf else 1e-12
        log(f"[3] reduced x7 + split == full x8, {'CSF' if csf else 'perturbation'} "
            f"256x128 float64: max_abs_err={err!r} (limit {limit!r}), colour mass "
            f"rel diff={mass!r} (limit 1e-12)")
        if not (err <= limit and mass <= 1e-12):
            raise AssertionError("the reduced and full MRT-CG kernels disagree")

    # kernel 10 (TRT) on noisy states, bench.py's rates
    err10 = hold_periodic(
        "[3] kernel 10",
        lambda R, C, dt, n: trt.make_trt_fused_step(
            R, C, omega_plus=TRT_OMEGA, omega_minus=trt_minus, dtype=dt, substeps=n),
        lambda R, C, dt, n: collide_stream.make_fused_step(
            R, C, trt.trt_collide_fn(TRT_OMEGA, trt_minus, dt), dt, substeps=n),
        [(f32, BIG, 1), (f32, BIG, 8), (f64, (128, 128), 8)], dev, seed=3000)

    # kernel 11 (power law): bench.py's state at 4096x2048, and its three
    # branches on a noisy sheared state at 128x128 (tests/test_power_law.py)
    err11 = {}
    for dtype, (R, C), steps, n, sigma_y, noisy in (
            (f32, BIG, 1, 0.5, 0.0, None), (f32, BIG, 8, 0.5, 0.0, None),
            (f64, (128, 128), 8, 0.5, 0.0, 1), (f64, (128, 128), 8, 1.5, 0.0, 2),
            (f64, (128, 128), 8, 0.8, 5e-4, 3)):
        f = shear_state(R, C, dtype, dev, noisy)
        kw = dict(cons_K=PLAW["cons_K"], n=n, sigma_y=sigma_y)
        got = power_law.make_power_law_fused_step(R, C, dtype=dtype, substeps=steps, **kw)(f)
        want = collide_stream.make_fused_step(
            R, C, power_law.power_law_collide_fn(tau_min=0.52, tau_max=50.0, iters=8,
                                                 dtype=dtype, **kw), dtype, steps)(f)
        e = compare(f"[3] kernel 11 n={n} sigma_y={sigma_y} {R}x{C} {dtype} "
                    f"{steps} step(s)", got, want, dtype)
        err11[dtype] = max(err11.get(dtype, 0.0), e)
        del f, got, want
    torch.cuda.empty_cache()

    # kernel 12 (RK) from rk_rayleigh_taylor's initial state; kernel 13 (CSF
    # droplet) from csf_static_droplet's at radius min(R, C)/4; kernel 14
    # (Shan-Chen) on noisy states in its four eos/forcing instances
    err12 = hold_steps(
        "[3] kernel 12", lambda R, C, dt, n: rk.make_rk_fused_step(
            R, C, dtype=dt, substeps=n, **RK),
        lambda: rk.make_plain_step(**RK), rk_state,
        [(f32, BIG, 1), (f32, BIG, 8), (f32, (1024, 256), 8), (f64, (1024, 256), 8)], dev)
    torch.cuda.empty_cache()
    red13, blue13 = csf_drop_colours()
    err13 = hold_steps(
        "[3] kernel 13", lambda R, C, dt, n: csf_droplet.make_csf_droplet_fused_step(
            R, C, red13, blue13, 0.1, dtype=dt, substeps=n),
        lambda: csf_droplet.make_plain_step(red13, blue13, 0.1), csf_drop_state,
        [(f32, BIG, 3), (f64, (100, 100), 5), (f64, (41, 41), 5)], dev)
    torch.cuda.empty_cache()
    err14 = {}
    for eos, forcing in SC_INSTANCES:
        kw = sc_kwargs(eos, forcing)
        e = hold_steps(
            f"[3] kernel 14 {eos}/{forcing}", lambda R, C, dt, n, kw=kw:
            shan_chen.make_sc_fused_step(R, C, dtype=dt, substeps=n, **kw),
            lambda kw=kw: shan_chen.make_plain_step(**kw),
            lambda R, C, dt, d, eos=eos: sc_state(R, C, dt, d, eos, seed=R + C),
            [(f32, BIG, 4), (f32, (256, 256), 4), (f32, (256, 128), 4),
             (f64, (128, 128), 4)], dev)
        for dt, v in e.items():
            err14[dt] = max(err14.get(dt, 0.0), v)
    torch.cuda.empty_cache()

    # 4. the channel kernels against their plain versions, 10 steps
    tau, rho_in = TAU_DEFAULT, 1.001  # the Poiseuille tau; a 0.1% pressure drop
    err2, err4 = {}, {}
    for family, errs, cases in (
            ("bgk", err2, [(f32, BIG), (f64, (21, 21)), (f64, (101, 101))]),
            ("kbc", err4, [(f32, BIG), (f64, (128, 128)), (f64, (24, 24))])):
        for dtype, (R, C) in cases:
            if family == "bgk":
                f = seeded_state(R, C, dtype, dev, seed=R * C, incompressible=True)
                args = (1 / tau, rho_in, 1.0)
                plain = channel.channel_model(*args).step
            else:
                f = seeded_state(R, C, dtype, dev, seed=R * C + 1, noisy=True)
                args = (ULBM_S2, ULBM_RHO_IN, 1.0)
                plain = channel.kbc_channel_step(*args)
            step = channel.make_channel_fused_step(R, C, *args, dtype, family=family)
            got, want = f, f
            for _ in range(10):
                got, want = step(got), plain(want)
            kernel = {"bgk": 2, "kbc": 4}[family]
            e = compare(f"[4] kernel {kernel} {R}x{C} {dtype} 10 steps", got, want, dtype)
            errs[dtype] = max(errs.get(dtype, 0.0), e)
            del f, got, want

    # kernel 9 in each configuration; at 4096x2048 the kernel runs twice and
    # must repeat itself bit for bit (a second writer of an entry would race)
    err9 = {}
    for name, kw in VARIANTS.items():
        for dtype, (R, C) in ((f32, BIG), (f64, (21, 21)), (f64, (51, 51)), (f64, (54, 42))):
            f = seeded_state(R, C, dtype, dev, seed=R + C + len(name),
                             incompressible=kw["incompressible"], noisy=True)
            step = channel.make_channel_variant_step(R, C, dtype=dtype, **kw)
            plain = channel.ChannelVariant(**kw).model().step
            got, want = f, f
            for _ in range(10):
                got, want = step(got), plain(want)
            e = compare(f"[4] kernel 9 {name} {R}x{C} {dtype} 10 steps", got, want, dtype)
            err9[dtype] = max(err9.get(dtype, 0.0), e)
            if dtype == f32:
                again = f
                for _ in range(10):
                    again = step(again)
                same = bool(torch.equal(again, got))
                log(f"[4] kernel 9 {name} {R}x{C} float32, second run bit-identical: {same}")
                if not same:
                    raise AssertionError(f"kernel 9 {name}: two runs differ (a race)")
                del again
            del f, got, want
    torch.cuda.empty_cache()

    # kernels 15-17 at the main path's own grids; each runs twice, and the
    # runs must be bit-identical.  Kernel 15, 10 steps from a noisy state with
    # a noisy force over the ROI of the grid's cylinder, at both Guo pairs
    # (the Strouhal grid; cylinder_flow's defaults; the transcription test's
    # 48x128; 4096x2048)
    err15, err17 = {}, {}
    for dtype, (R, C), ib in ((f32, (1024, 256), IBM.circle(*STROUHAL_CIRCLE)),
                              (f64, (160, 120), IBM.circle(60.0, 60.0, 20.0, 64)),
                              (f64, (48, 128), IBM.circle(24.0, 60.0, 9.0, 24)),
                              (f32, BIG, IBM.circle(*STROUHAL_CIRCLE))):
        f, F, origin = cylinder_case(R, C, dtype, dev, ib, seed=R + C + 15)
        for guo in GUO:
            step = cylinder.make_cylinder_fused_step(R, C, 1 / 0.55, (0.05, 0.0), guo, dtype)
            e = hold_twice(
                f"[4] kernel 15 guo ({guo[0]:.4g}, {guo[1]:.4g}) {R}x{C} {dtype} 10 steps",
                lambda x, step=step: step(x, F, origin),
                lambda x, guo=guo: cylinder.plain_cylinder_step(x, F, origin, 1 / 0.55,
                                                                (0.05, 0.0), guo),
                f, 10, dtype)
            err15[dtype] = max(err15.get(dtype, 0.0), e)
        del f, F
    torch.cuda.empty_cache()
    err16, err_mov = ibm_holds(dev)
    # kernel 17, 10 steps from the scene's initial state with noise
    for dtype, (R, C) in ((f32, (256, 320)), (f64, (256, 320)), (f64, (64, 96)), (f32, BIG)):
        kw = sediment_kwargs(R, C)
        S = sediment_state(R, C, dtype, dev, seed=R + C + 17)
        e = hold_twice(f"[4] kernel 17 {R}x{C} {dtype} 10 steps",
                       sediment.make_sediment_fused_step(R, C, dtype=dtype, **kw),
                       lambda x, kw=kw, R=R: sediment.plain_sediment_step(
                           x, **dict(kw, R23=kw["R23"] % R)), S, 10, dtype)
        err17[dtype] = max(err17.get(dtype, 0.0), e)
        del S
    torch.cuda.empty_cache()
    # kernel 18, 10 steps from a noisy state with a noisy force window read
    # at a device origin: 4096x2048 f32, falling_cylinder's 400x256 in both
    # types, an odd 97x61 f64, and the phase-5 gates' grids in f32 (falling
    # 96x256, dkt 800x128 with its 228x128 window, ellipse 800x256)
    err18 = {}
    for dtype, (R, C), (r0, c0, rw, cw) in ((f32, BIG, (1990, 1010, 34, 34)),
                                            (f32, (400, 256), (83, 111, 34, 34)),
                                            (f64, (400, 256), (83, 111, 34, 34)),
                                            (f64, (97, 61), (3, 40, 34, 21)),
                                            (f32, (96, 256), (30, 115, 26, 26)),
                                            (f32, (800, 128), (300, 0, 228, 128)),
                                            (f32, (800, 256), (150, 107, 42, 42))):
        f = seeded_state(R, C, dtype, dev, seed=R + C + 18, noisy=True)
        F = torch.as_tensor(np.random.default_rng(R * C).normal(0.0, 1e-3, (2, rw, cw)),
                            dtype=dtype, device=dev)
        origin = torch.tensor([r0, c0], dtype=torch.int32, device=dev)
        step = cylinder.make_box_fused_step(R, C, 1 / 0.6, dtype=dtype)
        e = hold_twice(f"[4] kernel 18 {R}x{C} {dtype} window {rw}x{cw} at ({r0}, {c0}), "
                       "10 steps", lambda x, step=step, F=F, o=origin: step(x, F, o),
                       lambda x, F=F, o=origin: cylinder.plain_box_step(x, F, o, 1 / 0.6),
                       f, 10, dtype)
        err18[dtype] = max(err18.get(dtype, 0.0), e)
        del f
    torch.cuda.empty_cache()
    # kernel 22, 10 steps from a noisy state at the reference's
    # super-critical force (the strip's source large): ring_cavity's L = 512
    # and L = 4096 in float32, L = 128 and an L that is no multiple of 4 in
    # float64
    err22 = {}
    for dtype, L in ((f32, 512), (f32, 4096), (f64, 128), (f64, 130)):
        f = seeded_state(L, L, dtype, dev, seed=L + 22, noisy=True)
        e = hold_twice(f"[4] kernel 22 L={L} {dtype} 10 steps",
                       cavity.make_cavity_fused_step(L, omega=CAVITY_OMEGA, force=3e-3,
                                                     dtype=dtype),
                       lambda x: cavity.plain_cavity_step(x, omega=CAVITY_OMEGA, force=3e-3),
                       f, 10, dtype)
        err22[dtype] = max(err22.get(dtype, 0.0), e)
        del f
    torch.cuda.empty_cache()
    # kernels 23 and 24 in both scalar lattices, 10 steps from a noisy
    # buoyant state: 4096x2048 float32, the gates' 64x128 and 128x128 in both
    # types, an odd 97x61 float64
    err_th = {}
    for name in THERMAL_NAMES:
        make, plain, _, q = thermal_kernel(name)
        for dtype, (R, C) in ((f32, BIG), (f32, (64, 128)), (f64, (64, 128)),
                              (f32, (128, 128)), (f64, (128, 128)), (f64, (97, 61))):
            S = thermal_state(q, R, C, dtype, dev, seed=R + C + q)
            e = hold_twice(f"[4] kernel {23 if 'rb' in name else 24} {name} {R}x{C} {dtype} "
                           "10 steps",
                           make(R, C, dtype=dtype, scalar_lattice=f"d2q{q}", **THERMAL_PHYS),
                           lambda x, plain=plain: plain(x, **THERMAL_PHYS), S, 10, dtype)
            err_th.setdefault(name, {})
            err_th[name][dtype] = max(err_th[name].get(dtype, 0.0), e)
            del S
        torch.cuda.empty_cache()
    # kernels 25 and 26 in the four wall sets and at phase 5's shapes, 10
    # steps from noisy states
    err25, err26 = d3q19_hold(dev)
    err_sh = sharded_hold(dev)
    # kernel 39 at bench.py's lane-block shapes, against kernel 6 and its
    # plain version
    err39 = lanes_hold(dev)

    # 5. the main path
    for k in counted.values():
        k.launches = 0
    R, C = BIG
    f = seeded_state(R, C, f32, dev, seed=5)
    mass0, mom0 = f.double().sum().item(), d2q9.calc_momentum(f.double()).sum((1, 2))
    step = bgk.make_fused_step(R, C, OMEGA, f32, substeps=8)
    for _ in range(25):
        f = step(f)
    torch.cuda.synchronize()
    mass, mom = f.double().sum().item(), d2q9.calc_momentum(f.double()).sum((1, 2))
    drift = abs(mass / mass0 - 1.0)
    mom_drift = (mom - mom0).abs().max().item() / (R * C)
    log(f"[5] periodic BGK {R}x{C} float32, 200 steps: finite="
        f"{bool(torch.isfinite(f).all())} mass drift={drift!r} "
        f"momentum drift per cell={mom_drift!r}")
    if not (torch.isfinite(f).all() and drift < 1e-5 and mom_drift < 1e-6):
        raise AssertionError("periodic BGK run lost mass or momentum")
    del f

    before = k2.launches
    t0 = time.perf_counter()
    res = horizontal_poiseuille(device=dev, dtype=f64)
    wall = time.perf_counter() - t0
    log(f"[5] horizontal_poiseuille 21x21 float64 on {res.f.device}: steps={res.steps} "
        f"L2={res.l2!r} (gate 1e-11), kernel-2 launches={k2.launches - before}, "
        f"host wall time {wall!r} s")
    if not (res.l2 <= 1e-11 and k2.launches - before == res.steps
            and res.f.is_cuda):
        raise AssertionError("Poiseuille gate failed on the card")

    # the CLIs of every path run together in one process later in phase 5
    clis = [("horizontal_poiseuille", "--x64", "--device", "cuda")]

    # lbm_tpu's hardware gates on the BGK kernels (scripts/validate_tpu.py
    # poiseuille :40-48, through kernel 2; taylor_green :79-106, through
    # kernel 1 at 8 steps per call)
    before = k2.launches
    t0 = time.perf_counter()
    pg = horizontal_poiseuille(H=128, W=128, T=200000, device=dev, dtype=f32)
    wall = time.perf_counter() - t0
    check_gates(f"[5] poiseuille 128x128 float32, {pg.steps} steps (host wall time "
                f"{wall!r} s)", {
        "L2": (pg.l2, 0.0, 5e-4),
        "kernel-2 launches - steps": (k2.launches - before - pg.steps, 0, 0)})
    del pg
    n_tg, nu_tg, u_tg, T_tg = 256, 0.05, 0.02, 400
    kx = 2 * np.pi / n_tg
    X = np.arange(n_tg)[:, None] * np.ones((1, n_tg))
    Y = np.ones((n_tg, 1)) * np.arange(n_tg)[None, :]
    u_np = np.stack([u_tg * np.cos(kx * X) * np.sin(kx * Y),
                     -u_tg * np.sin(kx * X) * np.cos(kx * Y)])
    f = d2q9.equilibrium(torch.as_tensor(u_np, dtype=f32, device=dev),
                         torch.ones((n_tg, n_tg), dtype=f32, device=dev)).contiguous()
    step = bgk.make_fused_step(n_tg, n_tg, 1.0 / (3 * nu_tg + 0.5), f32, substeps=8)
    before = k1.launches
    t0 = time.perf_counter()
    for _ in range(T_tg // 8):
        f = step(f)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    u = d2q9.calc_u(f, d2q9.calc_rho(f))
    decay = (u.double() ** 2).sum().item() / float((u_np.astype(np.float32) ** 2).sum())
    expect = float(np.exp(-2 * nu_tg * 2 * kx * kx * T_tg))
    check_gates(f"[5] taylor_green 256x256 float32, {T_tg} steps (host wall time {wall!r} s)", {
        "decay ratio": (decay / expect, 0.97, 1.03),
        "kernel-1 launches": (k1.launches - before, T_tg, T_tg)})
    del f, u

    before = k2.launches
    big = horizontal_poiseuille(H=R, W=C, T=1000, device=dev, dtype=f32)
    log(f"[5] horizontal_poiseuille {R}x{C} float32: steps={big.steps} finite="
        f"{bool(torch.isfinite(big.f).all())} max|u_x|={big.u[0].abs().max().item()!r} "
        f"kernel-2 launches={k2.launches - before}")
    if not (big.steps == 1000 and torch.isfinite(big.f).all()
            and k2.launches - before == 1000):
        raise AssertionError("large channel run failed")
    del big

    # ulbm_poiseuille at the reference's defaults, float64, with the watcher
    # at lbm_tpu's hardware-gate cadence (scripts/validate_tpu.py ulbm_300k)
    before = k4.launches
    t0 = time.perf_counter()
    up = ulbm.ulbm_poiseuille(tolerance=1e-12, t_interval=1000, device=dev, dtype=f64)
    wall = time.perf_counter() - t0
    ux = up.m1[0]
    tail = statistics.median(r for _, r in up.watch[-5:])
    log(f"[5] ulbm_poiseuille 128x128 float64: kernel-4 launches={k4.launches - before}, "
        f"host wall time {wall!r} s ({wall / up.steps * 1e6!r} us/step), "
        f"watch tail {up.watch[-5:]}")
    check_gates("[5] ulbm_poiseuille", {
        "steps": (up.steps, 299000, 300000),
        "finite": (float(torch.isfinite(up.f).all()), 1.0, 1.0),
        "max|u_x|": (ux.abs().max().item(), 1e-4, 0.02),
        "l2 vs parabola": (up.l2, 0.90, 0.99),
        "watch tail x 300": (tail * 300.0, 0.8, 1.2),
        "kernel-4 launches - steps": (k4.launches - before - up.steps, 0, 0),
    })
    del up

    # ulbm_double_shear at the reference's defaults, float64: finite through
    # all 10k steps (lbm_tpu on the CPU: |f|max 0.445 -> 0.505)
    m0, u = ulbm.double_shear_init(128, 128, 0.02, device=dev, dtype=f64)
    fmax0 = kbc.equilibrium(m0, u).abs().max().item()
    before = k3.launches
    t0 = time.perf_counter()
    ds = ulbm.ulbm_double_shear(device=dev, dtype=f64)
    wall = time.perf_counter() - t0
    log(f"[5] ulbm_double_shear 128x128 float64, 10000 steps: |f|max {fmax0!r} -> "
        f"{ds.f.abs().max().item()!r}, host wall time {wall!r} s")
    check_gates("[5] ulbm_double_shear", {
        "finite": (float(torch.isfinite(ds.f).all()), 1.0, 1.0),
        "kernel-3 launches": (k3.launches - before, 10000, 10000),
    })
    del ds

    # the resolved shear layer in float32 (validate_tpu.py kbc)
    H = W = 256
    before = k3.launches
    rs = ulbm.ulbm_double_shear(H=H, W=W, T=5000, nu=1e-3, u_max=0.04, device=dev,
                                dtype=f32)
    _, u0 = ulbm.double_shear_init(H, W, 0.04, device=dev, dtype=f32)
    energy = (rs.m1.double() ** 2).sum().item() / (u0.double() ** 2).sum().item()
    check_gates("[5] resolved KBC shear 256x256 float32, 5000 steps", {
        "mass error": (abs(rs.m0.double().sum().item() / (H * W) - 1.0), 0.0, 1e-6),
        "max|u|": (rs.m1.abs().max().item(), 0.04, 0.09),
        "energy ratio": (energy, 0.90, 0.99),
        "kernel-3 launches": (k3.launches - before, 5000, 5000),
    })
    del rs

    # les_double_shear at the reference's shear defaults, float32, 8 substeps
    # per call (validate_tpu.py les)
    before = k5.launches
    ls = ulbm.les_double_shear(T=10000, substeps=8, device=dev, dtype=f32)
    check_gates("[5] les_double_shear 128x128 float32, 10000 steps", {
        "finite": (float(torch.isfinite(ls.f).all()), 1.0, 1.0),
        "|f|max": (ls.f.abs().max().item(), 0.3, 0.6),
        "|u|max": (ls.m1.abs().max().item(), 0.01, 0.1),
        "kernel-5 launches": (k5.launches - before, 10000, 10000),
    })
    del ls

    clis.append(("ulbm_double_shear", "--x64", "--device", "cuda", "--set", "T=200"))

    # the MRT-CG scenes: kernel 6 for T-1 steps and kernel 7 once per run
    red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
    mrt_wall = {}

    def scene(label, fn, **kw):
        b6, b7 = k6.launches, k7.launches
        t0 = time.perf_counter()
        res = fn(device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mrt_wall[label] = (wall, res.steps)
        log(f"[5] {label}: kernel-6 launches={k6.launches - b6}, kernel-7 launches="
            f"{k7.launches - b7}, host wall time {wall!r} s "
            f"({wall / res.steps * 1e6!r} us/step)")
        return res, {"kernel-6 launches - (T-1)": (k6.launches - b6 - res.steps + 1, 0, 0),
                     "kernel-7 launches": (k7.launches - b7, 1, 1)}

    # the Laplace law (validate_tpu.py laplace; in f64 also the red mass
    # drift of its df64 gate, :380-382)
    r0_mass = mp.init_rho_droplet(128, 128, red.rho_0, True, 25.0).sum()
    for dtype in (f64, f32):
        res, gates = scene(f"mrtcg_static_droplet 128x128 {dtype} 40000 steps",
                           mp.mrtcg_static_droplet, R=128, C=128, T=40000, radius=25.0,
                           sigma=0.1, dtype=dtype)
        st = res.state
        p = (st.red.rho.double() * red.cs2 + st.blue.rho.double() * blue.cs2).cpu().numpy()
        dp = p[61:67, 61:67].mean() - np.concatenate([p[:4].ravel(), p[-4:].ravel()]).mean()
        gates["dp / (2 sigma / R)"] = (dp / (2 * 0.1 / 25.0), 0.95, 1.1)
        gates["|u|max"] = (st.u.abs().max().item(), 0.0, 5e-3)
        drift = abs(st.red.rho.double().sum().item() / r0_mass - 1.0)
        if dtype == f64:
            gates["red mass drift"] = (drift, 0.0, 1e-9)
        else:
            log(f"[5] Laplace float32: red mass drift {drift!r} (not gated)")
        check_gates(f"[5] Laplace {dtype}", gates)
        del res, st

    # the reference's RT horizon, 256x128 for 100k steps (validate_tpu.py rt_100k)
    mass0 = (mp.init_rho_cosine(256, 128, red.rho_0, True, -1.0)
             + mp.init_rho_cosine(256, 128, blue.rho_0, False, -1.0)).sum()
    for dtype in (f32, f64):
        res, gates = scene(f"mrtcg_rayleigh_taylor 256x128 {dtype} 100000 steps",
                           mp.mrtcg_rayleigh_taylor, dtype=dtype)
        st = res.state
        psi = phase_field(st.red.rho.double(), red.rho_0, st.blue.rho.double(),
                          blue.rho_0).cpu().numpy()
        rho = (st.red.rho.double() + st.blue.rho.double()).cpu().numpy()
        gates.update({
            "finite": (float(torch.isfinite(st.red.f).all() and torch.isfinite(st.blue.f).all()),
                       1.0, 1.0),
            "mass rel drift": (abs(rho.sum() / mass0 - 1.0), 0.0, 1e-3),
            "interface std": (float((psi > 0).sum(axis=0).astype(float).std()), 1.5, 2.1),
            "|psi|max": (float(np.abs(psi).max()), 0.9, 1.001),
        })
        check_gates(f"[5] RT 100k {dtype}", gates)
        del res, st

    # RT growth in the unstable regime (validate_tpu.py rt_growth)
    res, gates = scene("mrtcg_rayleigh_taylor growth 256x128 float32 20000 steps",
                       mp.mrtcg_rayleigh_taylor, T=20000, sigma=1e-5,
                       gravity_magnitude=5e-6, dtype=f32)
    psi = phase_field(res.state.red.rho.double(), red.rho_0, res.state.blue.rho.double(),
                      blue.rho_0).cpu().numpy()
    gates["interface std"] = (float((psi > 0).sum(axis=0).astype(float).std()), 18.0, 40.0)
    check_gates("[5] RT growth float32", gates)

    # CSF growth (validate_tpu.py csf_growth)
    res, gates = scene("mrt_csf_rayleigh_taylor 256x128 float32 6000 steps",
                       mp.mrt_csf_rayleigh_taylor, T=6000, dtype=f32)
    rho = res.state.red.rho.double().cpu().numpy()
    gates.update({
        "finite": (float(np.isfinite(rho).all()), 1.0, 1.0),
        "interface std": (float((rho > 1.5).sum(axis=0).astype(float).std()), 2.0, 60.0),
        "mass rel drift": (abs(rho.sum() / (128 * 128 * 3.0) - 1.0), 0.0, 0.05),
    })
    check_gates("[5] CSF growth float32", gates)
    del res

    clis.append(("mrtcg_static_droplet", "--x64", "--device", "cuda", "--set", "T=200"))

    # the full per-colour layout (kernel 8, lbm_tpu's make_mrtcg_fused_step /
    # make_csf_fused_step) from the scenes' initial states gives the scenes'
    # results over 20 steps: 1e-12 in the perturbation mode, lbm_tpu's 1e-6
    # in CSF mode, the colour masses at 1e-12 relative.  (The two layouts
    # round rho differently and RT amplifies that: 2.8e-6 apart after 2000
    # float64 steps in the perturbation mode, on the H100.)
    for csf, fn in ((False, mp.mrtcg_rayleigh_taylor), (True, mp.mrt_csf_rayleigh_taylor)):
        T = 20
        res = fn(T=T, device=dev, dtype=f64)
        S = mrtcg_state(256, 128, f64, dev, csf)
        full, _ = mrtcg_steps("full", 256, 128, f64, csf)
        before = k8.launches
        for _ in range(T):
            S = full(S)
        want = torch.cat([res.state.red.f, res.state.blue.f])
        err = (S[:18] - want).abs().max().item()
        mass = max(abs(S[a:a + 9].sum().item() / want[a:a + 9].sum().item() - 1.0)
                   for a in (0, 9))
        check_gates(f"[5] full layout (kernel 8) vs {fn.__name__} 256x128 float64 {T} steps", {
            "max_abs_err": (err, 0.0, 1e-6 if csf else 1e-12),
            "colour mass rel diff": (mass, 0.0, 1e-12),
            "kernel-8 launches": (k8.launches - before, T, T),
        })
        del res, S, want

    # the periodic TRT and power-law runs at 4096x2048 float32, 8 steps per
    # call (bench.py --model trt / plaw): finite, mass and momentum kept
    R, C = BIG
    for label, kernel, f, step in (
            ("TRT", k10, seeded_state(R, C, f32, dev, seed=12),
             trt.make_trt_fused_step(R, C, omega_plus=TRT_OMEGA, omega_minus=trt_minus,
                                     dtype=f32, substeps=8)),
            ("power-law", k11, shear_state(R, C, f32, dev),
             power_law.make_power_law_fused_step(R, C, dtype=f32, substeps=8, **PLAW))):
        before = kernel.launches
        mass0, mom0 = f.double().sum().item(), d2q9.calc_momentum(f.double()).sum((1, 2))
        for _ in range(25):
            f = step(f)
        torch.cuda.synchronize()
        mass, mom = f.double().sum().item(), d2q9.calc_momentum(f.double()).sum((1, 2))
        check_gates(f"[5] periodic {label} {R}x{C} float32, 200 steps", {
            "finite": (float(torch.isfinite(f).all()), 1.0, 1.0),
            "mass drift": (abs(mass / mass0 - 1.0), 0.0, 1e-5),
            "momentum drift per cell": ((mom - mom0).abs().max().item() / (R * C), 0.0, 1e-6),
            "launches": (kernel.launches - before, 200, 200),
        })
        del f

    def variant_scene(label, fn, **kw):
        """A kernel-9 scene on the card: one launch per step, host wall time."""
        before = k9.launches
        t0 = time.perf_counter()
        res = fn(device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"[5] {label}: steps={res.steps} kernel-9 launches={k9.launches - before} "
            f"host wall time {wall!r} s")
        if not (k9.launches - before == res.steps and res.f.is_cuda):
            raise AssertionError(f"{label}: not one kernel-9 launch per step")
        return res

    # the reference's 1e-11 gate in the vertical geometry (incompressible)
    # and the faithful compressible run, watched to a stop
    # (tests/test_channel.py:91-113)
    res = variant_scene("vertical_poiseuille 21x21 float64 incompressible",
                        chs.vertical_poiseuille, H=21, W=21, T=20000,
                        u_max=1.030985714e-1, incompressible=True, tolerance=1e-12,
                        dtype=f64)
    check_gates("[5] vertical_poiseuille incompressible", {"L2": (res.l2, 0.0, 1e-11)})
    res = variant_scene("vertical_poiseuille 31x31 float64", chs.vertical_poiseuille,
                        H=31, W=31, T=30000, u_max=0.05, tolerance=1e-12, dtype=f64)
    mid = res.u[1][:, 15].cpu().numpy()
    ua = chs.poiseuille_analytic(31, 0.05)
    check_gates("[5] vertical_poiseuille compressible", {
        "steps": (res.steps, 1, 29999), "L2": (res.l2, 0.0, 2e-2),
        "max|mid - parabola| - 0.05|parabola|":
            (float((np.abs(mid - ua) - 0.05 * np.abs(ua)).max()), -1.0, 4e-4)})

    # TRT at tau 1.2: the 1e-11 gate in float64, validate_tpu.py trt in float32
    res = variant_scene("trt_poiseuille 21x21 float64", chs.trt_poiseuille, dtype=f64)
    check_gates("[5] trt_poiseuille float64", {"L2": (res.l2, 0.0, 1e-11)})
    res = variant_scene("trt_poiseuille 128x128 float32", chs.trt_poiseuille, H=128, W=128,
                        T=200000, dtype=f32)
    check_gates("[5] trt_poiseuille 128x128 float32", {"L2": (res.l2, 0.0, 5e-4)})

    # gravity: the converged profile against the parabola (tests/test_channel.py:19-37)
    res = variant_scene("gravity_channel 21x21 float64", chs.gravity_channel, dtype=f64)
    nu = (2.0 * TAU_DEFAULT - 1.0) / 6.0
    ua = chs.poiseuille_analytic(21, -3e-4 * 21 * 21 / (8.0 * nu))
    mid = res.u[0][10].cpu().numpy()
    check_gates("[5] gravity_channel", {
        "max(|mid - ua| - 0.25|ua|)": (float((np.abs(mid - ua) - 0.25 * np.abs(ua)).max()),
                                        -1.0, 2e-4),
        "max|mid - mirror| / max|mid|": (float(np.abs(mid - mid[::-1]).max()
                                               / np.abs(mid).max()), 0.0, 1e-6),
        "argmax|mid|": (int(np.abs(mid).argmax()), 10, 10)})

    # specular walls: a flat plug that keeps accelerating (tests/test_channel.py:40-55)
    means = []
    for T in (300, 600):
        res = variant_scene(f"specular_channel 31x21 float64 T={T}", chs.specular_channel,
                            H=31, W=21, T=T, dtype=f64)
        mid = (res.u[0] / res.rho)[15].cpu().numpy()
        means.append(float(mid.mean()))
        check_gates(f"[5] specular_channel T={T}", {
            "finite": (float(np.isfinite(mid).all()), 1.0, 1.0),
            "ptp(mid) / |mean|": (float(np.ptp(mid) / abs(mid.mean())), 0.0, 2e-2)})
    check_gates("[5] specular_channel accelerates", {
        "mean(T=600) - mean(T=300)": (means[1] - means[0], 1e-12, 1.0)})

    # the faithful free stream (tests/test_channel.py:58-73) and the
    # corner-consistent fixed point (:76-88)
    res = variant_scene("free_stream 30x24 float64", chs.free_stream, H=30, W=24, T=100,
                        dtype=f64)
    ux = (res.u[0] / res.rho).cpu().numpy()
    check_gates("[5] free_stream", {
        "bulk mean u_x": (float(ux[6:-6, 6:-6].mean()), 0.08, 0.14),
        "ptp wall rows": (float(max(np.ptp(ux[0]), np.ptp(ux[-1]))), 0.0, 1e-5),
        "|u_x(0, 0) - 0.1|": (float(abs(ux[0, 0] - 0.1)), 0.0, 5e-3)})
    res = variant_scene("free_stream 30x24 float64 corner-consistent", chs.free_stream,
                        H=30, W=24, T=500, corner_consistent=True, dtype=f64)
    check_gates("[5] free_stream corner-consistent fixed point", {
        "max|u_x - 0.1|": ((res.u[0] - 0.1).abs().max().item(), 0.0, 1e-12),
        "max|u_y|": (res.u[1].abs().max().item(), 0.0, 1e-12),
        "max|rho - 1|": ((res.rho - 1.0).abs().max().item(), 0.0, 1e-12)})

    # the full-width run: free_stream from configs/channel.toml in float64,
    # 2700x2100 for 1580 steps, (ux, uy, ps) every 79 steps streamed to disk
    with tempfile.TemporaryDirectory() as tmp:
        prefix = str(Path(tmp) / "free_stream")
        res = variant_scene("free_stream configs/channel.toml float64", chs.free_stream,
                            config_path=str(ROOT / "configs" / "channel.toml"),
                            snapshot_prefix=prefix, dtype=f64)
        frames = {k: np.load(f"{prefix}-{k}.npy", mmap_mode="r") for k in ("ux", "uy", "ps")}
        finite = all(bool(np.isfinite(frames[k][-1]).all()) for k in frames)
        check_gates("[5] free_stream configs/channel.toml", {
            "grid": (res.f.shape[1] * 10000 + res.f.shape[2], 27002100, 27002100),
            "steps": (res.steps, 1580, 1580),
            "frames per field": (min(v.shape[0] for v in frames.values()), 20, 20),
            "frame shape": (max(v.shape[1] * 10000 + v.shape[2] for v in frames.values()),
                            27002100, 27002100),
            "last frames finite": (float(finite), 1.0, 1.0),
            "state finite": (float(torch.isfinite(res.f).all()), 1.0, 1.0)})
        del res, frames

    # power_law_channel has no kernel: plain ops on the card against the CPU
    t0 = time.perf_counter()
    got = chs.power_law_channel(H=4, W=41, T=2000, device=dev, dtype=f64)
    wall = time.perf_counter() - t0
    want = chs.power_law_channel(H=4, W=41, T=2000, device="cpu", dtype=f64)
    check_gates(f"[5] power_law_channel 4x41 float64 on the card vs the CPU (card host "
                f"wall time {wall!r} s)", {
        "steps": (got.steps - want.steps, 0, 0),
        "max|f_card - f_cpu|": ((got.f.cpu() - want.f).abs().max().item(), 0.0, 1e-10)})
    del got, want

    clis += [("vertical_poiseuille", "--x64", "--device", "cuda"),
             ("free_stream", "--config", "configs/channel.toml", "--set", "T=158",
              "--device", "cuda")]

    # the multiphase slice of kernels 12-14: its counts start at 0 here and
    # are read at its end
    launches = {name: k.launches for name, k in counted.items()}
    for k in counted.values():
        k.launches = 0

    # the RK-CG Rayleigh-Taylor at the reference's largest single-domain
    # workload, 1024x256 for 100k steps (validate_tpu.py rk_rt_100k), one
    # kernel-12 launch per step
    rk_wall = {}
    mass0 = (mp.init_rho_cosine(1024, 256, 3.0, False, 1.0)
             + mp.init_rho_cosine(1024, 256, 1.0, True, 1.0)).sum()
    for dtype in (f32, f64):
        before = k12.launches
        t0 = time.perf_counter()
        res = mp.rk_rayleigh_taylor(L=256, T=100000, device=dev, dtype=dtype)
        torch.cuda.synchronize()
        rk_wall[dtype] = wall = time.perf_counter() - t0
        r_rho = res.state.r_rho.double().cpu().numpy()
        b_rho = res.state.b_rho.double().cpu().numpy()
        psi = (r_rho / 3.0 - b_rho) / (r_rho / 3.0 + b_rho)
        h = (psi > 0).sum(axis=0).astype(float)
        check_gates(f"[5] rk_rayleigh_taylor 1024x256 {dtype} 100000 steps (host wall time "
                    f"{wall!r} s = {wall / res.steps * 1e6!r} us/step)", {
            "finite": (float(np.isfinite(psi).all() and bool(torch.isfinite(res.state.f).all())),
                       1.0, 1.0),
            "mass rel drift": (abs((r_rho + b_rho).sum() / mass0 - 1.0), 0.0, 5e-3),
            "|psi|max": (float(np.abs(psi).max()), 0.9, 1.001),
            "interface std": (float(h.std()), 0.0, 1.5),
            "interface mean": (float(h.mean()), 505.0, 517.0),
            "kernel-12 launches - steps": (k12.launches - before - res.steps, 0, 0)})
        del res

    # csf_static_droplet at the reference's L = 100, T = 100 in float64
    # through kernel 13 (tests/test_multiphase.py:147-166's invariants)
    before = k13.launches
    res = mp.csf_static_droplet(device=dev, dtype=f64)
    st = res.state
    red_rho, blue_rho = st.red.rho.double(), st.blue.rho.double()
    rho = red_rho + blue_rho
    check_gates("[5] csf_static_droplet 100x100 float64 100 steps", {
        "finite": (float(torch.isfinite(st.red.f).all() and torch.isfinite(st.blue.f).all()),
                   1.0, 1.0),
        "red mass rel diff": (abs(red_rho.sum().item() / mp.init_rho_droplet(
            100, 100, 1.0, True, 25.0, 2.0).sum() - 1.0), 0.0, 1e-10),
        "blue mass rel diff": (abs(blue_rho.sum().item() / mp.init_rho_droplet(
            100, 100, 1.0, False, 25.0, 2.0).sum() - 1.0), 0.0, 1e-10),
        "|psi|max": (((red_rho - blue_rho) / rho).abs().max().item(), 0.0, 1.0 + 1e-9),
        "rho min": (rho.min().item(), 0.5, 1.5), "rho max": (rho.max().item(), 0.5, 1.5),
        "kernel-13 launches": (k13.launches - before, 100, 100)})
    del res, st

    # rk_static_droplet has no kernel: plain ops on the card (timed here),
    # held against the CPU below
    t0 = time.perf_counter()
    drop = mp.rk_static_droplet(device=dev, dtype=f64)
    torch.cuda.synchronize()
    drop_wall = time.perf_counter() - t0

    # the Shan-Chen gates of validate_tpu.py shan_chen in float32, 4 steps
    # per call, one kernel-14 launch per step
    def sc_scene(label, fn, **kw):
        before = k14.launches
        t0 = time.perf_counter()
        res = fn(device=dev, dtype=f32, substeps=4, **kw)
        torch.cuda.synchronize()
        label = f"[5] {label} (host wall time {time.perf_counter() - t0!r} s)"
        return res, label, {"kernel-14 launches - steps": (k14.launches - before - res.steps,
                                                           0, 0)}

    res, label, gates = sc_scene("sc_phase_separation 256x256 float32 4000 steps",
                                 scs.sc_phase_separation, H=256, W=256, T=4000, G=-5.0)
    gates["rho_l / rho_v"] = (res.rho_l / max(res.rho_v, 1e-6), 4.0, 50.0)
    check_gates(label, gates)
    res, label, gates = sc_scene("sc_flat_interface 256x128 float32 12000 steps",
                                 scs.sc_flat_interface, H=256, W=128, T=12000, G=-5.0)
    gates.update({"p_jump": (res.p_jump, 0.0, 0.03), "rho_l": (res.rho_l, 1.5, 2.2)})
    check_gates(label, gates)
    res, label, gates = sc_scene("sc_cs_interface 256x128 float32 12000 steps T/T_c 0.7",
                                 scs.sc_cs_interface, H=256, W=128, T=12000, T_red=T_RED)
    gates.update({"rho_l / rho_v": (res.rho_l / max(res.rho_v, 1e-9), 30.0, 120.0),
                  "rho_l / Maxwell rho_l": (res.rho_l / cs_coexistence()[2], 0.98, 1.02)})
    check_gates(label, gates)
    del res

    slice_launches = {name: counted[name].launches for name in ("rk_cg", "csf_droplet",
                                                                 "shan_chen")}
    log(f"[5] kernel 12-14 path launches: {slice_launches}")
    if not all(slice_launches.values()):
        raise AssertionError("a kernel of the RK / CSF-droplet / Shan-Chen path never launched")
    clis += [("rk_rayleigh_taylor", "--device", "cuda", "--set", "T=1000"),
             ("sc_flat_interface", "--device", "cuda", "--set", "substeps=4", "--set", "T=2000")]

    # the obstacle slice of kernels 15-17: its counts start at 0 here and are
    # read at its end
    launches = {name: launches[name] + k.launches for name, k in counted.items()}
    for k in counted.values():
        k.launches = 0

    # the Strouhal gate (validate_tpu.py strouhal): 1024x256, D = 32, Re 96,
    # the standard Guo pair, 200k steps, the lift sampled every 40 steps;
    # one launch each of kernels 16 and 15 per step
    t0 = time.perf_counter()
    res = obs.cylinder_flow(H=1024, W=256, T=200000, ibm=IBM.circle(*STROUHAL_CIRCLE),
                            guo_coeffs=(3.0, 9.0), record_every=40, device=dev, dtype=f32)
    torch.cuda.synchronize()
    strouhal_wall = time.perf_counter() - t0
    Fy = res.forces[:, 1].double().numpy()
    sig = Fy[2000:] - Fy[2000:].mean()
    spec = np.abs(np.fft.rfft(sig))
    St = np.fft.rfftfreq(len(sig), d=40)[np.argmax(spec[1:]) + 1] * 32.0 / 0.05
    check_gates(f"[5] Strouhal: cylinder_flow 1024x256 float32 200000 steps (host wall time "
                f"{strouhal_wall!r} s = {strouhal_wall / 200000 * 1e6!r} us/step; mean drag "
                f"{res.forces[2000:, 0].double().mean().item()!r})", {
        "St": (float(St), 0.15, 0.20), "lift rms": (float(sig.std()), 0.02, 0.5),
        "finite": (float(torch.isfinite(res.f).all()), 1.0, 1.0),
        "force samples": (res.forces.shape[0], 5000, 5000),
        "kernel-15 launches": (k15.launches, 200000, 200000),
        "kernel-16 launches": (k16.launches, 200000, 200000)})
    del res

    # cylinder_flow and rectangle_sedimentation at the reference's defaults
    # in float64 on the card (held against the CPU below, while the CLIs run)
    cyl_card, cyl_wall = {}, {}
    for ref in (False, True):
        before = k15.launches, k16.launches
        t0 = time.perf_counter()
        cyl_card[ref] = obs.cylinder_flow(reference_weights=ref, device=dev, dtype=f64)
        torch.cuda.synchronize()
        cyl_wall[ref] = time.perf_counter() - t0
        if (k15.launches - before[0], k16.launches - before[1]) != (500, 500):
            raise AssertionError("cylinder_flow: not one launch of kernels 15 and 16 per step")
    # kernel 17 launches through lbm::launch_cells: one launch a step, a
    # dependent one exactly where the grid fits the card in one wave (phase 2)
    k17_dependent = _build.library().lbm_dependent_launches
    k17_dependent.argtypes, k17_dependent.restype = [], ctypes.c_longlong
    before, pdl = k17.launches, k17_dependent()
    t0 = time.perf_counter()
    sed_card = obs.rectangle_sedimentation(device=dev, dtype=f64)
    torch.cuda.synchronize()
    sed_wall = time.perf_counter() - t0
    want_pdl = 500 if k17_wave[256, 320, 1] else 0
    if k17.launches - before != 500 or k17_dependent() - pdl != want_pdl:
        raise AssertionError(f"rectangle_sedimentation float64: {k17.launches - before} "
                             f"kernel-17 launches (not 500), {k17_dependent() - pdl} dependent "
                             f"(not {want_pdl})")
    log(f"[5] rectangle_sedimentation 256x320 float64 500 steps: 500 kernel-17 launches, "
        f"{want_pdl} dependent")

    # rectangle_sedimentation at its defaults in float32 for 20k steps, with
    # tests/test_sedimentation.py's invariants at this geometry (inlet rows
    # 206..255, the rectangle at rows 105.. and cols 200..250)
    before, pdl = k17.launches, k17_dependent()
    want_pdl32 = 20000 if k17_wave[256, 320, 0] else 0
    t0 = time.perf_counter()
    res = obs.rectangle_sedimentation(T=20000, device=dev, dtype=f32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    Cf = res.C.double().cpu().numpy()
    uy = (res.u[1] / res.rho).double().cpu().numpy()
    check_gates(f"[5] rectangle_sedimentation 256x320 float32 20000 steps (host wall time "
                f"{wall!r} s = {wall / 20000 * 1e6!r} us/step)", {
        "finite": (float(torch.isfinite(res.f).all() and torch.isfinite(res.g).all()), 1.0, 1.0),
        "C max": (float(Cf.max()), 1e-4, 1.0),
        "C min": (float(Cf.min()), -1e-3, 1.0),
        "plume: C bottom 50 rows - top 50 rows, cols 1..19":
            (float(Cf[-50:, 1:20].mean() - Cf[:50, 1:20].mean()), 1e-12, 1.0),
        "u_y above the rectangle, rows 0..99 at col 225": (float(uy[:100, 225].mean()),
                                                          0.02, 1.0),
        "kernel-17 launches": (k17.launches - before, 20000, 20000),
        "its dependent launches (all where the grid fits one wave)": (
            k17_dependent() - pdl, want_pdl32, want_pdl32)})
    del res

    # the timed runs are over: the CLIs of every path run in their own
    # process while this one computes the CPU references
    clis += [("cylinder_flow", "--markers", "configs/cylinder-markers.toml", "--x64",
              "--device", "cuda"),
             ("rectangle_sedimentation", "--device", "cuda"),
             ("falling_cylinder", "--device", "cuda"),
             ("falling_cylinders", "--device", "cuda", "--set", "T=2000"),
             ("falling_ellipse", "--device", "cuda", "--set", "T=2000")]
    cli_run = start_clis(clis)
    for ref in (False, True):
        want = obs.cylinder_flow(reference_weights=ref, device="cpu", dtype=f64)
        got = cyl_card[ref]
        check_gates(f"[5] cylinder_flow 160x120 float64 500 steps reference_weights={ref} on "
                    f"the card vs the CPU (card host wall time {cyl_wall[ref]!r} s)", {
            **{f"max|{k}_card - {k}_cpu|": (
                (getattr(got, k).cpu() - getattr(want, k)).abs().max().item(), 0.0, 1e-12)
               for k in ("f", "F_roi", "surface_force")},
            "drag surface_force[0]": (got.surface_force[0].item(), -1e9, -1e-12)})
    del cyl_card, got, want
    want = obs.rectangle_sedimentation(device="cpu", dtype=f64)
    check_gates(f"[5] rectangle_sedimentation 256x320 float64 500 steps on the card vs the CPU "
                f"(card host wall time {sed_wall!r} s)", {
        f"max|{k}_card - {k}_cpu|": (
            (getattr(sed_card, k).cpu() - getattr(want, k)).abs().max().item(), 0.0, 1e-12)
        for k in ("f", "g", "C")})
    del sed_card, want
    want = mp.rk_static_droplet(device="cpu", dtype=f64)
    check_gates(f"[5] rk_static_droplet 101x101 float64 2000 steps on the card vs the CPU "
                f"(card host wall time {drop_wall!r} s)", {
        "finite": (float(torch.isfinite(drop.state.red.f).all()), 1.0, 1.0),
        "max|card - cpu|": (max((g.cpu() - w).abs().max().item() for g, w in (
            (drop.state.red.f, want.state.red.f), (drop.state.blue.f, want.state.blue.f),
            (drop.state.u, want.state.u))), 0.0, 1e-10)})
    del drop, want

    finish_clis(cli_run)

    slice_launches = {name: counted[name].launches for name in ("cylinder", "ibm_forcing",
                                                                 "sediment")}
    log(f"[5] kernel 15-17 path launches: {slice_launches}")
    if not all(slice_launches.values()):
        raise AssertionError("a kernel of the cylinder / sedimentation path never launched")
    launches = {name: launches[name] + k.launches for name, k in counted.items()}

    # the moving-body slice of kernels 18-21 (its CLIs ran with the obstacle
    # slice's): its counts start at 0 here and are read at its end
    for k in counted.values():
        k.launches = 0
    mov_wall = {}

    def moving_run(label, fn, kernel, **kw):
        """One scene run on the card, timed, with one launch of kernel 18 and
        one of ``kernel`` per step."""
        before = k18.launches, kernel.launches
        t0 = time.perf_counter()
        res = fn(device=dev, **kw)
        torch.cuda.synchronize()
        mov_wall[label] = time.perf_counter() - t0
        n = (k18.launches - before[0], kernel.launches - before[1])
        if n != (kw["T"], kw["T"]):
            raise AssertionError(f"{label}: launches {n}, not one of each per step")
        return res

    # validate_tpu.py falling (:455-476): 96x256 f32, T 200; lbm_tpu's
    # fused-against-jnp check becomes the card against the CPU, at the
    # gate's own 5e-4
    kw = dict(H=96, W=256, T=200, center=(24.0, 128.0), radius=8.0, rho_s=1.5, gravity=1e-4,
              record_every=50, dtype=f32)
    res = moving_run("falling", obs.falling_cylinder, k19, **kw)
    want = obs.falling_cylinder(device="cpu", **kw)
    tr, cen = res.trajectory.double().numpy(), res.center.double().cpu().numpy()
    check_gates(f"[5] validate_tpu.py falling: falling_cylinder 96x256 float32 200 steps "
                f"(host wall time {mov_wall['falling']!r} s)", {
        "max|traj_card - traj_cpu|": (float(np.abs(tr - want.trajectory.double().numpy()).max()),
                                      0.0, 5e-4),
        "descent cells": (float(cen[0] - 24.0), 0.01, 10.0),
        "symmetry |dcol|": (float(abs(cen[1] - 128.0)), 0.0, 0.2),
        "reaction sign": (float(-tr[-1, 4] / max(abs(tr[-1, 4]), 1e-30)), 0.999, 1.001)})
    # validate_tpu.py dkt (:479-493): the defaults with row_slack=160, 30k steps
    res = moving_run("dkt", obs.falling_cylinders, k21, T=30000, record_every=500,
                     row_slack=160, dtype=f32)
    tr = res.trajectory.double().numpy()
    gap = np.hypot(tr[:, 0, 0] - tr[:, 1, 0], tr[:, 0, 1] - tr[:, 1, 1]) - 24.0
    lateral = np.abs(tr[:, 0, 1] - tr[:, 1, 1])
    check_gates(f"[5] validate_tpu.py dkt: falling_cylinders 800x128 float32 30000 steps, "
                f"window 228x128 (host wall time {mov_wall['dkt']!r} s = "
                f"{mov_wall['dkt'] / 30000 * 1e6!r} us/step; gap at t = 10k/20k/30k "
                f"{gap[19]!r}/{gap[39]!r}/{gap[59]!r})", {
        "draft min gap": (float(gap.min()), 0.0, 3.0),
        "tumble lateral": (float(lateral[-1]), 5.0, 64.0),
        "finite": (float(np.isfinite(tr).all() and torch.isfinite(res.f).all()), 1.0, 1.0)})
    # validate_tpu.py ellipse (:496-510): 800x256 f32, 60k steps
    res = moving_run("ellipse", obs.falling_ellipse, k20, H=800, W=256, T=60000,
                     center=(100.0, 127.5), a=16.0, b=8.0, theta0=0.3, rho_s=1.25,
                     gravity=2e-4, record_every=500, dtype=f32)
    tr = res.trajectory.double().numpy()
    theta = np.degrees(np.arctan2(tr[:, 7], tr[:, 6]))
    check_gates(f"[5] validate_tpu.py ellipse: falling_ellipse 800x256 float32 60000 steps "
                f"(host wall time {mov_wall['ellipse']!r} s = "
                f"{mov_wall['ellipse'] / 60000 * 1e6!r} us/step)", {
        "final theta deg": (float(theta[-1]), 80.0, 100.0),
        "overshoot deg": (float(theta.max()), 91.0, 120.0),
        "glide cells": (float(np.abs(tr[:, 1] - 127.5).max()), 10.0, 128.0),
        "finite": (float(np.isfinite(tr).all() and torch.isfinite(res.f).all()), 1.0, 1.0)})
    del res
    # each scene at its defaults in float64, 40 steps, on the card against
    # the CPU
    for name, fn, kernel in (("falling_cylinder", obs.falling_cylinder, k19),
                             ("falling_cylinders", obs.falling_cylinders, k21),
                             ("falling_ellipse", obs.falling_ellipse, k20)):
        got = moving_run(f"{name} f64", fn, kernel, T=40, dtype=f64)
        want = fn(T=40, device="cpu", dtype=f64)
        check_gates(f"[5] {name} at its defaults float64 40 steps on the card vs the CPU "
                    f"(card host wall time {mov_wall[f'{name} f64']!r} s)", {
            "max|f_card - f_cpu|": ((got.f.cpu() - want.f).abs().max().item(), 0.0, 1e-12),
            "max|traj_card - traj_cpu|": ((got.trajectory - want.trajectory).abs().max().item(),
                                          0.0, 1e-12)})
    del got, want
    slice_launches = {name: counted[name].launches for name in ("box", "moving_forcing",
                                                                 "moving_rot", "moving_bodies")}
    log(f"[5] kernel 18-21 path launches: {slice_launches}")
    if not all(slice_launches.values()):
        raise AssertionError("a kernel of the falling-body path never launched")
    launches = {name: launches[name] + k.launches for name, k in counted.items()}

    # the cavity and thermal slice of kernels 22-24: its counts start at 0
    # here and are read at its end
    for k in counted.values():
        k.launches = 0
    th_wall = {}
    # kernels 23 and 24 launch through lbm::launch_grid, whose count of
    # programmatic dependent launches the library keeps: every launch of this
    # slice's grids (64x128 and 128x128 in float32, 32x64 and 32x32 in
    # float64) fits the card in one wave, so every one is dependent; the CLIs
    # run in a process of their own
    dependent = _build.library().lbm_dependent_launches
    dependent.argtypes, dependent.restype = [], ctypes.c_longlong
    dependent_before = dependent()

    def slice_run(label, fn, kernel, **kw):
        """One scene run on the card, timed, with one launch of ``kernel`` per
        step."""
        before = kernel.launches
        t0 = time.perf_counter()
        res = fn(device=dev, **kw)
        torch.cuda.synchronize()
        th_wall[label] = time.perf_counter() - t0
        if kernel.launches - before != kw["T"]:
            raise AssertionError(f"{label}: {kernel.launches - before} launches for "
                                 f"{kw['T']} steps")
        return res

    # validate_tpu.py cavity (:298-307): L = 512 float32, 50k steps, F = 3e-5
    res = slice_run("cavity", cavs.ring_cavity, cavity.CAVITY, L=512, T=50000, force=3e-5,
                    dtype=f32)
    u = res.u.cpu().numpy()
    left, right = u[0][:, :128].mean(), u[0][:, -128:].mean()
    check_gates(f"[5] validate_tpu.py cavity: ring_cavity L=512 float32 50000 steps F=3e-5 "
                f"(host wall time {th_wall['cavity']!r} s = "
                f"{th_wall['cavity'] / 50000 * 1e6!r} us/step; arm mean u_x left "
                f"{float(left)!r}, right {float(right)!r})", {
        "max|u|": (float(np.abs(u).max()), 1e-4, 0.1),
        "antisymmetry": (float(left / (-right + 1e-30)), 0.9, 1.1),
        "finite": (float(torch.isfinite(res.f).all()), 1.0, 1.0)})
    # validate_tpu.py thermal (:513-531), in both scalar lattices: Rayleigh-
    # Benard at Ra 1e4 (Clever & Busse 2.661), the de Vahl Davis cavity at
    # Ra 1e4 (2.243)
    for q in (9, 5):
        lat = f"d2q{q}"
        res = slice_run(f"rb {lat}", ths.rayleigh_benard, thermal_kernel(f"thermal_rb_q{q}")[2],
                        H=64, W=128, T=30000, Ra=1e4, Pr=0.71, amp=1e-2, record_every=10000,
                        scalar_lattice=lat, dtype=f32)
        check_gates(f"[5] validate_tpu.py thermal: rayleigh_benard 64x128 {lat} float32 "
                    f"30000 steps (host wall time {th_wall[f'rb {lat}']!r} s = "
                    f"{th_wall[f'rb {lat}'] / 30000 * 1e6!r} us/step; series (Nu, u_rms, "
                    f"theta_max) {res.series.tolist()})", {
            "Nu": (res.nusselt, 2.60, 2.72),
            "saturated |dNu|": (abs(float(res.series[-1, 0] - res.series[-2, 0])), 0.0, 5e-3),
            "finite": (float(torch.isfinite(res.f).all() and torch.isfinite(res.g).all()),
                       1.0, 1.0)})
        res = slice_run(f"hc {lat}", ths.heated_cavity,
                        thermal_kernel(f"heated_cavity_q{q}")[2], H=128, W=128, T=40000,
                        Ra=1e4, Pr=0.71, record_every=10000, scalar_lattice=lat, dtype=f32)
        check_gates(f"[5] validate_tpu.py thermal: heated_cavity 128x128 {lat} float32 "
                    f"40000 steps (host wall time {th_wall[f'hc {lat}']!r} s = "
                    f"{th_wall[f'hc {lat}'] / 40000 * 1e6!r} us/step; series "
                    f"{res.series.tolist()})", {
            "Nu": (res.nusselt, 2.20, 2.29),
            "finite": (float(torch.isfinite(res.f).all() and torch.isfinite(res.g).all()),
                       1.0, 1.0)})
    del res
    # the CLIs, in one process beside the CPU references; each scene at a
    # small size in float64 on the card against the CPU
    cli_run = start_clis([("ring_cavity", "--device", "cuda"),
                          ("rayleigh_benard", "--device", "cuda", "--set", "T=2000",
                           "--set", "scalar_lattice=d2q5"),
                          ("heated_cavity", "--x64", "--device", "cuda", "--set", "T=2000")])
    for label, fn, kernel, kw in (
            ("ring_cavity L=64", cavs.ring_cavity, cavity.CAVITY, dict(L=64, T=200)),
            *((f"rayleigh_benard 32x64 d2q{q}", ths.rayleigh_benard,
               thermal_kernel(f"thermal_rb_q{q}")[2],
               dict(H=32, W=64, T=200, amp=1e-2, record_every=50, scalar_lattice=f"d2q{q}"))
              for q in (9, 5)),
            *((f"heated_cavity 32x32 d2q{q}", ths.heated_cavity,
               thermal_kernel(f"heated_cavity_q{q}")[2],
               dict(H=32, W=32, T=200, record_every=50, scalar_lattice=f"d2q{q}"))
              for q in (9, 5))):
        got = slice_run(f"{label} f64", fn, kernel, dtype=f64, **kw)
        want = fn(device="cpu", dtype=f64, **kw)
        gates = {"max|f_card - f_cpu|": ((got.f.cpu() - want.f).abs().max().item(), 0.0, 1e-12)}
        if not label.startswith("ring"):
            gates.update({
                "max|g_card - g_cpu|": ((got.g.cpu() - want.g).abs().max().item(), 0.0, 1e-12),
                "|Nu_card - Nu_cpu|": (abs(got.nusselt - want.nusselt), 0.0, 1e-12),
                "max|series_card - series_cpu|": (
                    (got.series - want.series).abs().max().item(), 0.0, 1e-12)})
        check_gates(f"[5] {label} float64 200 steps on the card vs the CPU (card host wall "
                    f"time {th_wall[f'{label} f64']!r} s)", gates)
    del got, want
    finish_clis(cli_run)
    slice_launches = {name: counted[name].launches for name in ("cavity", *THERMAL_NAMES)}
    th_dependent = dependent() - dependent_before
    log(f"[5] kernel 22-24 path launches: {slice_launches}; dependent launches {th_dependent}")
    if not all(slice_launches.values()):
        raise AssertionError("a kernel of the cavity / thermal path never launched")
    if th_dependent != sum(slice_launches[name] for name in THERMAL_NAMES):
        raise AssertionError(f"kernels 23 and 24: {th_dependent} dependent launches, not one "
                             "for each of their launches in one wave")
    launches = {name: launches[name] + k.launches for name, k in counted.items()}
    # the D3Q19 slice of kernels 25-26: its counts start at 0 there and are
    # read at its end
    d3_wall = d3q19_path(dev, counted)
    launches = {name: launches[name] + k.launches for name, k in counted.items()}
    # the row-sharded slice of kernels 27-30: its counts start at 0 there and
    # are read at its end
    sharded_path(dev, counted)
    launches = {name: launches[name] + k.launches for name, k in counted.items()}
    # kernels 31-34: their counts start at 0 there and are read at its end
    k31_34_path(dev, counted)
    launches = {name: launches[name] + k.launches for name, k in counted.items()}
    # kernels 35-38: the same
    k35_38_path(dev, counted)
    launches = {name: launches[name] + k.launches for name, k in counted.items()}
    # kernel 39: the same
    lanes_path(dev, counted)
    launches = {name: launches[name] + k.launches for name, k in counted.items()}
    log(f"[5] main-path launches: {launches}")
    if not all(launches.values()):
        raise AssertionError("a kernel of the main path was never launched")

    # 6. times at 4096x2048 float32, in turns (kernel, plain, ..., then the
    # reverse order, then again); the states are bench.py's where it has one
    cells = R * C
    f = seeded_state(R, C, f32, dev, seed=6)
    fi = seeded_state(R, C, f32, dev, seed=7, incompressible=True)
    u = torch.zeros((2, R, C), dtype=f32, device=dev)
    u[0] = 0.05  # bench.py's KBC state: the equilibrium at u = (0.05, 0)
    fk = kbc.equilibrium(torch.ones((R, C), dtype=f32, device=dev), u)
    fc = seeded_state(R, C, f32, dev, seed=10, noisy=True)
    m0, u = ulbm.double_shear_init(R, C, 0.05, device=dev, dtype=f32)
    fl = d2q9.equilibrium(u, m0).contiguous()
    plain1 = collide_stream.make_fused_step(R, C, bgk.bgk_collide_fn(OMEGA, f32), f32)
    model = channel.channel_model(1 / tau, rho_in, 1.0)
    plain3 = collide_stream.make_fused_step(R, C, collide_stream.kbc_collide_fn(OMEGA), f32)
    plain4 = channel.kbc_channel_step(ULBM_S2, ULBM_RHO_IN, 1.0)
    plain5 = collide_stream.make_fused_step(R, C, les.les_collide_fn(dtype=f32, **LES), f32)
    dst = torch.empty_like(f)
    S8 = mrtcg_state(R, C, f32, dev)
    G6 = reduced_input(S8, False)
    G6c = reduced_input(mrtcg_state(R, C, f32, dev, csf=True), True)
    mrt = {layout_csf: mrtcg_steps(layout_csf[0], R, C, f32, layout_csf[1])
           for layout_csf in (("reduced", False), ("reduced", True), ("split", False),
                              ("full", False))}
    grav, free = (channel.ChannelVariant(**VARIANTS[k]) for k in ("gravity", "free_stream"))
    grav_c, free_c = grav.constants(f32), free.constants(f32)
    fs = seeded_state(R, C, f32, dev, seed=13, incompressible=True, noisy=True)
    fp = shear_state(R, C, f32, dev)
    plain9g, plain9f = grav.model().step, free.model().step
    plain10 = collide_stream.make_fused_step(
        R, C, trt.trt_collide_fn(TRT_OMEGA, trt_minus, f32), f32)
    plain11 = collide_stream.make_fused_step(
        R, C, power_law.power_law_collide_fn(tau_min=0.52, tau_max=50.0, iters=8, dtype=f32,
                                             **PLAW), f32)

    def new_kernels(dtype):
        """(kernel call, plain call) of kernels 12-14 at 4096x2048, from the
        states of phase 3 (kernel 14: sc/guo and cs/shift)."""
        S12, S13 = rk_state(R, C, dtype, dev), csf_drop_state(R, C, dtype, dev)
        f14, f14c = (sc_state(R, C, dtype, dev, eos, seed=15) for eos in ("sc", "cs"))
        k = {"rk_cg": (rk.make_rk_fused_step(R, C, dtype=dtype, **RK), rk.make_plain_step(**RK),
                       S12),
             "csf_droplet": (csf_droplet.make_csf_droplet_fused_step(
                 R, C, red13, blue13, 0.1, dtype=dtype),
                 csf_droplet.make_plain_step(red13, blue13, 0.1), S13)}
        for name, eos, x in (("shan_chen", ("sc", "guo"), f14), ("shan_chen_cs", ("cs", "shift"),
                                                                 f14c)):
            kw = sc_kwargs(*eos)
            k[name] = (shan_chen.make_sc_fused_step(R, C, dtype=dtype, **kw),
                       shan_chen.make_plain_step(**kw), x)
        return {name: ((lambda s=s, x=x: s(x)), (lambda q=q, x=x: q(x)))
                for name, (s, q, x) in k.items()}

    new32 = new_kernels(f32)

    def obstacle_kernels(dtype):
        """(kernel call, plain call) of kernels 15, 17 and 18 at 4096x2048:
        kernel 15 from a noisy state with a force over the Strouhal cylinder's
        ROI, kernel 17 from the scene's initial state with noise, kernel 18
        from a noisy state with a 34x34 force window at a device origin."""
        ib = IBM.circle(*STROUHAL_CIRCLE)
        f15, F15, o15 = cylinder_case(R, C, dtype, dev, ib, seed=615)
        c15 = cylinder.cylinder_constants(1 / 0.55, (0.05, 0.0), (3.0, 9.0), dtype)
        F18 = torch.as_tensor(np.random.default_rng(618).normal(0.0, 1e-3, (2, 34, 34)),
                              dtype=dtype, device=dev)
        o18 = torch.tensor([1990, 1010], dtype=torch.int32, device=dev)
        c18 = cylinder.box_constants(1 / 0.6, (3.0, 9.0), dtype)
        kw = sediment_kwargs(R, C)
        S17 = sediment_state(R, C, dtype, dev, seed=617)
        step17 = sediment.make_sediment_fused_step(R, C, dtype=dtype, **kw)
        plain_kw = dict(kw, R23=kw["R23"] % R)
        return {
            "cylinder": ((lambda: cylinder.cylinder_step(f15, F15, o15, c15)),
                         (lambda: cylinder.plain_cylinder_step(f15, F15, o15, 1 / 0.55,
                                                               (0.05, 0.0), (3.0, 9.0)))),
            "sediment": ((lambda: step17(S17)),
                         (lambda: sediment.plain_sediment_step(S17, **plain_kw))),
            "box": ((lambda: cylinder.box_step(f15, F18, o18, c18)),
                    (lambda: cylinder.plain_box_step(f15, F18, o18, 1 / 0.6)))}

    obst32 = obstacle_kernels(f32)
    fns = {
        "collide_stream_bgk": (lambda: collide_stream.collide_stream_bgk(f, OMEGA), 50),
        "collide_stream_bgk_plain": (lambda: plain1(f), 10),
        "channel_bgk": (lambda: channel.channel_bgk(fi, 1 / tau, rho_in, 1.0), 50),
        "channel_bgk_plain": (lambda: model.step(fi), 10),
        "collide_stream_kbc": (lambda: collide_stream.collide_stream_kbc(fk, OMEGA), 50),
        "collide_stream_kbc_direct": (lambda: collide_stream.collide_stream_kbc(
            fk, OMEGA, gamma_impl="direct"), 50),
        "collide_stream_kbc_plain": (lambda: plain3(fk), 5),
        "channel_kbc": (lambda: channel.channel_kbc(fc, ULBM_S2, ULBM_RHO_IN, 1.0), 50),
        "channel_kbc_plain": (lambda: plain4(fc), 5),
        "collide_stream_les": (lambda: les.collide_stream_les(fl, **LES), 50),
        "collide_stream_les_plain": (lambda: plain5(fl), 10),
        "mrtcg_reduced": (lambda: mrt["reduced", False][0](G6), 30),
        "mrtcg_reduced_plain": (lambda: mrt["reduced", False][1](G6), 3),
        "mrtcg_reduced_csf": (lambda: mrt["reduced", True][0](G6c), 30),
        "mrtcg_reduced_csf_plain": (lambda: mrt["reduced", True][1](G6c), 3),
        "mrtcg_split": (lambda: mrt["split", False][0](G6), 30),
        "mrtcg_split_plain": (lambda: mrt["split", False][1](G6), 3),
        "mrtcg_full": (lambda: mrt["full", False][0](S8), 30),
        "mrtcg_full_plain": (lambda: mrt["full", False][1](S8), 3),
        "channel_variant": (lambda: channel.channel_variant(fi, grav, grav_c), 50),
        "channel_variant_plain": (lambda: plain9g(fi), 10),
        "channel_variant_free_stream": (lambda: channel.channel_variant(fs, free, free_c), 50),
        "channel_variant_free_stream_plain": (lambda: plain9f(fs), 10),
        "collide_stream_trt": (lambda: trt.collide_stream_trt(f, TRT_OMEGA, trt_minus), 50),
        "collide_stream_trt_plain": (lambda: plain10(f), 10),
        "collide_stream_power_law": (lambda: power_law.collide_stream_power_law(fp, **PLAW), 50),
        "collide_stream_power_law_plain": (lambda: plain11(fp), 5),
        **{k: v for name, (kern, plain) in new32.items() for k, v in (
            (name, (kern, 30 if name in ("rk_cg", "csf_droplet") else 50)),
            (f"{name}_plain", (plain, 3 if name in ("rk_cg", "csf_droplet") else 5)))},
        "cylinder": (obst32["cylinder"][0], 50),
        "cylinder_plain": (obst32["cylinder"][1], 5),
        "sediment": (obst32["sediment"][0], 30),
        "sediment_plain": (obst32["sediment"][1], 3),
        "box": (obst32["box"][0], 50),
        "box_plain": (obst32["box"][1], 5),
        "copy": (lambda: dst.copy_(f), 50),
    }
    runs = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1], list(fns)):
        for k in order:
            fn, n = fns[k]
            runs[k].append(cuda_ms(fn, n))
    ms = {k: sorted(v)[1] for k, v in runs.items()}  # median of 3
    copy_gbs = 2 * f.numel() * 4 / (ms["copy"] * 1e-3) / 1e9
    log(f"[6] {card}; copy of {f.numel() * 4 / 1e6:.1f} MB: {ms['copy']!r} ms "
        f"= {copy_gbs!r} GB/s (read + write)")
    # bytes per cell in float32: each input plane read once, each output
    # plane written once
    bytes32 = {"mrtcg_reduced": 80, "mrtcg_reduced_csf": 96, "mrtcg_split": 112,
               "mrtcg_full": 144, "rk_cg": 88, "csf_droplet": 160, "sediment": 144}
    for k in fns:
        if k == "copy":
            continue
        b = bytes32.get(k.removesuffix("_plain"), 72)
        mlups = cells / (ms[k] * 1e-3) / 1e6
        gbs = b * cells / (ms[k] * 1e-3) / 1e9
        log(f"[6] {k}: {ms[k]!r} ms/step (runs {runs[k]}) = {mlups!r} MLUPS, "
            f"{gbs!r} GB/s at {b} B/cell = {gbs / copy_gbs!r} of copy")
    del f, fi, fk, fc, fl, dst, S8, G6, G6c, mrt, fs, fp, new32, obst32
    torch.cuda.empty_cache()
    f = seeded_state(R, C, f64, dev, seed=8)
    fs = seeded_state(R, C, f64, dev, seed=14, incompressible=True, noisy=True)
    fp = shear_state(R, C, f64, dev)
    grav_c, free_c = grav.constants(f64), free.constants(f64)
    fi = seeded_state(R, C, f64, dev, seed=9, incompressible=True)
    fc = seeded_state(R, C, f64, dev, seed=11, noisy=True)
    S8 = mrtcg_state(R, C, f64, dev)
    G6 = reduced_input(S8, False)
    G6c = reduced_input(mrtcg_state(R, C, f64, dev, csf=True), True)
    mrt = {layout_csf: mrtcg_steps(layout_csf[0], R, C, f64, layout_csf[1])[0]
           for layout_csf in (("reduced", False), ("reduced", True), ("split", False),
                              ("full", False))}
    new64 = new_kernels(f64)
    obst64 = obstacle_kernels(f64)
    ms64 = {}
    for k, fn in (
            ("collide_stream_bgk", lambda: collide_stream.collide_stream_bgk(f, OMEGA)),
            ("channel_bgk", lambda: channel.channel_bgk(fi, 1 / tau, rho_in, 1.0)),
            ("collide_stream_kbc", lambda: collide_stream.collide_stream_kbc(f, OMEGA)),
            ("collide_stream_kbc_direct", lambda: collide_stream.collide_stream_kbc(
                f, OMEGA, gamma_impl="direct")),
            ("channel_kbc", lambda: channel.channel_kbc(fc, ULBM_S2, ULBM_RHO_IN, 1.0)),
            ("collide_stream_les", lambda: les.collide_stream_les(f, **LES)),
            ("mrtcg_reduced", lambda: mrt["reduced", False](G6)),
            ("mrtcg_reduced_csf", lambda: mrt["reduced", True](G6c)),
            ("mrtcg_split", lambda: mrt["split", False](G6)),
            ("mrtcg_full", lambda: mrt["full", False](S8)),
            ("channel_variant", lambda: channel.channel_variant(fi, grav, grav_c)),
            ("channel_variant_free_stream", lambda: channel.channel_variant(fs, free, free_c)),
            ("collide_stream_trt", lambda: trt.collide_stream_trt(f, TRT_OMEGA, trt_minus)),
            ("collide_stream_power_law",
             lambda: power_law.collide_stream_power_law(fp, **PLAW)),
            *((name, kern) for name, (kern, _) in new64.items()),
            *((name, kern) for name, (kern, _) in obst64.items())):
        t = ms64[k] = cuda_ms(fn, 20 if k.startswith(("mrtcg", "rk", "csf", "sed")) else 50)
        b = 2 * bytes32.get(k, 72)
        gbs = b * cells / (t * 1e-3) / 1e9
        log(f"[6] {k} float64: {t!r} ms/step = {cells / (t * 1e-3) / 1e6!r} MLUPS, "
            f"{gbs!r} GB/s at {b} B/cell = {gbs / copy_gbs!r} of copy")
    # the plain versions of kernels 9-11 in float64
    plain10_64 = collide_stream.make_fused_step(
        R, C, trt.trt_collide_fn(TRT_OMEGA, trt_minus, f64), f64)
    plain11_64 = collide_stream.make_fused_step(
        R, C, power_law.power_law_collide_fn(tau_min=0.52, tau_max=50.0, iters=8, dtype=f64,
                                             **PLAW), f64)
    plain64 = {}
    for k, fn in (("channel_variant", lambda: plain9g(fi)),
                  ("channel_variant_free_stream", lambda: plain9f(fs)),
                  ("collide_stream_trt", lambda: plain10_64(f)),
                  ("collide_stream_power_law", lambda: plain11_64(fp)),
                  *((name, plain) for name, (_, plain) in new64.items()),
                  *((name, plain) for name, (_, plain) in obst64.items())):
        plain64[k] = cuda_ms(fn, 3 if k in ("rk_cg", "csf_droplet", "sediment") else 5)
        log(f"[6] {k}_plain float64: {plain64[k]!r} ms/step")
    del f, fi, fc, S8, G6, G6c, mrt, fs, fp, new64, obst64
    torch.cuda.empty_cache()

    # kernel 6 at the reference's RT grid, 256x128: the device time per
    # step from a CUDA graph of 100 steps (one step issues in ~30 us on the
    # host, longer than the kernel runs, so events around eager launches
    # time the host), and the host time per step of the 100k-step runs
    for dtype in (f32, f64):
        G = reduced_input(mrtcg_state(256, 128, dtype, dev), False)
        step, _ = mrtcg_steps("reduced", 256, 128, dtype, False)
        t_graph = graph_ms(step, G)
        t_eager = cuda_ms(lambda: step(G), 500)
        wall, steps = mrt_wall[f"mrtcg_rayleigh_taylor 256x128 {dtype} 100000 steps"]
        log(f"[6] mrtcg_reduced 256x128 {dtype}: {t_graph!r} device ms/step (CUDA graph "
            f"of 100 steps), {t_eager!r} ms/step issued eagerly, "
            f"{wall / steps * 1e6!r} host us/step over the 100k-step run")

    # kernel 12 at the reference's RK grid, 1024x256: as kernel 6 above
    ms_rk_small = {}
    for dtype in (f32, f64):
        S = rk_state(1024, 256, dtype, dev)
        step = rk.make_rk_fused_step(1024, 256, dtype=dtype, **RK)
        ms_rk_small[dtype] = t_graph = graph_ms(step, S)
        t_eager = cuda_ms(lambda: step(S), 500)
        log(f"[6] rk_cg 1024x256 {dtype}: {t_graph!r} device ms/step (CUDA graph of 100 "
            f"steps) = {1024 * 256 / (t_graph * 1e-3) / 1e6!r} MLUPS, {t_eager!r} ms/step "
            f"issued eagerly, {rk_wall[dtype] / 100000 * 1e6!r} host us/step over the "
            f"100k-step run")
        del S

    # kernels 16 and 15 at the Strouhal grid, 1024x256: each alone and the
    # whole step (16 then 15) under a CUDA graph of 100 calls, against the
    # host time per step of the 200k-step run; kernel 16 is one block, on one
    # SM of 132, and bound by its latency (forcing_work gives its bytes and
    # operations)
    ib = IBM.circle(*STROUHAL_CIRCLE)
    strouhal_ms, forcing_bound = {}, {}
    for dtype in (f32, f64):
        f, F, origin = cylinder_case(1024, 256, dtype, dev, ib, seed=616)
        force = kibm.make_ibm_forcing_step(1024, 256, ib, dtype)
        grid = cylinder.make_cylinder_fused_step(1024, 256, 1 / 0.55, (0.05, 0.0), (3.0, 9.0),
                                                 dtype)
        def forcing_only(x):
            force(x)
            return x

        t16 = graph_ms(forcing_only, f)
        t15 = graph_ms(lambda x: grid(x, F, origin), f)
        t_step = graph_ms(lambda x: grid(x, force(x), origin), f)
        t16_plain = cuda_ms(lambda: ib.force_from_populations(f), 50)
        fb, fo = forcing_work(ib, f.element_size())
        forcing_bound[dtype] = bound(fb / (1024 * 256), fo / (1024 * 256), 1024 * 256,
                                     str(dtype).removeprefix("torch."))
        strouhal_ms[dtype] = (t16, t15, t_step, t16_plain)
        log(f"[6] Strouhal step 1024x256 {dtype} (CUDA graphs of 100): kernel 16 {t16!r} ms "
            f"(ROI {ib.roi_shape}, 64 markers, one block on one SM of 132; plain version "
            f"{t16_plain!r} ms eager; bound {forcing_bound[dtype][0]!r} ms by "
            f"{forcing_bound[dtype][1]}: {fb} B, {fo} operations), kernel 15 {t15!r} ms, "
            f"the step {t_step!r} ms; host {strouhal_wall / 200000 * 1e3!r} ms per step in "
            f"the 200k-step run")
        del f, F

    # kernels 19-21 at their scenes' default sizes: the forcing kernel alone,
    # kernel 18 alone and the two-launch step under CUDA graphs of 100 calls,
    # the plain forcing eagerly, against the host time per step of the
    # phase-5 runs; each kernel's forcing is one block on one SM of 132 (more
    # blocks zero the window), bound by its latency (moving_work gives its
    # bytes and operations at this run's support)
    mov_ms, mov_bound = {}, {}
    host_us = {"moving_forcing": mov_wall["falling"] / 200 * 1e6,
               "moving_rot": mov_wall["ellipse"] / 60000 * 1e6,
               "moving_bodies": mov_wall["dkt"] / 30000 * 1e6}
    for variant, name, markers in (("forcing", "moving_forcing", 76), ("rot", "moving_rot", 78),
                                   ("bodies", "moving_bodies", 152)):
        for dtype in (f32, f64):
            step, f, state = moving_case(variant, dtype, dev)
            H, W = f.shape[1:]
            grid = cylinder.make_box_fused_step(H, W, 1 / 0.6, dtype=dtype)
            F, origin, _ = step(f, state)
            t_force = graph_ms(lambda s_, step=step, f=f: step(f, s_)[2], state)
            t_box = graph_ms(lambda x, grid=grid, F=F, o=origin: grid(x, F, o), f)

            def two(c, step=step, grid=grid):
                F2, o2, s2 = step(*c)
                return grid(c[0], F2, o2), s2

            t_step = graph_ms(two, (f, state))
            t_plain = cuda_ms(lambda step=step, f=f, state=state: step.plain(f, state), 20)
            wb, wo = moving_work(F, markers, state.shape[0], 4, f.element_size())
            mov_bound[name, dtype] = bound(wb, wo, 1, str(dtype).removeprefix("torch."))
            mov_ms[name, dtype] = (t_force, t_box, t_step, t_plain)
            log(f"[6] {name} ({variant}) {H}x{W} {dtype}, window {tuple(F.shape[1:])}, "
                f"{markers} markers (CUDA graphs of 100): kernel {t_force!r} ms (plain "
                f"{t_plain!r} ms eager; bound {mov_bound[name, dtype][0]!r} ms by "
                f"{mov_bound[name, dtype][1]}: {wb} B, {wo} operations), kernel 18 {t_box!r} ms, "
                f"the step {t_step!r} ms")
            del f, F
    log(f"[6] host us per step of the phase-5 runs: falling 96x256 f32 (200 steps) "
        f"{host_us['moving_forcing']!r}, ellipse 800x256 f32 (60k) "
        f"{host_us['moving_rot']!r}, dkt 800x128 f32 (30k) {host_us['moving_bodies']!r}")

    # kernel 22 at L = 4096 (ring_cavity's geometry, 16.8M cells) and
    # kernels 23 and 24 in both lattices at 4096x2048, in float32 and
    # float64, each in turns with its plain version (median of 3); the bound
    # from this run's inputs: the bytes (each plane read once and written
    # once) over HBM3's rate against the plain version's operations on the
    # same state, counted on the card (the cavity's Guo source counts on its
    # strip only)
    th_ms, th_bound = {}, {}
    for dtype in (f32, f64):
        L = 4096
        cases = {"cavity": (cavity.make_cavity_fused_step(L, omega=CAVITY_OMEGA, force=3e-5,
                                                          dtype=dtype),
                            lambda x: cavity.plain_cavity_step(x, omega=CAVITY_OMEGA,
                                                               force=3e-5),
                            seeded_state(L, L, dtype, dev, seed=622, noisy=True), 9)}
        for name in THERMAL_NAMES:
            make, plain, _, q = thermal_kernel(name)
            cases[name] = (make(R, C, dtype=dtype, scalar_lattice=f"d2q{q}", **THERMAL_PHYS),
                           lambda x, plain=plain: plain(x, **THERMAL_PHYS),
                           thermal_state(q, R, C, dtype, dev, seed=623 + q), 9 + q)
        calls = [(name, i) for name in cases for i in (0, 1)]
        th_runs = {c: [] for c in calls}
        for order in (calls, calls[::-1], calls):
            for name, i in order:
                fn, x = cases[name][i], cases[name][2]
                th_runs[name, i].append(cuda_ms(lambda: fn(x), 30 if i == 0 else 3))
        for name, (_, plain, x, planes) in cases.items():
            n = x.shape[1] * x.shape[2]
            t, tp = (sorted(th_runs[name, i])[1] for i in (0, 1))
            b = 2 * planes * x.element_size()
            ops = ops_per_cell(plain, x)
            th_bound[name, dtype] = bound(b, ops, n, str(dtype).removeprefix("torch."))
            th_ms[name, dtype] = (t, tp)
            gbs = b * n / (t * 1e-3) / 1e9
            log(f"[6] {name} {x.shape[1]}x{x.shape[2]} {dtype}: {t!r} ms/step (runs "
                f"{th_runs[name, 0]}) = {n / (t * 1e-3) / 1e6!r} MLUPS, {gbs!r} GB/s at {b} "
                f"B/cell = {gbs / copy_gbs!r} of copy; plain {tp!r} ms; bound "
                f"{th_bound[name, dtype][0]!r} ms by {th_bound[name, dtype][1]} ({ops!r} "
                f"flops/cell)")
        del cases, th_runs
        torch.cuda.empty_cache()
    # the gate runs' steps under CUDA graphs of 100 steps, against the host
    # time per step of the phase-5 runs
    th_graph = {}
    for label, name, (Rg, Cg), steps in (("cavity", "cavity", (512, 512), 50000),
                                          ("rb d2q9", "thermal_rb_q9", (64, 128), 30000),
                                          ("rb d2q5", "thermal_rb_q5", (64, 128), 30000),
                                          ("hc d2q9", "heated_cavity_q9", (128, 128), 40000),
                                          ("hc d2q5", "heated_cavity_q5", (128, 128), 40000)):
        if name == "cavity":
            step = cavity.make_cavity_fused_step(Rg, omega=CAVITY_OMEGA, force=3e-5, dtype=f32)
            x = seeded_state(Rg, Cg, f32, dev, seed=1)
        else:
            make, _, _, q = thermal_kernel(name)
            step = make(Rg, Cg, dtype=f32, scalar_lattice=f"d2q{q}", **THERMAL_PHYS)
            x = thermal_state(q, Rg, Cg, f32, dev, seed=2)
        t = graph_ms(step, x)
        host = th_wall[label] / steps * 1e3
        th_graph[name] = (t, host)
        log(f"[6] {label} gate step {Rg}x{Cg} float32 (CUDA graph of 100): {t!r} device "
            f"ms/step; host {host!r} ms/step over the phase-5 run ({th_wall[label]!r} s): "
            f"device busy {t / host!r}")

    d3_times = d3q19_times(dev, card, d3_wall)
    sh_times = sharded_times(dev, card)
    lanes_tm = lanes_times(dev, card)
    # the MRT-CG engines' kernels (and kernel 12, the control): the tile and
    # the strip engine, and the parent tree's where --parent names one
    parent_lib = build_parent(parent) if parent is not None else None
    engine_tm = engine_times(dev, card, parent_lib, engine_rows)
    # kernels 16 and 19-21 and their steps against the parent tree's design
    ibm_tm = ibm_times(dev, card, load_parent_ibm(parent)) if parent is not None else {}
    # kernels 12 and 36 at their launch shapes and at 4096x2048 (kernel 12 at
    # each tile height), against the parent tree's where --parent names one
    rk_k36_tm = rk_k36_times(dev, card, parent)
    # kernels 4 and 33 at their launch shapes and at the big grids, with the
    # exchange alone at 33's, against the parent tree's where --parent names one
    k4_k33_tm = k4_k33_times(dev, card, parent)
    # kernels 2 and 9 at their launch shapes, the gate's 21x21 and the big
    # grid, against the parent tree's where --parent names one
    k2_k9_tm = k2_k9_times(dev, card, parent)
    # kernels 27 and 34 at their launch shape and at one step a call, every
    # collision, with the exchange alone, against the parent tree's where
    # --parent names one
    k27_k34_tm = k27_k34_times(dev, card, parent)
    # kernels 32 and 35 at their launch shape and at the big grid, against the
    # parent tree's where --parent names one
    k32_k35_tm = k32_k35_times(dev, card, parent)
    # kernels 37 and 14 at their launch shapes and at the big grid, against
    # the parent tree's where --parent names one
    k37_k14_tm = k37_k14_times(dev, card, parent)
    # kernels 23 and 24 at their launch shapes and at the big grid, with their
    # loss, against the parent tree's (and 28 too) where --parent names one
    k23_k24_tm = k23_k24_times(dev, card, parent)
    # kernels 17 and 30 at their launch shapes and at the big grid, with their
    # loss, against the parent tree's where --parent names one
    k17_k30_tm = k17_k30_times(dev, card, parent)

    log(f"[6] nvidia-smi clocks.sm,power.draw,temperature.gpu: "
        f"{nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")

    # the bound of each kernel at 4096x2048 float32: its bytes over HBM3's
    # rate against its operations (counted on its plain version at 64x64 on
    # the CPU) over the fp32 peak
    small = 64
    cpu = torch.device("cpu")
    S_small = mrtcg_state(small, small, f32, cpu)
    plains = {
        "collide_stream_bgk": (collide_stream.make_fused_step(
            small, small, bgk.bgk_collide_fn(OMEGA, f32), f32),
            seeded_state(small, small, f32, cpu, seed=1)),
        "channel_bgk": (channel.channel_model(1 / tau, rho_in, 1.0).step,
                        seeded_state(small, small, f32, cpu, seed=2, incompressible=True)),
        "collide_stream_kbc": (collide_stream.make_fused_step(
            small, small, collide_stream.kbc_collide_fn(OMEGA), f32),
            seeded_state(small, small, f32, cpu, seed=3, noisy=True)),
        "collide_stream_kbc_direct": (collide_stream.make_fused_step(
            small, small, collide_stream.kbc_collide_fn(OMEGA, "direct"), f32),
            seeded_state(small, small, f32, cpu, seed=3, noisy=True)),
        "channel_kbc": (channel.kbc_channel_step(ULBM_S2, ULBM_RHO_IN, 1.0),
                        seeded_state(small, small, f32, cpu, seed=4, noisy=True)),
        "collide_stream_les": (collide_stream.make_fused_step(
            small, small, les.les_collide_fn(dtype=f32, **LES), f32),
            seeded_state(small, small, f32, cpu, seed=5)),
        "mrtcg_reduced": (mrtcg_steps("reduced", small, small, f32, False)[1],
                          reduced_input(S_small, False)),
        "mrtcg_reduced_csf": (mrtcg_steps("reduced", small, small, f32, True)[1],
                              reduced_input(mrtcg_state(small, small, f32, cpu, True), True)),
        "mrtcg_split": (mrtcg_steps("split", small, small, f32, False)[1],
                        reduced_input(S_small, False)),
        "mrtcg_full": (mrtcg_steps("full", small, small, f32, False)[1], S_small),
        "channel_variant": (grav.model().step,
                            seeded_state(small, small, f32, cpu, seed=6, incompressible=True)),
        "channel_variant_free_stream": (free.model().step, seeded_state(
            small, small, f32, cpu, seed=7, incompressible=True, noisy=True)),
        "collide_stream_trt": (collide_stream.make_fused_step(
            small, small, trt.trt_collide_fn(TRT_OMEGA, trt_minus, f32), f32),
            seeded_state(small, small, f32, cpu, seed=8, noisy=True)),
        "collide_stream_power_law": (collide_stream.make_fused_step(
            small, small, power_law.power_law_collide_fn(
                tau_min=0.52, tau_max=50.0, iters=8, dtype=f32, **PLAW), f32),
            shear_state(small, small, f32, cpu)),
        "rk_cg": (rk.make_plain_step(**RK), rk_state(small, small, f32, cpu)),
        "csf_droplet": (csf_droplet.make_plain_step(red13, blue13, 0.1),
                        csf_drop_state(small, small, f32, cpu)),
        "shan_chen": (shan_chen.make_plain_step(**sc_kwargs("sc", "guo")),
                      sc_state(small, small, f32, cpu, "sc", seed=1)),
        "shan_chen_cs": (shan_chen.make_plain_step(**sc_kwargs("cs", "shift")),
                         sc_state(small, small, f32, cpu, "cs", seed=2)),
        # kernel 15 with a 2x2 force: at 4096x2048 the ROI is 0.02% of the grid
        "cylinder": (lambda x: cylinder.plain_cylinder_step(
            x, torch.full((2, 2, 2), 1e-3), (10, 10), 1 / 0.55, (0.05, 0.0), (3.0, 9.0)),
            seeded_state(small, small, f32, cpu, seed=15, noisy=True)),
        # kernel 18 with a 2x2 force window, as kernel 15 above
        "box": (lambda x: cylinder.plain_box_step(
            x, torch.full((2, 2, 2), 1e-3), torch.tensor([10, 10], dtype=torch.int32), 1 / 0.6),
            seeded_state(small, small, f32, cpu, seed=18, noisy=True)),
        "sediment": (lambda x: sediment.plain_sediment_step(
            x, **dict(SED, R23=40, C28=20, C38=30, inlet_rows=16)),
            obs.sediment_initial_state(small, small, 0.02, 1e-3, 16, cpu, f32)),
    }
    bounds = {}
    for name, (fn, x) in plains.items():
        ops = ops_per_cell(fn, x)
        b = bytes32.get(name, 72)
        bounds[name] = bound(b, ops, cells, "float32")
        b64 = bound(2 * b, ops, cells, "float64")
        log(f"[6] bound {name} at {R}x{C}: {b} B/cell, {ops!r} flops/cell -> float32 "
            f"{bounds[name][0]!r} ms ({bounds[name][1]}), float64 {b64[0]!r} ms ({b64[1]})")

    # every kernel left at the shape its phase-5 launches run, ranked by loss
    shape_rows = launch_shape_times(dev, card, launches, counted)

    ms["ibm_forcing"], ms["ibm_forcing_plain"] = strouhal_ms[f32][0], strouhal_ms[f32][3]
    ms64["ibm_forcing"], plain64["ibm_forcing"] = strouhal_ms[f64][0], strouhal_ms[f64][3]
    bounds["ibm_forcing"] = forcing_bound[f32]
    rows = [
        ("collide_stream_bgk", "lbm_tpu/kernels/bgk_pallas.py:74", err1),
        ("channel_bgk", "lbm_tpu/kernels/channel_pallas.py:128", err2),
        ("collide_stream_kbc", "lbm_tpu/kernels/collide_stream.py:154", err3),
        ("channel_kbc", "lbm_tpu/kernels/channel_pallas.py:128", err4),
        ("collide_stream_les", "lbm_tpu/kernels/les_pallas.py:78", err5),
        ("mrtcg_reduced", "lbm_tpu/kernels/mrtcg_pallas.py:1004", err_mrt["reduced"]),
        ("mrtcg_split", "lbm_tpu/kernels/mrtcg_pallas.py:1129", err_mrt["split"]),
        ("mrtcg_full", "lbm_tpu/kernels/mrtcg_pallas.py:876", err_mrt["full"]),
        ("channel_variant", "lbm_tpu/kernels/channel_pallas.py:158", err9),
        ("collide_stream_trt", "lbm_tpu/kernels/trt_pallas.py:74", err10),
        ("collide_stream_power_law", "lbm_tpu/kernels/power_law_pallas.py:144", err11),
        ("rk_cg", "lbm_tpu/kernels/rk_pallas.py:163", err12),
        ("csf_droplet", "lbm_tpu/kernels/csf_droplet_pallas.py:66", err13),
        ("shan_chen", "lbm_tpu/kernels/shan_chen_pallas.py:172", err14),
        ("cylinder", "lbm_tpu/kernels/cylinder_pallas.py:129", err15),
        ("ibm_forcing", "lbm_tpu/kernels/ibm_pallas.py:39", err16),
        ("sediment", "lbm_tpu/kernels/sediment_pallas.py:79", err17),
        ("box", "lbm_tpu/kernels/cylinder_pallas.py:153", err18),
        *((f"moving_{v}", f"lbm_tpu/kernels/moving_ibm_pallas.py:{line}",
           {dt: err_mov[v][dt][0] for dt in (f32, f64)})
          for v, line in (("forcing", 163), ("rot", 301), ("bodies", 452))),
    ]
    sources = {"box": "cylinder", "moving_forcing": "moving_ibm", "moving_rot": "moving_ibm",
               "moving_bodies": "moving_ibm"}
    for name, _, _ in rows[-3:]:
        ms[name], ms[f"{name}_plain"] = mov_ms[name, f32][0], mov_ms[name, f32][3]
        ms64[name], plain64[name] = mov_ms[name, f64][0], mov_ms[name, f64][3]
        bounds[name] = mov_bound[name, f32]
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"lbm_tpu_torch/csrc/{sources.get(name, name)}.cu",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": errs[f32], "max_abs_err_f64": errs[f64],
         "ms": ms[name], "plain_ms": ms[f"{name}_plain"],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None,
         "ms_f64": ms64[name]}
        for name, replaces, errs in rows]
    kernels[2].update(ms_direct=ms["collide_stream_kbc_direct"],
                      ms_direct_f64=ms64["collide_stream_kbc_direct"],
                      bound_ms_direct=bounds["collide_stream_kbc_direct"][0])
    kernels[5].update(engine_ms=engine_tm)
    kernels[5].update(ms_csf=ms["mrtcg_reduced_csf"],
                      plain_ms_csf=ms["mrtcg_reduced_csf_plain"],
                      ms_csf_f64=ms64["mrtcg_reduced_csf"],
                      bound_ms_csf=bounds["mrtcg_reduced_csf"][0])
    kernels[8].update(ms_free_stream=ms["channel_variant_free_stream"],
                      plain_ms_free_stream=ms["channel_variant_free_stream_plain"],
                      ms_free_stream_f64=ms64["channel_variant_free_stream"],
                      plain_ms_free_stream_f64=plain64["channel_variant_free_stream"],
                      bound_ms_free_stream=bounds["channel_variant_free_stream"][0])
    for entry in kernels[8:]:
        entry["plain_ms_f64"] = plain64[entry["name"]]
    kernels[11].update(ms_1024x256=ms_rk_small[f32], ms_1024x256_f64=ms_rk_small[f64])
    kernels[13].update(ms_cs=ms["shan_chen_cs"], plain_ms_cs=ms["shan_chen_cs_plain"],
                       ms_cs_f64=ms64["shan_chen_cs"], plain_ms_cs_f64=plain64["shan_chen_cs"],
                       bound_ms_cs=bounds["shan_chen_cs"][0])
    kernels[14].update(ms_1024x256=strouhal_ms[f32][1], ms_1024x256_f64=strouhal_ms[f64][1],
                       step_ms_1024x256=strouhal_ms[f32][2],
                       step_ms_1024x256_f64=strouhal_ms[f64][2])
    kernels[15].update(shape="Strouhal ROI 37x37, 64 markers, in 1024x256", blocks=1,
                       bound_ms_f64=forcing_bound[f64][0], bound_by_f64=forcing_bound[f64][1])
    shapes = {"moving_forcing": "falling_cylinder 400x256, window 34x34, 76 markers",
              "moving_rot": "falling_ellipse 800x256, window 42x42, 78 markers",
              "moving_bodies": "falling_cylinders 800x128, window 116x128, 2x76 markers"}
    for entry in kernels[-3:]:
        name = entry["name"]
        errs = err_mov[name.removeprefix("moving_")]
        entry.update(state_err_vs_plain=errs[f32][1], state_err_vs_plain_f64=errs[f64][1],
                     state_excess_vs_f64=errs[f32][2])
        entry.update(shape=shapes[name], blocks=1, bound_ms_f64=mov_bound[name, f64][0],
                     box_ms=mov_ms[name, f32][1], box_ms_f64=mov_ms[name, f64][1],
                     step_ms=mov_ms[name, f32][2], step_ms_f64=mov_ms[name, f64][2],
                     host_us_per_step=host_us[name])
    for entry in (kernels[15], *kernels[-3:]):
        k = {"ibm_forcing": 16, "moving_forcing": 19, "moving_rot": 20,
             "moving_bodies": 21}[entry["name"]]
        tm = {" ".join(key): v for key, v in ibm_tm.items() if key[0].startswith(f"kernel {k} ")}
        if tm:
            entry["parent_us"] = tm
    th_source = {"cavity": ("cavity", "cavity_pallas.py:29", "ring_cavity L=4096"),
                 "thermal_rb_q9": ("thermal", "thermal_pallas.py:245", "4096x2048, 18 planes"),
                 "thermal_rb_q5": ("thermal", "thermal_pallas.py:245", "4096x2048, 14 planes"),
                 "heated_cavity_q9": ("thermal", "thermal_pallas.py:344",
                                      "4096x2048, 18 planes"),
                 "heated_cavity_q5": ("thermal", "thermal_pallas.py:344",
                                      "4096x2048, 14 planes")}
    for name, (src, replaces, shape) in th_source.items():
        errs = err22 if name == "cavity" else err_th[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"lbm_tpu_torch/csrc/{src}.cu",
            "replaces": f"lbm_tpu/kernels/{replaces}", "launches": launches[name],
            "max_abs_err": errs[f32], "max_abs_err_f64": errs[f64],
            "ms": th_ms[name, f32][0], "plain_ms": th_ms[name, f32][1],
            "bound_ms": th_bound[name, f32][0], "bound_by": th_bound[name, f32][1],
            "library_ms": None, "ms_f64": th_ms[name, f64][0],
            "plain_ms_f64": th_ms[name, f64][1], "bound_ms_f64": th_bound[name, f64][0],
            "shape": shape, "gate_graph_ms": th_graph[name][0],
            "gate_host_ms_per_step": th_graph[name][1]})
    kernels[11]["us"] = {f"{shape} {dt}": v for (k, shape, dt), v in rk_k36_tm.items()
                         if k == 12}
    kernels += d3q19_entries(launches, err25, err26, d3_times)
    kernels += sharded_entries(launches, err_sh, sh_times)
    kernels.append(lanes_entry(launches, err39, lanes_tm))
    next(e for e in kernels if e["name"] == "halo2d_thermal")["us"] = {
        f"{shape} {dt}": v for (k, shape, dt), v in rk_k36_tm.items() if k == 36}
    for k, name, tm in ((4, "channel_kbc", k4_k33_tm), (33, "halo_d3q19", k4_k33_tm),
                        (2, "channel_bgk", k2_k9_tm), (9, "channel_variant", k2_k9_tm)):
        next(e for e in kernels if e["name"] == name)["us"] = {
            f"{shape} {dt}": v for (kk, shape, dt), v in tm.items() if kk == k}
    for k, name, tm in ((27, "halo_collide_stream", k27_k34_tm),
                        (34, "halo2d_collide_stream", k27_k34_tm),
                        (32, "halo_shan_chen", k32_k35_tm), (35, "halo2d_shan_chen", k32_k35_tm),
                        (37, "halo2d_rk", k37_k14_tm), (14, "shan_chen", k37_k14_tm),
                        (17, "sediment", k17_k30_tm), (30, "halo_rk", k17_k30_tm)):
        next(e for e in kernels if e["name"] == name)["us"] = {
            f"{case} {dt}": v for (kk, case, dt), v in tm.items() if kk == k}
    for name in ("halo_thermal", *THERMAL_NAMES):  # 28 only against a parent
        us = {f"{case} {dt}": v for (_, case, dt), v in k23_k24_tm.items()
              if case.startswith(f"{name} ")}
        if us:
            next(e for e in kernels if e["name"] == name)["us"] = us
    for row in shape_rows:
        for entry in kernels:
            if entry["name"] == row["name"]:
                entry.setdefault("launch_shapes", []).append(
                    {key: row[key] for key in ("shape", "dtype", "us", "bound_us", "launches",
                                               "loss_s")})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
