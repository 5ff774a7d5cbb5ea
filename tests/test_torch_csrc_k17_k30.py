"""Kernels 17 (csrc/sediment.cu) and 30 (csrc/rk_cg.cu) compiled for the CPU
with g++ through the stand-in CUDA runtime of tests/test_torch_csrc_on_cpu.py
(a block's threads as std::threads at a std::barrier, blocks one after
another, cudaLaunchKernelEx counting the programmatic dependent launches, a
warp's shuffle at a barrier of its threads), held to their plain versions
at the card tests' tolerance, and chip_smoke.py's other designs of both
(K17_DESIGNS, K30_DESIGNS) to the tree's bits.  No JAX, no card; skipped
without a C++ compiler."""

import concurrent.futures
import contextlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lbm_tpu_torch.kernels import _build, rk, sediment
from lbm_tpu_torch.kernels import sharded as ksh
from lbm_tpu_torch.parallel import halo as ph
from lbm_tpu_torch.parallel import mesh as pm
from lbm_tpu_torch.scenes.obstacles import sediment_initial_state

_spec = importlib.util.spec_from_file_location(
    "_csrc_on_cpu", Path(__file__).resolve().parent / "test_torch_csrc_on_cpu.py")
_on_cpu = importlib.util.module_from_spec(_spec)
sys.modules.setdefault(_spec.name, _on_cpu)
_spec.loader.exec_module(_on_cpu)
_cpu_library, _bind, _nan_buffers = _on_cpu._cpu_library, _on_cpu._bind, _on_cpu._nan_buffers
_chip_smoke, _rk_state, RK_KW, TOL = (_on_cpu._chip_smoke, _on_cpu._rk_state, _on_cpu.RK_KW,
                                      _on_cpu.TOL)
CSRC = _on_cpu.CSRC
UNITS = ("sediment", "rk_cg")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The tree's sediment.cu and rk_cg.cu, and every design of K17_DESIGNS
    (with sediment.cu) and K30_DESIGNS that edits a source (with rk_cg.cu),
    each built for the CPU, side by side: {label: library}, "tree" the
    tree's."""
    smoke = _chip_smoke()
    builds = {"tree": (UNITS, None)}
    for label, files in smoke.design_sources(CSRC, smoke.K17_DESIGNS).items():
        builds[label] = (("sediment",), files)
    for label, files in smoke.design_sources(CSRC, smoke.K30_DESIGNS).items():
        if files:
            builds[label] = (("rk_cg",), files)
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        done = {label: pool.submit(_cpu_library, tmp_path_factory.mktemp("k17_k30"), units,
                                   files)
                for label, (units, files) in builds.items()}
    return {label: lib.result() for label, lib in done.items()}


# (R, C, R23, C28, C38, inlet_rows, one wave): 16x64 is 1,024 cells, 8 blocks
# of 128 threads on the stand-in's 4 SMs of 2 resident blocks: one wave, so
# programmatic dependent launches; every row's cells C-2 and C-1 share a warp
# (C a multiple of 32).  40x33 is 11 blocks of 128: plain launches; cell C-1
# of row 32 is lane 0 of its warp ((32 + 1) 33 - 1 = 33 x 32), so its column
# C-2 lies in the warp before.
K17_GRIDS = [(16, 64, 9, 20, 30, 5, True), (40, 33, 25, 12, 20, 10, False)]
SED = dict(omega=1 / 0.55, u_in=0.02, w_s=3e-3, C_w=1e-3)


def _sed_state(R, C, inlet, dtype, seed):
    """The scene's initial state with 3% noise: every cell off equilibrium."""
    S = sediment_initial_state(R, C, SED["u_in"], SED["C_w"], inlet, "cpu", dtype)
    rng = np.random.default_rng(seed)
    return (S * torch.as_tensor(rng.uniform(0.97, 1.03, S.shape), dtype=dtype)).contiguous()


def _k17_steps(lib, monkeypatch, S, geom, steps=3):
    """``steps`` steps of kernel 17 through make_sediment_fused_step (one
    launch a step), bound to the CPU build ``lib``, into NaN-filled outputs:
    (the state, its launches, the dependent ones among them)."""
    R, C = S.shape[-2:]
    R23, C28, C38, inlet = geom
    with monkeypatch.context() as m:
        _bind(m, lib, sediment.SEDIMENT)
        m.setattr(sediment, "resolve_fused", lambda f: True)
        step = sediment.make_sediment_fused_step(R, C, substeps=steps, dtype=S.dtype, R23=R23,
                                                 C28=C28, C38=C38, inlet_rows=inlet, **SED)
        _nan_buffers(m)
        before, pdl = sediment.SEDIMENT.launches, lib.shim_pdl_count()
        out = step(S)
        return out, sediment.SEDIMENT.launches - before, lib.shim_pdl_count() - pdl


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("R,C,R23,C28,C38,inlet,one_wave", K17_GRIDS)
def test_kernel_17_source_matches_plain(libs, monkeypatch, dtype, R, C, R23, C28, C38, inlet,
                                        one_wave):
    """csrc/sediment.cu's step through lbm::launch_cells, 3 steps from a
    noisy state into NaN-filled outputs: one launch a step, dependent
    exactly where the grid fits one wave, every entry written, the plain
    step within TOL."""
    S = _sed_state(R, C, inlet, dtype, R * C)
    want = S
    for _ in range(3):
        want = sediment.plain_sediment_step(want, R23=R23, C28=C28, C38=C38, inlet_rows=inlet,
                                            **SED)
    got, launches, dependent = _k17_steps(libs["tree"], monkeypatch, S, (R23, C28, C38, inlet))
    assert launches == 3 and dependent == (3 if one_wave else 0)
    assert not got.isnan().any() and (got - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("design", ["without PDL", "128-thread blocks", "outlet by shuffle",
                                    "owned mask once", "64-bit indices",
                                    "256-thread blocks in float64",
                                    "neighbour loads after the collisions"])
def test_kernel_17_designs_give_the_tree_bits(libs, monkeypatch, design):
    """chip_smoke.py's other designs of kernel 17 (K17_DESIGNS, edits of
    csrc/sediment.cu and d2q9.cuh that ``k17_k30_times`` times against the
    tree) built for the CPU: the tree's bits over 3 steps on both grids in
    both types, the outlet's shuffle with cell C-1 on lane 0 (40x33) and
    beside cell C-2 in every warp (16x64); dependent launches at 16x64 but
    "without PDL"."""
    assert set(_chip_smoke().K17_DESIGNS) == {"without PDL", "128-thread blocks",
                                              "outlet by shuffle", "owned mask once",
                                              "64-bit indices", "256-thread blocks in float64",
                                              "neighbour loads after the collisions"}
    for R, C, R23, C28, C38, inlet, one_wave in K17_GRIDS:
        for dtype in (torch.float64, torch.float32):
            S = _sed_state(R, C, inlet, dtype, R + C)
            geom = (R23, C28, C38, inlet)
            tree = _k17_steps(libs["tree"], monkeypatch, S, geom)
            other = _k17_steps(libs[design], monkeypatch, S, geom)
            assert torch.equal(tree[0], other[0]) and other[1] == 3
            if one_wave:
                assert tree[2] == 3 and other[2] == (0 if design == "without PDL" else 3)


def _k30_run(lib, monkeypatch, n, R, C, dtype, calls=2, context=contextlib.nullcontext):
    """``calls`` calls of make_sharded_rk_step on a mesh of n CPU shards with
    kernel 30 bound to the CPU build ``lib`` (built and run inside
    ``context()``), into NaN-filled buffers: (the gathered state, the
    launches, the exchange copies, the geometries of the first launch,
    the shards it ran on, the plain sharded step's result)."""
    mesh = pm.make_mesh(["cpu"] * n)
    S = pm.shard_state(mesh, _rk_state(R, C, dtype, R + C + n))
    with monkeypatch.context() as m, context():
        step = ksh.make_sharded_rk_step(mesh, R, C, dtype=dtype, **RK_KW)
        want = S
        for _ in range(calls):
            want = step.plain(want)
        _bind(m, lib, ksh.HALO_RK)
        m.setattr(ksh, "resolve_fused", lambda f: True)
        _nan_buffers(m)
        fn, geoms = ksh.HALO_RK._fn, []

        def record(g, params, n_shards, *rest):
            geoms.append([g[i] for i in range(n_shards * len(ksh.GEOM))])
            return fn(g, params, n_shards, *rest)
        m.setattr(ksh.HALO_RK, "_fn", record)
        copies, copy_to = [], ph.copy_to
        m.setattr(ph, "copy_to", lambda src, device: copies.append(1) or copy_to(src, device))
        before = ksh.HALO_RK.launches
        y = S
        for _ in range(calls):
            y = step(y)
        return (y.gather(), ksh.HALO_RK.launches - before, len(copies), geoms[0], S.shards,
                want.gather())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,R,C", [(2, 40, 29), (4, 48, 40)])
def test_kernel_30_source_matches_plain(libs, monkeypatch, dtype, n, R, C):
    """Kernel 30 of csrc/rk_cg.cu through make_sharded_rk_step on 2 and 4
    CPU shards, two calls from a noisy interface into NaN-filled buffers:
    one launch a call over the shards, edge and interior ranks in one
    launch, no exchange copy; each shard's halos are views of its
    neighbours' own rows (top the last HALO rows of shard i-1, bot the first
    of shard i+1, at their plane stride R_loc C); the plain sharded step
    within TOL."""
    got, launches, copies, geoms, shards, want = _k30_run(libs["tree"], monkeypatch, n, R, C,
                                                          dtype)
    assert launches == 2 and copies == 0
    item, R_loc, k = shards[0].element_size(), R // n, len(ksh.GEOM)
    for i in range(n):
        g = dict(zip(ksh.GEOM, geoms[i * k:(i + 1) * k]))
        assert g["top"] == shards[i - 1].data_ptr() + (R_loc - ksh.HALO) * C * item
        assert g["mid"] == shards[i].data_ptr() and g["bot"] == shards[(i + 1) % n].data_ptr()
        assert g["top_plane"] == g["mid_plane"] == g["bot_plane"] == R_loc * C
        assert g["edge"] == int(i in (0, n - 1)) and g["off"] == i * R_loc
    assert not got.isnan().any() and (got - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("design", ["exchange copies kept", "launch per shard",
                                    "masked instance in float32 too",
                                    "no register cap in float32"])
def test_kernel_30_designs_give_the_tree_bits(libs, monkeypatch, design):
    """chip_smoke.py's other designs of kernel 30 (K30_DESIGNS, which
    ``k17_k30_times`` times against the tree): "exchange copies kept" runs
    the tree's kernel on ``exchange_rows``' copies (2 n copies a call),
    "launch per shard" a shard a launch, the edits of csrc/rk_cg.cu the
    masked instance for every shard in float32 and float32 without its
    register cap; each gives the tree's bits over two calls on 4 shards
    (edge and interior ranks) in both types."""
    smoke = _chip_smoke()
    assert set(smoke.K30_DESIGNS) == {"exchange copies kept", "launch per shard",
                                      "masked instance in float32 too",
                                      "no register cap in float32"}
    context = {"exchange copies kept": smoke.exchange_copies_kept,
               "launch per shard": smoke.launch_per_shard}.get(design, contextlib.nullcontext)
    n, R, C = 4, 48, 40
    for dtype in (torch.float64, torch.float32):
        tree = _k30_run(libs["tree"], monkeypatch, n, R, C, dtype)
        other = _k30_run(libs.get(design, libs["tree"]), monkeypatch, n, R, C, dtype,
                         context=context)
        assert torch.equal(tree[0], other[0])
        assert other[1] == (2 * n if design == "launch per shard" else 2)
        assert other[2] == (4 * n if design == "exchange copies kept" else 0)
