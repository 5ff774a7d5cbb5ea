"""Kernels 12, 36, 33, 4, 27, 34, 2, 9, 32, 35, 37, 14, 23 and 24 (csrc/rk_cg.cu, thermal.cu,
d3q19.cu, channel_kbc.cu, collide_stream_bgk.cu, collide_stream_kbc.cu,
channel_bgk.cu, channel_variant.cu and shan_chen.cu) compiled for the CPU
with g++ through a stand-in for the CUDA runtime: a block's threads run as
std::threads that meet at a std::barrier, blocks one after another, shared
memory (dynamic, and a kernel's one static array) NaN-filled a block,
cudaLaunchKernelEx a launch that counts the programmatic dependent ones.
Every operation of these sources rounds once in IEEE arithmetic (-fmad=false
on the card for all but channel_kbc.cu and channel_bgk.cu, -ffp-contract=off
here), and each
kernel is held to its plain version at the card tests' tolerance: torch's
CPU kernels round a few operations differently (its square root by an ulp).
A wrong geometry, tap or batch gives errors of order one or NaN.  No JAX,
no card; skipped without a C++ compiler."""

import concurrent.futures
import contextlib
import ctypes
import importlib.util
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from lbm_tpu_torch.kernels import (_build, bgk, channel, collide_stream, d3q19, rk, shan_chen,
                                   thermal)
from lbm_tpu_torch.kernels import sharded as ksh
from lbm_tpu_torch.kernels import sharded2d as k2d
from lbm_tpu_torch.ops import d2q9
from lbm_tpu_torch.ops import d3q19 as od3
from lbm_tpu_torch.parallel import mesh as pm
from lbm_tpu_torch.parallel.halo import exchange_2d, exchange_rows, ring_rows, strip_parts

CSRC = Path(__file__).resolve().parents[1] / "lbm_tpu_torch" / "csrc"
TOL = {torch.float32: 2e-6, torch.float64: 1e-13}

CUDA_RUNTIME = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
using std::exp;
using std::fabs;
using std::sqrt;
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9,
                   cudaErrorInvalidDevice = 101 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct cudaFuncAttributes { int numRegs = 0; size_t localSizeBytes = 0; };
typedef void* cudaStream_t;
namespace shim {
inline thread_local dim3 tIdx, bIdx, bDim, gDim;
inline thread_local unsigned char* smem = nullptr;
inline thread_local unsigned char* smem_static = nullptr;  // a kernel's static __shared__ array
constexpr size_t STATIC_SMEM = 48 << 10;
inline thread_local std::barrier<>* bar = nullptr;
template <typename F>
void launch(dim3 grid, unsigned threads, size_t bytes, void*, F f) {
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::vector<unsigned char> mem(bytes + 16, 0xff), fixed(STATIC_SMEM, 0xff);
        std::barrier<> b(threads);
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < threads; ++t)
          ts.emplace_back([&, t, bx, by, bz] {
            tIdx = dim3(t); bIdx = dim3(bx, by, bz); bDim = dim3(threads); gDim = grid;
            smem = mem.data(); smem_static = fixed.data(); bar = &b;
            f();
          });
        for (auto& th : ts) th.join();
      }
}
}  // namespace shim
enum cudaLaunchAttributeID { cudaLaunchAttributeProgrammaticStreamSerialization = 5 };
union cudaLaunchAttributeValue { int programmaticStreamSerializationAllowed; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes = 0;
  cudaStream_t stream = nullptr;
  cudaLaunchAttribute* attrs = nullptr;
  unsigned numAttrs = 0;
};
inline int shim_pdl_launches = 0;  // launches that asked for a programmatic dependent launch
template <typename... P, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c, void (*k)(P...), A&&... a) {
  for (unsigned i = 0; i < c->numAttrs; ++i)
    if (c->attrs[i].id == cudaLaunchAttributeProgrammaticStreamSerialization &&
        c->attrs[i].val.programmaticStreamSerializationAllowed)
      ++shim_pdl_launches;
  shim::launch(c->gridDim, c->blockDim.x, c->dynamicSmemBytes, c->stream, [&] { k(a...); });
  return cudaSuccess;
}
#define threadIdx shim::tIdx
#define blockIdx shim::bIdx
#define blockDim shim::bDim
#define gridDim shim::gDim
inline void __syncthreads() { shim::bar->arrive_and_wait(); }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 4; return cudaSuccess; }
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 2; return cudaSuccess; }
template <typename K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
template <typename K>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) { *a = {}; return cudaSuccess; }
template <typename T> inline void __stcs(T* p, T v) { *p = v; }
// __shfl_up_sync among a warp's threads (threadIdx.x / 32) of the running
// block: the threads of `mask` meet at a barrier of their number, made again
// where the block or the number changes (blocks run one after another)
namespace shim {
struct Warp {
  std::mutex m;
  std::unique_ptr<std::barrier<>> bar;
  long long block = -1;
  int count = 0;
  unsigned char slot[32][8];
};
inline Warp warps[32];
}  // namespace shim
template <typename T>
T __shfl_up_sync(unsigned mask, T v, unsigned d) {
  const unsigned lane = threadIdx.x % 32;
  const long long block = (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) *
                          gridDim.x + blockIdx.x;
  const int count = __builtin_popcount(mask);
  shim::Warp& w = shim::warps[threadIdx.x / 32];
  {
    std::lock_guard<std::mutex> g(w.m);
    if (w.block != block || w.count != count) {
      w.bar = std::make_unique<std::barrier<>>(count);
      w.block = block;
      w.count = count;
    }
  }
  std::memcpy(w.slot[lane], &v, sizeof(T));
  w.bar->arrive_and_wait();
  T out = v;
  if (lane >= d) std::memcpy(&out, w.slot[lane - d], sizeof(T));
  w.bar->arrive_and_wait();
  return out;
}
"""
PIPELINE = r"""
#pragma once
#include <cstring>
inline void __pipeline_memcpy_async(void* d, const void* s, size_t n) { std::memcpy(d, s, n); }
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {}
"""


def _cpu_library(d: Path, units=("rk_cg", "thermal"), sources=None):
    """The csrc units ``units`` as one CPU library in ``d``: each launch
    ``k<<<g, t, s, st>>>(args)`` becomes a call of the stand-in's launcher,
    the dynamic shared memory a per-block buffer, as is a kernel's one static
    ``__shared__`` array; ``sources`` maps a file name to the text that
    stands in for it."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build csrc/ for the CPU")
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME)
    (d / "cuda_pipeline_primitives.h").write_text(PIPELINE)
    launch = re.compile(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)
    for f in CSRC.iterdir():
        if f.suffix not in (".cu", ".cuh"):
            continue
        text = (sources or {}).get(f.name, None) or f.read_text()
        text = re.sub(r"extern __shared__ (__align__\(\d+\) )?unsigned char smem_raw\[\];",
                      "unsigned char* smem_raw = shim::smem;", text)
        text = re.sub(r"(?<!extern )__shared__ (\w+) (\w+)\[\w+\];",
                      r"\1* \2 = reinterpret_cast<\1*>(shim::smem_static);", text)
        text = launch.sub(lambda m: f"shim::launch({m.group(2)}, [&]() {{ "
                                    f"{m.group(1)}({m.group(3)}); }});", text)
        (d / (f.name if f.suffix == ".cuh" else f.stem + ".cpp")).write_text(text)
    (d / "shim.cpp").write_text('#include "cuda_runtime.h"\n'
                                'extern "C" int shim_pdl_count() { return shim_pdl_launches; }\n')
    lib = d / "kernels.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", f"-I{d}", "-o", str(lib), str(d / "shim.cpp"),
                    *(str(d / f"{u}.cpp") for u in units)],
                   check=True, capture_output=True, timeout=600)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def cpu_kernels(tmp_path_factory):
    """csrc/rk_cg.cu and csrc/thermal.cu as one CPU library."""
    return _cpu_library(tmp_path_factory.mktemp("csrc_cpu"))


def _rk_state(R, C, dtype, seed):
    """A noisy two-colour state with an interface across the rows."""
    g = np.random.default_rng(seed)
    x = np.arange(R)[:, None] - R / 2 + 3 * np.sin(np.arange(C)[None] / 5)
    r_rho = 1.0 + 0.5 * np.tanh(x / 3.0) + 0.01 * g.random((R, C))
    b_rho = 2.0 - r_rho + 0.01 * g.random((R, C))
    f = 0.05 + 0.1 * g.random((9, R, C))
    return torch.tensor(np.concatenate([f, r_rho[None], b_rho[None]]), dtype=dtype)


RK_KW = dict(r_alpha=11 / 15, b_alpha=0.2, r_nu=0.04, b_nu=0.06, sigma=0.01, beta=0.7,
             gravity=(-6.25e-6, 1e-6))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("R,C", [(37, 29), (12, 70), (4, 3)])
def test_kernel_12_source_matches_plain(cpu_kernels, dtype, R, C):
    """csrc/rk_cg.cu's step, 2 steps from a noisy interface on grids with
    edge tiles both ways, ragged tiles and the smallest grid, against
    kernels/rk.py's plain step: TOL."""
    S = _rk_state(R, C, dtype, R * C)
    plain = rk.make_plain_step(**RK_KW)
    got = _rk_steps(cpu_kernels.lbm_rk_cg, S)
    assert (got - plain(plain(S))).abs().max().item() <= TOL[dtype]


def _rk_steps(fn, S, steps=2):
    """``steps`` steps of kernel 12's entry point ``fn`` from ``S``, each
    output NaN-filled before the step."""
    fn.argtypes, fn.restype = rk.RK_CG.argtypes, ctypes.c_int
    params = _build.c_doubles(rk.kernel_params(**RK_KW))
    R, C = S.shape[-2:]
    for _ in range(steps):
        out = torch.full_like(S, float("nan"))
        assert fn(S.data_ptr(), out.data_ptr(), R, C, params, int(S.dtype == torch.float64),
                  None) == 0
        S = out
    return S


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", CSRC.parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("design", ["staged in float32 too", "loads in float64 too",
                                    "taps once a cell"])
def test_kernel_12_designs_give_the_tree_bits(cpu_kernels, tmp_path, design):
    """chip_smoke.py's other designs of kernel 12 (RK_DESIGNS, edits of
    csrc/rk_cg.cu that the breakdown times against it) built for the CPU:
    the tree's kernel's bits, two steps in both types on a grid with edge
    and ragged tiles both ways."""
    src = _chip_smoke().rk_probe_sources(CSRC, _chip_smoke().RK_DESIGNS)[design]
    lib = _cpu_library(tmp_path, ("rk_cg",), {"rk_cg.cu": src})
    for dtype in (torch.float64, torch.float32):
        S = _rk_state(37, 70, dtype, 3770)
        assert torch.equal(_rk_steps(lib.lbm_rk_cg, S), _rk_steps(cpu_kernels.lbm_rk_cg, S))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind,R,C,mesh_shape", [("rows", 48, 40, (4, 1)), ("rows", 40, 29, (2, 1)),
                                                 ("rows x cols", 64, 96, (4, 2)),
                                                 ("rows x cols", 40, 70, (2, 2))])
def test_rk_halo_kernels_source_match_plain(cpu_kernels, monkeypatch, dtype, kind, R, C,
                                            mesh_shape):
    """Kernels 30 (row shards) and 37 (rows x cols shards) of
    csrc/rk_cg.cu, driven through the port's sharded RK steps (their
    geometries, halos and sweeps as on the card), two calls from a noisy
    interface: the plain sharded step within TOL.  Each launches once a call
    over up to MAX_SHARDS shards of a device: kernel 30 reading its
    neighbours' edge rows in place (``ring_rows``), edge and interior ranks
    in one launch on (4, 1); kernel 37 each padded block in place from
    ``ring_2d``'s 3 x 3 parts, edge and interior row ranks in one launch on
    (4, 2).  Their staged rows span shard, halo and strip buffers, whole
    chunks and single elements."""
    from lbm_tpu_torch.kernels import sharded

    _bind(monkeypatch, cpu_kernels, sharded.HALO_RK, k2d.HALO2D_RK)
    mesh = pm.make_mesh(["cpu"] * (mesh_shape[0] * mesh_shape[1]), mesh_shape)
    make = sharded.make_sharded_rk_step if kind == "rows" else k2d.make_sharded2d_rk_step
    step = make(mesh, R, C, dtype=dtype, **RK_KW)
    S = pm.shard_state(mesh, _rk_state(R, C, dtype, R + C))
    want = step.plain(step.plain(S)).gather()
    monkeypatch.setattr(sharded, "resolve_fused", lambda f: True)
    monkeypatch.setattr(k2d, "resolve_fused", lambda f: True)
    kernel = sharded.HALO_RK if kind == "rows" else k2d.HALO2D_RK
    n = mesh_shape[0] * mesh_shape[1]
    before = kernel.launches
    got = step(step(S)).gather()
    assert kernel.launches - before == 2 * -(-n // _build.MAX_SHARDS)
    assert not got.isnan().any() and (got - want).abs().max().item() <= TOL[dtype]


def _k37_dependent(mesh_shape, R, C) -> int:
    """The launches of a call of kernel 37 whose grid fits the stand-in's 4
    SMs of 2 resident blocks in one wave: column tiles of 32 x row tiles of
    8 over a shard, one grid layer a shard of each launch of up to
    MAX_SHARDS."""
    (nx, ny), n = mesh_shape, mesh_shape[0] * mesh_shape[1]
    tiles = -(-(C // ny) // 32) * -(-(R // nx) // 8)
    return sum(tiles * min(_build.MAX_SHARDS, n - c) <= 8 for c in range(0, n, _build.MAX_SHARDS))


# (R, C, mesh, halos): kernel 37's batches of mixed edge and interior row ranks
# ((4, 2)) and of edge ranks only ((2, 2)), a mesh of 10 shards in two launches
# a call (8 and 2, each in one wave: dependent launches), the neighbours'
# lines read in place (``ring_2d``) and from ``exchange_2d``'s copies
# (``strip_parts``' views of its strips)
K37_CASES = [(64, 96, (4, 2), "exchanged"), (40, 70, (2, 2), "exchanged"),
             (40, 40, (5, 2), "in place"), (40, 40, (5, 2), "exchanged")]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("R,C,mesh_shape,halos", K37_CASES)
def test_kernel_37_source_matches_plain(cpu_kernels, monkeypatch, dtype, R, C, mesh_shape,
                                        halos):
    """Kernel 37 of csrc/rk_cg.cu through the port's rows x cols RK step, two
    calls into NaN-filled outputs: one launch a call over up to MAX_SHARDS
    shards (10: two), a dependent launch exactly where the batch's grid fits
    one wave, the plain sharded step within TOL, no NaN."""
    _bind(monkeypatch, cpu_kernels, k2d.HALO2D_RK)
    mesh = pm.make_mesh(["cpu"] * (mesh_shape[0] * mesh_shape[1]), mesh_shape)
    step = k2d.make_sharded2d_rk_step(mesh, R, C, dtype=dtype, **RK_KW)
    S = pm.shard_state(mesh, _rk_state(R, C, dtype, R * C))
    want = step.plain(step.plain(S)).gather()
    monkeypatch.setattr(ksh, "resolve_fused", lambda f: True)
    _in_place_or_exchanged(monkeypatch, halos)
    _nan_buffers(monkeypatch)
    n = mesh_shape[0] * mesh_shape[1]
    before, pdl = k2d.HALO2D_RK.launches, cpu_kernels.shim_pdl_count()
    got = step(step(S)).gather()
    assert k2d.HALO2D_RK.launches - before == 2 * -(-n // _build.MAX_SHARDS)
    assert cpu_kernels.shim_pdl_count() - pdl == 2 * _k37_dependent(mesh_shape, R, C)
    assert not got.isnan().any() and (got - want).abs().max().item() <= TOL[dtype]


def test_kernel_37_reads_the_neighbours_lines_in_place(cpu_kernels, monkeypatch):
    """On shards of one device kernel 37 makes no exchange copy (``step.plain``
    makes its exchange's): its geometry names each part of the padded block
    in the neighbour's own buffer at the neighbour's strides (11 planes), the
    shard's global offsets, the grid's shape and the edge flag of its row
    rank; a launch of no shard or of more than MAX_SHARDS is refused, and the
    wrapper raises: no fallback."""
    from lbm_tpu_torch.parallel import halo as ph
    from lbm_tpu_torch.parallel.halo import ring_2d

    copies, copy_to = [], ph.copy_to
    monkeypatch.setattr(ph, "copy_to", lambda src, device: copies.append(1) or
                        copy_to(src, device))
    _bind(monkeypatch, cpu_kernels, k2d.HALO2D_RK)
    monkeypatch.setattr(ksh, "resolve_fused", lambda f: True)
    R, C, (nx, ny), h = 64, 48, (4, 2), ksh.HALO
    R_loc, C_loc = R // nx, C // ny
    mesh = pm.make_mesh(["cpu"] * (nx * ny), (nx, ny))
    step = k2d.make_sharded2d_rk_step(mesh, R, C, dtype=torch.float64, **RK_KW)
    x = pm.shard_state(mesh, _rk_state(R, C, torch.float64, 5))
    step(x)
    assert copies == []
    step.plain(x)
    assert copies
    grid = [x.shards[i * ny:(i + 1) * ny] for i in range(nx)]
    item = 8
    for b, parts in enumerate(ring_2d(grid, h)):
        i, j = divmod(b, ny)
        out, geoms, slabs = k2d._parts_geoms(grid[i][j], parts, substeps=1, rows_per_sweep=3,
                                             planes=11, walls=True, off=(i * R_loc, j * C_loc),
                                             shape=(R, C), edge=i in (0, nx - 1))
        assert slabs == [] and len(geoms) == 1
        g = dict(zip(k2d.PARTS_GEOM, geoms[0]))
        assert g["in11_base"] == grid[i][j].data_ptr() and g["out"] == out.data_ptr()
        assert g["in01_base"] == grid[i - 1][j].data_ptr() + (R_loc - h) * C_loc * item
        assert g["in12_base"] == grid[i][(j + 1) % ny].data_ptr()
        assert g["in20_base"] == grid[(i + 1) % nx][j - 1].data_ptr() + (C_loc - h) * item
        assert all((g[f"in{a}{c}_plane"], g[f"in{a}{c}_ld"]) == (R_loc * C_loc, C_loc)
                   for a in range(3) for c in range(3))
        rows = (h - 3 if i else h, h + R_loc + 3 if i < nx - 1 else h + R_loc)
        assert (g["in_r_lo"], g["in_r_hi"], g["in_c_lo"], g["in_c_hi"]) == (*rows, h - 3,
                                                                           h + C_loc + 3)
        assert (g["off_r"], g["off_c"], g["rows"], g["cols"], g["edge"]) == (
            i * R_loc, j * C_loc, R, C, int(i in (0, nx - 1)))
    values = [v for _ in range(_build.MAX_SHARDS + 1) for v in geoms[0]]
    params = _build.c_doubles(rk.kernel_params(**RK_KW))
    for n in (0, _build.MAX_SHARDS + 1):
        with pytest.raises(RuntimeError, match="launch failed with cudaError_t 1"):
            k2d.HALO2D_RK.launch((ctypes.c_longlong * len(values))(*values), params, n, 0, 0, 1,
                                 None)


THERMAL = dict(omega_f=1.0 / (0.71 * 0.1 * 3.0 + 0.5), omega_g=1.25,
               g_beta=1e4 * 0.71 * 0.1 * 0.1 / 64 ** 3)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape,mesh_shape,s", [((64, 64), (4, 2), 3), ((48, 96), (1, 2), 2),
                                                ((144, 32), (9, 2), 1)])
def test_kernel_36_source_matches_plain(cpu_kernels, monkeypatch, dtype, shape, mesh_shape, s):
    """csrc/thermal.cu's kernel 36, each sweep one launch over up to
    MAX_SHARDS shards (18 shards: two launches a sweep), their geometries
    from kernels/sharded2d.py's ``_sweep_geoms``, one call of s sweeps
    after an exchange: the plain rows x cols step within TOL, no NaN (the
    outputs and slabs start NaN-filled)."""
    monkeypatch.setattr(_build, "check_state", lambda f, planes=9: tuple(f.shape[1:]))
    fn = cpu_kernels.lbm_halo2d_thermal
    fn.argtypes, fn.restype = k2d.HALO2D_THERMAL.argtypes, ctypes.c_int
    R, C = shape
    nx, ny = mesh_shape
    g = np.random.default_rng(R + C + s)
    S = torch.tensor(np.concatenate([0.05 + 0.1 * g.random((9, R, C)),
                                     0.1 * g.random((9, R, C)) - 0.04]), dtype=dtype)
    mesh = pm.make_mesh(["cpu"] * (nx * ny), mesh_shape)
    step = k2d.make_sharded2d_thermal_step(mesh, R, C, substeps=s, dtype=dtype, **THERMAL)
    want = step.plain(pm.shard_state(mesh, S)).gather()
    shards = [f.contiguous() for f in pm.shard_state(mesh, S).shards]
    R_loc, C_loc = R // nx, C // ny
    grid = [shards[i * ny:(i + 1) * ny] for i in range(nx)]
    strips = exchange_2d(grid, k2d.HALO)  # read by the launches: held until they end
    plans = [k2d._sweep_geoms(f, *st, substeps=s, rows_per_sweep=1, walls=True,
                              off=(b // ny * R_loc, b % ny * C_loc), shape=(R, C),
                              edge=b // ny in (0, nx - 1))
             for b, (f, st) in enumerate(zip(shards, strips))]
    for out, _, slabs in plans:
        out.fill_(float("nan"))
        for slab in slabs:
            slab.fill_(float("nan"))
    params = thermal.thermal_constants(dtype=dtype, **THERMAL)
    batches = k2d.shard_batches([(f.device, f.dtype) for f in shards])
    assert [len(b) for b in batches] == [min(k2d.MAX_SHARDS, nx * ny - c)
                                         for c in range(0, nx * ny, k2d.MAX_SHARDS)]
    for j in range(s):
        for batch in batches:
            geoms = (ctypes.c_longlong * (len(k2d.GEOM) * len(batch)))(
                *(v for i in batch for v in plans[i][1][j]))
            assert fn(geoms, params, len(batch), 0, int(dtype == torch.float64), None) == 0
    got = torch.cat([torch.cat([p[0] for p in plans[i * ny:(i + 1) * ny]], dim=2)
                     for i in range(nx)], dim=1)
    assert not got.isnan().any() and (got - want).abs().max().item() <= TOL[dtype]


def test_kernel_36_batches_group_shards_by_device():
    """One launch takes up to MAX_SHARDS shards of one device and type, in
    the mesh's order: a card's 18 shards go 8, 8, 2; shards of two cards
    (a mesh of one shard a card) and of two types never share a launch."""
    n = k2d.MAX_SHARDS
    assert k2d.shard_batches([("cuda:0", 0)] * 18) == [list(range(n)), list(range(n, 2 * n)),
                                                        [16, 17]]
    keys = [("cuda:0", 0), ("cuda:1", 0), ("cuda:0", 0), ("cuda:1", 1)]
    assert k2d.shard_batches(keys) == [[0, 2], [1], [3]]
    assert k2d.shard_batches([]) == []


@pytest.fixture(scope="module")
def cpu_kernels_33_4(tmp_path_factory):
    """csrc/d3q19.cu and csrc/channel_kbc.cu as one CPU library."""
    return _cpu_library(tmp_path_factory.mktemp("csrc_cpu_33_4"), ("d3q19", "channel_kbc"))


def _bind(monkeypatch, lib, *kernels):
    """Point ``kernels`` at ``lib`` and let a CPU tensor through their
    wrappers' device, stream and state checks."""
    for kernel in kernels:
        fn = getattr(lib, kernel.symbol)
        fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
        monkeypatch.setattr(kernel, "_fn", fn)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream_handle", lambda f: None)
    monkeypatch.setattr(_build, "check_state", lambda f, planes=9: tuple(f.shape[1:]))


def _nan_buffers(monkeypatch):
    """Every later torch.empty / empty_like of a float type NaN-filled, so an
    entry that no launch writes shows."""
    empty, empty_like = torch.empty, torch.empty_like

    def nan(t):
        return t.fill_(float("nan")) if t.is_floating_point() else t

    monkeypatch.setattr(torch, "empty", lambda *a, **k: nan(empty(*a, **k)))
    monkeypatch.setattr(torch, "empty_like", lambda *a, **k: nan(empty_like(*a, **k)))


def _d3_state(X, Y, Z, dtype, seed):
    """A seeded off-equilibrium D3Q19 state (19, X, Y, Z)."""
    g = np.random.default_rng(seed)
    u = torch.as_tensor(g.uniform(-0.05, 0.05, (3, X, Y, Z)))
    rho = torch.as_tensor(1.0 + g.uniform(-0.01, 0.01, (X, Y, Z)))
    noise = torch.as_tensor(g.uniform(0.97, 1.03, (19, X, Y, Z)))
    return (od3.equilibrium(u, rho) * noise).to(dtype).contiguous()


D3_WALLS = {"periodic": {}, "cavity": dict(x_walls=True, y_walls=True, z_walls=True, lid_u=0.05)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("halos", ["in place", "exchanged"])
@pytest.mark.parametrize("walls,n,Y,s", [("cavity", 8, 64, 2), ("periodic", 8, 64, 8),
                                         ("cavity", 3, 27, 3), ("periodic", 3, 24, 1),
                                         ("cavity", 16, 128, 2), ("periodic", 16, 128, 1)])
def test_kernel_33_source_matches_plain(cpu_kernels_33_4, monkeypatch, dtype, halos, walls, n,
                                        Y, s):
    """csrc/d3q19.cu's kernel 33 through the port's sharded D3Q19 step, one
    launch a sweep over up to MAX_SHARDS shards (16 shards: two a sweep),
    the first sweep reading the neighbours' rows in place (``ring_rows``,
    views of their buffers) or from exchanged copies (``exchange_rows``),
    two calls of s sweeps, outputs and slabs NaN-filled: the plain sharded
    step within TOL, no NaN."""
    X, Z = 3, 5
    mesh = pm.make_mesh(["cpu"] * n)
    kw = dict(omega=1.0 / 0.7, substeps=s, dtype=dtype, **D3_WALLS[walls])
    x = pm.shard_state(mesh, _d3_state(X, Y, Z, dtype, Y + s).reshape(19 * X, Y, Z))
    plain = ksh.make_sharded_d3q19_step(mesh, X, Y, Z, **kw).plain
    want = plain(plain(x)).gather()
    _bind(monkeypatch, cpu_kernels_33_4, ksh.HALO_D3Q19)
    monkeypatch.setattr(ksh, "resolve_fused", lambda f: True)
    if halos == "exchanged":
        monkeypatch.setattr(ksh, "ring_rows", exchange_rows)
    step = ksh.make_sharded_d3q19_step(mesh, X, Y, Z, **kw)
    _nan_buffers(monkeypatch)
    before = ksh.HALO_D3Q19.launches
    got = step(step(x)).gather()
    assert ksh.HALO_D3Q19.launches - before == 2 * s * -(-n // _build.MAX_SHARDS)
    assert not got.isnan().any() and (got - want).abs().max().item() <= TOL[dtype]


def test_kernel_33_reads_the_neighbours_rows_in_place(monkeypatch):
    """``ring_rows`` hands shard i the last HALO rows of shard i-1 and the
    first of shard i+1 as views of their buffers where they share its device
    (plane stride R_loc C), copies elsewhere; the first sweep's geometry
    names those rows: top at (R_loc - HALO) C entries into the neighbour,
    bot at its start, each at the neighbour's plane stride."""
    monkeypatch.setattr(_build, "check_state", lambda f, planes=9: tuple(f.shape[1:]))
    planes, R_loc, C, h = 6, 10, 7, ksh.HALO
    shards = [torch.rand(planes, R_loc, C, dtype=torch.float64) for _ in range(3)]
    item = shards[0].element_size()
    halos = ring_rows(shards, h)
    for i, (top, bot) in enumerate(halos):
        up, down = shards[i - 1], shards[(i + 1) % 3]
        assert top.data_ptr() == up.data_ptr() + (R_loc - h) * C * item
        assert bot.data_ptr() == down.data_ptr()
        assert top.stride() == bot.stride() == (R_loc * C, C, 1)
        assert torch.equal(top, exchange_rows(shards, h)[i][0])
        geom = dict(zip(ksh.GEOM, ksh._sweep_geoms(shards[i], top, bot, i * R_loc, False,
                                                   3 * R_loc, substeps=2, rows_per_sweep=1,
                                                   walls=False)[1][0]))
        assert (geom["top"], geom["mid"], geom["bot"]) == (top.data_ptr(), shards[i].data_ptr(),
                                                           down.data_ptr())
        assert geom["top_plane"] == geom["mid_plane"] == geom["bot_plane"] == R_loc * C
        assert (geom["in_lo"], geom["in_hi"]) == (h - 2, h + R_loc + 2)
    copied = exchange_rows(shards, h)[0][0]
    assert copied.stride(0) == h * C and copied.data_ptr() != halos[0][0].data_ptr()
    from lbm_tpu_torch.parallel import halo as ph

    copies = []  # (source device, destination device) of each copy ring_rows makes
    monkeypatch.setattr(ph, "copy_to", lambda src, device: copies.append(
        (src.device.type, torch.device(device).type)) or torch.zeros(src.shape, device=device))
    mixed = [shards[0], torch.empty((planes, R_loc, C), dtype=torch.float64, device="meta"),
             shards[2]]
    (top, bot), (top1, bot1), (top2, bot2) = ring_rows(mixed, h)
    assert sorted(copies) == [("cpu", "meta")] * 2 + [("meta", "cpu")] * 2
    assert top.data_ptr() == shards[2].data_ptr() + (R_loc - h) * C * item
    assert bot2.data_ptr() == shards[0].data_ptr()
    assert bot.stride(0) == top2.stride(0) == h * C and top1.device.type == "meta"


def test_batched_halo_kernels_share_one_grouping():
    """Kernels 33 and 36 group a sweep's shards with the one
    ``_build.shard_batches``: by device and type, in the mesh's order, at
    most MAX_SHARDS a launch (cavity3d's 8 shards of a card: one; 16: two;
    a mesh of one shard a card: one a card)."""
    assert ksh.shard_batches is k2d.shard_batches is _build.shard_batches
    assert k2d.MAX_SHARDS == _build.MAX_SHARDS == 8
    n = _build.MAX_SHARDS
    assert _build.shard_batches([("cuda:0", 0)] * 8) == [list(range(8))]
    assert _build.shard_batches([("cuda:0", 0)] * 16) == [list(range(n)), list(range(n, 2 * n))]
    assert _build.shard_batches([(f"cuda:{i}", 0) for i in range(4)]) == [[0], [1], [2], [3]]


def _kbc_state(R, C, dtype, seed):
    """An equilibrium at a seeded flow, each population times 1 + U(-3%, 3%):
    off equilibrium, where the KBC gamma is well defined."""
    g = np.random.default_rng(seed)
    u = torch.as_tensor(g.uniform(-0.05, 0.05, (2, R, C)))
    rho = torch.as_tensor(1.0 + g.uniform(-0.01, 0.01, (R, C)))
    f = d2q9.equilibrium(u, rho) * torch.as_tensor(g.uniform(0.97, 1.03, (9, R, C)))
    return f.to(dtype).contiguous()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("R,C,one_wave", [(16, 24, True), (37, 29, False), (4, 2, True)])
def test_kernel_4_source_matches_plain(cpu_kernels_33_4, monkeypatch, dtype, R, C, one_wave):
    """csrc/channel_kbc.cu's kernel 4 through make_channel_fused_step, its
    blocks sized to the stand-in's 4 SMs of 2 resident blocks each (6
    blocks of 64 threads at 16x24 and 1 at 4x2: one wave, so programmatic
    dependent launches; 9 of 128 at 37x29: plain launches), 3 steps into
    NaN-filled outputs: kbc_channel_step within TOL."""
    args = (1.7, 1.001, 1.0)
    plain = channel.kbc_channel_step(*args)
    f = _kbc_state(R, C, dtype, R * C)
    want = plain(plain(plain(f)))
    _bind(monkeypatch, cpu_kernels_33_4, channel.CHANNEL_KBC)
    monkeypatch.setattr(channel, "resolve_fused", lambda f: True)
    step = channel.make_channel_fused_step(R, C, *args, dtype, family="kbc")
    _nan_buffers(monkeypatch)
    lib = cpu_kernels_33_4
    before, pdl = channel.CHANNEL_KBC.launches, lib.shim_pdl_count()
    got = step(step(step(f)))
    dependent = 3 if one_wave else 0
    assert channel.CHANNEL_KBC.launches - before == 3
    assert lib.shim_pdl_count() - pdl == dependent
    assert not got.isnan().any() and (got - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("design", ["without PDL", "64 registers"])
def test_kernel_4_designs_give_the_tree_bits(cpu_kernels_33_4, tmp_path, monkeypatch, design):
    """chip_smoke.py's other designs of kernel 4 (K4_DESIGNS, edits of
    csrc/channel_kbc.cu that ``k4_k33_times`` times against it) built for
    the CPU: the tree's kernel's bits over 3 steps in both types at 16x24
    (one wave), and no dependent launch without PDL."""
    smoke = _chip_smoke()
    lib = _cpu_library(tmp_path, ("channel_kbc",),
                       smoke.design_sources(CSRC, smoke.K4_DESIGNS)[design])
    args = (1.7, 1.001, 1.0)
    for dtype in (torch.float64, torch.float32):
        f = _kbc_state(16, 24, dtype, 384)
        got = {}
        for name, where in (("tree", cpu_kernels_33_4), (design, lib)):
            with monkeypatch.context() as m:
                _bind(m, where, channel.CHANNEL_KBC)
                m.setattr(channel, "resolve_fused", lambda f: True)
                step = channel.make_channel_fused_step(16, 24, *args, dtype, family="kbc")
                before = where.shim_pdl_count()
                got[name] = step(step(step(f)))
                dependent = where.shim_pdl_count() - before
            assert dependent == (0 if name == "without PDL" else 3)
        assert torch.equal(got["tree"], got[design])


@pytest.fixture(scope="module")
def cpu_kernels_2_9(tmp_path_factory):
    """csrc/channel_bgk.cu and csrc/channel_variant.cu as one CPU library."""
    return _cpu_library(tmp_path_factory.mktemp("csrc_cpu_2_9"), ("channel_bgk", "channel_variant"))


K2_ARGS = (1.0 / 0.9, 1.02, 1.0)  # omega, rho_in, rho_out


def _channel_steps(lib, monkeypatch, f, kernel, make_step, steps=3):
    """``steps`` steps of ``make_step()`` with ``kernel`` bound to the CPU
    build ``lib``, into NaN-filled outputs: (the state, its launches, the
    dependent ones among them)."""
    with monkeypatch.context() as m:
        _bind(m, lib, kernel)
        m.setattr(channel, "resolve_fused", lambda f: True)
        step = make_step()
        _nan_buffers(m)
        before, pdl = kernel.launches, lib.shim_pdl_count()
        for _ in range(steps):
            f = step(f)
        return f, kernel.launches - before, lib.shim_pdl_count() - pdl


def _k2_steps(lib, monkeypatch, f):
    """Kernel 2 through make_channel_fused_step (``_channel_steps``)."""
    R, C = f.shape[-2:]
    return _channel_steps(lib, monkeypatch, f, channel.CHANNEL_BGK,
                          lambda: channel.make_channel_fused_step(R, C, *K2_ARGS, f.dtype))


def _k9_steps(lib, monkeypatch, f, scene):
    """Kernel 9 in chip_smoke.py's variant ``scene`` through
    make_channel_variant_step (``_channel_steps``)."""
    R, C = f.shape[-2:]
    kw = _chip_smoke().variants()[scene]
    return _channel_steps(lib, monkeypatch, f, channel.CHANNEL_VARIANT,
                          lambda: channel.make_channel_variant_step(R, C, dtype=f.dtype, **kw))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("R,C,one_wave", [(16, 24, True), (37, 29, False), (21, 21, True),
                                          (4, 2, True)])
def test_kernel_2_source_matches_plain(cpu_kernels_2_9, monkeypatch, dtype, R, C, one_wave):
    """csrc/channel_bgk.cu's kernel 2 through make_channel_fused_step, its
    blocks sized to the stand-in's 4 SMs of 2 resident blocks each (6 and 7
    blocks of 64 threads at 16x24 and 21x21, 1 at 4x2: one wave, so
    programmatic dependent launches; 9 of 128 at 37x29: plain launches), a
    virtual row's thread colliding only its source, 3 steps into NaN-filled
    outputs: channel_model(...).step within TOL."""
    f = _kbc_state(R, C, dtype, R * C + 2)
    plain = channel.channel_model(*K2_ARGS).step
    want = plain(plain(plain(f)))
    got, launches, dependent = _k2_steps(cpu_kernels_2_9, monkeypatch, f)
    assert launches == 3 and dependent == (3 if one_wave else 0)
    assert not got.isnan().any() and (got - want).abs().max().item() <= TOL[dtype]


K9_SCENES = ["gravity", "specular", "free_stream", "free_stream_cc", "vertical",
             "vertical_incomp", "trt"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("R,C,one_wave", [(16, 24, True), (37, 29, False), (4, 4, True)])
@pytest.mark.parametrize("scene", K9_SCENES)
def test_kernel_9_source_matches_plain(cpu_kernels_2_9, monkeypatch, dtype, R, C, one_wave,
                                       scene):
    """csrc/channel_variant.cu's kernel 9 in every scene variant of
    chip_smoke.py (pressure on rows and on columns, force, TRT, bounce-back,
    anti-bounce-back and specular walls, the corner-consistent mode) through
    make_channel_variant_step, sized as kernel 2 (dependent launches only in
    one wave), a virtual line's thread colliding only its source, 3 steps
    into NaN-filled outputs: the plain step within TOL."""
    kw = _chip_smoke().variants()[scene]
    f = _kbc_state(R, C, dtype, R * C + 9)
    plain = channel.make_channel_variant_step(R, C, dtype=dtype, **kw)
    want = plain(plain(plain(f)))
    got, launches, dependent = _k9_steps(cpu_kernels_2_9, monkeypatch, f, scene)
    assert launches == 3 and dependent == (3 if one_wave else 0)
    assert not got.isnan().any() and (got - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("design", ["without PDL", "256-thread blocks", "own collision kept",
                                    "near walls only"])
def test_kernels_2_9_designs_give_the_tree_bits(cpu_kernels_2_9, tmp_path, monkeypatch, design):
    """chip_smoke.py's other designs of kernels 2 and 9 (K2_K9_DESIGNS, edits
    of csrc/ that ``k2_k9_times`` times against the tree) built for the CPU:
    the tree's bits over 3 steps in both types at 16x24 (one wave), kernel 2
    and kernel 9 with pressure on rows and on columns, force and
    anti-bounce-back rows; no dependent launch without PDL."""
    smoke = _chip_smoke()
    lib = _cpu_library(tmp_path, ("channel_bgk", "channel_variant"),
                       smoke.design_sources(CSRC, smoke.K2_K9_DESIGNS)[design])
    dependent = 0 if design == "without PDL" else 3
    for dtype in (torch.float64, torch.float32):
        f = _kbc_state(16, 24, dtype, 29)
        tree, design_run = (_k2_steps(where, monkeypatch, f) for where in (cpu_kernels_2_9, lib))
        assert torch.equal(tree[0], design_run[0]) and design_run[2] == dependent
        for scene in ("trt", "vertical", "gravity", "free_stream_cc"):
            tree, design_run = (_k9_steps(where, monkeypatch, f, scene)
                                for where in (cpu_kernels_2_9, lib))
            assert torch.equal(tree[0], design_run[0]) and design_run[2] == dependent


@pytest.fixture(scope="module")
def cpu_kernels_27_34(tmp_path_factory):
    """csrc/collide_stream_bgk.cu and collide_stream_kbc.cu as one CPU
    library: kernels 1 and 3 and their instances of kernels 27 and 34."""
    return _cpu_library(tmp_path_factory.mktemp("csrc_cpu_27_34"),
                        ("collide_stream_bgk", "collide_stream_kbc"))


def _single_steps(lib, kind, f, s):
    """s steps of the CPU build's single-device kernel 1 (BGK) or 3 (KBC,
    factored gamma) from f, each into a NaN-filled buffer."""
    fn = lib.lbm_collide_stream_bgk if kind == "bgk" else lib.lbm_collide_stream_kbc
    fn.restype = ctypes.c_int
    R, C = f.shape[-2:]
    is_f64 = int(f.dtype == torch.float64)
    for _ in range(s):
        out = torch.full_like(f, float("nan"))
        args = (ctypes.c_double(OMEGA_27),) if kind == "bgk" else (
            ctypes.c_double(OMEGA_27), ctypes.c_int(1))
        assert fn(ctypes.c_void_p(f.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                  ctypes.c_longlong(R), ctypes.c_longlong(C), *args, ctypes.c_int(is_f64),
                  None) == 0
        f = out
    return f


OMEGA_27 = 1.0 / 0.8


def _in_place_or_exchanged(monkeypatch, halos):
    """Kernels 27 and 34 read the neighbours' lines through ``ring_rows`` and
    ``ring_2d`` (views); "exchanged" hands them ``exchange_rows``' and
    ``exchange_2d``' copies instead (``strip_parts``' views of the strips)."""
    if halos == "exchanged":
        monkeypatch.setattr(ksh, "ring_rows", exchange_rows)
        monkeypatch.setattr(k2d, "ring_2d", lambda grid, w: [
            strip_parts(f, *st) for f, st in zip((f for row in grid for f in row),
                                                  exchange_2d(grid, w))])


# (kind, mesh: n row shards or an (nx, ny) mesh, R, C, s, halos): shards that
# are not multiples of a tile (a tile writes (48 - 2 s) x (64 - 2 s) cells,
# 32 x 48 at s = 8; KBC's float32 tile (96 - 2 s) x (64 - 2 s)), fewer
# columns than the halo on a row
# shard, 16 shards in two launches, a mesh of one shard its own neighbour,
# one step (the one-thread-a-cell engine); the neighbours' lines read in
# place, and for three meshes also from the exchanges' copies
K27_34_CASES = [
    ("bgk", 8, 80, 52, 8, "in place"), ("bgk", 8, 80, 52, 8, "exchanged"),
    ("kbc", 8, 80, 52, 8, "in place"), ("bgk", 3, 99, 61, 3, "in place"),
    ("bgk", 3, 99, 61, 1, "in place"), ("bgk", 16, 160, 20, 3, "in place"),
    ("bgk", 16, 160, 20, 3, "exchanged"), ("bgk", 2, 32, 5, 8, "in place"),
    ("bgk", (4, 2), 80, 100, 8, "in place"), ("bgk", (4, 2), 80, 100, 8, "exchanged"),
    ("kbc", (4, 2), 72, 100, 3, "in place"), ("bgk", (2, 4), 40, 36, 3, "in place"),
    ("bgk", (1, 1), 50, 70, 8, "in place"), ("bgk", (4, 2), 40, 24, 1, "in place"),
    ("bgk", (4, 4), 64, 64, 2, "in place")]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind,n,R,C,s,halos", K27_34_CASES)
def test_kernels_27_34_source_match_plain(cpu_kernels_27_34, monkeypatch, dtype, kind, n, R,
                                          C, s, halos):
    """Kernels 27 (row shards) and 34 (rows x cols) of csrc/collide_stream.cuh
    through the port's sharded steps: a call's s steps in one launch over up
    to MAX_SHARDS shards (16: two), the tile engine for s >= 2, outputs
    NaN-filled, two calls: the plain sharded step within TOL and the CPU
    build's single-device kernel run 2 s times bit for bit, no NaN."""
    two_d = isinstance(n, tuple)
    shards = n[0] * n[1] if two_d else n
    mesh = pm.make_mesh(["cpu"] * shards, n if two_d else None)
    fn = (bgk.bgk_collide_fn(OMEGA_27, dtype) if kind == "bgk"
          else collide_stream.kbc_collide_fn(OMEGA_27))
    make = k2d.make_sharded_fused_step_2d if two_d else ksh.make_sharded_fused_step
    x = _kbc_state(R, C, dtype, R * C + s)
    plain = make(mesh, R, C, fn, dtype, substeps=s).plain
    want = plain(plain(pm.shard_state(mesh, x))).gather()
    kernel = (k2d.HALO2D_COLLIDE_STREAM if two_d else ksh.HALO_COLLIDE_STREAM)[kind]
    _bind(monkeypatch, cpu_kernels_27_34, kernel)
    monkeypatch.setattr(ksh, "resolve_fused", lambda f: True)
    _in_place_or_exchanged(monkeypatch, halos)
    step = make(mesh, R, C, fn, dtype, substeps=s)
    single = _single_steps(cpu_kernels_27_34, kind, x, 2 * s)
    _nan_buffers(monkeypatch)
    before = kernel.launches
    got = step(step(pm.shard_state(mesh, x))).gather()
    assert kernel.launches - before == 2 * -(-shards // _build.MAX_SHARDS)
    assert not got.isnan().any() and (got - want).abs().max().item() <= TOL[dtype]
    assert torch.equal(got, single)


def test_kernels_27_34_refuse_what_they_cannot_run(cpu_kernels_27_34, monkeypatch):
    """A launch of more than MAX_SHARDS shards, of no shard, or of more steps
    than the parts' halo is refused (cudaErrorInvalidValue), and the wrapper
    raises: no fallback."""
    kernel = ksh.HALO_COLLIDE_STREAM["bgk"]
    _bind(monkeypatch, cpu_kernels_27_34, kernel)
    f = _kbc_state(16, 12, torch.float64, 1)
    top, bot = f[:, -8:], f[:, :8]
    out = torch.empty_like(f)
    geom = ksh.block_geom(f, ksh.row_parts(f, top, bot), out, True)
    params = _build.c_doubles([OMEGA_27])
    for n, s in ((_build.MAX_SHARDS + 1, 2), (0, 2), (1, 9)):
        geoms = (ctypes.c_longlong * (len(geom) * max(n, 1)))(*geom * max(n, 1))
        with pytest.raises(RuntimeError, match="launch failed with cudaError_t 1"):
            kernel.launch(geoms, params, n, s, 0, 0, 1, None)
    kernel.launch((ctypes.c_longlong * len(geom))(*geom), params, 1, 2, 0, 0, 1, None)
    assert torch.equal(out, _single_steps(cpu_kernels_27_34, "bgk", f, 2))


@pytest.mark.parametrize("design", ["plain loads",
                                    "float32 box 48 rows, two blocks an SM, every collision",
                                    "float32 box 96 rows, 1024 threads, every collision",
                                    "float32 box 64 rows, one block an SM", "float64 512 threads",
                                    "tile at one step"])
def test_kernels_27_34_designs_give_the_tree_bits(cpu_kernels_27_34, tmp_path, monkeypatch,
                                                  design):
    """chip_smoke.py's other designs of kernels 27 and 34 (K27_K34_DESIGNS,
    edits of csrc/collide_stream.cuh that ``k27_k34_times`` times against it)
    built for the CPU with csrc/collide_stream_bgk.cu: the tree's bits over a
    call of 1 and of 3 steps on a (2, 2) mesh in both types."""
    header = _chip_smoke().k27_k34_design_sources(CSRC)[design]
    lib = _cpu_library(tmp_path, ("collide_stream_bgk",), {"collide_stream.cuh": header})
    monkeypatch.setattr(ksh, "resolve_fused", lambda f: True)
    mesh = pm.make_mesh(["cpu"] * 4, (2, 2))
    for dtype in (torch.float64, torch.float32):
        x = pm.shard_state(mesh, _kbc_state(36, 40, dtype, 7))
        for s in (1, 3):
            got = {}
            for name, where in (("tree", cpu_kernels_27_34), (design, lib)):
                with monkeypatch.context() as m:
                    _bind(m, where, k2d.HALO2D_COLLIDE_STREAM["bgk"])
                    step = k2d.make_sharded_fused_step_2d(
                        mesh, 36, 40, bgk.bgk_collide_fn(OMEGA_27, dtype), dtype, substeps=s)
                    got[name] = step(x).gather()
            assert torch.equal(got["tree"], got[design])


@pytest.fixture(scope="module")
def cpu_kernels_32_35(tmp_path_factory):
    """csrc/shan_chen.cu as a CPU library: kernels 14, 32 and 35."""
    return _cpu_library(tmp_path_factory.mktemp("csrc_cpu_32_35"), ("shan_chen",))


SC_KW = {"sc guo": dict(omega=1.0, G=-5.0, eos="sc", forcing="guo"),
         "sc shift": dict(omega=1.0, G=-5.0, eos="sc", forcing="shift"),
         "cs shift": dict(omega=1.0, eos="cs", T=0.7 * 0.09433, forcing="shift"),
         "cs guo": dict(omega=1.0, eos="cs", T=0.7 * 0.09433, forcing="guo")}


def _sc_state(R, C, dtype, cs, seed):
    """An equilibrium at seeded densities about the instance's liquid (sc
    0.7, cs 0.18) and a seeded flow, each population times 1 + U(-2%, 2%)."""
    g = np.random.default_rng(seed)
    rho = (0.18 + 0.04 * g.standard_normal((R, C)) if cs
           else 0.7 + 0.1 * g.standard_normal((R, C)))
    u = torch.as_tensor(g.uniform(-0.03, 0.03, (2, R, C)))
    f = d2q9.equilibrium(u, torch.as_tensor(rho)) * torch.as_tensor(g.uniform(0.98, 1.02,
                                                                             (9, R, C)))
    return f.to(dtype).contiguous()


def _sc_step(mesh_shape, R, C, dtype, instance, s):
    """Kernel 32's sharded step (``mesh_shape`` n row shards) or kernel 35's
    (an (nx, ny) mesh) on CPU shards, and its mesh."""
    two_d = isinstance(mesh_shape, tuple)
    n = mesh_shape[0] * mesh_shape[1] if two_d else mesh_shape
    mesh = pm.make_mesh(["cpu"] * n, mesh_shape if two_d else None)
    make = k2d.make_sharded2d_sc_step if two_d else ksh.make_sharded_sc_step
    return make(mesh, R, C, substeps=s, dtype=dtype, **SC_KW[instance]), mesh


def _sc_bound(monkeypatch, lib):
    """Kernels 32 and 35 bound to the CPU build ``lib``, CPU shards let
    through to them."""
    _bind(monkeypatch, lib, ksh.HALO_SHAN_CHEN, k2d.HALO2D_SHAN_CHEN)
    monkeypatch.setattr(ksh, "resolve_fused", lambda f: True)


def _sc_dependent(mesh_shape, R, C, s) -> int:
    """The sweeps of a call of kernel 32 or 35 whose grid fits the stand-in's
    4 SMs of 2 resident blocks in one wave: column tiles of 32 x row tiles
    of 8 over the collided band, one grid layer a shard."""
    if isinstance(mesh_shape, tuple):
        (nx, ny), n = mesh_shape, mesh_shape[0] * mesh_shape[1]
        bands = [(r[1] - r[0] - 2, c[1] - c[0] - 2)
                 for r, c in k2d.sweep_bands_2d(R // nx, C // ny, ksh.HALO, s, 2)]
    else:
        n = mesh_shape
        bands = [(b[1] - b[0] - 2, C) for b in ksh.sweep_bands(R // n, ksh.HALO, 0, R, s, 2,
                                                               False)]
    return sum(-(-cols // 32) * -(-rows // 8) * n <= 8 for rows, cols in bands)


# (instance, n row shards or an (nx, ny) mesh, R, C, s, halos): every eos x
# forcing instance, s = 1-4, 1, 2 and 4 row shards and (1, 2) and (2, 2)
# meshes, sweeps in one wave (dependent launches) and in more; the
# neighbours' lines read in place, and for two cases from the exchanges'
# copies
K32_35_CASES = [
    ("sc guo", 1, 16, 24, 4, "in place"), ("sc shift", 2, 32, 24, 1, "in place"),
    ("cs shift", 4, 32, 24, 3, "in place"), ("cs guo", 4, 32, 24, 4, "in place"),
    ("sc guo", 2, 32, 40, 2, "exchanged"),
    ("sc guo", (1, 2), 16, 32, 4, "in place"), ("sc shift", (2, 2), 32, 48, 2, "in place"),
    ("cs shift", (2, 2), 32, 32, 1, "in place"), ("cs guo", (1, 2), 16, 48, 3, "in place"),
    ("cs guo", (2, 2), 32, 32, 2, "exchanged")]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("instance,mesh_shape,R,C,s,halos", K32_35_CASES)
def test_kernels_32_35_source_match_plain(cpu_kernels_32_35, monkeypatch, dtype, instance,
                                          mesh_shape, R, C, s, halos):
    """Kernels 32 (row shards) and 35 (rows x cols) of csrc/shan_chen.cu
    through the port's sharded Shan-Chen steps: one launch a sweep over the
    device's shards (s a call), a dependent launch exactly where the sweep's
    grid fits one wave, the first sweep reading the neighbours' lines in
    place (``ring_rows``, ``ring_2d``) or from the exchanges' copies, two
    calls into NaN-filled outputs and slabs: the plain sharded step within
    TOL, no NaN."""
    x = _sc_state(R, C, dtype, instance.startswith("cs"), R * C + s)
    step, mesh = _sc_step(mesh_shape, R, C, dtype, instance, s)
    want = step.plain(step.plain(pm.shard_state(mesh, x))).gather()
    _sc_bound(monkeypatch, cpu_kernels_32_35)
    _in_place_or_exchanged(monkeypatch, halos)
    step, _ = _sc_step(mesh_shape, R, C, dtype, instance, s)
    kernel = k2d.HALO2D_SHAN_CHEN if isinstance(mesh_shape, tuple) else ksh.HALO_SHAN_CHEN
    _nan_buffers(monkeypatch)
    before, pdl = kernel.launches, cpu_kernels_32_35.shim_pdl_count()
    got = step(step(pm.shard_state(mesh, x))).gather()
    assert kernel.launches - before == 2 * s
    assert cpu_kernels_32_35.shim_pdl_count() - pdl == 2 * _sc_dependent(mesh_shape, R, C, s)
    assert not got.isnan().any() and (got - want).abs().max().item() <= TOL[dtype]


def test_kernels_32_35_read_the_neighbours_lines_in_place(cpu_kernels_32_35, monkeypatch):
    """On shards of one device kernels 32 and 35 make no exchange copy
    (``step.plain`` makes its exchange's): kernel 35's first sweep names
    each part of the padded block in the neighbour's own buffer (the rows
    above at (R_loc - HALO) C_loc entries into the block above, the columns
    left at C_loc - HALO, at the neighbour's strides), later sweeps a slab.
    A launch of no shard or of more than MAX_SHARDS is refused, and the
    wrapper raises: no fallback."""
    from lbm_tpu_torch.parallel import halo as ph
    from lbm_tpu_torch.parallel.halo import ring_2d

    copies, copy_to = [], ph.copy_to
    monkeypatch.setattr(ph, "copy_to", lambda src, device: copies.append(1) or
                        copy_to(src, device))
    _sc_bound(monkeypatch, cpu_kernels_32_35)
    for mesh_shape, C in ((4, 24), ((2, 2), 48)):
        step, mesh = _sc_step(mesh_shape, 32, C, torch.float64, "sc guo", 2)
        x = pm.shard_state(mesh, _sc_state(32, C, torch.float64, False, 1))
        step(x)
        assert copies == []
        step.plain(x)
        assert copies
        copies.clear()
    h, (R_loc, C_loc) = ksh.HALO, (16, 24)
    grid = [[f for f in x.shards[i * 2:(i + 1) * 2]] for i in range(2)]
    item = 8
    for b, parts in enumerate(ring_2d(grid, h)):
        i, j = divmod(b, 2)
        up, left = grid[i - 1][j], grid[i][j - 1]
        out, geoms, slabs = k2d._parts_geoms(grid[i][j], parts, substeps=2, rows_per_sweep=2)
        g = [dict(zip(k2d.PARTS_GEOM, v)) for v in geoms]
        assert g[0]["in11_base"] == grid[i][j].data_ptr()
        assert g[0]["in01_base"] == up.data_ptr() + (R_loc - h) * C_loc * item
        assert g[0]["in10_base"] == left.data_ptr() + (C_loc - h) * item
        assert g[0]["in00_base"] == grid[i - 1][j - 1].data_ptr() + ((R_loc - h) * C_loc + C_loc
                                                                      - h) * item
        assert all((g[0][f"in{a}{c}_plane"], g[0][f"in{a}{c}_ld"]) == (R_loc * C_loc, C_loc)
                   for a in range(3) for c in range(3))
        assert g[0]["out"] == slabs[0].data_ptr() and g[1]["out"] == out.data_ptr()
        Cp = C_loc + 2 * h
        assert (g[1]["in11_base"], g[1]["in11_ld"]) == (
            slabs[0].data_ptr() + (h * Cp + h) * item, Cp)
    f = _sc_state(16, 24, torch.float64, False, 2)
    _, geoms, _ = ksh._sweep_geoms(f, f[:, -8:], f[:, :8], 0, False, 16, substeps=1,
                                   rows_per_sweep=2, walls=False)
    params = _build.c_doubles(shan_chen.kernel_params(1.0, -5.0, "sc", None, None)[2])
    for n in (0, _build.MAX_SHARDS + 1):
        values = [v for _ in range(max(n, 1)) for v in geoms[0]]
        with pytest.raises(RuntimeError, match="launch failed with cudaError_t 1"):
            ksh.HALO_SHAN_CHEN.launch((ctypes.c_longlong * len(values))(*values), params, n,
                                      0, 0, 1, None)


def _k14_steps(lib, monkeypatch, f, instance, steps=3):
    """A call of ``steps`` steps of kernel 14 through make_sc_fused_step with
    the kernel bound to the CPU build ``lib``, into NaN-filled outputs: (the
    state, its launches, the dependent ones among them)."""
    R, C = f.shape[-2:]
    with monkeypatch.context() as m:
        _bind(m, lib, shan_chen.SHAN_CHEN)
        m.setattr(shan_chen, "resolve_fused", lambda f: True)
        step = shan_chen.make_sc_fused_step(R, C, substeps=steps, dtype=f.dtype,
                                            **SC_KW[instance])
        _nan_buffers(m)
        before, pdl = shan_chen.SHAN_CHEN.launches, lib.shim_pdl_count()
        f = step(f)
        return f, shan_chen.SHAN_CHEN.launches - before, lib.shim_pdl_count() - pdl


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("R,C,one_wave", [(16, 64, True), (40, 96, False), (5, 7, True)])
@pytest.mark.parametrize("instance", sorted(SC_KW))
def test_kernel_14_source_matches_plain(cpu_kernels_32_35, monkeypatch, dtype, R, C, one_wave,
                                        instance):
    """csrc/shan_chen.cu's kernel 14 in every eos x forcing instance through
    make_sc_fused_step, 3 steps into NaN-filled outputs, on grids sized to
    the stand-in's 4 SMs of 2 resident blocks each: 16x64 (4 tiles of 8 x
    32, one wave: programmatic dependent launches), 40x96 (15 tiles: plain
    launches) and 5x7, shorter and narrower than a tile (one wave; its
    window wraps by a remainder): the plain step within TOL, no NaN."""
    f = _sc_state(R, C, dtype, instance.startswith("cs"), R * C + 14)
    plain = shan_chen.make_plain_step(**SC_KW[instance])
    want = plain(plain(plain(f)))
    got, launches, dependent = _k14_steps(cpu_kernels_32_35, monkeypatch, f, instance)
    assert launches == 3 and dependent == (3 if one_wave else 0)
    assert not got.isnan().any() and (got - want).abs().max().item() <= TOL[dtype]


@pytest.fixture(scope="module")
def k32_k35_design_libs(tmp_path_factory):
    """chip_smoke.py's K32_K35_DESIGNS that edit a source, each built for the
    CPU with csrc/shan_chen.cu, the builds side by side: {label: library}."""
    smoke = _chip_smoke()
    sources = {label: files for label, files in
               smoke.design_sources(CSRC, smoke.K32_K35_DESIGNS).items() if files}
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = {label: pool.submit(_cpu_library, tmp_path_factory.mktemp("design_32_35"),
                                    ("shan_chen",), files)
                 for label, files in sources.items()}
    return {label: lib.result() for label, lib in built.items()}


@pytest.mark.parametrize("design", ["without PDL", "release after loads", "release first",
                                    "64-bit wraps", "exchange copies kept"])
def test_kernels_32_35_designs_give_the_tree_bits(cpu_kernels_32_35, k32_k35_design_libs,
                                                  monkeypatch, design):
    """chip_smoke.py's other designs of kernels 32 and 35 (K32_K35_DESIGNS,
    which ``k32_k35_times`` times against the tree) built for the CPU:
    "without PDL" (an edit of d2q9.cuh) launches no dependent sweep, the
    other edits of csrc/shan_chen.cu the tree's dependent ones, and
    "exchange copies kept" runs the tree's kernels on the exchanges' copies;
    each gives the tree's bits over a call of 2 sweeps on 2 row shards in
    float64 and of 3 on a (1, 2) mesh in float32."""
    smoke = _chip_smoke()
    lib = k32_k35_design_libs.get(design, cpu_kernels_32_35)
    for dtype, mesh_shape, s in ((torch.float64, 2, 2), (torch.float32, (1, 2), 3)):
        x = _sc_state(16, 32, dtype, False, 5)
        got = {}
        for name, where in (("tree", cpu_kernels_32_35), (design, lib)):
            with monkeypatch.context() as m, (
                    smoke.exchange_copies_kept() if name == "exchange copies kept"
                    else contextlib.nullcontext()):
                _sc_bound(m, where)
                step, mesh = _sc_step(mesh_shape, 16, 32, dtype, "sc guo", s)
                pdl = where.shim_pdl_count()
                got[name] = step(pm.shard_state(mesh, x)).gather()
                dependent = where.shim_pdl_count() - pdl
            assert dependent == (0 if name == "without PDL"
                                 else _sc_dependent(mesh_shape, 16, 32, s))
        assert torch.equal(got["tree"], got[design])


@pytest.fixture(scope="module")
def k37_k14_design_libs(tmp_path_factory):
    """chip_smoke.py's K37_K14_DESIGNS that edit a source, each built for the
    CPU, kernel 37's with csrc/rk_cg.cu and kernel 14's with
    csrc/shan_chen.cu, the builds side by side: {label: library}."""
    smoke = _chip_smoke()
    sources = {label: files for label, files in
               smoke.design_sources(CSRC, smoke.K37_K14_DESIGNS).items() if files}
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = {label: pool.submit(_cpu_library, tmp_path_factory.mktemp("design_37_14"),
                                    ("rk_cg",) if label in smoke.K37_DESIGNS else ("shan_chen",),
                                    files)
                 for label, files in sources.items()}
    return {label: lib.result() for label, lib in built.items()}


@pytest.mark.parametrize("design", ["exchange copies kept", "launch per shard",
                                    "masked instance in float32 too",
                                    "branch per block in float64 too",
                                    "no register cap in float64", "five blocks an SM in float32"])
def test_kernel_37_designs_give_the_tree_bits(cpu_kernels, k37_k14_design_libs, monkeypatch,
                                              design):
    """chip_smoke.py's other designs of kernel 37 (K37_K14_DESIGNS, which
    ``k37_k14_times`` times against the tree): "exchange copies kept" and
    "launch per shard" run the tree's kernel on the exchange's copies and a
    shard a launch (8 launches a call on (4, 2)), the edits of csrc/rk_cg.cu
    the masked instance for every shard in float32 too, the branch per
    block in float64 too and other register caps; each gives the tree's
    bits over a
    call on (4, 2) in float64, its batch of edge and interior row ranks,
    and on (2, 2) in float32."""
    smoke = _chip_smoke()
    lib = k37_k14_design_libs.get(design, cpu_kernels)
    for dtype, mesh_shape, R, C in ((torch.float64, (4, 2), 64, 96),
                                    (torch.float32, (2, 2), 40, 70)):
        n = mesh_shape[0] * mesh_shape[1]
        mesh = pm.make_mesh(["cpu"] * n, mesh_shape)
        x = pm.shard_state(mesh, _rk_state(R, C, dtype, 3))
        got = {}
        for name, where in (("tree", cpu_kernels), (design, lib)):
            with monkeypatch.context() as m, (
                    smoke.exchange_copies_kept() if name == "exchange copies kept" else
                    smoke.launch_per_shard() if name == "launch per shard" else
                    contextlib.nullcontext()):
                _bind(m, where, k2d.HALO2D_RK)
                m.setattr(ksh, "resolve_fused", lambda f: True)
                step = k2d.make_sharded2d_rk_step(mesh, R, C, dtype=dtype, **RK_KW)
                before = k2d.HALO2D_RK.launches
                got[name] = step(x).gather()
                launches = k2d.HALO2D_RK.launches - before
            assert launches == (n if name == "launch per shard" else -(-n // _build.MAX_SHARDS))
        assert torch.equal(got["tree"], got[design])


@pytest.mark.parametrize("design", ["64-bit wraps", "without PDL", "release after loads"])
def test_kernel_14_designs_give_the_tree_bits(cpu_kernels_32_35, k37_k14_design_libs,
                                              monkeypatch, design):
    """chip_smoke.py's other designs of kernel 14 (K37_K14_DESIGNS, edits of
    csrc/shan_chen.cu and of d2q9.cuh) built for the CPU: the tree's bits
    over 3 steps at 16x64 (one wave) in float64 and at 5x7 (shorter and
    narrower than a tile) in float32, dependent launches but "without
    PDL"."""
    lib = k37_k14_design_libs[design]
    for dtype, (R, C) in ((torch.float64, (16, 64)), (torch.float32, (5, 7))):
        f = _sc_state(R, C, dtype, False, R + C)
        tree = _k14_steps(cpu_kernels_32_35, monkeypatch, f, "sc guo")
        other = _k14_steps(lib, monkeypatch, f, "sc guo")
        assert torch.equal(tree[0], other[0]) and tree[2] == 3
        assert other[1] == 3 and other[2] == (0 if design == "without PDL" else 3)


THERMAL_NAMES = ["thermal_rb_q9", "thermal_rb_q5", "heated_cavity_q9", "heated_cavity_q5"]


def _thermal_steps(lib, monkeypatch, S, name, steps=3):
    """``steps`` steps of the thermal instance ``name`` (kernel 23 or 24 in a
    scalar lattice, chip_smoke.py's ``thermal_kernel``) through
    make_thermal_fused_step or make_heated_cavity_fused_step, its kernel
    bound to the CPU build ``lib``, into NaN-filled outputs: (the state, its
    launches, the dependent ones among them)."""
    make, _, kernel, q = _chip_smoke().thermal_kernel(name)
    R, C = S.shape[-2:]
    with monkeypatch.context() as m:
        _bind(m, lib, kernel)
        m.setattr(thermal, "resolve_fused", lambda f: True)
        step = make(R, C, dtype=S.dtype, scalar_lattice=f"d2q{q}", **THERMAL)
        _nan_buffers(m)
        before, pdl = kernel.launches, lib.shim_pdl_count()
        for _ in range(steps):
            S = step(S)
        return S, kernel.launches - before, lib.shim_pdl_count() - pdl


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("R,C,one_wave", [(16, 24, True), (37, 29, False), (4, 4, True)])
@pytest.mark.parametrize("name", THERMAL_NAMES)
def test_kernels_23_24_source_match_plain(cpu_kernels, monkeypatch, dtype, R, C, one_wave, name):
    """csrc/thermal.cu's kernels 23 (Rayleigh-Benard) and 24 (heated cavity)
    in both scalar lattices, launched as kernels 2 and 9 are (blocks sized to
    the stand-in's 4 SMs of 2 resident blocks each: 6 blocks of 64 threads
    at 16x24 and 1 at 4x4, one wave, so programmatic dependent launches; 9
    of 128 at 37x29, plain launches), 3 steps into NaN-filled outputs: the
    plain step within TOL."""
    smoke = _chip_smoke()
    _, plain, _, q = smoke.thermal_kernel(name)
    S = smoke.thermal_state(q, R, C, dtype, "cpu", seed=R * C + q)
    want = S
    for _ in range(3):
        want = plain(want, **THERMAL)
    got, launches, dependent = _thermal_steps(cpu_kernels, monkeypatch, S, name)
    assert launches == 3 and dependent == (3 if one_wave else 0)
    assert not got.isnan().any() and (got - want).abs().max().item() <= TOL[dtype]


@pytest.fixture(scope="module")
def k23_k24_design_libs(tmp_path_factory):
    """chip_smoke.py's K23_K24_DESIGNS, each built for the CPU with
    csrc/thermal.cu, the builds side by side: {label: library}."""
    smoke = _chip_smoke()
    sources = smoke.design_sources(CSRC, smoke.K23_K24_DESIGNS)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = {label: pool.submit(_cpu_library, tmp_path_factory.mktemp("design_23_24"),
                                    ("thermal",), files)
                 for label, files in sources.items()}
    return {label: lib.result() for label, lib in built.items()}


@pytest.mark.parametrize("design", ["without PDL", "256-thread blocks", "32-bit indices",
                                    "release at block exit", "near walls only",
                                    "near walls only, 32-bit indices",
                                    "near walls only, release at block exit"])
def test_kernels_23_24_designs_give_the_tree_bits(cpu_kernels, k23_k24_design_libs,
                                                  monkeypatch, design):
    """chip_smoke.py's other designs of kernels 23 and 24 (K23_K24_DESIGNS,
    edits of csrc/thermal.cu and d2q9.cuh that ``k23_k24_times`` times
    against the tree) built for the CPU: the tree's bits over 3 steps, every
    instance, at 16x24 (one wave: dependent launches but "without PDL") in
    float64 and at 37x29 (plain launches of the tree) in float32."""
    lib = k23_k24_design_libs[design]
    smoke = _chip_smoke()
    for name in THERMAL_NAMES:
        q = smoke.thermal_kernel(name)[3]
        for dtype, (R, C) in ((torch.float64, (16, 24)), (torch.float32, (37, 29))):
            S = smoke.thermal_state(q, R, C, dtype, "cpu", seed=R + C + q)
            tree = _thermal_steps(cpu_kernels, monkeypatch, S, name)
            other = _thermal_steps(lib, monkeypatch, S, name)
            assert torch.equal(tree[0], other[0]) and other[1] == 3
            if R == 16:
                assert tree[2] == 3 and other[2] == (0 if design == "without PDL" else 3)
