"""Rows x cols sharded collide-stream: the plain version and CUDA kernel 34
(counterpart of lbm_tpu/kernels/sharded2d_pallas.py, its first
``pallas_call``: make_local_2d_step :223 and make_sharded_fused_step_2d
:290).

The grid's rows are split over mesh axis 'x' and its columns over 'y', on
any (nx, ny) mesh (parallel/mesh.py).  Each call exchanges halos once
(parallel/halo.py ``exchange_2d``: row strips of HALO rows within each mesh
column, then column strips of HALO columns that carry their row strips, so
the corners come from the diagonal neighbours) and then runs ``substeps``
sweeps of the globally periodic collide-stream on every shard.  lbm_tpu
packs its two 64-lane column halves into one 128-lane tile after the
interior lanes, a Mosaic layout; the port's column strips are HALO columns
wide, one a side, so the same 8-deep halo bounds the cadence in both axes:
up to 8 sweeps per exchange, ``"auto"`` = 8.

Local step ``local(f_loc, top, bot, left, right)``:
  * on a CPU shard, the plain version, the doubly periodic path of
    parallel/sharded.py (``stream_halo``'s ``sweep_block``) with any
    collision and ``substeps`` sweeps: the shard and its four strips
    concatenated into a padded block of ``(R_loc + 2 HALO) x (C_loc + 2
    HALO)``, ``substeps`` sweeps of ``stream(collide_fn(block))`` over it (the
    rolls wrap the block, and each sweep leaves one more line stale on every
    side), the shard kept.  It equals the single-device plain step bit for
    bit (the tests hold it so);
  * on a CUDA shard, kernel 34, one launch per sweep (``launch_sweeps_2d``):
    the first sweep reads the five buffers in place (csrc/halo2d.cuh),
    later sweeps a padded scratch slab, the last one writes the shard only.
    Sweep j of s writes the shard and s - j more rows and columns on each
    side, reading one line beyond them (``sweep_bands`` in both axes).

Kernel 34, ``HALO2D_COLLIDE_STREAM``, has one instance per local collision
(BGK, KBC, LES, TRT, power law), each in its family's source beside
kernels 1/3/5/10/11 and 27 with the same collision functor and flags
(csrc/collide_stream.cuh ``halo2d_step``).  The collide function names its
instance through its ``halo_kernel`` attribute, as for kernel 27; a
function without one raises on a CUDA shard.

Bound: device-memory bytes, 72 B/cell in float32 over the band each sweep
reads and writes, plus the strips of the exchange, each written and read
once (chip_smoke.py counts them); the exchange itself is 2 n row strips
of ``9 x HALO x C_loc`` and 2 n column strips of ``9 x (R_loc + 2 HALO) x
HALO`` values, the column strips strided copies.
"""

from __future__ import annotations

import ctypes

import torch

from ..parallel.halo import exchange_2d, pad_block
from ..parallel.mesh import Mesh, ShardedState
from ..parallel.sharded import sweep_block
from ..utils.xmath import resolve_fused
from . import _build
from .sharded import (_ARGS, COLLIDE_KINDS, HALO, _check_sweeps, collide_launch,
                      resolve_substeps, sweep_bands)

# the geometry array of a kernel-34 launch (csrc/halo2d.cuh ``Geom``)
GEOM = ("top", "mid", "bot", "left", "right", "out",
        "top_plane", "mid_plane", "bot_plane", "left_plane", "right_plane", "out_plane",
        "top_ld", "mid_ld", "bot_ld", "left_ld", "right_ld", "out_ld",
        "halo", "r_loc", "c_loc", "in_r_lo", "in_r_hi", "in_c_lo", "in_c_hi",
        "out_r_lo", "out_r_hi", "out_c_lo", "out_c_hi", "out_first")
HALO2D_COLLIDE_STREAM = {kind: _build.CudaKernel(f"lbm_halo2d_{kind}", _ARGS)
                         for kind in COLLIDE_KINDS}                       # kernel 34


def sweep_bands_2d(R_loc: int, C_loc: int, halo: int, substeps: int):
    """(rows, cols) bands of each sweep of one exchange, each as
    ``sweep_bands``' (in_lo, in_hi, out_lo, out_hi) in padded lines of the
    shard: sweep j of s writes ``s - j`` more lines on each side of the
    shard, reading one beyond them; nothing wraps and no wall clips."""
    rows = sweep_bands(R_loc, halo, 0, R_loc, substeps, 1, False)
    cols = sweep_bands(C_loc, halo, 0, C_loc, substeps, 1, False)
    return list(zip(rows, cols))


def _check_strips(f, top, bot, left, right, halo: int):
    R_loc, C_loc = _build.check_state(f, 9)
    for name, h, shape in (("top", top, (9, halo, C_loc)), ("bot", bot, (9, halo, C_loc)),
                           ("left", left, (9, R_loc + 2 * halo, halo)),
                           ("right", right, (9, R_loc + 2 * halo, halo))):
        if tuple(h.shape) != shape or h.dtype != f.dtype or h.device != f.device or \
                not h.is_contiguous():
            raise ValueError(f"halo {name} must be a contiguous {shape} {f.dtype} tensor on "
                             f"{f.device}, got {tuple(h.shape)} {h.dtype} on {h.device}")
    return R_loc, C_loc


def launch_sweeps_2d(kernel: _build.CudaKernel, f, top, bot, left, right, *, substeps: int,
                     params, i0: int = 0, i1: int = 0) -> torch.Tensor:
    """``substeps`` launches of kernel 34 on the shard ``f`` with its four
    strips; returns the shard's new values in a fresh buffer (``f`` is never
    written).  Raises on a tensor the kernel does not take and on a refused
    launch."""
    halo = top.shape[-2]
    R_loc, C_loc = _check_strips(f, top, bot, left, right, halo)
    _check_sweeps(substeps, halo)
    item = f.element_size()
    Rp, Cp = R_loc + 2 * halo, C_loc + 2 * halo
    out = torch.empty_like(f)
    slabs = [torch.empty((9, Rp, Cp), dtype=f.dtype, device=f.device)
             for _ in range(min(substeps - 1, 2))]
    # (base, plane, ld) of top, mid, bot, left, right
    src = [(top.data_ptr(), halo * C_loc, C_loc), (f.data_ptr(), R_loc * C_loc, C_loc),
           (bot.data_ptr(), halo * C_loc, C_loc), (left.data_ptr(), Rp * halo, halo),
           (right.data_ptr(), Rp * halo, halo)]
    with torch.cuda.device(f.device):
        stream = _build.stream_handle(f)
        for j, ((ri_lo, ri_hi, ro_lo, ro_hi), (ci_lo, ci_hi, co_lo, co_hi)) in enumerate(
                sweep_bands_2d(R_loc, C_loc, halo, substeps), start=1):
            if j == substeps:
                dst, first, dplane, dld = out, halo, R_loc * C_loc, C_loc
            else:
                dst, first, dplane, dld = slabs[(j - 1) % 2], 0, Rp * Cp, Cp
            bases, planes, lds = zip(*src)
            geom = (ctypes.c_longlong * len(GEOM))(
                *bases, dst.data_ptr(), *planes, dplane, *lds, dld, halo, R_loc, C_loc,
                ri_lo, ri_hi, ci_lo, ci_hi, ro_lo, ro_hi, co_lo, co_hi, first)
            kernel.launch(geom, params, i0, i1, int(f.dtype == torch.float64), stream)
            b = dst.data_ptr()
            slab = (Rp * Cp, Cp)
            src = [(b + halo * item, *slab), (b + (halo * Cp + halo) * item, *slab),
                   (b + ((halo + R_loc) * Cp + halo) * item, *slab), (b, *slab),
                   (b + (halo + C_loc) * item, *slab)]
    return out


def make_local_2d_step(R_loc: int, C_loc: int, collide_fn, dtype: torch.dtype = torch.float32,
                       substeps: int = 1):
    """The periodic collide-stream over one shard of an (nx, ny) mesh with
    explicit strips: ``(f_loc (9, R_loc, C_loc), top, bot (9, HALO, C_loc),
    left, right (9, R_loc + 2 HALO, HALO)) -> f_loc'``, ``substeps`` steps
    (lbm_tpu sharded2d_pallas.py:223, whose combined 128-lane tile is here
    the two strips).  Kernel 34 on a CUDA shard, the plain version on a CPU
    shard; ``fn.plain`` is the plain version on any device."""
    _check_sweeps(substeps, HALO)
    if R_loc < HALO or C_loc < HALO:
        raise ValueError(f"local shard {R_loc}x{C_loc} smaller than the {HALO}-line "
                         "exchange strips")
    launch = collide_launch(collide_fn, HALO2D_COLLIDE_STREAM, launch_sweeps_2d,
                            substeps=substeps)

    def plain(f, top, bot, left, right):
        return sweep_block(pad_block(f, top, bot, left, right), top.shape[-2], collide_fn,
                           substeps)

    def fn(f, top, bot, left, right):
        if tuple(f.shape) != (9, R_loc, C_loc) or f.dtype != dtype:
            raise ValueError(f"shard {tuple(f.shape)} {f.dtype}, step built for "
                             f"(9, {R_loc}, {C_loc}) {dtype}")
        if resolve_fused(f):
            return launch(f, top, bot, left, right)
        return plain(f, top, bot, left, right)

    fn.plain = plain
    return fn


def make_sharded_fused_step_2d(mesh: Mesh, R: int, C: int, collide_fn,
                               dtype: torch.dtype = torch.float32, substeps: int | str = 1):
    """Globally periodic collide-stream with any local collision, rows
    sharded over mesh axis 'x' and columns over 'y': ShardedState ->
    ShardedState, ``substeps`` steps per call and one exchange of HALO rows
    and columns (lbm_tpu sharded2d_pallas.py:290).  Kernel 34 on CUDA
    shards; ``step.plain`` runs the plain version on any device."""
    substeps = _check_sweeps(resolve_substeps(substeps, "bgk"), HALO)
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    if R % nx or C % ny:
        raise ValueError(f"grid {R}x{C} not divisible by mesh {nx}x{ny}")
    R_loc, C_loc = R // nx, C // ny
    local = make_local_2d_step(R_loc, C_loc, collide_fn, dtype, substeps)

    def build(run):
        def step(state: ShardedState) -> ShardedState:
            if state.mesh != mesh:
                raise ValueError("the state is sharded over another mesh than the step's")
            for f in state.shards:
                if tuple(f.shape) != (9, R_loc, C_loc) or f.dtype != dtype:
                    raise ValueError(f"shard {tuple(f.shape)} {f.dtype}, step built for "
                                     f"(9, {R_loc}, {C_loc}) {dtype}")
            grid = [state.shards[i * ny:(i + 1) * ny] for i in range(nx)]
            return ShardedState(mesh, [run(f, *strips) for f, strips in
                                       zip(state.shards, exchange_2d(grid, HALO))])

        return step

    step = build(local)
    step.plain = build(local.plain)
    return step
