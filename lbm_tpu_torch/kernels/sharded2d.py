"""Rows x cols sharded steps: the plain versions and CUDA kernels 34-38
(counterpart of lbm_tpu/kernels/sharded2d_pallas.py: the collide-stream,
make_local_2d_step :223 and make_sharded_fused_step_2d :290, and the body
steps, make_local_2d_body_step :392 under the wrappers :432 (RK), :455
(MRT-CG, CSF), :549 (Shan-Chen) and :578 (thermal)).

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

Local step ``local(f_loc, top, bot, left, right)`` (``make_local_2d_step``;
the sharded step reads the same padded block as ``parallel/halo.py``
``ring_2d``'s 3 x 3 parts, in place where a neighbour shares the card):
  * on a CPU shard, the plain version, the doubly periodic path of
    parallel/sharded.py (``stream_halo``'s ``sweep_block``) with any
    collision and ``substeps`` sweeps: the shard and its four strips
    concatenated into a padded block of ``(R_loc + 2 HALO) x (C_loc + 2
    HALO)``, ``substeps`` sweeps of ``stream(collide_fn(block))`` over it (the
    rolls wrap the block, and each sweep leaves one more line stale on every
    side), the shard kept.  It equals the single-device plain step bit for
    bit (the tests hold it so);
  * on CUDA shards, kernel 34: a call's s steps in one launch over up to
    ``MAX_SHARDS`` shards of a card (kernels/sharded.py
    ``launch_collide_shards``; csrc/collide_stream.cuh's tile engine runs
    the s steps in shared memory, one pass over device memory), each shard
    reading its padded block from its 3 x 3 parts in place.

Kernel 34, ``HALO2D_COLLIDE_STREAM``, has one instance per local collision
(BGK, KBC, LES, TRT, power law), each in its family's source beside
kernels 1/3/5/10/11 and 27 with the same collision functor and flags
(csrc/collide_stream.cuh ``block::launch_shards``).  The collide function
names its instance through its ``halo_kernel`` attribute, as for kernel 27;
a function without one raises on a CUDA shard.

Bound: device-memory bytes, 72 B/cell in float32, each shard read and
written once a call, plus the neighbours' lines its first step reads (s a
side); no exchange between shards of one card (``step.plain`` keeps
``exchange_2d``: 2 n row strips of ``9 x HALO x C_loc`` and 2 n column
strips of ``9 x (R_loc + 2 HALO) x HALO`` values, the column strips strided
copies).

The body steps (``make_sharded2d_body_step``, lbm_tpu's ``_sharded2d_wrap``
:517-546) run a family's step on each shard with its global row and column
offsets, one exchange of HALO rows and columns per call (``exchange_2d``;
kernels 35 and 37 ``ring_2d``) and
``substeps`` sweeps, each consuming ``ROWS_PER_SWEEP`` lines of the strips
in both axes; the masked (edge) instance on row ranks 0 and nx-1, the
mask-free one on interior row ranks:
  * on a CPU shard, the plain version: ``sweep_block`` over the padded block
    with the family's plain step, given the block's global rows (unwrapped:
    the walls and the replicate padding at the grid's rows 0 and R-1) and
    its global columns wrapped into [0, C) (the 5x5 stencils' replicate
    padding and the column repair of the MRT-CG and RK streams at the grid's
    columns 0 and C-1, wherever the block holds them).  It equals the
    single-device plain step bit for bit;
  * on a CUDA shard, the family's rows x cols kernel, one launch per sweep
    and shard (``launch_sweeps_2d``) or per sweep over a card's shards:
    kernel 35 ``HALO2D_SHAN_CHEN`` (csrc/shan_chen.cu, kernel 14's
    collision; one launch a sweep over up to ``MAX_SHARDS`` shards of a card,
    ``launch_parts_shards``, its first sweep reading each padded block from
    ``ring_2d``'s 3 x 3 parts: no exchange copy on one card), 36
    ``HALO2D_THERMAL`` (csrc/thermal.cu, kernel 23's D2Q9 step; one launch a
    sweep over up to ``MAX_SHARDS`` shards of a card,
    ``launch_sweeps_2d_shards``, from ``exchange_2d``'s strips), 37
    ``HALO2D_RK`` (csrc/rk_cg.cu, kernel 12's tile; one launch a call over
    up to ``MAX_SHARDS`` shards of a card, edge and interior shards alike,
    ``launch_parts_shards``, each padded block read from ``ring_2d``'s 3 x 3
    parts) and 38 ``HALO2D_MRTCG_FULL`` (csrc/mrtcg_full.cu, both modes; one
    launch a sweep and shard), 37-38 on the tile engine of csrc/mrtcg.cuh
    with its columns the shard's padded ones (``BandCols``).
    Sweep j of s writes the shard and ``rows_per_sweep (s - j)`` more lines
    on each side, reading ``rows_per_sweep`` beyond them, the rows clipped at
    the grid's walls.

Sweeps per exchange: lbm_tpu's 2-D caps, ``min(8 // rps, 32 // rps)`` with
rps the lines a sweep consumes (``CAP_2D``: MRT-CG 2, CSF 1, Shan-Chen 4,
thermal 8; RK runs one), and ``"auto"`` the cap; the row path's deeper
``AUTO_SUBSTEPS`` (on 16- and 24-row strips) do not apply, since every
2-D strip is HALO = 8 lines deep.

Guards of the body steps, each a ValueError: a mesh with ny >= 2 (an (n, 1)
mesh takes kernels/sharded.py's row-sharded factories), a grid divisible
by the mesh, shards of at least HALO rows and columns, and no global column
twice in a padded block, ``C - C_loc >= 2 HALO`` (lbm_tpu's ``C - C_loc >=
CHALO`` for its two 64-lane halves).  lbm_tpu's Mosaic guards (``C_loc %
128``, a 128-lane halo tile) have no counterpart.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..parallel.halo import exchange_2d, pad_block, parts_block, ring_2d, strip_parts
from ..parallel.mesh import Mesh, ShardedState
from ..parallel.sharded import sweep_block
from ..utils.xmath import resolve_fused
from . import _build, mrtcg, rk, shan_chen, thermal
from ._build import MAX_SHARDS, shard_batches
from .sharded import (_ARGS, BLOCK_ARGS, COLLIDE_KINDS, HALO, ROWS_PER_SWEEP, SHARDS_ARGS,
                      _check_parts, _check_sweeps, _per_colour, collide_launch,
                      launch_planned_shards, resolve_substeps, sweep_bands, thermal_body)

# the geometry array of a rows x cols launch (csrc/halo2d.cuh ``Geom``)
GEOM = ("top", "mid", "bot", "left", "right", "out",
        "top_plane", "mid_plane", "bot_plane", "left_plane", "right_plane", "out_plane",
        "top_ld", "mid_ld", "bot_ld", "left_ld", "right_ld", "out_ld",
        "halo", "r_loc", "c_loc", "in_r_lo", "in_r_hi", "in_c_lo", "in_c_hi",
        "out_r_lo", "out_r_hi", "out_c_lo", "out_c_hi", "out_first",
        "off_r", "off_c", "rows", "cols", "edge")
# the geometry array of one shard of kernels 35 and 37 (csrc/halo2d.cuh
# ``PartsGeom``): the 3 x 3 parts of its padded block row-major, each (base,
# plane stride, row stride), then the output's, the parts' halo, the shard's
# rows and columns, the cells read and the cells written, and the body
# kernels' global offsets, grid shape and edge flag (kernel 37 reads them)
PARTS_GEOM = (*(f"in{a}{b}_{x}" for a in range(3) for b in range(3)
                for x in ("base", "plane", "ld")),
              "out", "out_plane", "out_ld", "out_first", "halo", "r_loc", "c_loc",
              "in_r_lo", "in_r_hi", "in_c_lo", "in_c_hi", "out_r_lo", "out_r_hi", "out_c_lo",
              "out_c_hi", "off_r", "off_c", "rows", "cols", "edge")
HALO2D_COLLIDE_STREAM = {kind: _build.CudaKernel(f"lbm_halo2d_{kind}", BLOCK_ARGS)
                         for kind in COLLIDE_KINDS}                       # kernel 34
HALO2D_SHAN_CHEN = _build.CudaKernel("lbm_halo2d_shan_chen", SHARDS_ARGS)  # kernel 35
HALO2D_THERMAL = _build.CudaKernel("lbm_halo2d_thermal", _ARGS)           # kernel 36
HALO2D_RK = _build.CudaKernel("lbm_halo2d_rk", SHARDS_ARGS)               # kernel 37
HALO2D_MRTCG_FULL = _build.CudaKernel("lbm_halo2d_mrtcg_full", _ARGS)     # kernel 38

#: sweeps per exchange of the body steps: lbm_tpu's 2-D caps, min(8 // rps,
#: 32 // rps) (sharded2d_pallas.py:484-486, :569, :598; its RK wrapper runs
#: one), which ``"auto"`` also resolves to
CAP_2D = {"mrtcg": 2, "csf": 1, "shan_chen": 4, "thermal": 8, "rk": 1}


def resolve_substeps_2d(substeps, family: str) -> int:
    """The sweeps per exchange of a body step: ``"auto"`` resolves to
    ``CAP_2D[family]``; an int must lie in [1, CAP_2D[family]]."""
    cap = CAP_2D[family]
    return _check_sweeps(cap if substeps == "auto" else substeps, cap)


def sweep_bands_2d(R_loc: int, C_loc: int, halo: int, substeps: int,
                   rows_per_sweep: int = 1, off: int = 0, R: int | None = None,
                   walls: bool = False):
    """(rows, cols) bands of each sweep of one exchange, each as
    ``sweep_bands``' (in_lo, in_hi, out_lo, out_hi) in padded lines of the
    shard: sweep j of s writes ``rows_per_sweep (s - j)`` more lines on each
    side of the shard, reading ``rows_per_sweep`` beyond them; ``walls``
    clips the rows to the grid's rows [0, R) (the shard's global row offset
    ``off``), and no column wraps or clips."""
    rows = sweep_bands(R_loc, halo, off, R_loc if R is None else R, substeps, rows_per_sweep,
                       walls)
    cols = sweep_bands(C_loc, halo, 0, C_loc, substeps, rows_per_sweep, False)
    return list(zip(rows, cols))


def _check_strips(f, top, bot, left, right, halo: int):
    planes = f.shape[0] if f.dim() == 3 else 9
    R_loc, C_loc = _build.check_state(f, planes)
    for name, h, shape in (("top", top, (planes, halo, C_loc)),
                           ("bot", bot, (planes, halo, C_loc)),
                           ("left", left, (planes, R_loc + 2 * halo, halo)),
                           ("right", right, (planes, R_loc + 2 * halo, halo))):
        if tuple(h.shape) != shape or h.dtype != f.dtype or h.device != f.device or \
                not h.is_contiguous():
            raise ValueError(f"halo {name} must be a contiguous {shape} {f.dtype} tensor on "
                             f"{f.device}, got {tuple(h.shape)} {h.dtype} on {h.device}")
    return R_loc, C_loc


def _sweep_geoms(f, top, bot, left, right, *, substeps: int, rows_per_sweep: int,
                 walls: bool, off: tuple[int, int], shape: tuple[int, int], edge: bool):
    """(out, geoms, slabs) of ``substeps`` sweeps of a rows x cols kernel on
    the shard ``f`` with its four strips: ``out`` a fresh buffer for the
    shard's new values (``f`` is never written), in order each sweep's
    geometry (``GEOM``'s values) and the scratch slabs they name, which the
    caller holds until the launches are issued: the first sweep reads the
    five buffers in place, later ones a padded slab (two, alternating), the
    last writes ``out``.  Raises on a tensor the kernels do not take."""
    halo = top.shape[-2]
    R_loc, C_loc = _check_strips(f, top, bot, left, right, halo)
    _check_sweeps(substeps, halo // rows_per_sweep)
    planes, item = f.shape[0], f.element_size()
    Rp, Cp = R_loc + 2 * halo, C_loc + 2 * halo
    out = torch.empty_like(f)
    slabs = [torch.empty((planes, Rp, Cp), dtype=f.dtype, device=f.device)
             for _ in range(min(substeps - 1, 2))]
    # (base, plane, ld) of top, mid, bot, left, right
    src = [(top.data_ptr(), halo * C_loc, C_loc), (f.data_ptr(), R_loc * C_loc, C_loc),
           (bot.data_ptr(), halo * C_loc, C_loc), (left.data_ptr(), Rp * halo, halo),
           (right.data_ptr(), Rp * halo, halo)]
    geoms = []
    for j, ((ri_lo, ri_hi, ro_lo, ro_hi), (ci_lo, ci_hi, co_lo, co_hi)) in enumerate(
            sweep_bands_2d(R_loc, C_loc, halo, substeps, rows_per_sweep, off[0], shape[0],
                           walls), start=1):
        if j == substeps:
            dst, first, dplane, dld = out, halo, R_loc * C_loc, C_loc
        else:
            dst, first, dplane, dld = slabs[(j - 1) % 2], 0, Rp * Cp, Cp
        bases, planes_, lds = zip(*src)
        geoms.append((*bases, dst.data_ptr(), *planes_, dplane, *lds, dld, halo, R_loc, C_loc,
                      ri_lo, ri_hi, ci_lo, ci_hi, ro_lo, ro_hi, co_lo, co_hi, first, *off,
                      *shape, int(edge)))
        b = dst.data_ptr()
        slab = (Rp * Cp, Cp)
        src = [(b + halo * item, *slab), (b + (halo * Cp + halo) * item, *slab),
               (b + ((halo + R_loc) * Cp + halo) * item, *slab), (b, *slab),
               (b + (halo + C_loc) * item, *slab)]
    return out, geoms, slabs


def launch_sweeps_2d(kernel: _build.CudaKernel, f, top, bot, left, right, *, substeps: int,
                     params, i0: int = 0, i1: int = 0, rows_per_sweep: int = 1,
                     walls: bool = False, off: tuple[int, int] = (0, 0),
                     shape: tuple[int, int] = (0, 0), edge: bool = False) -> torch.Tensor:
    """``substeps`` launches of a rows x cols kernel (38) on the
    shard ``f`` with its four strips; returns the shard's new values in a
    fresh buffer (``f`` is never written).  Each sweep consumes
    ``rows_per_sweep`` lines of the strips in both axes; ``off`` is the
    shard's global (row, column) offset, ``shape`` the grid's (R, C),
    ``edge`` whether its rows reach a wall, ``walls`` clips the row bands to
    the grid's rows.  Raises on a tensor the kernel does not take and on a
    refused launch."""
    out, geoms, _slabs = _sweep_geoms(f, top, bot, left, right, substeps=substeps,
                                      rows_per_sweep=rows_per_sweep, walls=walls, off=off,
                                      shape=shape, edge=edge)
    with torch.cuda.device(f.device):
        stream = _build.stream_handle(f)
        for g in geoms:
            kernel.launch((ctypes.c_longlong * len(GEOM))(*g), params, i0, i1,
                          int(f.dtype == torch.float64), stream)
    return out


def launch_sweeps_2d_shards(kernel: _build.CudaKernel, shards, *, substeps: int, params,
                            rows_per_sweep: int, walls: bool, shape: tuple[int, int],
                            plain) -> list:
    """``substeps`` sweeps of kernel 36 on ``shards``, a list of (f, top, bot,
    left, right, off_r, off_c, edge), through kernels/sharded.py
    ``launch_planned_shards``: one launch a sweep over up to ``MAX_SHARDS``
    shards of one device and type, CPU shards through ``plain``.  A shard's
    sweeps are launch_sweeps_2d's, so the values are the same bits."""
    def plan(f, top, bot, left, right, off_r, off_c, edge):
        return _sweep_geoms(f, top, bot, left, right, substeps=substeps,
                            rows_per_sweep=rows_per_sweep, walls=walls, off=(off_r, off_c),
                            shape=shape, edge=edge)

    return launch_planned_shards(kernel, shards, plan, substeps=substeps, params=params,
                                 ints=(0,), plain=plain)


def _parts_geoms(f, parts, *, substeps: int, rows_per_sweep: int, planes: int = 9,
                 walls: bool = False, off: tuple[int, int] = (0, 0),
                 shape: tuple[int, int] = (0, 0), edge: bool = False):
    """(out, geoms, slabs) of ``substeps`` sweeps of kernel 35 or 37 on the
    shard ``f`` (``planes`` planes) with the 3 x 3 ``parts`` of its padded
    block (``ring_2d``'s, or ``strip_parts``' views of exchanged strips):
    ``out`` a fresh buffer for the shard's new values (``f`` is never
    written), in order each sweep's geometry (``PARTS_GEOM``'s values) and
    the scratch slabs they name, which the caller holds until the launches
    are issued.  The first sweep reads the parts in place, later ones a
    padded slab (two, alternating) as 3 x 3 views of it, the last writes
    ``out``; no line wraps, and ``walls`` clips the rows to the grid's rows
    (the shard's global offsets ``off``, the grid's ``shape`` (R, C), ``edge``
    whether its rows reach a wall).  Raises on a tensor the kernel does not
    take."""
    R_loc, C_loc, halo = _check_parts(f, parts, planes)
    _check_sweeps(substeps, halo // rows_per_sweep)
    item = f.element_size()
    Rp, Cp = R_loc + 2 * halo, C_loc + 2 * halo
    out = torch.empty_like(f)
    slabs = [torch.empty((planes, Rp, Cp), dtype=f.dtype, device=f.device)
             for _ in range(min(substeps - 1, 2))]
    src = [v for row in parts for h in row for v in (h.data_ptr(), h.stride(0), h.stride(1))]
    first = (0, halo, halo + R_loc), (0, halo, halo + C_loc)  # each part's first line
    geoms = []
    for j, ((ri_lo, ri_hi, ro_lo, ro_hi), (ci_lo, ci_hi, co_lo, co_hi)) in enumerate(
            sweep_bands_2d(R_loc, C_loc, halo, substeps, rows_per_sweep, off[0], shape[0],
                           walls), start=1):
        if j == substeps:
            dst, at, dplane, dld = out, halo, R_loc * C_loc, C_loc
        else:
            dst, at, dplane, dld = slabs[(j - 1) % 2], 0, Rp * Cp, Cp
        geoms.append((*src, dst.data_ptr(), dplane, dld, at, halo, R_loc, C_loc, ri_lo, ri_hi,
                      ci_lo, ci_hi, ro_lo, ro_hi, co_lo, co_hi, *off, *shape, int(edge)))
        src = [v for r in first[0] for c in first[1]
               for v in (dst.data_ptr() + (r * Cp + c) * item, Rp * Cp, Cp)]
    return out, geoms, slabs


def launch_parts_shards(kernel: _build.CudaKernel, shards, *, substeps: int, params, ints,
                        rows_per_sweep: int, plain, planes: int = 9, walls: bool = False,
                        shape: tuple[int, int] = (0, 0)) -> list:
    """``substeps`` sweeps of kernel 35 or 37 on ``shards``, a list of (f,
    parts, off_r, off_c, edge), ``parts`` the 3 x 3 parts of the shard's
    padded block, through kernels/sharded.py ``launch_planned_shards``: one
    launch a sweep over up to ``MAX_SHARDS`` shards of one device and type
    (``_parts_geoms``), CPU shards through ``plain``, which takes the same."""
    return launch_planned_shards(
        kernel, shards, lambda f, parts, off_r, off_c, edge: _parts_geoms(
            f, parts, substeps=substeps, rows_per_sweep=rows_per_sweep, planes=planes,
            walls=walls, off=(off_r, off_c), shape=shape, edge=edge),
        substeps=substeps, params=params, ints=ints, plain=plain)


def make_local_2d_step(R_loc: int, C_loc: int, collide_fn, dtype: torch.dtype = torch.float32,
                       substeps: int = 1):
    """The periodic collide-stream over one shard of an (nx, ny) mesh with
    explicit strips: ``(f_loc (9, R_loc, C_loc), top, bot (9, HALO, C_loc),
    left, right (9, R_loc + 2 HALO, HALO)) -> f_loc'``, ``substeps`` steps
    (lbm_tpu sharded2d_pallas.py:223, whose combined 128-lane tile is here
    the two strips).  Kernel 34 on a CUDA shard (one launch, the strips read
    as ``strip_parts``' views), the plain version on a CPU shard;
    ``fn.plain`` is the plain version on any device."""
    _check_sweeps(substeps, HALO)
    if R_loc < HALO or C_loc < HALO:
        raise ValueError(f"local shard {R_loc}x{C_loc} smaller than the {HALO}-line "
                         "exchange strips")
    launch = collide_launch(collide_fn, HALO2D_COLLIDE_STREAM, substeps)

    def plain(f, top, bot, left, right):
        return sweep_block(pad_block(f, top, bot, left, right), top.shape[-2], collide_fn,
                           substeps)

    def fn(f, top, bot, left, right):
        if tuple(f.shape) != (9, R_loc, C_loc) or f.dtype != dtype:
            raise ValueError(f"shard {tuple(f.shape)} {f.dtype}, step built for "
                             f"(9, {R_loc}, {C_loc}) {dtype}")
        if resolve_fused(f):
            _check_strips(f, top, bot, left, right, top.shape[-2])
        return launch([(f, strip_parts(f, top, bot, left, right), False)],
                      plain=lambda i: plain(f, top, bot, left, right))[0]

    fn.plain = plain
    return fn


def make_sharded_fused_step_2d(mesh: Mesh, R: int, C: int, collide_fn,
                               dtype: torch.dtype = torch.float32, substeps: int | str = 1):
    """Globally periodic collide-stream with any local collision, rows
    sharded over mesh axis 'x' and columns over 'y': ShardedState ->
    ShardedState, ``substeps`` steps per call (lbm_tpu
    sharded2d_pallas.py:290).  Kernel 34 on CUDA shards: a call's steps in
    one launch over up to MAX_SHARDS shards of a card, each padded block
    read from ``ring_2d``'s 3 x 3 parts (the neighbours' HALO lines in place
    where they share the card, copied only across cards); CPU shards run
    the plain version on the same parts; ``step.plain`` runs the plain
    version after ``exchange_2d`` on any device."""
    substeps = _check_sweeps(resolve_substeps(substeps, "bgk"), HALO)
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    if R % nx or C % ny:
        raise ValueError(f"grid {R}x{C} not divisible by mesh {nx}x{ny}")
    R_loc, C_loc = R // nx, C // ny
    local = make_local_2d_step(R_loc, C_loc, collide_fn, dtype, substeps)
    launch = collide_launch(collide_fn, HALO2D_COLLIDE_STREAM, substeps)

    def check(state: ShardedState):
        if state.mesh != mesh:
            raise ValueError("the state is sharded over another mesh than the step's")
        for f in state.shards:
            if tuple(f.shape) != (9, R_loc, C_loc) or f.dtype != dtype:
                raise ValueError(f"shard {tuple(f.shape)} {f.dtype}, step built for "
                                 f"(9, {R_loc}, {C_loc}) {dtype}")
        return [state.shards[i * ny:(i + 1) * ny] for i in range(nx)]

    def step(state: ShardedState) -> ShardedState:
        parts = ring_2d(check(state), HALO)
        return ShardedState(mesh, launch(
            [(f, p, False) for f, p in zip(state.shards, parts)],
            plain=lambda i: sweep_block(parts_block(parts[i]), HALO, collide_fn, substeps)))

    def plain(state: ShardedState) -> ShardedState:
        return ShardedState(mesh, [local.plain(f, *strips) for f, strips in
                                   zip(state.shards, exchange_2d(check(state), HALO))])

    step.plain = plain
    return step


# --- the body steps (kernels 35-38) ------------------------------------------------

def make_plain_2d_body_step(R: int, C: int, body, substeps: int):
    """``plain(f_loc, top, bot, left, right, off_r, off_c, edge) -> f_loc'``
    on any device: ``substeps`` sweeps of ``body(block, rows, cols)`` over
    the padded block (``sweep_block``; ``rows`` the block's global rows,
    ``cols`` its global columns wrapped into [0, C)).  ``plain.parts(f_loc,
    parts, off_r, off_c, edge)`` is the same on the block that ``ring_2d``'s
    3 x 3 parts tile."""

    def sweeps(block, halo, off_r, off_c):
        R_loc, C_loc = block.shape[-2] - 2 * halo, block.shape[-1] - 2 * halo
        rows = torch.arange(off_r - halo, off_r + R_loc + halo, device=block.device)
        cols = torch.arange(off_c - halo, off_c + C_loc + halo, device=block.device) % C
        return sweep_block(block, halo, substeps=substeps, body=body, rows=rows, cols=cols)

    def plain(f, top, bot, left, right, off_r, off_c, edge):
        return sweeps(pad_block(f, top, bot, left, right), top.shape[-2], off_r, off_c)

    def parts(f, parts, off_r, off_c, edge):
        return sweeps(parts_block(parts), parts[0][1].shape[-2], off_r, off_c)

    plain.parts = parts
    return plain


def make_local_2d_body_step(R: int, C: int, body, launch, substeps: int):
    """``local(f_loc, top, bot, left, right, off_r, off_c, edge) -> f_loc'``
    (lbm_tpu sharded2d_pallas.py:392 make_local_2d_body_step): on a CPU shard
    the plain version, on a CUDA shard ``launch`` (a rows x cols kernel's
    ``launch_sweeps_2d``), which launches or raises.
    ``local.plain`` is the plain version on any device
    (``make_plain_2d_body_step``)."""
    plain = make_plain_2d_body_step(R, C, body, substeps)

    def local(f, top, bot, left, right, off_r, off_c, edge):
        if resolve_fused(f):
            return launch(f, top, bot, left, right, off=(off_r, off_c), shape=(R, C),
                          edge=edge)
        return plain(f, top, bot, left, right, off_r, off_c, edge)

    local.plain = plain
    return local


def check_mesh_2d(mesh: Mesh, R: int, C: int, row_factory: str) -> tuple[int, int]:
    """lbm_tpu's semantic guards of a rows x cols body step, each a
    ValueError: ny >= 2 (``row_factory`` of kernels/sharded.py takes an (n,
    1) mesh), a grid divisible by the mesh, shards of at least HALO rows and
    columns, and no global column twice in a padded block (``C - C_loc >=
    2 HALO``).  Returns (R_loc, C_loc)."""
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    if ny < 2:
        raise ValueError(f"the rows x cols steps need ny >= 2, got mesh {mesh.shape}: use "
                         f"kernels/sharded.py {row_factory} for an (n, 1) mesh")
    if R % nx or C % ny:
        raise ValueError(f"grid {R}x{C} not divisible by mesh {nx}x{ny}")
    R_loc, C_loc = R // nx, C // ny
    if R_loc < HALO or C_loc < HALO:
        raise ValueError(f"local shard {R_loc}x{C_loc} smaller than the {HALO}-line "
                         "exchange strips")
    if C - C_loc < 2 * HALO:
        raise ValueError(f"C - C/ny = {C - C_loc} < {2 * HALO}: a padded block of "
                         f"{C_loc + 2 * HALO} columns would hold a global column twice")
    return R_loc, C_loc


def each_shard(local):
    """A body step's ``run`` that takes the shards one by one through
    ``local(f_loc, top, bot, left, right, off_r, off_c, edge)``."""
    return lambda shards: [local(*a) for a in shards]


def make_sharded2d_body_step(mesh: Mesh, planes: int, R: int, C: int, run, plain,
                             dtype: torch.dtype, row_factory: str, halos=exchange_2d):
    """Shard a local body step over rows ('x') and columns ('y') (lbm_tpu
    sharded2d_pallas.py:517 ``_sharded2d_wrap``): ShardedState of
    ``(planes, R / nx, C / ny)`` shards -> the same, one exchange of HALO
    rows and columns per call.  ``run`` gets every shard's (f_loc, *halos,
    off_r, off_c, edge), with its global offsets and ``edge`` on row ranks 0
    and nx-1 (the masked instance), and returns their new values:
    ``each_shard(local)`` takes them one by one, kernel 36's
    ``launch_sweeps_2d_shards`` and kernels 35 and 37's
    ``launch_parts_shards`` a launch a sweep over a card's shards.
    ``halos(grid, HALO)`` gives each block's halos in row-major order, a
    tuple each: ``exchange_2d``'s (top, bot, left, right) strips, or
    ``ring_parts``' (parts,).  ``step.plain`` runs ``plain`` (one shard's
    plain version, on any device) on each after ``exchange_2d``."""
    R_loc, C_loc = check_mesh_2d(mesh, R, C, row_factory)
    nx, ny = mesh.shape["x"], mesh.shape["y"]

    def build(run, halos):
        def step(state: ShardedState) -> ShardedState:
            if state.mesh != mesh:
                raise ValueError("the state is sharded over another mesh than the step's")
            for f in state.shards:
                if tuple(f.shape) != (planes, R_loc, C_loc) or f.dtype != dtype:
                    raise ValueError(f"shard {tuple(f.shape)} {f.dtype}, step built for "
                                     f"({planes}, {R_loc}, {C_loc}) {dtype}")
            grid = [state.shards[i * ny:(i + 1) * ny] for i in range(nx)]
            return ShardedState(mesh, run([
                (f, *h, b // ny * R_loc, b % ny * C_loc, b // ny in (0, nx - 1))
                for b, (f, h) in enumerate(zip(state.shards, halos(grid, HALO)))]))

        return step

    step = build(run, halos)
    step.plain = build(each_shard(plain), exchange_2d)
    return step


def ring_parts(grid, width: int):
    """The body steps' ``halos`` of kernels 35 and 37: each block's (parts,),
    ``ring_2d``'s 3 x 3 parts of its padded block."""
    return [(p,) for p in ring_2d(grid, width)]


def _body_launch(kernel, family: str, substeps: int, params, walls: bool, i0=0, i1=0):
    return functools.partial(launch_sweeps_2d, kernel, substeps=substeps, params=params,
                             i0=i0, i1=i1, rows_per_sweep=ROWS_PER_SWEEP[family], walls=walls)


def make_sharded2d_sc_step(mesh: Mesh, R: int, C: int, *, omega: float, G: float | None = None,
                           eos: str = "sc", T: float | None = None, forcing: str | None = None,
                           substeps: int | str = 1, dtype: torch.dtype = torch.float32):
    """The fully periodic Shan-Chen step (kernels/shan_chen.py) sharded over
    rows and columns: f (9, R, C) shards -> the same, ``substeps`` (at most
    4) steps per exchange, each sweep consuming 2 lines (lbm_tpu
    sharded2d_pallas.py:549).  Kernel 35 on CUDA shards: one launch a sweep
    over up to MAX_SHARDS shards of a card (``launch_parts_shards``), the
    first reading each padded block from ``ring_2d``'s 3 x 3 parts (the
    neighbours' lines in place where they share the card, copied only
    across cards); CPU shards run the plain version on the same parts;
    ``step.plain`` the plain version after ``exchange_2d`` on any device."""
    substeps = resolve_substeps_2d(substeps, "shan_chen")
    eos_i, forcing_i, params = shan_chen.kernel_params(omega, G, eos, T, forcing)
    sc = shan_chen.make_plain_step(omega, G, eos, T, forcing)
    plain = make_plain_2d_body_step(R, C, lambda S, rows, cols: sc(S), substeps)
    run = functools.partial(launch_parts_shards, HALO2D_SHAN_CHEN, substeps=substeps,
                            params=_build.c_doubles(params), ints=(eos_i, forcing_i),
                            rows_per_sweep=ROWS_PER_SWEEP["shan_chen"], plain=plain.parts)
    return make_sharded2d_body_step(mesh, 9, R, C, run, plain, dtype, "make_sharded_sc_step",
                                    halos=ring_parts)


def make_sharded2d_thermal_step(mesh: Mesh, R: int, C: int, *, omega_f: float,
                                omega_g: float, g_beta: float, substeps: int | str = 1,
                                dtype: torch.dtype = torch.float32):
    """The Rayleigh-Benard step (kernels/thermal.py, D2Q9 temperature)
    sharded over rows and columns: S (18, R, C) shards -> the same, walls at
    global rows 0 and R-1, columns periodic, ``substeps`` steps per exchange
    (lbm_tpu sharded2d_pallas.py:578).  Kernel 36 on CUDA shards."""
    substeps = resolve_substeps_2d(substeps, "thermal")
    body = thermal_body(omega_f, omega_g, g_beta)
    plain = make_plain_2d_body_step(R, C, lambda S, rows, cols: body(S, rows, R), substeps)
    run = functools.partial(
        launch_sweeps_2d_shards, HALO2D_THERMAL, substeps=substeps,
        params=thermal.thermal_constants(omega_f, omega_g, g_beta, dtype),
        rows_per_sweep=ROWS_PER_SWEEP["thermal"], walls=True, shape=(R, C), plain=plain)
    return make_sharded2d_body_step(mesh, 18, R, C, run, plain, dtype,
                                    "make_sharded_thermal_step")


def make_sharded2d_rk_step(mesh: Mesh, R: int, C: int, *, r_alpha: float, b_alpha: float,
                           r_nu: float, b_nu: float, sigma: float, beta: float = 0.7,
                           gravity=(0.0, 0.0), dtype: torch.dtype = torch.float32):
    """The RK mixture step sharded over rows and columns: S (11, R, C) =
    [f (9), r_rho, b_rho] shards -> the same, one exchange per step (lbm_tpu
    sharded2d_pallas.py:432).  Kernel 37 on CUDA shards: one launch a call
    over up to MAX_SHARDS shards of a card (``launch_parts_shards``), each
    padded block read from ``ring_2d``'s 3 x 3 parts (the neighbours' lines
    in place where they share the card, copied only across cards), edge and
    interior shards in one launch; CPU shards run the plain version on the
    same parts; ``step.plain`` the plain version after ``exchange_2d`` on any
    device."""
    kw = dict(r_alpha=r_alpha, b_alpha=b_alpha, r_nu=r_nu, b_nu=b_nu, sigma=sigma, beta=beta,
              gravity=gravity)
    rk_plain = rk.make_plain_step(**kw)
    plain = make_plain_2d_body_step(R, C, lambda S, rows, cols: rk_plain(S, rows, R, cols, C),
                                    CAP_2D["rk"])
    run = functools.partial(launch_parts_shards, HALO2D_RK, substeps=CAP_2D["rk"],
                            params=_build.c_doubles(rk.kernel_params(**kw)), ints=(0, 0),
                            rows_per_sweep=ROWS_PER_SWEEP["rk"], plain=plain.parts,
                            planes=rk.PLANES, walls=True, shape=(R, C))
    return make_sharded2d_body_step(mesh, rk.PLANES, R, C, run, plain, dtype,
                                    "make_sharded_rk_step", halos=ring_parts)


def make_sharded2d_mrtcg_step(mesh: Mesh, R: int, C: int, red, blue, sigma: float,
                              gravity=(0.0, 0.0), delta: float = 0.1,
                              apply_gravity_source: bool = True,
                              dtype: torch.dtype = torch.float32, substeps: int | str = 1,
                              surface_tension: str = "perturbation"):
    """The full per-colour MRT colour-gradient step sharded over rows and
    columns (lbm_tpu sharded2d_pallas.py:455).  Perturbation mode: F (2, 9,
    R, C) sharded as ``shard_state(mesh, F.reshape(18, R, C))`` -> shards of
    (2, 9, R/nx, C/ny), which gather to F (the step also takes those shards
    back); CSF mode: shards of S (20, R, C) = [red f, blue f, fst carry] ->
    the same.  ``substeps`` steps per exchange, at most 2 (CSF 1).  Kernel 38
    on CUDA shards."""
    csf = surface_tension == "csf"
    family = "csf" if csf else "mrtcg"
    substeps = resolve_substeps_2d(substeps, family)
    plain = mrtcg.make_plain_step(red, blue, sigma, gravity, delta, apply_gravity_source,
                                  surface_tension, reduced_in=False, reduced_out=False)
    params = _build.c_doubles(mrtcg.kernel_params(red, blue, sigma, gravity, delta,
                                                  apply_gravity_source))
    launch = _body_launch(HALO2D_MRTCG_FULL, family, substeps, params, True, int(csf))
    local = make_local_2d_body_step(R, C, lambda S, rows, cols: plain(S, rows, R, cols, C),
                                    launch, substeps)
    step = make_sharded2d_body_step(mesh, mrtcg.full_planes(surface_tension), R, C,
                                    each_shard(local), local.plain, dtype,
                                    "make_sharded_mrtcg_step")
    return step if csf else _per_colour(step)
