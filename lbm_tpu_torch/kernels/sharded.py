"""Row-sharded steps with halo inputs: the plain versions and CUDA kernels
27-33 (counterpart of lbm_tpu/kernels/sharded_pallas.py).

A row-sharded step splits the grid's rows over an (n, 1) mesh
(parallel/mesh.py).  Each call exchanges halos once (parallel/halo.py
``exchange_rows``: each shard gets a ``(planes, halo, C)`` copy of its ring
neighbours' edge rows, on its own device) and then runs ``substeps`` sweeps
of the family's step on every shard, with the global row offset of the
shard, so the walls and the replicate padding of the stencils sit at the
grid's global rows 0 and R-1.  Ranks 0 and n-1 run the masked (edge)
instance and interior ranks the mask-free one (sharded_pallas.py:379-397).

Sweeps per exchange: each sweep consumes ``rows_per_sweep`` rows of the
strip (1 for the collide-stream and thermal families: the push; 3 for the
MRT-CG and RK bodies: the 5x5 gradient's 2 and the push's 1; 5 in CSF
mode: the chained curvature stencils; 2 for Shan-Chen: psi's 1-cell
stencil and the push; 1 for the D3Q19 step), so ``halo =
halo_for(substeps, rows_per_sweep)`` rows buy ``substeps`` steps per
exchange.

Local steps, one per family, ``local(f_loc, top, bot, off, edge)``:
  * on a CPU shard, the plain version: the shard and its halos
    concatenated into a padded slab of ``R_loc + 2 halo`` rows, ``substeps``
    sweeps of the family's plain step over the slab with the slab's global
    row indices, the shard's rows kept.  It equals the single-device plain
    step bit for bit (the tests hold it so);
  * on a CUDA shard, the family's halo-input kernel, one launch per sweep
    (``launch_sweeps``): the first sweep reads the three buffers (rows
    -halo..-1 and R_loc..R_loc+halo-1 from the halos, no concatenation),
    later sweeps a padded scratch slab, and the last one writes the shard's
    rows only.  Sweep j of s computes the band of rows that the remaining
    s - j sweeps still need, ``rows_per_sweep * (s - j)`` beyond the shard on
    each side, clipped to the grid for the wall families.  Kernels 30, 32
    and 33 run one launch a sweep over up to ``MAX_SHARDS`` shards of a card
    instead (``launch_sweeps_shards``), and their first sweep reads a
    neighbour's edge rows in place where the neighbour shares the card
    (parallel/halo.py ``ring_rows``): no exchange copy on one card.
    Kernel 27 runs a call's s steps on up to ``MAX_SHARDS`` shards of a card
    in one launch (``launch_collide_shards``, csrc/collide_stream.cuh's
    sharded call), reading its neighbours' rows in place the same way.

Kernels (one C entry point per family instance, in the family's source,
built with that source's flags so the collision is the same device code as
the single-device kernel's):
  * kernel 27, ``HALO_COLLIDE_STREAM``: the periodic collide-stream family,
    lbm_tpu's ``make_local_halo_step`` / ``make_sharded_fused_step``
    (sharded_pallas.py:171, :528), one instance per local collision: BGK
    (csrc/collide_stream_bgk.cu, kernel 1's), KBC (kernel 3's), LES (5),
    TRT (10) and the power law (11), each a call of s steps in one launch
    over a card's shards (the tile engine of csrc/collide_stream.cuh: s
    steps in shared memory, one pass over device memory; one step: a
    thread a cell).  The collide function names its instance through its
    ``halo_kernel`` attribute (bgk.bgk_collide_fn and the other
    ``*_collide_fn``); a function without one raises on a CUDA shard;
  * kernel 28, ``HALO_THERMAL``: the Rayleigh-Benard step with a D2Q9
    temperature (:503 make_sharded_thermal_step; csrc/thermal.cu, kernel
    23's);
  * kernel 29, ``HALO_MRTCG``: the reduced MRT-CG state, both modes (:453
    make_sharded_mrtcg_reduced_step; csrc/mrtcg_reduced.cu on kernel 6's
    engines, csrc/mrtcg.cuh);
  * kernel 30, ``HALO_RK``: the RK mixture, one sweep per exchange (:486
    make_sharded_rk_step; csrc/rk_cg.cu, kernel 12's), one launch a call
    over a card's shards;
  * kernel 31, ``HALO_MRTCG_FULL``: the full per-colour MRT-CG state, both
    modes (:406 make_sharded_mrtcg_step; csrc/mrtcg_full.cu on kernel 8's
    engines);
  * kernel 32, ``HALO_SHAN_CHEN``: the Shan-Chen body, fully periodic, in
    its four eos x forcing instances (shan_chen_pallas.py:138 make_sc_body
    on :345 make_sharded_body_step; csrc/shan_chen.cu, kernel 14's), one
    launch a sweep over a card's shards;
  * kernel 33, ``HALO_D3Q19``: the D3Q19 step with the y axis sharded, the
    planes state (19, X, Y, Z) being (19 X, Y, Z) in memory
    (d3q19_pallas.py:173 make_d3q19_body on :345; csrc/d3q19.cu, kernel
    25's), one launch a sweep over a card's shards.

The rows x cols steps (kernels 34-38) are kernels/sharded2d.py.

Bound: device-memory bytes, those of the family's single-device kernel per
sweep over the band it computes, plus the halo reads of each exchange
(chip_smoke.py counts them); the exchange itself is 2 n copies of
``planes * halo * C`` values (kernels 27, 30, 32 and 33: none between shards of
one card; 27 reads and writes its shards once a call).

``substeps="auto"`` resolves to the deepest cadence the family's strip
admits (``AUTO_SUBSTEPS``).  lbm_tpu picks it from TPU v5e cadence tables
and ICI constants (sharded_pallas.py:47-131), which say nothing about this
card; at every ICI cost its picker returns the deepest measured cadence for
BGK, the value taken here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..boundary import bc
from ..core import lattice as lat
from ..ops import d2q9
from ..parallel.halo import exchange_rows, ring_rows
from ..parallel.mesh import Mesh, ShardedState
from ..utils.xmath import resolve_fused
from . import _build, d3q19, mrtcg, rk, shan_chen, thermal
from ._build import shard_batches

HALO = 8
COLLIDE_KINDS = ("bgk", "kbc", "les", "trt", "power_law")
#: halo rows one sweep consumes (the push, plus the stencils' reach)
ROWS_PER_SWEEP = {**{kind: 1 for kind in COLLIDE_KINDS}, "thermal": 1,
                  "mrtcg": mrtcg.rows_per_sweep("perturbation"),
                  "csf": mrtcg.rows_per_sweep("csf"), "rk": 3, "shan_chen": 2, "d3q19": 1}
#: ``substeps="auto"``: the deepest cadence of each family's strip (8 rows
#: for the 1-row families, 4 sweeps of Shan-Chen's 2 rows; lbm_tpu's
#: deepest measured MRT-CG cadence, 5 on a 16-row strip, and CSF's, 4 on a
#: 24-row one); the RK step takes 1 sweep per exchange
AUTO_SUBSTEPS = {**{kind: 8 for kind in COLLIDE_KINDS}, "thermal": 8, "mrtcg": 5,
                 "csf": 4, "rk": 1, "shan_chen": 4, "d3q19": 8}

# the geometry array of a halo kernel launch (csrc/halo.cuh ``Geom``)
GEOM = ("top", "mid", "bot", "out", "top_plane", "mid_plane", "bot_plane", "out_plane",
        "halo", "r_loc", "cols", "in_lo", "in_hi", "out_lo", "out_hi", "out_first", "off",
        "rows", "edge")
_FAR = 1 << 62
_ARGS = [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_double), ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# the geometry array of one shard of kernels 27 and 34 (csrc/collide_stream.cuh
# ``block::Geom``): 3 x 3 parts row-major, each (base, plane stride, row
# stride), then the output's, the parts' halo, the shard's rows and columns
# and whether its columns wrap
BLOCK_GEOM = (*(f"in{a}{b}_{x}" for a in range(3) for b in range(3)
                for x in ("base", "plane", "ld")),
              "out", "out_plane", "out_ld", "halo", "rows", "cols", "wrap")
# (geoms, params, n_shards, steps, i0, i1, is_f64, stream)
BLOCK_ARGS = [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_double), ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
HALO_COLLIDE_STREAM = {kind: _build.CudaKernel(f"lbm_halo_{kind}", BLOCK_ARGS)
                       for kind in COLLIDE_KINDS}                           # kernel 27
HALO_THERMAL = _build.CudaKernel("lbm_halo_thermal", _ARGS)                 # kernel 28
HALO_MRTCG = _build.CudaKernel("lbm_halo_mrtcg_reduced", _ARGS)             # kernel 29
HALO_MRTCG_FULL = _build.CudaKernel("lbm_halo_mrtcg_full", _ARGS)           # kernel 31
# (geoms, params, n_shards, i0, i1, is_f64, stream): one sweep over a card's shards
SHARDS_ARGS = [*_ARGS[:2], ctypes.c_int, *_ARGS[2:]]
HALO_RK = _build.CudaKernel("lbm_halo_rk", SHARDS_ARGS)                     # kernel 30
HALO_SHAN_CHEN = _build.CudaKernel("lbm_halo_shan_chen", SHARDS_ARGS)       # kernel 32
HALO_D3Q19 = _build.CudaKernel("lbm_halo_d3q19", SHARDS_ARGS)               # kernel 33


def halo_for(substeps: int, rows_per_sweep: int) -> int:
    """Smallest 8-aligned strip admitting ``substeps`` sweeps that each
    consume ``rows_per_sweep`` rows (lbm_tpu's ``halo_for`` and
    ``_halo_rows``)."""
    return max(HALO, -(-substeps * rows_per_sweep // 8) * 8)


def default_substeps(family: str) -> int:
    """The cadence ``"auto"`` stands for: ``AUTO_SUBSTEPS[family]``."""
    if family not in AUTO_SUBSTEPS:
        raise ValueError(f"unknown family {family!r}; one of {sorted(AUTO_SUBSTEPS)}")
    return AUTO_SUBSTEPS[family]


def resolve_substeps(substeps, family: str) -> int:
    """Ints pass through untouched; ``"auto"`` resolves to
    ``default_substeps(family)``."""
    if isinstance(substeps, str):
        if substeps != "auto":
            raise ValueError(f"substeps must be an int or 'auto', got {substeps!r}")
        return default_substeps(family)
    return substeps


def _check_sweeps(substeps, most: int | None) -> int:
    """``substeps`` as an int in [1, most] (no upper limit for None)."""
    if not isinstance(substeps, int) or isinstance(substeps, bool) or substeps < 1 or \
            (most is not None and substeps > most):
        raise ValueError(f"substeps must be an int in [1, {most or 'inf'}], got {substeps!r}")
    return substeps


# --- the plain versions ------------------------------------------------------------

def plain_sweeps(body, f, top, bot, off: int, R: int, substeps: int) -> torch.Tensor:
    """``substeps`` sweeps of ``body(slab, rows, R)`` over the shard ``f``
    padded with its halos, ``rows`` the slab's global row indices (the MRT-CG
    and RK ``make_plain_step`` steps take these arguments); returns the
    shard's rows."""
    halo, R_loc = top.shape[1], f.shape[1]
    slab = torch.cat([top, f, bot], dim=1)
    rows = torch.arange(off - halo, off + R_loc + halo, device=f.device)
    for _ in range(substeps):
        slab = body(slab, rows, R)
    return slab[:, halo:halo + R_loc].contiguous()


def collide_stream_body(collide_fn):
    """The periodic collide-stream sweep: stream(collide_fn(slab))."""
    return lambda S, rows, R: d2q9.stream(collide_fn(S))


def thermal_body(omega_f: float, omega_g: float, g_beta: float):
    """The Rayleigh-Benard sweep (kernels/thermal.py ``plain_rb_step``, D2Q9
    temperature) on a block of global rows ``rows``: the walls act where the
    global row is 0 or R-1, as position masks."""

    def body(S, rows, R):
        f_coll, g_coll = thermal._collide(S, omega_f, omega_g, g_beta)
        f_new, g_new = list(d2q9.stream(f_coll)), list(d2q9.stream(g_coll))
        g_eq_hot = thermal._wall_eq(S, S.shape[2])
        for side, row, g_wall in (("row0", 0, g_eq_hot), ("rowN", R - 1, -g_eq_hot)):
            m = (rows == row)[:, None]
            for k in bc.SIDE_OUT[side]:
                o = lat.OPPQ[k]
                f_new[o] = torch.where(m, f_coll[k], f_new[o])
                g_new[o] = torch.where(m, -g_coll[k] + 2.0 * g_wall[k], g_new[o])
        return torch.stack(f_new + g_new)

    return body


def d3q19_body(X: int, **kw):
    """The D3Q19 sweep (kernels/d3q19.py ``plain_d3q19_rows``) on a block of
    global y rows ``rows`` of the (19 X, rows, Z) state."""

    def body(S, rows, Y):
        f = S.reshape(d3q19.Q, X, *S.shape[1:])
        return d3q19.plain_d3q19_rows(f, rows, Y, **kw).reshape(S.shape)

    return body


# --- the kernels -------------------------------------------------------------------

def _check_halo_inputs(f, top, bot, planes: int, halo: int):
    """The shard's (R_loc, C); raises unless ``top`` and ``bot`` are
    ``(planes, halo, C)`` tensors of ``f``'s type and device with rows of C
    contiguous values: copies, or views of a neighbour's rows (``ring_rows``;
    any plane stride)."""
    R_loc, C = _build.check_state(f, planes)
    for name, h in (("top", top), ("bot", bot)):
        if tuple(h.shape) != (planes, halo, C) or h.dtype != f.dtype or \
                h.device != f.device or h.stride()[1:] != (C, 1):
            raise ValueError(f"halo {name} must be a ({planes}, {halo}, {C}) {f.dtype} tensor "
                             f"on {f.device} with rows of {C} contiguous values, got "
                             f"{tuple(h.shape)} {h.dtype} on {h.device}, strides {h.stride()}")
    return R_loc, C


def sweep_bands(R_loc: int, halo: int, off: int, R: int, substeps: int,
                rows_per_sweep: int, walls: bool) -> list[tuple[int, int, int, int]]:
    """(in_lo, in_hi, out_lo, out_hi) of each sweep of one exchange, in padded
    rows of the shard (padded row p is global row ``off - halo + p``): sweep
    j of s writes the shard's rows and ``rows_per_sweep * (s - j)`` more on
    each side, reading ``rows_per_sweep`` beyond them; ``walls`` clips both
    to the grid's rows [0, R)."""
    r = rows_per_sweep
    lo_wall, hi_wall = (halo - off, halo - off + R) if walls else (-_FAR, _FAR)
    bands = []
    for j in range(1, substeps + 1):
        m = r * (substeps - j)
        o_lo, o_hi = max(halo - m, lo_wall), min(halo + R_loc + m, hi_wall)
        bands.append((max(o_lo - r, lo_wall), min(o_hi + r, hi_wall), o_lo, o_hi))
    return bands


def _sweep_geoms(f, top, bot, off: int, edge: bool, R: int, *, substeps: int,
                 rows_per_sweep: int, walls: bool):
    """(out, geoms, slabs) of ``substeps`` sweeps of a halo-input kernel on
    the shard ``f`` with its halos ``top`` and ``bot``: ``out`` a fresh
    buffer for the shard's new rows (``f`` is never written), in order each
    sweep's geometry (``GEOM``'s values) and the scratch slabs they name,
    which the caller holds until the launches are issued.  The first sweep
    reads the three buffers in place (each halo at its own plane stride: a
    copy's ``halo * C``, a neighbour's view ``R_loc * C``), later ones a
    padded slab (two, alternating), the last writes ``out``.  Padded row p
    of the shard is global row ``off - halo + p``; ``walls`` clips every
    band to the grid's rows [0, R).  Raises on a tensor the kernels do not
    take."""
    planes, halo = f.shape[0], top.shape[1]
    R_loc, C = _check_halo_inputs(f, top, bot, planes, halo)
    _check_sweeps(substeps, halo // rows_per_sweep)
    item = f.element_size()
    pad = R_loc + 2 * halo
    out = torch.empty_like(f)
    slabs = [torch.empty((planes, pad, C), dtype=f.dtype, device=f.device)
             for _ in range(min(substeps - 1, 2))]
    src = (top.data_ptr(), f.data_ptr(), bot.data_ptr(), top.stride(0), R_loc * C,
           bot.stride(0))
    geoms = []
    for j, (i_lo, i_hi, o_lo, o_hi) in enumerate(
            sweep_bands(R_loc, halo, off, R, substeps, rows_per_sweep, walls), start=1):
        if j == substeps:
            dst, first, dplane = out, halo, R_loc * C
        else:
            dst, first, dplane = slabs[(j - 1) % 2], 0, pad * C
        geoms.append((*src[:3], dst.data_ptr(), *src[3:], dplane, halo, R_loc, C, i_lo, i_hi,
                      o_lo, o_hi, first, off, R, int(edge)))
        base = dst.data_ptr()
        src = (base, base + halo * C * item, base + (halo + R_loc) * C * item,
               pad * C, pad * C, pad * C)
    return out, geoms, slabs


def launch_sweeps(kernel: _build.CudaKernel, f, top, bot, off: int, edge: bool, R: int, *,
                  substeps: int, rows_per_sweep: int, walls: bool, params, i0: int = 0,
                  i1: int = 0) -> torch.Tensor:
    """``substeps`` launches of a halo-input kernel (28, 29, 31) on the shard
    ``f`` with its halos ``top`` and ``bot`` (``(planes, halo, C)`` each;
    ``_sweep_geoms``); returns the shard's new rows in a fresh buffer (``f``
    is never written).  Raises on a tensor the kernel does not take and on
    a refused launch."""
    out, geoms, _slabs = _sweep_geoms(f, top, bot, off, edge, R, substeps=substeps,
                                      rows_per_sweep=rows_per_sweep, walls=walls)
    with torch.cuda.device(f.device):
        stream = _build.stream_handle(f)
        for g in geoms:
            kernel.launch((ctypes.c_longlong * len(GEOM))(*g), params, i0, i1,
                          int(f.dtype == torch.float64), stream)
    return out


def launch_planned_shards(kernel: _build.CudaKernel, shards, plan, *, substeps: int, params,
                          ints=(), plain) -> list:
    """``substeps`` sweeps of a batched halo-input kernel (30, 32, 33, 35, 36) on
    ``shards``, a list of argument tuples whose first entry is the shard: a
    CPU shard's through ``plain`` (which takes the same tuple), the others'
    one launch a sweep over up to ``MAX_SHARDS`` shards of one device and
    type (blockIdx.y or z the shard, ``shard_batches``), ``kernel.launch(
    geoms, params, n_shards, *ints, is_f64, stream)``, which launches or
    raises.  ``plan(*shard)`` gives a shard's (out, geometry of each sweep,
    scratch slabs), as ``_sweep_geoms`` does; the slabs and the inputs stay
    referenced until the launches are issued.  Returns each shard's new
    values in a fresh buffer."""
    out = [None] * len(shards)
    plans, batches = {}, []
    for batch in shard_batches([(s[0].device, s[0].dtype) for s in shards]):
        if not resolve_fused(shards[batch[0]][0]):
            for i in batch:
                out[i] = plain(*shards[i])
            continue
        batches.append(batch)
        for i in batch:
            plans[i] = plan(*shards[i])
            out[i] = plans[i][0]
    for j in range(substeps):
        for batch in batches:
            f = shards[batch[0]][0]
            with torch.cuda.device(f.device):
                values = [v for i in batch for v in plans[i][1][j]]
                kernel.launch((ctypes.c_longlong * len(values))(*values), params, len(batch),
                              *ints, int(f.dtype == torch.float64), _build.stream_handle(f))
    return out


def launch_sweeps_shards(kernel: _build.CudaKernel, shards, *, substeps: int,
                         rows_per_sweep: int, walls: bool, R: int, params, ints=(),
                         plain) -> list:
    """``substeps`` sweeps of a batched row-shard kernel (30, 32, 33) on
    ``shards``, a list of (f, top, bot, off, edge), through
    ``launch_planned_shards``: one launch a sweep over a card's shards, CPU
    shards through ``plain``.  A shard's sweeps are ``launch_sweeps``'
    bands (``_sweep_geoms``), so the values are the same bits."""
    return launch_planned_shards(
        kernel, shards, lambda f, top, bot, off, edge: _sweep_geoms(
            f, top, bot, off, edge, R, substeps=substeps, rows_per_sweep=rows_per_sweep,
            walls=walls),
        substeps=substeps, params=params, ints=ints, plain=plain)


def make_local_halo_body_step(R: int, body, launch, substeps: int):
    """``local(f_loc, top, bot, off, edge) -> f_loc'``: on a CPU shard
    ``plain_sweeps`` of ``body``, on a CUDA shard ``launch(f_loc, top, bot,
    off, edge)`` (a halo-input kernel's ``launch_sweeps``), which launches or
    raises (lbm_tpu sharded_pallas.py:303).  ``local.plain`` is the plain
    version on any device."""

    def plain(f, top, bot, off, edge):
        return plain_sweeps(body, f, top, bot, off, R, substeps)

    def local(f, top, bot, off, edge):
        if resolve_fused(f):
            return launch(f, top, bot, off, edge)
        return plain(f, top, bot, off, edge)

    local.plain = plain
    return local


def make_sharded_body_step(mesh: Mesh, planes: int, R: int, C: int, local,
                           dtype: torch.dtype, halo: int = HALO, batched=None):
    """Row-shard a local halo-input step over mesh axis 'x' (lbm_tpu
    sharded_pallas.py:345): ShardedState of ``(planes, R / n, C)`` shards ->
    the same, one exchange of ``halo`` rows per call.  ``local(f_loc, top,
    bot, off, edge)`` gets the shard's global row offset ``off`` and
    ``edge`` on ranks 0 and n-1 (the masked instance; interior ranks run the
    mask-free one).  ``batched``, where given, takes every shard's (f_loc,
    top, bot, off, edge) at once instead and returns their new rows (kernel
    33's ``launch_sweeps_shards``, 27's ``launch_collide_shards``), with
    ``top`` and ``bot`` from ``ring_rows``: a neighbour's rows in place where
    it shares the shard's device, copied only across devices; ``local`` is
    then the plain per-shard step.  ``step.plain`` runs the plain version on any device
    after ``exchange_rows``: ``local`` beside ``batched``, else
    ``local.plain``, where the local step has one."""
    nx = mesh.shape["x"]
    if mesh.shape["y"] != 1:
        raise ValueError(f"the row-sharded steps take an (n, 1) mesh, got {mesh.shape}: "
                         "the rows x cols steps are kernels/sharded2d.py's "
                         "make_sharded_fused_step_2d, make_sharded2d_mrtcg_step, "
                         "make_sharded2d_rk_step, make_sharded2d_sc_step and "
                         "make_sharded2d_thermal_step")
    if R % nx:
        raise ValueError(f"rows {R} not divisible by mesh x={nx}")
    R_loc = R // nx
    if R_loc < halo:
        raise ValueError(f"local shard rows {R_loc} shallower than the {halo}-row "
                         "exchange strip")

    def build(run, halos):
        def step(state: ShardedState) -> ShardedState:
            if state.mesh != mesh:
                raise ValueError("the state is sharded over another mesh than the step's")
            for f in state.shards:
                if tuple(f.shape) != (planes, R_loc, C) or f.dtype != dtype:
                    raise ValueError(f"shard {tuple(f.shape)} {f.dtype}, step built for "
                                     f"({planes}, {R_loc}, {C}) {dtype}")
            return ShardedState(mesh, run([
                (f, top, bot, i * R_loc, i in (0, nx - 1))
                for i, (f, (top, bot)) in enumerate(zip(state.shards,
                                                        halos(state.shards, halo)))]))

        return step

    def each(fn):
        return lambda shards: [fn(*shard) for shard in shards]

    if batched is not None:
        step = build(batched, ring_rows)
        step.plain = build(each(local), exchange_rows)
        return step
    step = build(each(local), exchange_rows)
    if getattr(local, "plain", None) is not None:
        step.plain = build(each(local.plain), exchange_rows)
    return step


def row_parts(f, top, bot):
    """A row shard's 3 x 3 parts (csrc/collide_stream.cuh ``block::Shard``):
    its halos above and below it in the middle column; the columns wrap."""
    return [[None, top, None], [None, f, None], [None, bot, None]]


PART_NAMES = (("top left", "top", "top right"), ("left", "shard", "right"),
              ("bottom left", "bot", "bottom right"))


def _check_parts(f, parts, planes: int = 9) -> tuple[int, int, int]:
    """The shard's (R_loc, C_loc, halo); raises unless ``f`` is a kernel state
    of ``planes`` planes (``check_state``) and each part (None: one a row
    shard does not have) a tensor of ``f``'s type and device, of the rows
    (halo, R_loc, halo) by part row and the columns (halo, C_loc, halo) by
    part column, with unit column stride (a copy, or a view of a neighbour's
    lines)."""
    R_loc, C_loc = _build.check_state(f, planes)
    halo = parts[0][1].shape[-2]
    rows, cols = (halo, R_loc, halo), (halo, C_loc, halo)
    for a in range(3):
        for b in range(3):
            h = parts[a][b]
            shape = (planes, rows[a], cols[b])
            if h is not None and (tuple(h.shape) != shape or h.dtype != f.dtype or
                                  h.device != f.device or (h.stride(2) != 1 and shape[2] > 1)):
                raise ValueError(f"halo {PART_NAMES[a][b]} must be a {shape} {f.dtype} tensor "
                                 f"on {f.device} with unit column stride, got "
                                 f"{tuple(h.shape)} {h.dtype} on {h.device}, strides "
                                 f"{h.stride()}")
    return R_loc, C_loc, halo


def block_geom(f, parts, out, wrap: bool) -> tuple:
    """``BLOCK_GEOM``'s values of one shard ``f`` with its 3 x 3 ``parts``
    (``row_parts`` where ``wrap``; a missing part takes the middle one of its
    row) and its output buffer ``out``."""
    R_loc, C_loc, halo = _check_parts(f, parts)
    geom = []
    for row in parts:
        for h in row:
            h = row[1] if h is None else h
            geom += [h.data_ptr(), h.stride(0), h.stride(1)]
    return (*geom, out.data_ptr(), out.stride(0), out.stride(1), halo, R_loc, C_loc, int(wrap))


def launch_collide_shards(kernel, items, *, substeps: int, params, i0: int = 0, i1: int = 0,
                          plain) -> list:
    """A call of ``substeps`` steps of kernel 27 or 34 on ``items``, each
    shard's (f, parts, wrap): a CPU shard's through ``plain(i)``, the others'
    in one launch over up to ``MAX_SHARDS`` shards of one device and type
    (``shard_batches``; blockIdx.y the shard), ``kernel.launch(geoms,
    params, n_shards, substeps, i0, i1, is_f64, stream)``, which launches or
    raises.  ``kernel`` None (a collide function that names no instance)
    raises on a shard off the CPU.  Returns each shard's new values in a
    fresh buffer (``f`` is never written); the parts stay referenced until
    the launches are issued."""
    out = [None] * len(items)
    for batch in shard_batches([(f.device, f.dtype) for f, *_ in items]):
        f0 = items[batch[0]][0]
        if not resolve_fused(f0):
            for i in batch:
                out[i] = plain(i)
            continue
        if kernel is None:
            raise ValueError(
                "this collide function names no halo-input kernel (no ``halo_kernel`` "
                f"attribute of kind {COLLIDE_KINDS}): a CUDA shard has no kernel to run")
        geoms = []
        for i in batch:
            f, parts, wrap = items[i]
            out[i] = torch.empty_like(f)
            geoms += block_geom(f, parts, out[i], wrap)
        with torch.cuda.device(f0.device):
            kernel.launch((ctypes.c_longlong * len(geoms))(*geoms), params, len(batch),
                          substeps, i0, i1, int(f0.dtype == torch.float64),
                          _build.stream_handle(f0))
    return out


def collide_launch(collide_fn, kernels: dict, substeps: int):
    """``launch_collide_shards`` bound to ``collide_fn``'s instance (its
    ``halo_kernel`` attribute) among ``kernels`` (kernel 27's or 34's, by
    kind), its parameters and ``substeps``; to no kernel where the function
    names none (a CUDA shard then raises)."""
    tag = getattr(collide_fn, "halo_kernel", None)
    if tag is None or tag[0] not in kernels:
        return functools.partial(launch_collide_shards, None, substeps=substeps, params=None)
    kind, doubles, (i0, i1) = tag
    return functools.partial(launch_collide_shards, kernels[kind], substeps=substeps,
                             params=_build.c_doubles(doubles), i0=i0, i1=i1)


def make_local_halo_step(R_loc: int, C: int, collide_fn, dtype: torch.dtype = torch.float32,
                         substeps: int = 1):
    """The periodic collide-stream sweep over one shard with explicit
    ``(9, HALO, C)`` halos: ``(f_loc, halo_top, halo_bot) -> f_loc'``,
    ``substeps`` steps (lbm_tpu sharded_pallas.py:171).  Kernel 27 on a
    CUDA shard (one launch), the plain version on a CPU shard."""
    _check_sweeps(substeps, HALO)
    body = collide_stream_body(collide_fn)
    launch = collide_launch(collide_fn, HALO_COLLIDE_STREAM, substeps)

    def fn(f_loc, halo_top, halo_bot):
        if tuple(f_loc.shape) != (9, R_loc, C) or f_loc.dtype != dtype:
            raise ValueError(f"shard {tuple(f_loc.shape)} {f_loc.dtype}, step built for "
                             f"(9, {R_loc}, {C}) {dtype}")
        return launch([(f_loc, row_parts(f_loc, halo_top, halo_bot), True)],
                      plain=lambda i: plain_sweeps(body, f_loc, halo_top, halo_bot, 0, R_loc,
                                                   substeps))[0]

    return fn


def make_sharded_fused_step(mesh: Mesh, R: int, C: int, collide_fn,
                            dtype: torch.dtype = torch.float32, substeps: int | str = 1):
    """Globally periodic collide-stream with any local collision, rows
    sharded over the mesh: ShardedState -> ShardedState, ``substeps`` steps
    per call (lbm_tpu sharded_pallas.py:528).  Kernel 27 on CUDA shards: a
    call's steps in one launch over up to MAX_SHARDS shards of a card
    (``launch_collide_shards``), the neighbours' HALO edge rows read in place
    where they share the card (``ring_rows``); CPU shards run the plain
    version; ``step.plain`` the plain version after ``exchange_rows`` on any
    device."""
    substeps = _check_sweeps(resolve_substeps(substeps, "bgk"), HALO)
    body = collide_stream_body(collide_fn)
    launch = collide_launch(collide_fn, HALO_COLLIDE_STREAM, substeps)

    def plain(f, top, bot, off, edge):
        return plain_sweeps(body, f, top, bot, off, R, substeps)

    def batched(shards):
        return launch([(f, row_parts(f, top, bot), True) for f, top, bot, _, _ in shards],
                      plain=lambda i: plain(*shards[i]))

    return make_sharded_body_step(mesh, 9, R, C, plain, dtype, batched=batched)


def make_sharded_thermal_step(mesh: Mesh, R: int, C: int, *, omega_f: float,
                              omega_g: float, g_beta: float, substeps: int | str = 1,
                              dtype: torch.dtype = torch.float32):
    """The Rayleigh-Benard step (kernels/thermal.py, D2Q9 temperature) with
    rows sharded: S (18, R, C) shards -> the same, walls at global rows 0
    and R-1, ``substeps`` steps per exchange of HALO rows (lbm_tpu
    sharded_pallas.py:503).  Kernel 28 on CUDA shards."""
    substeps = _check_sweeps(resolve_substeps(substeps, "thermal"), HALO)
    if R < 4 or C < 4:
        raise ValueError(f"the thermal step needs R >= 4 and C >= 4, got {R}x{C}")
    launch = functools.partial(
        launch_sweeps, HALO_THERMAL, R=R, substeps=substeps, rows_per_sweep=1, walls=True,
        params=thermal.thermal_constants(omega_f, omega_g, g_beta, dtype))
    local = make_local_halo_body_step(R, thermal_body(omega_f, omega_g, g_beta), launch,
                                      substeps)
    return make_sharded_body_step(mesh, 18, R, C, local, dtype)


def make_sharded_mrtcg_reduced_step(mesh: Mesh, R: int, C: int, red, blue, sigma: float,
                                    gravity=(0.0, 0.0), delta: float = 0.1,
                                    apply_gravity_source: bool = True,
                                    dtype: torch.dtype = torch.float32,
                                    surface_tension: str = "perturbation",
                                    substeps: int | str = 1):
    """The reduced MRT colour-gradient state with rows sharded: G (10, R, C)
    shards ((12, R, C) in CSF mode) -> the same, ``substeps`` steps per
    exchange of ``halo_for(substeps, 3 or 5)`` rows (lbm_tpu
    sharded_pallas.py:453).  Kernel 29 on CUDA shards."""
    csf = surface_tension == "csf"
    family = "csf" if csf else "mrtcg"
    planes = mrtcg.reduced_planes(surface_tension)
    r = ROWS_PER_SWEEP[family]
    substeps = _check_sweeps(resolve_substeps(substeps, family), None)
    halo = halo_for(substeps, r)
    if R < 4 or C < 3:
        raise ValueError(f"the MRT-CG step takes R >= 4 and C >= 3, got {R}x{C}")
    plain = mrtcg.make_plain_step(red, blue, sigma, gravity, delta, apply_gravity_source,
                                  surface_tension)
    params = _build.c_doubles(mrtcg.kernel_params(red, blue, sigma, gravity, delta,
                                                  apply_gravity_source))
    launch = functools.partial(launch_sweeps, HALO_MRTCG, R=R, substeps=substeps,
                               rows_per_sweep=r, walls=True, params=params, i0=int(csf))
    local = make_local_halo_body_step(R, plain, launch, substeps)
    return make_sharded_body_step(mesh, planes, R, C, local, dtype, halo)


def make_sharded_rk_step(mesh: Mesh, R: int, C: int, *, r_alpha: float, b_alpha: float,
                         r_nu: float, b_nu: float, sigma: float, beta: float = 0.7,
                         gravity=(0.0, 0.0), dtype: torch.dtype = torch.float32):
    """The RK mixture step with rows sharded: S (11, R, C) = [f (9), r_rho,
    b_rho] shards -> the same, one step per call (lbm_tpu
    sharded_pallas.py:486).  Kernel 30 on CUDA shards: one launch a call
    over up to MAX_SHARDS shards of a card (``launch_sweeps_shards``),
    reading the neighbours' edge rows in place where they share the card
    (``ring_rows``); CPU shards run the plain version; ``step.plain`` the
    plain version after ``exchange_rows`` on any device."""
    if R < 4 or C < 3:
        raise ValueError(f"the RK step takes R >= 4 and C >= 3, got {R}x{C}")
    kw = dict(r_alpha=r_alpha, b_alpha=b_alpha, r_nu=r_nu, b_nu=b_nu, sigma=sigma, beta=beta,
              gravity=gravity)
    body = rk.make_plain_step(**kw)

    def plain(f, top, bot, off, edge):
        return plain_sweeps(body, f, top, bot, off, R, 1)

    batched = functools.partial(
        launch_sweeps_shards, HALO_RK, substeps=1, rows_per_sweep=ROWS_PER_SWEEP["rk"],
        walls=True, R=R, params=_build.c_doubles(rk.kernel_params(**kw)), ints=(0, 0),
        plain=plain)
    return make_sharded_body_step(mesh, rk.PLANES, R, C, plain, dtype, batched=batched)


def _per_colour(step):
    """``step`` (and its ``plain``) on the full per-colour state: each shard,
    (18, R_loc, C) or (2, 9, R_loc, C), viewed as (18, R_loc, C), and the
    result handed back as (2, 9, R_loc, C) shards, which gather to F (2, 9,
    R, C) (lbm_tpu sharded_pallas.py:442-445)."""

    def wrap(fn):
        def wrapped(state: ShardedState) -> ShardedState:
            flat = fn(ShardedState(state.mesh, [f.reshape(18, *f.shape[-2:])
                                                for f in state.shards]))
            return ShardedState(flat.mesh, [f.reshape(2, 9, *f.shape[-2:])
                                            for f in flat.shards])
        return wrapped

    out = wrap(step)
    out.plain = wrap(step.plain)
    return out


def make_sharded_mrtcg_step(mesh: Mesh, R: int, C: int, red, blue, sigma: float,
                            gravity=(0.0, 0.0), delta: float = 0.1,
                            apply_gravity_source: bool = True,
                            dtype: torch.dtype = torch.float32,
                            surface_tension: str = "perturbation",
                            substeps: int | str = 1):
    """The full per-colour MRT colour-gradient step with rows sharded.
    Perturbation mode: F (2, 9, R, C) sharded as ``shard_state(mesh,
    F.reshape(18, R, C))`` -> shards of (2, 9, R/n, C), which gather to F
    (the step also takes those shards back); CSF mode: shards of S (20, R,
    C) = [red f, blue f, fst carry] -> the same.
    ``substeps`` steps per exchange of ``halo_for(substeps, 3 or 5)`` rows
    (lbm_tpu sharded_pallas.py:406).  Kernel 31 on CUDA shards."""
    csf = surface_tension == "csf"
    family = "csf" if csf else "mrtcg"
    planes = mrtcg.full_planes(surface_tension)
    r = ROWS_PER_SWEEP[family]
    substeps = _check_sweeps(resolve_substeps(substeps, family), None)
    halo = halo_for(substeps, r)
    if R < 4 or C < 3:
        raise ValueError(f"the MRT-CG step takes R >= 4 and C >= 3, got {R}x{C}")
    plain = mrtcg.make_plain_step(red, blue, sigma, gravity, delta, apply_gravity_source,
                                  surface_tension, reduced_in=False, reduced_out=False)
    params = _build.c_doubles(mrtcg.kernel_params(red, blue, sigma, gravity, delta,
                                                  apply_gravity_source))
    launch = functools.partial(launch_sweeps, HALO_MRTCG_FULL, R=R, substeps=substeps,
                               rows_per_sweep=r, walls=True, params=params, i0=int(csf))
    local = make_local_halo_body_step(R, plain, launch, substeps)
    step = make_sharded_body_step(mesh, planes, R, C, local, dtype, halo)
    return step if csf else _per_colour(step)


def make_sharded_sc_step(mesh: Mesh, R: int, C: int, *, omega: float, G: float | None = None,
                         eos: str = "sc", T: float | None = None, forcing: str | None = None,
                         substeps: int | str = 1, dtype: torch.dtype = torch.float32):
    """The fully periodic Shan-Chen step (kernels/shan_chen.py) with rows
    sharded: f (9, R, C) shards -> the same, ``substeps`` (at most 4) steps
    per exchange of HALO rows, each sweep consuming 2 (lbm_tpu's
    make_sharded_body_step on make_sc_body, shan_chen_pallas.py:138).
    Kernel 32 on CUDA shards: one launch a sweep over up to MAX_SHARDS
    shards of a card (``launch_sweeps_shards``), the first reading the
    neighbours' edge rows in place where they share the card
    (``ring_rows``); CPU shards run the plain version; ``step.plain`` the
    plain version after ``exchange_rows`` on any device."""
    substeps = _check_sweeps(resolve_substeps(substeps, "shan_chen"),
                            HALO // ROWS_PER_SWEEP["shan_chen"])
    eos_i, forcing_i, params = shan_chen.kernel_params(omega, G, eos, T, forcing)
    sc = shan_chen.make_plain_step(omega, G, eos, T, forcing)

    def plain(f, top, bot, off, edge):
        return plain_sweeps(lambda S, rows, R_: sc(S), f, top, bot, off, R, substeps)

    batched = functools.partial(
        launch_sweeps_shards, HALO_SHAN_CHEN, substeps=substeps,
        rows_per_sweep=ROWS_PER_SWEEP["shan_chen"], walls=False, R=R,
        params=_build.c_doubles(params), ints=(eos_i, forcing_i), plain=plain)
    return make_sharded_body_step(mesh, 9, R, C, plain, dtype, batched=batched)


def make_sharded_d3q19_step(mesh: Mesh, X: int, Y: int, Z: int, *, omega: float,
                            force_z: float = 0.0, x_walls: bool = False,
                            y_walls: bool = False, z_walls: bool = False, lid_u: float = 0.0,
                            substeps: int | str = 1, dtype: torch.dtype = torch.float32):
    """The D3Q19 step (kernels/d3q19.py) with the y axis sharded: shards of
    the planes state viewed as (19 X, Y, Z) (``f.reshape(19 * X, Y, Z)``;
    plane k X + x) -> the same, ``substeps`` steps per exchange of HALO
    rows; the y faces and the lid at the grid's global rows 0 and Y-1, the
    x and z walls local (lbm_tpu's make_sharded_body_step on
    make_d3q19_body, d3q19_pallas.py:173).  Kernel 33 on CUDA shards: one
    launch a sweep over up to MAX_SHARDS shards of a card
    (``launch_sweeps_shards``), the first reading the neighbours' edge rows
    in place where they share the card (``ring_rows``); CPU shards run the
    plain version; ``step.plain`` the plain version after ``exchange_rows``
    on any device."""
    substeps = _check_sweeps(resolve_substeps(substeps, "d3q19"), HALO)
    d3q19._check_grid(X, Y, Z, x_walls, y_walls, z_walls, lid_u)
    kw = dict(omega=omega, force_z=force_z, x_walls=x_walls, y_walls=y_walls, z_walls=z_walls,
              lid_u=lid_u)
    body = d3q19_body(X, **kw)

    def plain(f, top, bot, off, edge):
        return plain_sweeps(body, f, top, bot, off, Y, substeps)

    batched = functools.partial(
        launch_sweeps_shards, HALO_D3Q19, substeps=substeps, rows_per_sweep=1, walls=y_walls,
        R=Y, params=d3q19.d3q19_constants(omega, force_z, lid_u, dtype),
        ints=(X, d3q19._flags(force_z, x_walls, y_walls, z_walls, lid_u)), plain=plain)
    return make_sharded_body_step(mesh, d3q19.Q * X, Y, Z, plain, dtype, batched=batched)
