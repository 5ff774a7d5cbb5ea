"""The D3Q19 step: plain versions and CUDA kernels 25 and 26 (counterpart of
lbm_tpu/kernels/d3q19_pallas.py and d3q19_lanes_pallas.py).

One D3Q19 BGK step on the (19, X, Y, Z) state, with an optional Guo body
force along z and its half-force velocity shift, then the periodic push,
then optional halfway walls, each rule over the last in lbm_tpu's order:
the x end walls (``x_walls``; the reversed population arrives at the same
cell, with no y or z displacement), the y faces (``y_walls``; with
``lid_u`` the y = Y-1/2 face slides along +z with the 6 w_k c_k.u_w
correction), then the z faces (``z_walls``), which win the shared edges.

  * ``collide`` is lbm_tpu's ``_collide_x`` (d3q19_pallas.py:50-98) term
    for term: rho as a running sum, the moments per axis in k order, the
    k / opp(k) pairing of the even and odd parts;
  * ``plain_d3q19_step`` is that collision, ``ops.d3q19.stream`` and the
    wall rules of ``make_d3q19_body`` (:173-248) on the whole grid
    (``plain_d3q19_rows`` on a block of global y rows, the y faces as
    position masks, as the row-sharded step takes it);
    ``make_d3q19_fused_step`` runs CUDA kernel 25 (csrc/d3q19.cu) on a CUDA
    state, one launch per step and ``substeps`` steps per call, and the
    plain version on a CPU state;
  * ``pack_lanes`` / ``unpack_lanes`` carry the state to lbm_tpu's lanes
    layout (19, Y, X*Z), lane = z*X + x; ``plain_d3q19_lanes_step`` is the
    plain step in that layout and ``make_d3q19_lanes_step`` runs kernel 26,
    the same kernel over the lanes addresses.

lbm_tpu's depth-as-planes layout (19 X, Y, Z) is a Mosaic view: the port's
planes layout is the (19, X, Y, Z) tensor itself (io/convert.py carries
the TPU layouts across).  Any X, Y, Z >= 1 on a periodic axis and >= 2 on
a walled one, in float32 and float64.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.d3q19 import CX, CY, CZ, OPP, Q, WQ, stream
from ..utils.xmath import resolve_fused, rounded
from . import _build
from .collide_stream import _check_substeps

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p]
D3Q19 = _build.CudaKernel("lbm_d3q19", _ARGS)
D3Q19_LANES = _build.CudaKernel("lbm_d3q19_lanes", _ARGS)

# the bits of the kernels' ``flags`` argument
X_WALLS, Y_WALLS, Z_WALLS, FORCE, LID = 1, 2, 4, 8, 16

Y_OUT_LO = tuple(k for k in range(1, Q) if CY[k] < 0)
Y_OUT_HI = tuple(k for k in range(1, Q) if CY[k] > 0)
Z_OUT_LO = tuple(k for k in range(1, Q) if CZ[k] < 0)
Z_OUT_HI = tuple(k for k in range(1, Q) if CZ[k] > 0)


def collide(fx: list, omega: float, gz: float) -> list:
    """One BGK collision of the 19 planes ``fx`` (+ the Guo force (0, 0, gz)
    with the half-force velocity shift), lbm_tpu's ``_collide_x``: cu flips
    sign under k -> opp(k), so each pair shares its even part and splits
    its odd part."""
    rho = fx[0]
    for k in range(1, Q):
        rho = rho + fx[k]
    inv_rho = 1.0 / rho
    mx = my = mz = None
    for k in range(1, Q):
        if CX[k]:
            mx = fx[k] * CX[k] if mx is None else mx + fx[k] * CX[k]
        if CY[k]:
            my = fx[k] * CY[k] if my is None else my + fx[k] * CY[k]
        if CZ[k]:
            mz = fx[k] * CZ[k] if mz is None else mz + fx[k] * CZ[k]
    ux = mx * inv_rho
    uy = my * inv_rho
    uz = (mz + 0.5 * gz) * inv_rho if gz else mz * inv_rho
    uu15 = 1.5 * (ux * ux + uy * uy + uz * uz)

    pref = (1.0 - 0.5 * omega) if gz else 0.0
    out = [None] * Q
    out[0] = (1.0 - omega) * fx[0] + omega * (WQ[0] * rho * (1.0 - uu15))
    if gz:
        out[0] = out[0] - pref * WQ[0] * (3.0 * uz * gz)
    for k in range(1, Q, 2):  # the pair leaders 1, 3, ..., 17; opp(k) = k + 1
        ko = OPP[k]
        cu = CX[k] * ux + CY[k] * uy + CZ[k] * uz
        w = WQ[k]
        wr = w * rho
        even = omega * (wr * (1.0 + 4.5 * cu * cu - uu15))
        odd = omega * (wr * (3.0 * cu))
        out[k] = (1.0 - omega) * fx[k] + (even + odd)
        out[ko] = (1.0 - omega) * fx[ko] + (even - odd)
        if gz:
            cF = CZ[k] * gz
            even_s = pref * w * (9.0 * cu * cF - 3.0 * uz * gz)
            odd_s = pref * w * (3.0 * cF)
            out[k] = out[k] + (even_s + odd_s)
            out[ko] = out[ko] + (even_s - odd_s)
    return out


def _check_grid(X: int, Y: int, Z: int, x_walls: bool, y_walls: bool, z_walls: bool,
                lid_u: float) -> None:
    for n, walled, name in ((X, x_walls, "X"), (Y, y_walls, "Y"), (Z, z_walls, "Z")):
        if n < (2 if walled else 1):
            raise ValueError(f"{name} = {n}: the D3Q19 step needs >= 1 cell on a periodic "
                             "axis and >= 2 on a walled one")
    if lid_u and not y_walls:
        raise ValueError("lid_u needs y_walls=True")


def plain_d3q19_step(f: torch.Tensor, *, omega: float, force_z: float = 0.0,
                     x_walls: bool = False, y_walls: bool = False, z_walls: bool = False,
                     lid_u: float = 0.0) -> torch.Tensor:
    """The plain version of one step on f (19, X, Y, Z) (kernel 25):
    ``collide``, the periodic push, then the wall rules of lbm_tpu's
    make_d3q19_body in its order."""
    _check_grid(*f.shape[1:], x_walls, y_walls, z_walls, lid_u)
    Y = f.shape[2]
    return plain_d3q19_rows(f, torch.arange(Y, device=f.device), Y, omega=omega,
                            force_z=force_z, x_walls=x_walls, y_walls=y_walls,
                            z_walls=z_walls, lid_u=lid_u)


def plain_d3q19_rows(f: torch.Tensor, rows: torch.Tensor, Y: int, *, omega: float,
                     force_z: float = 0.0, x_walls: bool = False, y_walls: bool = False,
                     z_walls: bool = False, lid_u: float = 0.0) -> torch.Tensor:
    """``plain_d3q19_step`` on f (19, X, len(rows), Z), the consecutive
    global y rows ``rows`` of a grid of Y rows: the y faces and the lid act
    where the global row is 0 or Y-1, as position masks (lbm_tpu's
    ``abs_iota``), and the push wraps the block, whose edge rows are then
    stale (the row-sharded plain version, kernels/sharded.py)."""
    coll = torch.stack(collide(list(f), omega, float(force_z)))
    new = stream(coll)
    if x_walls:  # the reversal arrives at the same cell
        for k in range(1, Q):
            if CX[k] > 0:
                new[k, 0] = coll[OPP[k], 0]
            elif CX[k] < 0:
                new[k, -1] = coll[OPP[k], -1]
    if y_walls:
        lo, hi = (rows == 0)[:, None], (rows == Y - 1)[:, None]
        for k in Y_OUT_LO:
            new[OPP[k]] = torch.where(lo, coll[k], new[OPP[k]])
        for k in Y_OUT_HI:
            src = coll[k]
            if lid_u and CZ[k]:
                src = src - (6.0 * WQ[k] * CZ[k] * lid_u)
            new[OPP[k]] = torch.where(hi, src, new[OPP[k]])
    if z_walls:
        for k in Z_OUT_LO:
            new[OPP[k], :, :, 0] = coll[k, :, :, 0]
        for k in Z_OUT_HI:
            new[OPP[k], :, :, -1] = coll[k, :, :, -1]
    return new


def pack_lanes(f: torch.Tensor) -> torch.Tensor:
    """(19, X, Y, Z) -> the lanes layout (19, Y, X*Z), lane = z*X + x."""
    q, X, Y, Z = f.shape
    return f.permute(0, 2, 3, 1).reshape(q, Y, Z * X).contiguous()


def unpack_lanes(S: torch.Tensor, X: int, Y: int, Z: int) -> torch.Tensor:
    """Inverse of ``pack_lanes``."""
    return S.reshape(S.shape[0], Y, Z, X).permute(0, 3, 1, 2).contiguous()


def plain_d3q19_lanes_step(S: torch.Tensor, X: int, Y: int, Z: int,
                           **kw) -> torch.Tensor:
    """The plain version of one step on the lanes state (19, Y, X*Z)
    (kernel 26): ``plain_d3q19_step`` between ``unpack_lanes`` and
    ``pack_lanes``."""
    return pack_lanes(plain_d3q19_step(unpack_lanes(S, X, Y, Z), **kw))


def d3q19_constants(omega: float, force_z: float, lid_u: float, dtype: torch.dtype):
    """Kernels 25 and 26's 10 scalars, each as ``collide`` and the lid rule
    round it in ``dtype`` (a product of Python floats rounds once, at the
    end): omega, 1 - omega, gz, 0.5 gz, pref w_0, pref w_axis, pref w_diag,
    pref w_axis (3 gz), pref w_diag (3 gz), 6 w_diag lid_u, with
    pref = 1 - omega/2 (0 without a force)."""
    gz = float(force_z)
    pref = (1.0 - 0.5 * omega) if gz else 0.0
    w0, w1, w2 = WQ[0], WQ[1], WQ[7]
    return _build.c_doubles([rounded(x, dtype) for x in (
        omega, 1.0 - omega, gz, 0.5 * gz, pref * w0, pref * w1, pref * w2,
        pref * w1 * (3.0 * gz), pref * w2 * (3.0 * gz), 6.0 * w2 * 1 * lid_u)])


def _flags(force_z, x_walls, y_walls, z_walls, lid_u) -> int:
    return ((X_WALLS if x_walls else 0) | (Y_WALLS if y_walls else 0)
            | (Z_WALLS if z_walls else 0) | (FORCE if force_z else 0)
            | (LID if lid_u else 0))


def _check_state(f: torch.Tensor, shape: tuple, dtype: torch.dtype) -> None:
    if tuple(f.shape) != shape or f.dtype != dtype:
        raise ValueError(f"state {tuple(f.shape)} {f.dtype}, step built for {shape} {dtype}")


def launch_d3q19(kernel: _build.CudaKernel, f: torch.Tensor, X: int, Y: int, Z: int,
                 substeps: int, consts, flags: int) -> torch.Tensor:
    """``substeps`` launches of kernel 25 or 26 on a contiguous CUDA state of
    19 * X * Y * Z entries, ping-ponging two fresh buffers; ``f`` itself is
    never written.  Raises on a tensor the kernel does not take and on a
    refused launch."""
    _check_substeps(substeps)
    if f.device.type != "cuda":
        raise ValueError(f"kernel state must be a CUDA tensor, got {f.device}")
    if f.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel state must be float32 or float64, got {f.dtype}")
    if f.numel() != Q * X * Y * Z or f.shape[0] != Q or not f.is_contiguous():
        raise ValueError(f"kernel state must be a contiguous (19, ...) tensor of "
                         f"19 x {X} x {Y} x {Z} entries, got {tuple(f.shape)}")
    bufs = [torch.empty_like(f) for _ in range(min(substeps, 2))]
    with torch.cuda.device(f.device):
        stream_h = _build.stream_handle(f)
        src = f
        for i in range(substeps):
            dst = bufs[i % 2]
            kernel.launch(src.data_ptr(), dst.data_ptr(), X, Y, Z, consts, flags,
                          int(f.dtype == torch.float64), stream_h)
            src = dst
    return src


def _make(kernel, shape, X, Y, Z, plain, omega, force_z, x_walls, y_walls, z_walls, lid_u,
          substeps, dtype):
    _check_substeps(substeps)
    _check_grid(X, Y, Z, x_walls, y_walls, z_walls, lid_u)
    consts = d3q19_constants(omega, force_z, lid_u, dtype)
    flags = _flags(force_z, x_walls, y_walls, z_walls, lid_u)
    kw = dict(omega=omega, force_z=force_z, x_walls=x_walls, y_walls=y_walls,
              z_walls=z_walls, lid_u=lid_u)

    def step(f: torch.Tensor) -> torch.Tensor:
        _check_state(f, shape, dtype)
        if resolve_fused(f):
            return launch_d3q19(kernel, f, X, Y, Z, substeps, consts, flags)
        for _ in range(substeps):
            f = plain(f, **kw)
        return f

    return step


def make_d3q19_fused_step(X: int, Y: int, Z: int, *, omega: float, force_z: float = 0.0,
                          x_walls: bool = False, y_walls: bool = False,
                          z_walls: bool = False, lid_u: float = 0.0, substeps: int = 1,
                          dtype: torch.dtype = torch.float32):
    """D3Q19 step f (19, X, Y, Z) -> f, ``substeps`` steps per call: kernel
    25 on a CUDA state (one launch per step), ``plain_d3q19_step`` on a CPU
    state."""
    return _make(D3Q19, (Q, X, Y, Z), X, Y, Z, plain_d3q19_step, omega, force_z, x_walls,
                 y_walls, z_walls, lid_u, substeps, dtype)


def make_d3q19_lanes_step(X: int, Y: int, Z: int, *, omega: float, force_z: float = 0.0,
                          x_walls: bool = False, y_walls: bool = False,
                          z_walls: bool = False, lid_u: float = 0.0, substeps: int = 1,
                          dtype: torch.dtype = torch.float32):
    """The same step on the lanes state (19, Y, X*Z): kernel 26 on a CUDA
    state (one launch per step), ``plain_d3q19_lanes_step`` on a CPU
    state."""
    def plain(S, **kw):
        return plain_d3q19_lanes_step(S, X, Y, Z, **kw)

    return _make(D3Q19_LANES, (Q, Y, X * Z), X, Y, Z, plain, omega, force_z, x_walls,
                 y_walls, z_walls, lid_u, substeps, dtype)
