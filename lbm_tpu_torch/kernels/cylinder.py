"""The IBM grid steps: plain versions and CUDA kernels 15 and 18
(counterpart of lbm_tpu/kernels/cylinder_pallas.py).

``make_cylinder_fused_step(R, C, omega, u_wall, guo, dtype)`` returns
``fn(f, F_roi, origin) -> f``: BGK at the compressible equilibrium, the
Guo source of the ROI force density F_roi (2, roi_r, roi_c) whose first
cell is ``origin``, the periodic stream, anti-bounce-back rows 0 and R-1
at the constant wall velocity ``u_wall``, and specular columns C-1 then 0
(test/cylinder_test.cpp:88-163).  ``guo`` is (ics2, ics4): the reference
program's weak (1/3, 1/9) by default, or the standard (3, 9).

On a CPU state it runs ``plain_cylinder_step``, lbm_tpu's jnp step body with
a precomputed force (tests/test_cylinder_pallas.py:15-27, the source added
over the ROI only as scenes/obstacles.py:234-236 does); on a CUDA state it
launches kernel 15 (csrc/cylinder.cu) or raises.  lbm_tpu's kernel took the
force on the full grid; the port's takes the ROI and its origin, so the
zeros outside it are never stored.

``make_box_fused_step(R, C, omega, guo, dtype)`` (cylinder_pallas.py:153)
returns ``fn(f, F_win, origin) -> f``, the grid half of the moving-body
scenes: BGK, the Guo source (standard (3, 9) by default) of the force window
F_win (2, rw, cw) whose first cell is ``origin``, an int32 tensor (2,) on
the state's device, the periodic stream and halfway bounce-back on all four
walls.  On a CPU state it runs ``plain_box_step``; on a CUDA state it
launches kernel 18 (csrc/cylinder.cu), which reads the origin in device
memory, where the moving-forcing kernels 19-21 write it.
"""

from __future__ import annotations

import ctypes

import torch

from ..boundary import bc
from ..ops import d2q9
from ..utils.xmath import resolve_fused, rounded
from . import _build
from .collide_stream import check_step_state

WEAK_GUO = (1.0 / 3.0, 1.0 / 9.0)  # cylinder_test.cpp:66-67
STANDARD_GUO = (3.0, 9.0)

CYLINDER = _build.CudaKernel(
    "lbm_cylinder",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_longlong] * 6
    + [ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_void_p])

BOX = _build.CudaKernel(
    "lbm_box_step",
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4
    + [ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_void_p])


def plain_cylinder_step(f: torch.Tensor, F_roi: torch.Tensor, origin, omega: float,
                        u_wall, guo=WEAK_GUO) -> torch.Tensor:
    """The plain version of one step (scenes/obstacles.py:224-243 of
    lbm_tpu with the force F_roi given at ``origin``)."""
    r0, c0 = origin
    r1, c1 = r0 + F_roi.shape[1], c0 + F_roi.shape[2]
    rho = d2q9.calc_rho(f)
    u = d2q9.calc_u(f, rho)
    f_coll = d2q9.bgk_collision(f, d2q9.equilibrium(u, rho), omega)
    S = d2q9.guo_source(u[:, r0:r1, c0:c1], F_roi, omega, ics2=guo[0], ics4=guo[1])
    f_coll[:, r0:r1, c0:c1] += S
    u_w = torch.as_tensor(u_wall, dtype=f.dtype, device=f.device)
    f_new = d2q9.stream(f_coll)
    f_new = bc.anti_bounce_back(f_new, f_coll, "row0", u_w)
    f_new = bc.anti_bounce_back(f_new, f_coll, "rowN", u_w)
    f_new = bc.specular(f_new, f_coll, "colN")
    return bc.specular(f_new, f_coll, "col0")


def cylinder_constants(omega: float, u_wall, guo, dtype: torch.dtype):
    """Kernel 15's 14 scalars, each as the plain version rounds it in
    ``dtype``: omega, 1 - omega, 1 - omega/2, ics2, ics4 and the ABB
    coefficients (9, d2q9.abb_coefficient in ``dtype``)."""
    abb = d2q9.abb_coefficient(torch.tensor(tuple(u_wall), dtype=dtype)).tolist()
    vals = [rounded(x, dtype) for x in (omega, 1.0 - omega, 1.0 - 0.5 * omega,
                                        guo[0], guo[1])] + abb
    return _build.c_doubles(vals)


def check_force(F_roi: torch.Tensor, origin, R: int, C: int, f: torch.Tensor) -> None:
    """F_roi must be a contiguous (2, rw, cw) tensor of the state's device and
    dtype whose ROI lies inside the grid."""
    r0, c0 = origin
    if F_roi.ndim != 3 or F_roi.shape[0] != 2 or r0 < 0 or c0 < 0 \
            or r0 + F_roi.shape[1] > R or c0 + F_roi.shape[2] > C:
        raise ValueError(f"force {tuple(F_roi.shape)} at {tuple(origin)} does not fit "
                         f"the {R}x{C} grid")
    if F_roi.device != f.device or F_roi.dtype != f.dtype or not F_roi.is_contiguous():
        raise ValueError("the force must be a contiguous tensor of the state's "
                         "device and dtype")


def cylinder_step(f: torch.Tensor, F_roi: torch.Tensor, origin, consts) -> torch.Tensor:
    """One step on the card (kernel 15) into a fresh buffer.  Raises on a
    tensor the kernel does not take and on a refused launch."""
    R, C = _build.check_state(f)
    check_force(F_roi, origin, R, C, f)
    out = torch.empty_like(f)
    with torch.cuda.device(f.device):
        CYLINDER.launch(f.data_ptr(), F_roi.data_ptr(), out.data_ptr(), R, C,
                        int(origin[0]), int(origin[1]), F_roi.shape[1], F_roi.shape[2],
                        consts, int(f.dtype == torch.float64), _build.stream_handle(f))
    return out


def make_cylinder_fused_step(R: int, C: int, omega: float, u_wall=(0.05, 0.0),
                             guo=WEAK_GUO, dtype: torch.dtype = torch.float32):
    """Cylinder grid step (f (9, R, C), F_roi, origin) -> (9, R, C) for any
    R, C >= 4: kernel 15 on a CUDA state, the plain version on a CPU state."""
    if R < 4 or C < 4:
        raise ValueError(f"the cylinder step needs R >= 4 and C >= 4, got {R}x{C}")
    guo = (float(guo[0]), float(guo[1]))
    u_wall = (float(u_wall[0]), float(u_wall[1]))
    consts = cylinder_constants(omega, u_wall, guo, dtype)

    def step(f: torch.Tensor, F_roi: torch.Tensor, origin) -> torch.Tensor:
        check_step_state(f, R, C, dtype)
        if resolve_fused(f):
            return cylinder_step(f, F_roi, origin, consts)
        check_force(F_roi, origin, R, C, f)
        return plain_cylinder_step(f, F_roi, origin, omega, u_wall, guo)

    return step


def plain_box_step(f: torch.Tensor, F_win: torch.Tensor, origin: torch.Tensor, omega: float,
                   guo=STANDARD_GUO) -> torch.Tensor:
    """The plain version of one box step: the grid half of lbm_tpu's jnp
    falling-body step (scenes/obstacles.py:1040-1066) with the force window
    given at ``origin``."""
    r0, c0 = (int(v) for v in origin.tolist())
    r1, c1 = r0 + F_win.shape[1], c0 + F_win.shape[2]
    rho = d2q9.calc_rho(f)
    u = d2q9.calc_u(f, rho)
    f_coll = d2q9.bgk_collision(f, d2q9.equilibrium(u, rho), omega)
    S = d2q9.guo_source(u[:, r0:r1, c0:c1], F_win, omega, ics2=guo[0], ics4=guo[1])
    f_coll[:, r0:r1, c0:c1] += S
    f_new = d2q9.stream(f_coll)
    for side in ("row0", "rowN", "col0", "colN"):
        f_new = bc.bounce_back(f_new, f_coll, side)
    return f_new


def box_constants(omega: float, guo, dtype: torch.dtype):
    """Kernel 18's 5 scalars, each as the plain version rounds it in
    ``dtype``: omega, 1 - omega, 1 - omega/2, ics2, ics4."""
    return _build.c_doubles([rounded(x, dtype) for x in (omega, 1.0 - omega,
                                                         1.0 - 0.5 * omega, guo[0], guo[1])])


def check_window(F_win: torch.Tensor, origin: torch.Tensor, R: int, C: int,
                 f: torch.Tensor) -> None:
    """F_win must be a contiguous (2, rw, cw) tensor of the state's device and
    dtype that fits the grid, and origin an int32 tensor (2,) beside it."""
    if F_win.ndim != 3 or F_win.shape[0] != 2 or F_win.shape[1] > R or F_win.shape[2] > C:
        raise ValueError(f"force window {tuple(F_win.shape)} does not fit the {R}x{C} grid")
    if F_win.device != f.device or F_win.dtype != f.dtype or not F_win.is_contiguous():
        raise ValueError("the force window must be a contiguous tensor of the state's "
                         "device and dtype")
    if origin.shape != (2,) or origin.dtype != torch.int32 or origin.device != f.device:
        raise ValueError("the window origin must be an int32 tensor (2,) on the state's "
                         "device")


def box_step(f: torch.Tensor, F_win: torch.Tensor, origin: torch.Tensor,
             consts) -> torch.Tensor:
    """One box step on the card (kernel 18) into a fresh buffer.  Raises on a
    tensor the kernel does not take and on a refused launch."""
    R, C = _build.check_state(f)
    check_window(F_win, origin, R, C, f)
    origin = origin.contiguous()
    out = torch.empty_like(f)
    with torch.cuda.device(f.device):
        BOX.launch(f.data_ptr(), F_win.data_ptr(), origin.data_ptr(), out.data_ptr(), R, C,
                   F_win.shape[1], F_win.shape[2], consts, int(f.dtype == torch.float64),
                   _build.stream_handle(f))
    return out


def make_box_fused_step(R: int, C: int, omega: float, guo=STANDARD_GUO,
                        dtype: torch.dtype = torch.float32):
    """Box grid step (f (9, R, C), F_win, origin) -> (9, R, C) for any R, C
    >= 4: kernel 18 on a CUDA state, the plain version on a CPU state."""
    if R < 4 or C < 4:
        raise ValueError(f"the box step needs R >= 4 and C >= 4, got {R}x{C}")
    guo = (float(guo[0]), float(guo[1]))
    consts = box_constants(omega, guo, dtype)

    def step(f: torch.Tensor, F_win: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
        check_step_state(f, R, C, dtype)
        if resolve_fused(f):
            return box_step(f, F_win, origin, consts)
        check_window(F_win, origin, R, C, f)
        return plain_box_step(f, F_win, origin, omega, guo)

    return step
