"""The rectangle-sedimentation step: plain version and CUDA kernel 17
(counterpart of lbm_tpu/kernels/sediment_pallas.py).

State ``S (18, R, C) = [f (9), g (9)]``: a BGK fluid and a passive
advection-diffusion scalar (Sc = 1) coupled one way.  ``plain_sediment_step``
is lbm_tpu's jnp step (scenes/obstacles.py:455-491), with the start-of-step
macroscopics taken from S itself (lbm_tpu's carry holds the same numbers).
``make_sediment_fused_step`` runs kernel 17 (csrc/sediment.cu) on a CUDA
state, one launch per step and ``substeps`` steps per call, and the plain
version on a CPU state.  lbm_tpu fuses up to 8 steps per launch; any
``substeps >= 1`` goes here.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..boundary import bc
from ..core import lattice as lat
from ..ops import d2q9
from ..utils.xmath import resolve_fused, rounded
from . import _build
from .collide_stream import check_step_state, launch_steps
from .mrtcg import _check_substeps

CX, CY, WQ = lat.CX, lat.CY, lat.WQ

SEDIMENT = _build.CudaKernel(
    "lbm_sediment",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
     ctypes.c_void_p])


def rect_wall_assignments(R23: int, C28: int, C38: int):
    """The rectangle's bounce-back walls for the fluid, as
    bc.obstacle_bounce_back assignments (rectangle_sedimentation_test.cpp:
    184-196): the rectangle spans rows [R23, H) at cols [C28, C38]."""
    rows = slice(R23 + 1, -1)
    ceil_cols = slice(C28, C38 + 1)
    return [
        # first (left-face) wall at col C28: reflect outgoing (2, 5, 6)
        (8, (rows, C28), 6, 1.0),
        (4, (rows, C28), 2, 1.0),
        (7, (rows, C28), 5, 1.0),
        # ceiling at row R23: reflect outgoing (1, 5, 8)
        (6, (R23, ceil_cols), 8, 1.0),
        (3, (R23, ceil_cols), 1, 1.0),
        (7, (R23, ceil_cols), 5, 1.0),
        # second (right-face) wall at col C38: reflect outgoing (4, 7, 8)
        (5, (rows, C38), 7, 1.0),
        (2, (rows, C38), 4, 1.0),
        (6, (rows, C38), 8, 1.0),
    ]


def rect_wall_assignments_ade(R23: int, C28: int, C38: int):
    """The scalar's rectangle walls: anti-bounce-back with zero wall
    concentration; the first wall's rows run to the last row
    (rectangle_sedimentation_test.cpp:220-232)."""
    rows_full = slice(R23 + 1, None)
    rows = slice(R23 + 1, -1)
    ceil_cols = slice(C28, C38 + 1)
    return [
        (8, (rows_full, C28), 6, -1.0),
        (4, (rows_full, C28), 2, -1.0),
        (7, (rows_full, C28), 5, -1.0),
        (6, (R23, ceil_cols), 8, -1.0),
        (3, (R23, ceil_cols), 1, -1.0),
        (7, (R23, ceil_cols), 5, -1.0),
        (5, (rows, C38), 7, -1.0),
        (2, (rows, C38), 4, -1.0),
        (6, (rows, C38), 8, -1.0),
    ]


def inlet_profile(R: int, C_w: float, inlet_rows: int, dtype, device) -> torch.Tensor:
    """The inlet concentration per row: C_w on the last ``inlet_rows`` rows
    (a Python slice [-inlet_rows:], as lbm_tpu takes it), else 0."""
    cw = np.zeros(R)
    cw[-inlet_rows:] = C_w
    return torch.as_tensor(cw, dtype=dtype, device=device)


def check_geometry(R: int, C: int, R23: int, C28: int, C38: int) -> None:
    """The rectangle must stand clear of the inlet, the outlet and the
    row walls: 1 <= R23 <= R-2 (after wrapping a negative R23) and
    1 <= C28 <= C38 <= C-2."""
    if R < 4 or C < 4:
        raise ValueError(f"the sedimentation step needs R >= 4 and C >= 4, got {R}x{C}")
    if not (1 <= R23 <= R - 2 and 1 <= C28 <= C38 <= C - 2):
        raise ValueError(f"rectangle R23={R23}, C28={C28}, C38={C38} does not fit the "
                         f"{R}x{C} grid clear of its walls")


def plain_sediment_step(S: torch.Tensor, *, omega: float, u_in: float, w_s: float,
                        C_w: float, R23: int, C28: int, C38: int,
                        inlet_rows: int) -> torch.Tensor:
    """The plain version of one step: lbm_tpu's jnp step (obstacles.py:
    455-491) on S = [f, g], the port's boundary rules in its order."""
    R = S.shape[1]
    dtype, device = S.dtype, S.device
    f, g = S[:9], S[9:]
    rho = d2q9.calc_rho(f)
    u = d2q9.calc_u(f, rho)
    conc = d2q9.calc_rho(g)
    f_coll = d2q9.bgk_collision(f, d2q9.equilibrium(u, rho), omega)
    g_coll = d2q9.bgk_collision(g, d2q9.equilibrium(u + w_s, conc), omega)

    # zero-gradient scalar outflows (pre-stream)
    g_coll = bc.zero_gradient(g_coll, "row0")
    g_coll = bc.zero_gradient(g_coll, "colN", lane=slice(1, -1))

    f_new = d2q9.stream(f_coll)
    g_new = d2q9.stream(g_coll)

    # fluid: ABB inlet (col 0, rows 1:-1) at the fixed wall velocity (0, u_in)
    fixed_u_w = torch.zeros((2, R), dtype=dtype, device=device)
    fixed_u_w[1] = u_in
    f_new = bc.anti_bounce_back(f_new, f_coll, "col0", fixed_u_w, lane=slice(1, -1))
    # fluid: ABB outlet (col C-1) at the extrapolated wall velocity
    u_wall = 1.5 * u[:, :, -1] - 0.5 * u[:, :, -2]
    f_new = bc.anti_bounce_back(f_new, f_coll, "colN", u_wall)
    # specular top, no-slip bottom, the rectangle
    f_new = bc.specular(f_new, f_coll, "row0")
    f_new = bc.bounce_back(f_new, f_coll, "rowN")
    f_new = bc.obstacle_bounce_back(f_new, f_coll, rect_wall_assignments(R23, C28, C38))

    # the ADE Dirichlet inlet at the updated velocity (:199-218)
    rho_new = d2q9.calc_rho(f_new)
    u_new = d2q9.calc_u(f_new, rho_new)
    g_new = bc.ade_dirichlet(g_new, g_coll, "col0",
                             _g_eq_wall(u_new[:, :, 0], w_s,
                                        inlet_profile(R, C_w, inlet_rows, dtype, device)),
                             lane=slice(1, -1))
    g_new = bc.obstacle_bounce_back(g_new, g_coll, rect_wall_assignments_ade(R23, C28, C38))
    g_new = bc.bounce_back(g_new, g_coll, "rowN")
    return torch.cat([f_new, g_new])


def _g_eq_wall(u_col0: torch.Tensor, w_s: float, cw: torch.Tensor) -> torch.Tensor:
    """The scalar's wall equilibrium along the inlet, (9, H): the
    equilibrium at u + w_s times the inlet concentration
    (rectangle_sedimentation_test.cpp:204-210)."""
    ux, uy = u_col0[0] + w_s, u_col0[1] + w_s
    uu = ux * ux + uy * uy
    cu = [CX[k] * ux + CY[k] * uy for k in range(9)]
    return torch.stack([(1.0 + 3.0 * cu[k] + 4.5 * cu[k] * cu[k] - 1.5 * uu) * WQ[k] * cw
                        for k in range(9)])


def sediment_constants(omega: float, u_in: float, w_s: float, C_w: float,
                       dtype: torch.dtype):
    """Kernel 17's 13 scalars, each as the plain version rounds it in
    ``dtype``: omega, 1 - omega, w_s, C_w and the inlet's ABB coefficients
    (9, d2q9.abb_coefficient at (0, u_in) in ``dtype``)."""
    abb = d2q9.abb_coefficient(torch.tensor((0.0, u_in), dtype=dtype)).tolist()
    return _build.c_doubles([rounded(x, dtype) for x in (omega, 1.0 - omega, w_s, C_w)]
                            + abb)


def make_sediment_fused_step(R: int, C: int, *, omega: float, u_in: float, w_s: float,
                             C_w: float, R23: int, C28: int, C38: int, inlet_rows: int,
                             substeps: int = 1, dtype: torch.dtype = torch.float32):
    """Coupled step S (18, R, C) -> (18, R, C), ``substeps`` steps per call:
    kernel 17 on a CUDA state (one launch per step), the plain version on a
    CPU state.  A negative R23 counts from the bottom row (R23 % R)."""
    substeps = _check_substeps(substeps)
    R23 = R23 % R if R23 < 0 else R23
    check_geometry(R, C, R23, C28, C38)
    kw = dict(omega=omega, u_in=u_in, w_s=w_s, C_w=C_w, R23=R23, C28=C28, C38=C38,
              inlet_rows=inlet_rows)
    consts = sediment_constants(omega, u_in, w_s, C_w, dtype)
    # the rows the inlet's [-inlet_rows:] slice takes
    geom = (ctypes.c_int * 4)(R23, C28, C38, len(range(R)[-inlet_rows:]))

    def step(S: torch.Tensor) -> torch.Tensor:
        check_step_state(S, R, C, dtype, planes=18)
        if resolve_fused(S):
            return launch_steps(SEDIMENT, S, substeps, consts, geom, planes=18)
        for _ in range(substeps):
            S = plain_sediment_step(S, **kw)
        return S

    return step
