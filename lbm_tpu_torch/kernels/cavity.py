"""The ring-cavity step: plain version and CUDA kernel 22 (counterpart of
lbm_tpu/kernels/cavity_pallas.py).

The square annulus of lbm_tpu's ring_cavity on f (9, L, L): a solid block
[L/4, 3L/4)^2 in a closed box, and a circulation driven by a force (F, 0)
on the strip rows [a+5, a+55) x cols [0, a) of the left arm, a = L/4
(decompose_domain_loop.cpp:41-78).  ``plain_cavity_step`` is lbm_tpu's jnp
step (scenes/cavity.py:125-143) written with the port's ops and boundary
rules: the velocity shift by (F, 0) on the strip, BGK, the standard Guo
source on the strip only, the periodic push, halfway bounce-back on row 0,
row L-1, column 0 and column L-1, then the block's faces
(``block_wall_assignments``).  The block's inside keeps colliding and
streaming, as in lbm_tpu.  ``make_cavity_fused_step`` runs kernel 22
(csrc/cavity.cu) on a CUDA state, one launch per step and ``substeps``
steps per call, and the plain version on a CPU state.
"""

from __future__ import annotations

import ctypes

import torch

from ..boundary import bc
from ..ops import d2q9
from ..utils.xmath import resolve_fused, rounded
from . import _build
from .collide_stream import _check_substeps, check_step_state, launch_steps

CAVITY = _build.CudaKernel(
    "lbm_cavity",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_void_p])


def block_wall_assignments(L: int):
    """Bounce-back on the four faces of the central block [L/4, 3L/4)^2, as
    bc.obstacle_bounce_back assignments (lbm_tpu/scenes/cavity.py:35-52).
    The face lines sit on the block's first solid cells; each reflects the
    populations leaving the block's side like a box wall there."""
    a, b = L // 4, 3 * L // 4
    rows = cols = slice(a, b)
    return [
        # left face (col a): reflect (2, 5, 6) like a column-(C-1) wall
        (4, (rows, a), 2, 1.0), (7, (rows, a), 5, 1.0), (8, (rows, a), 6, 1.0),
        # right face (col b-1): reflect (4, 7, 8) like a column-0 wall
        (2, (rows, b - 1), 4, 1.0), (5, (rows, b - 1), 7, 1.0), (6, (rows, b - 1), 8, 1.0),
        # top face (row a): reflect (1, 5, 8) like a row-(R-1) wall
        (3, (a, cols), 1, 1.0), (7, (a, cols), 5, 1.0), (6, (a, cols), 8, 1.0),
        # bottom face (row b-1): reflect (3, 6, 7) like a row-0 wall
        (1, (b - 1, cols), 3, 1.0), (5, (b - 1, cols), 7, 1.0), (8, (b - 1, cols), 6, 1.0),
    ]


def plain_cavity_step(f: torch.Tensor, *, omega: float, force: float) -> torch.Tensor:
    """The plain version of one step: lbm_tpu's jnp step (scenes/cavity.py:
    125-143), the port's operators and boundary rules in its order."""
    L = f.shape[1]
    a = L // 4
    frows, fcols = slice(a + 5, a + 55), slice(0, a)  # the forced strip
    fg = torch.tensor([force, 0.0], dtype=f.dtype, device=f.device)
    rho = d2q9.calc_rho(f)
    u = d2q9.calc_u(f, rho)
    u[:, frows, fcols] += fg[:, None, None]  # the force as a velocity shift
    f_coll = d2q9.bgk_collision(f, d2q9.equilibrium(u, rho), omega)
    f_coll[:, frows, fcols] += d2q9.guo_source(u[:, frows, fcols], fg, omega)
    f_new = d2q9.stream(f_coll)
    for side in ("row0", "rowN", "col0", "colN"):
        f_new = bc.bounce_back(f_new, f_coll, side)
    return bc.obstacle_bounce_back(f_new, f_coll, block_wall_assignments(L))


def cavity_constants(omega: float, force: float, dtype: torch.dtype):
    """Kernel 22's 4 scalars, each as the plain version rounds it in
    ``dtype``: omega, 1 - omega, 1 - omega/2 and F."""
    return _build.c_doubles([rounded(x, dtype) for x in (omega, 1.0 - omega,
                                                         1.0 - 0.5 * omega, force)])


def make_cavity_fused_step(L: int, *, omega: float, force: float, substeps: int = 1,
                           dtype: torch.dtype = torch.float32):
    """Annulus step f (9, L, L) -> (9, L, L) for any L >= 4, ``substeps``
    steps per call: kernel 22 on a CUDA state (one launch per step), the
    plain version on a CPU state."""
    _check_substeps(substeps)
    if L < 4:
        raise ValueError(f"the ring cavity needs L >= 4, got {L}")
    consts = cavity_constants(omega, force, dtype)

    def step(f: torch.Tensor) -> torch.Tensor:
        check_step_state(f, L, L, dtype)
        if resolve_fused(f):
            return launch_steps(CAVITY, f, substeps, consts)
        for _ in range(substeps):
            f = plain_cavity_step(f, omega=omega, force=force)
        return f

    return step
