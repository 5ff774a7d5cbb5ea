"""The thermal steps: plain versions and CUDA kernels 23 and 24 (counterpart
of lbm_tpu/kernels/thermal_pallas.py).

State ``S (P, R, C) = [f (9), g (9 or 5)]``: a BGK fluid driven by the
Boussinesq buoyancy (g_beta theta, 0) as a standard Guo force, with the
half-force velocity shift, and the temperature deviation theta carried by a
D2Q9 (P = 18) or D2Q5 (P = 14, ``scalar_lattice='d2q5'``) advection-
diffusion distribution advected at that velocity.

  * ``plain_rb_step`` is lbm_tpu's jnp Rayleigh-Benard step
    (scenes/thermal.py:142-200) on S: periodic columns, fluid halfway
    bounce-back on rows 0 and R-1, incoming-only ADE-Dirichlet temperature
    walls at theta_w = +1/2 (row 0) and -1/2 (row R-1).  Kernel 23
    (csrc/thermal.cu) on the card.
  * ``plain_heated_cavity_step`` is lbm_tpu's jnp de Vahl Davis step
    (:401-463): fluid no-slip on all four walls, rows first; temperature
    ADE-Dirichlet on the columns (hot column 0, cold column C-1), then
    adiabatic bounce-back on the rows, which win the corners.  Kernel 24.

The D2Q5 collision is written in the TPU kernel's even/odd pairing
(thermal_pallas.py:103-116, ``d2q5_collision``), where lbm_tpu's jnp step
takes ``bgk_collision`` on its ``d2q5_equilibrium``: the two agree to
rounding, and the kernels reproduce this one bit for bit.  Each
``make_*_fused_step`` runs its kernel on a CUDA state, one launch per step
and ``substeps`` steps per call, and the plain version on a CPU state.
"""

from __future__ import annotations

import ctypes

import torch

from ..boundary import bc
from ..core import lattice as lat
from ..ops import d2q9
from ..utils.xmath import resolve_fused, rounded
from . import _build
from .collide_stream import _check_substeps, check_step_state, launch_steps

CX, CY = lat.CX, lat.CY
W5Q = tuple(float(v) for v in lat.W5)
SCALAR_PLANES = {"d2q9": 9, "d2q5": 5}

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_void_p]
# one instance per scalar lattice, keyed by its number of planes
THERMAL = {q: _build.CudaKernel(f"lbm_thermal_rb_q{q}", _ARGS) for q in (9, 5)}
HEATED_CAVITY = {q: _build.CudaKernel(f"lbm_heated_cavity_q{q}", _ARGS) for q in (9, 5)}


def scalar_planes(scalar_lattice: str) -> int:
    """The temperature's number of planes: 9 for 'd2q9', 5 for 'd2q5'."""
    if scalar_lattice not in SCALAR_PLANES:
        raise ValueError(f"unknown scalar_lattice {scalar_lattice!r}")
    return SCALAR_PLANES[scalar_lattice]


def d2q5_stream(g: torch.Tensor) -> torch.Tensor:
    """Periodic push streaming on the 5 scalar planes."""
    return torch.stack([g[0]] + [torch.roll(g[k], shifts=(CX[k], CY[k]), dims=(0, 1))
                                 for k in range(1, 5)])


def d2q5_collision(g: torch.Tensor, ux, uy, theta, omega_g: float) -> torch.Tensor:
    """BGK of the 5 scalar planes toward w_k theta (1 + 3 c.u + 4.5 (c.u)^2 -
    1.5 u.u), each opposite pair split into an even and an odd part
    (lbm_tpu/kernels/thermal_pallas.py:103-116)."""
    uu15 = 1.5 * (ux * ux + uy * uy)
    th6 = W5Q[1] * theta
    out = [None] * 5
    out[0] = (1.0 - omega_g) * g[0] + omega_g * (W5Q[0] * theta * (1.0 - uu15))
    for kp, km, cu in ((1, 3, ux), (2, 4, uy)):
        even = th6 * (1.0 + 4.5 * cu * cu - uu15)
        odd = th6 * (3.0 * cu)
        out[kp] = (1.0 - omega_g) * g[kp] + omega_g * (even + odd)
        out[km] = (1.0 - omega_g) * g[km] + omega_g * (even - odd)
    return torch.stack(out)


def buoyant_velocity(f: torch.Tensor, g: torch.Tensor, g_beta: float):
    """(rho, theta, u, force) at the start of a step: rho and theta as
    sequential sums, the Boussinesq force (g_beta theta, 0) and u = m1 / rho
    with the half-force shift u += 0.5 F / rho."""
    rho = d2q9.calc_rho(f)
    theta = g[0]
    for k in range(1, g.shape[0]):
        theta = theta + g[k]
    force = torch.stack([g_beta * theta, torch.zeros_like(theta)])
    u = d2q9.calc_u(f, rho) + 0.5 * force / rho
    return rho, theta, u, force


def _collide(S: torch.Tensor, omega_f: float, omega_g: float, g_beta: float):
    """Both collisions of lbm_tpu's jnp step: BGK + Guo buoyancy on f, BGK
    on g (D2Q9 equilibrium with theta for rho, or ``d2q5_collision``)."""
    f, g = S[:9], S[9:]
    rho, theta, u, force = buoyant_velocity(f, g, g_beta)
    f_coll = d2q9.bgk_collision(f, d2q9.equilibrium(u, rho), omega_f) \
        + d2q9.guo_source(u, force, omega_f)
    if g.shape[0] == 5:
        return f_coll, d2q5_collision(g, u[0], u[1], theta, omega_g)
    return f_coll, d2q9.bgk_collision(g, d2q9.equilibrium(u, theta), omega_g)


def _wall_eq(S: torch.Tensor, n: int) -> torch.Tensor:
    """The hot wall's resting equilibrium 0.5 w_k along a wall of n cells;
    bc.ade_dirichlet doubles it (lbm_tpu: g_eq_hot, scenes/thermal.py:172)."""
    w = lat.tensor(lat.W, device=S.device, dtype=S.dtype)[:, None]
    return 0.5 * w * torch.ones((1, n), dtype=S.dtype, device=S.device)


def plain_rb_step(S: torch.Tensor, *, omega_f: float, omega_g: float,
                  g_beta: float) -> torch.Tensor:
    """The plain version of one Rayleigh-Benard step (kernel 23): lbm_tpu's
    jnp step (scenes/thermal.py:174-198) on S."""
    f_coll, g_coll = _collide(S, omega_f, omega_g, g_beta)
    f_new = d2q9.stream(f_coll)
    f_new = bc.bounce_back(f_new, f_coll, "row0")
    f_new = bc.bounce_back(f_new, f_coll, "rowN")
    if g_coll.shape[0] == 5:
        # halfway ADE Dirichlet, incoming-only: one direction per wall;
        # 2 w theta_w = 2 (1/6) (+-1/2) = +-1/6
        g_new = d2q5_stream(g_coll)
        g_new[1, 0] = -g_coll[3, 0] + W5Q[1]
        g_new[3, -1] = -g_coll[1, -1] + (-W5Q[1])
    else:
        g_eq_hot = _wall_eq(S, S.shape[2])
        g_new = d2q9.stream(g_coll)
        g_new = bc.ade_dirichlet(g_new, g_coll, "row0", g_eq_hot, incoming_only=True)
        g_new = bc.ade_dirichlet(g_new, g_coll, "rowN", -g_eq_hot, incoming_only=True)
    return torch.cat([f_new, g_new])


def plain_heated_cavity_step(S: torch.Tensor, *, omega_f: float, omega_g: float,
                             g_beta: float) -> torch.Tensor:
    """The plain version of one heated-cavity step (kernel 24): lbm_tpu's
    jnp step (scenes/thermal.py:421-461) on S."""
    f_coll, g_coll = _collide(S, omega_f, omega_g, g_beta)
    f_new = d2q9.stream(f_coll)
    for side in ("row0", "rowN", "col0", "colN"):
        f_new = bc.bounce_back(f_new, f_coll, side)
    if g_coll.shape[0] == 5:
        # the column ADE Dirichlet (incoming 2 at column 0, 4 at column C-1),
        # then the adiabatic rows' bounce-back
        g_new = d2q5_stream(g_coll)
        g_new[2, :, 0] = -g_coll[4, :, 0] + W5Q[1]
        g_new[4, :, -1] = -g_coll[2, :, -1] + (-W5Q[1])
        g_new[1, 0] = g_coll[3, 0]
        g_new[3, -1] = g_coll[1, -1]
    else:
        g_eq_hot = _wall_eq(S, S.shape[1])
        g_new = d2q9.stream(g_coll)
        g_new = bc.ade_dirichlet(g_new, g_coll, "col0", g_eq_hot, incoming_only=True)
        g_new = bc.ade_dirichlet(g_new, g_coll, "colN", -g_eq_hot, incoming_only=True)
        g_new = bc.bounce_back(g_new, g_coll, "row0")
        g_new = bc.bounce_back(g_new, g_coll, "rowN")
    return torch.cat([f_new, g_new])


def thermal_constants(omega_f: float, omega_g: float, g_beta: float, dtype: torch.dtype):
    """Kernels 23 and 24's 6 scalars, each as the plain versions round it in
    ``dtype``: omega_f, 1 - omega_f, 1 - omega_f/2, omega_g, 1 - omega_g,
    g_beta."""
    return _build.c_doubles([rounded(x, dtype) for x in (
        omega_f, 1.0 - omega_f, 1.0 - 0.5 * omega_f, omega_g, 1.0 - omega_g, g_beta)])


def _make_step(kernels: dict, plain, R: int, C: int, omega_f: float, omega_g: float,
               g_beta: float, substeps: int, dtype: torch.dtype, scalar_lattice: str):
    _check_substeps(substeps)
    if R < 4 or C < 4:
        raise ValueError(f"the thermal steps need R >= 4 and C >= 4, got {R}x{C}")
    q = scalar_planes(scalar_lattice)
    kernel = kernels[q]
    consts = thermal_constants(omega_f, omega_g, g_beta, dtype)
    kw = dict(omega_f=omega_f, omega_g=omega_g, g_beta=g_beta)

    def step(S: torch.Tensor) -> torch.Tensor:
        check_step_state(S, R, C, dtype, planes=9 + q)
        if resolve_fused(S):
            return launch_steps(kernel, S, substeps, consts, planes=9 + q)
        for _ in range(substeps):
            S = plain(S, **kw)
        return S

    return step


def make_thermal_fused_step(R: int, C: int, *, omega_f: float, omega_g: float,
                            g_beta: float, substeps: int = 1,
                            dtype: torch.dtype = torch.float32,
                            scalar_lattice: str = "d2q9"):
    """Rayleigh-Benard step S (18 or 14, R, C) -> S for any R, C >= 4,
    ``substeps`` steps per call: kernel 23 on a CUDA state (one launch per
    step), ``plain_rb_step`` on a CPU state."""
    return _make_step(THERMAL, plain_rb_step, R, C, omega_f, omega_g, g_beta, substeps,
                      dtype, scalar_lattice)


def make_heated_cavity_fused_step(R: int, C: int, *, omega_f: float, omega_g: float,
                                  g_beta: float, substeps: int = 1,
                                  dtype: torch.dtype = torch.float32,
                                  scalar_lattice: str = "d2q9"):
    """Heated-cavity step S (18 or 14, R, C) -> S for any R, C >= 4,
    ``substeps`` steps per call: kernel 24 on a CUDA state (one launch per
    step), ``plain_heated_cavity_step`` on a CPU state."""
    return _make_step(HEATED_CAVITY, plain_heated_cavity_step, R, C, omega_f, omega_g,
                      g_beta, substeps, dtype, scalar_lattice)
