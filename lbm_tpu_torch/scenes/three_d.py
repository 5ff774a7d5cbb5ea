"""3-D scenes on the D3Q19 lattice (counterpart of lbm_tpu/scenes/three_d.py;
beyond the reference, which is strictly 2-D).

  * ``poiseuille_3d``   - body-forced plane Poiseuille between halfway
    no-slip x walls, gated against the exact discrete-wall parabola;
  * ``taylor_green_3d`` - the z-invariant Taylor-Green vortex, an exact 3-D
    Navier-Stokes solution decaying as exp(-2 nu k^2 t);
  * ``lid_cavity_3d``   - the lid-driven cavity, the y = Y-1/2 lid sliding
    along +z, with or without x end walls.

Each step is one launch of CUDA kernel 25 on the card (kernels/d3q19.py),
its plain version on the CPU, on the (19, X, Y, Z) state; ``substeps``
steps run per call, T must be divisible by it.  Every scene drives through
``_common.drive_recorded``, so ``checkpoint_dir`` checkpoints and resumes
the state every ``checkpoint_every`` steps.  lbm_tpu's ``fused`` and
``interpret`` flags have no counterpart (the device decides), nor have its
Mosaic shape conditions (``_resolve_fused3``, the VMEM check): the kernel
takes any grid.  ``mesh_shape`` waits for an ``auto_sharded`` on parallel/
(ROADMAP Queue 1 item 14) and raises if set.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.d3q19 import make_d3q19_fused_step
from ..ops import d3q19
from ..utils.xmath import default_device, default_float
from ._common import drive_recorded, no_mesh


@dataclass
class ThreeDResult:
    f: torch.Tensor          # (19, X, Y, Z)
    rho: torch.Tensor
    u: torch.Tensor          # (3, X, Y, Z)
    steps: int
    l2: float | None = None  # analytic-profile error where defined


def _run(step, f: torch.Tensor, T: int, substeps: int, checkpoint_dir: str | None,
         checkpoint_every: int) -> torch.Tensor:
    if T % substeps:
        raise ValueError("T must be divisible by substeps")
    (f,), _ = drive_recorded(lambda c: (step(c[0]),), (f.contiguous(),), T, None, None,
                             substeps=substeps, checkpoint_dir=checkpoint_dir,
                             checkpoint_every=checkpoint_every)
    return f


def _at_rest(X: int, Y: int, Z: int, device, dtype) -> torch.Tensor:
    return d3q19.equilibrium(torch.zeros((3, X, Y, Z), dtype=dtype, device=device),
                             torch.ones((X, Y, Z), dtype=dtype, device=device))


def poiseuille_3d(X: int = 24, Y: int = 8, Z: int = 8, T: int = 20000,
                  tau: float | None = None, force: float = 1e-6,
                  mesh_shape: tuple[int, int] | None = None, substeps: int = 1,
                  checkpoint_dir: str | None = None, checkpoint_every: int = 10000,
                  device=None, dtype: torch.dtype | None = None) -> ThreeDResult:
    """Body-forced plane Poiseuille: no-slip walls on the x faces, periodic
    y and z, the Guo force along z.  Steady analytic profile between the
    halfway walls at -1/2 and X-1/2:

        uz(x) = F/(2 rho nu) (x + 1/2)(X - 1/2 - x)

    ``l2`` is the relative L2 error of the computed profile (the 3-D version
    of the reference's hard accuracy gate,
    horizontal_poiseuille_test.cpp:163-175).  The default tau is the magic
    sqrt(3/16) + 1/2, at which the halfway bounce-back slip vanishes
    (lbm_tpu measured L2 = 1.4e-11 in f64)."""
    no_mesh(mesh_shape)
    device, dtype = default_device(device), default_float(dtype)
    tau = float(np.sqrt(3.0 / 16.0) + 0.5) if tau is None else tau
    omega = 1.0 / tau
    nu = (tau - 0.5) / 3.0
    step = make_d3q19_fused_step(X, Y, Z, omega=omega, force_z=force, x_walls=True,
                                 substeps=substeps, dtype=dtype)
    f = _run(step, _at_rest(X, Y, Z, device, dtype), T, substeps, checkpoint_dir,
             checkpoint_every)
    rho = d3q19.calc_rho(f)
    u = d3q19.calc_u(f, rho)
    u[2] = u[2] + 0.5 * force / rho
    prof = u[2].mean(dim=(1, 2)).cpu().double().numpy()
    x = np.arange(X)
    exact = force / (2.0 * nu) * (x + 0.5) * (X - 0.5 - x)
    l2 = float(np.sqrt(((prof - exact) ** 2).sum() / (exact ** 2).sum()))
    return ThreeDResult(f=f, rho=rho, u=u, steps=T, l2=l2)


def taylor_green_3d(N: int = 32, T: int = 400, tau: float = 0.8, u0: float = 0.02,
                    mesh_shape: tuple[int, int] | None = None, substeps: int = 1,
                    checkpoint_dir: str | None = None, checkpoint_every: int = 10000,
                    device=None, dtype: torch.dtype | None = None) -> ThreeDResult:
    """z-invariant Taylor-Green vortex on a triply periodic N^3 box, an exact
    3-D Navier-Stokes solution with uniform decay exp(-2 nu k^2 t),
    k = 2 pi / N.  ``l2`` is the relative error of the decayed velocity
    field against the analytic solution at t = T."""
    no_mesh(mesh_shape)
    device, dtype = default_device(device), default_float(dtype)
    omega = 1.0 / tau
    nu = (tau - 0.5) / 3.0
    k = 2.0 * np.pi / N
    x = (np.arange(N) + 0.5) * k
    Xg, Yg = np.meshgrid(x, x, indexing="ij")
    u_init = np.zeros((3, N, N, N))
    u_init[0] = (u0 * np.cos(Xg) * np.sin(Yg))[:, :, None]
    u_init[1] = (-u0 * np.sin(Xg) * np.cos(Yg))[:, :, None]
    rho2 = 1.0 - (3.0 * u0 * u0 / 4.0) * (np.cos(2 * Xg) + np.cos(2 * Yg))
    rho0 = np.repeat(rho2[:, :, None], N, axis=2)
    f = d3q19.equilibrium(torch.as_tensor(u_init, dtype=dtype, device=device),
                          torch.as_tensor(rho0, dtype=dtype, device=device))
    step = make_d3q19_fused_step(N, N, N, omega=omega, substeps=substeps, dtype=dtype)
    f = _run(step, f, T, substeps, checkpoint_dir, checkpoint_every)
    rho = d3q19.calc_rho(f)
    u = d3q19.calc_u(f, rho)
    exact = u_init * np.exp(-2.0 * nu * k * k * T)
    num = ((u.cpu().double().numpy() - exact) ** 2).sum()
    return ThreeDResult(f=f, rho=rho, u=u, steps=T,
                        l2=float(np.sqrt(num / (exact ** 2).sum())))


def lid_cavity_3d(X: int = 8, Y: int = 64, Z: int = 128, T: int = 20000,
                  Re: float = 100.0, u_lid: float = 0.05, x_walls: bool = True,
                  mesh_shape: tuple[int, int] | None = None, substeps: int = 1,
                  checkpoint_dir: str | None = None, checkpoint_every: int = 10000,
                  device=None, dtype: torch.dtype | None = None) -> ThreeDResult:
    """3-D lid-driven cavity: no-slip on every face except the y = Y-1/2 lid
    sliding along +z at ``u_lid``; viscosity from ``Re = u_lid Z / nu``.
    ``x_walls=False`` makes x periodic: the flow is then exactly x-invariant
    (the quasi-2-D degeneracy).  With ``x_walls=True`` the end walls brake
    the core vortex, and the dynamics are mirror-symmetric in x.

    The wall rules follow lbm_tpu's order, x, then y (the lid on y = Y-1),
    then z, so the z faces win the shared edges: the lid's corrections at
    y = Y-1, z = 0 and Z-1 give way to the plain reflection."""
    no_mesh(mesh_shape)
    device, dtype = default_device(device), default_float(dtype)
    nu = u_lid * Z / Re
    omega = 1.0 / (3.0 * nu + 0.5)
    step = make_d3q19_fused_step(X, Y, Z, omega=omega, x_walls=x_walls, y_walls=True,
                                 z_walls=True, lid_u=u_lid, substeps=substeps, dtype=dtype)
    f = _run(step, _at_rest(X, Y, Z, device, dtype), T, substeps, checkpoint_dir,
             checkpoint_every)
    rho = d3q19.calc_rho(f)
    return ThreeDResult(f=f, rho=rho, u=d3q19.calc_u(f, rho), steps=T)
