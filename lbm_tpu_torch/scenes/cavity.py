"""Ring (square-annulus) forced cavity (counterpart of lbm_tpu/scenes/cavity.py).

The reference's decompose_domain_loop.cpp splits a square annulus around a
solid block into four bound subdomains and drives a circulation with a
Guo-forced strip (:65-68, :156-163).  As in lbm_tpu, one grid holds the
whole annulus with the block as interior bounce-back walls.  Each step is
one launch of kernel 22 on the card (kernels/cavity.py), its plain version
on the CPU.

lbm_tpu's ``fused`` and ``interpret`` flags have no counterpart (the device
decides); its ``mesh_shape`` (the step sharded over a device mesh) waits for
ROADMAP Queue 1 item 14 and raises if set.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass

import torch

from ..kernels.cavity import make_cavity_fused_step
from ..ops import d2q9
from ..utils.xmath import default_device, default_float
from ._common import no_mesh
from .ulbm import _drive


@dataclass
class CavityResult:
    f: torch.Tensor
    rho: torch.Tensor
    u: torch.Tensor
    steps: int


def ring_cavity(L: int = 512, T: int = 1000, force: float = 3e-3,
                tau: float | None = None, mesh_shape: tuple[int, int] | None = None,
                substeps: int = 1, device=None,
                dtype: torch.dtype | None = None) -> CavityResult:
    """Force-driven circulation in a square annulus of width L/4.

    Workload parity: L=512, tau=sqrt(3/16)+1/2, F=(3e-3, 0) applied on rows
    [L/4+5, L/4+55) of the left strip (decompose_domain_loop.cpp:41-78).
    ``substeps`` steps run per call of the step (one kernel-22 launch each
    on the card); T must be divisible by it.

    Stability envelope (lbm_tpu's measurement): the reference's F=3e-3 is
    super-critical: continuous forcing accelerates the annulus past lattice
    validity (max|u| > 0.5 by t=500, non-finite by t~2000-2500), so runs
    past T=1500 at F >= 1e-3 warn up front, and the NaN watchdog stops a
    run whose fields went non-finite (checked every 1000 steps).  F=3e-5
    gives a steady circulation over 50k steps (max|u| = 0.023,
    anti-symmetric arm flow +-1.07e-2)."""
    if force >= 1e-3 and T > 1500:
        warnings.warn(
            f"ring_cavity: F={force:g} is super-critical (reference "
            "workload quirk, decompose_domain_loop.cpp:41-78) — fields go "
            "non-finite by t~2000-2500; use force=3e-5 for T > 1500",
            stacklevel=2)
    no_mesh(mesh_shape)
    if T % substeps:
        raise ValueError("T must be divisible by substeps")
    device, dtype = default_device(device), default_float(dtype)
    tau = tau if tau is not None else math.sqrt(3.0 / 16.0) + 0.5
    step = make_cavity_fused_step(L, omega=1.0 / tau, force=force, substeps=substeps,
                                  dtype=dtype)
    f = d2q9.equilibrium(torch.zeros((2, L, L), dtype=dtype, device=device),
                         torch.ones((L, L), dtype=dtype, device=device))
    f = _drive(step, f, T // substeps, substeps, watchdog=True)
    rho = d2q9.calc_rho(f)
    return CavityResult(f=f, rho=rho, u=d2q9.calc_u(f, rho), steps=T)
