"""Shan-Chen pseudopotential liquid-vapour scenes (counterpart of
lbm_tpu/scenes/shan_chen.py; models/shan_chen.py).

Beyond the reference, whose multiphase drivers are all colour-gradient
immiscible mixtures:

  * sc_phase_separation - spinodal decomposition from density noise at
    G < G_c = -4: liquid and vapour domains whose densities come from the
    equation of state;
  * sc_static_droplet   - a liquid droplet in its vapour: the emergent
    surface tension obeys the Laplace law dP = sigma / R;
  * sc_flat_interface   - a 1-D liquid slab: coexistence densities and
    mechanical equilibrium (equal bulk EOS pressure in both phases);
  * sc_cs_interface     - the Carnahan-Starling EOS: high density ratios
    with rho_l near the Maxwell construction.

Every scene steps through kernels/shan_chen.py: CUDA kernel 14 on the card
(one launch per step, ``substeps`` <= 4 steps per call), its plain version
on the CPU.  lbm_tpu's ``fused`` and ``interpret`` flags have no
counterpart (the device decides).  ``checkpoint_dir`` turns on
checkpoint/resume every ``checkpoint_every`` steps (``_common.drive_recorded``).

One difference from lbm_tpu, recorded in ROADMAP Queue 3:
sc_phase_separation draws its noise from numpy's
``default_rng(seed).standard_normal``, where lbm_tpu draws
``jax.random.normal(PRNGKey(seed))``; torch cannot reproduce those bits,
so the two runs start from different noise of the same law.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.shan_chen import make_sc_fused_step, resolve_eos
from ..models import shan_chen as sc
from ..ops import d2q9
from ..utils.xmath import default_device, default_float
from .ulbm import _drive


@dataclass
class SCResult:
    f: torch.Tensor
    rho: torch.Tensor
    u: torch.Tensor  # the physical velocity (m + F/2)/rho: at a stationary
    # interface the bare moment is -F/2, not zero (Guo forcing)
    steps: int
    # scene-specific scalars (0.0 where not applicable)
    rho_l: float = 0.0
    rho_v: float = 0.0
    dp: float = 0.0          # droplet: P(centre) - P(far), bulk EOS
    p_jump: float = 0.0      # flat interface: |P_l - P_v| / P_l


def _run(rho0: torch.Tensor, T: int, omega: float, G: float | None, substeps: int,
         eos: str = "sc", T_eos: float | None = None, checkpoint_dir: str | None = None,
         checkpoint_every: int = 10000) -> torch.Tensor:
    """The equilibrium at rest of ``rho0``, stepped T times."""
    if T % substeps:
        raise ValueError("T must be divisible by substeps")
    H, W = rho0.shape
    f = d2q9.equilibrium(torch.zeros((2, H, W), dtype=rho0.dtype, device=rho0.device), rho0)
    step = make_sc_fused_step(H, W, omega=omega, G=G, eos=eos, T=T_eos, substeps=substeps,
                              dtype=rho0.dtype)
    return _drive(step, f.contiguous(), T // substeps, substeps, watchdog=True,
                  checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every)


def sc_phase_separation(H: int = 128, W: int = 128, T: int = 4000, G: float = -5.0,
                        tau: float = 1.0, rho_mean: float = 0.7, noise: float = 0.02,
                        seed: int = 0, substeps: int = 1,
                        checkpoint_dir: str | None = None,
                        checkpoint_every: int = 10000, device=None,
                        dtype: torch.dtype | None = None) -> SCResult:
    """Spinodal decomposition: uniform rho near the critical density plus
    numpy-seeded noise separates into liquid and vapour for G < -4 and
    stays mixed for G > -4."""
    device, dtype = default_device(device), default_float(dtype)
    rng = np.random.default_rng(seed)
    rho0 = torch.as_tensor(rho_mean + noise * rng.standard_normal((H, W)), dtype=dtype,
                           device=device)
    f = _run(rho0, T, 1.0 / tau, G, substeps, checkpoint_dir=checkpoint_dir,
             checkpoint_every=checkpoint_every)
    rho, u, _ = sc.macroscopics(f, G)
    return SCResult(f=f, rho=rho, u=u, steps=T, rho_l=rho.max().item(), rho_v=rho.min().item())


def _tanh_disk(H, W, radius, rho_l, rho_v, width, dtype, device=None):
    r = torch.sqrt((torch.arange(H, dtype=dtype, device=device)[:, None] - H / 2.0) ** 2
                   + (torch.arange(W, dtype=dtype, device=device)[None, :] - W / 2.0) ** 2)
    return rho_v + 0.5 * (rho_l - rho_v) * (1.0 - torch.tanh((r - radius) / width))


def sc_static_droplet(H: int = 128, W: int = 128, T: int = 10000, radius: float = 25.0,
                      G: float = -5.0, tau: float = 1.0, substeps: int = 1,
                      checkpoint_dir: str | None = None,
                      checkpoint_every: int = 10000, device=None,
                      dtype: torch.dtype | None = None) -> SCResult:
    """Liquid droplet in vapour: relax a tanh disk and measure the bulk EOS
    pressure jump dP = P(centre) - P(corner); the Laplace law with the
    emergent sigma compares two radii (dP ratio = inverse radius ratio)."""
    device, dtype = default_device(device), default_float(dtype)
    rho0 = _tanh_disk(H, W, radius, 1.93, 0.16, 3.0, dtype, device)
    f = _run(rho0, T, 1.0 / tau, G, substeps, checkpoint_dir=checkpoint_dir,
             checkpoint_every=checkpoint_every)
    rho, u, _ = sc.macroscopics(f, G)
    p_c = sc.pressure(rho[H // 2, W // 2], G)
    p_far = sc.pressure(rho[0, 0], G)
    return SCResult(f=f, rho=rho, u=u, steps=T, rho_l=rho[H // 2, W // 2].item(),
                    rho_v=rho[0, 0].item(), dp=(p_c - p_far).item())


def _slab(H: int, W: int, rho_v: float, rho_l: float, dtype, device) -> torch.Tensor:
    """Liquid in rows [H/4, 3H/4), tanh edges of width 3."""
    x = torch.arange(H, dtype=dtype, device=device)[:, None]
    prof = rho_v + (rho_l - rho_v) * 0.25 * (
        (1.0 + torch.tanh((x - H / 4.0) / 3.0)) * (1.0 + torch.tanh((3.0 * H / 4.0 - x) / 3.0)))
    return prof * torch.ones((1, W), dtype=dtype, device=device)


def sc_flat_interface(H: int = 256, W: int = 128, T: int = 20000, G: float = -5.0,
                      tau: float = 1.0, substeps: int = 1,
                      checkpoint_dir: str | None = None,
                      checkpoint_every: int = 10000, device=None,
                      dtype: torch.dtype | None = None) -> SCResult:
    """1-D liquid slab (rows [H/4, 3H/4)) between vapour: coexistence
    densities and mechanical equilibrium (equal bulk EOS pressures across
    the flat interface, a stationary profile)."""
    device, dtype = default_device(device), default_float(dtype)
    f = _run(_slab(H, W, 0.16, 1.93, dtype, device), T, 1.0 / tau, G, substeps,
             checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every)
    rho, u, _ = sc.macroscopics(f, G)
    rho_l = rho[H // 2].mean().item()
    rho_v = rho[0].mean().item()
    p_l = sc.pressure(rho_l, G).item()
    p_v = sc.pressure(rho_v, G).item()
    return SCResult(f=f, rho=rho, u=u, steps=T, rho_l=rho_l, rho_v=rho_v,
                    p_jump=abs(p_l - p_v) / abs(p_l))


def sc_cs_interface(H: int = 128, W: int = 128, T: int = 20000, T_red: float = 0.7,
                    tau: float = 1.0, substeps: int = 1,
                    checkpoint_dir: str | None = None,
                    checkpoint_every: int = 10000, device=None,
                    dtype: torch.dtype | None = None) -> SCResult:
    """Carnahan-Starling liquid slab at the reduced temperature
    ``T_red = T/T_c``: a high density ratio (lbm_tpu measured 65 at 0.7 in
    float64) with rho_l within 0.2% of the Maxwell construction; the vapour
    branch under-predicts (the scheme's known thermodynamic inconsistency).
    p_jump gates mechanical equilibrium on the CS EOS pressures, over the
    liquid's ideal-gas scale."""
    device, dtype = default_device(device), default_float(dtype)
    T_eos = T_red * sc.CS_TC
    rv, rl = sc.maxwell_coexistence(T_eos)
    f = _run(_slab(H, W, rv, rl, dtype, device), T, 1.0 / tau, None, substeps, eos="cs",
             T_eos=T_eos, checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every)
    psi_fn, G, _ = resolve_eos("cs", None, T_eos, None)
    rho, u, _ = sc.macroscopics(f, G, psi_fn)
    rho_l = rho[H // 2].mean().item()
    rho_v = rho[0].mean().item()
    p_l = sc.cs_eos_pressure(torch.tensor(rho_l, dtype=torch.float64), T_eos).item()
    p_v = sc.cs_eos_pressure(torch.tensor(rho_v, dtype=torch.float64), T_eos).item()
    return SCResult(f=f, rho=rho, u=u, steps=T, rho_l=rho_l, rho_v=rho_v,
                    p_jump=abs(p_l - p_v) / (rho_l / 3.0))
