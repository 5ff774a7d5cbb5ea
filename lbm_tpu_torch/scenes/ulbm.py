"""ULBM (KBC) and Smagorinsky scenes (counterpart of lbm_tpu/scenes/ulbm.py).

  * ulbm_poiseuille   — test/ulbm_poiseuille.cpp:61-147 (KBC channel,
                        kernels/channel.py family "kbc": CUDA kernel 4)
  * ulbm_double_shear — test/ulbm_double_shear_flow.cpp:42-143 (periodic
                        KBC, kernels/collide_stream.py: CUDA kernel 3)
  * les_double_shear  — the same shear layer under Smagorinsky-BGK
                        (kernels/les.py: CUDA kernel 5; beyond the reference)

Each scene steps through one step function: the CUDA kernel when the state
lies on a CUDA device, its plain PyTorch version on the CPU.  lbm_tpu's
``fused`` and ``interpret`` flags have no counterpart (the device decides),
nor have ``checkpoint_dir``/``checkpoint_every`` (they wait for
io/checkpoint, ROADMAP Queue 1 item 12) and ``ulbm_poiseuille_df64``
(native float64 replaces it, Queue 1 item 15).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.channel import make_channel_fused_step
from ..kernels.collide_stream import make_kbc_fused_step
from ..kernels.les import make_les_fused_step
from ..models import kbc
from ..ops import d2q9
from ..utils import observe
from ..utils.xmath import default_device, default_float
from .channel import converged_run, poiseuille_l2

CHUNK = 1000  # steps between progress logs (and NaN checks where taken)


@dataclass
class ULBMResult:
    f: torch.Tensor
    m0: torch.Tensor
    m1: torch.Tensor  # the velocity m1 / m0, as lbm_tpu names it
    steps: int
    l2: float | None = None  # vs the analytic parabola (poiseuille only)
    #: (step, |mean/old_mean - 1|) samples from the convergence watcher
    #: (tolerance mode only)
    watch: list | None = None


def _ulbm_l2(u_x: torch.Tensor, u_max: float) -> float:
    """The reference's row-averaged relative L2 of u_x against the analytic
    parabola (horizontal_poiseuille_test.cpp:163-173), applied to the KBC
    channel's cross-channel profile."""
    return poiseuille_l2(u_x.cpu().numpy(), u_max)


def _mean_ux(f: torch.Tensor) -> torch.Tensor:
    """The watched quantity: mean velocity u_x = m1_x / m0, as lbm_tpu's jnp
    path watches it (scenes/ulbm.py:147)."""
    return (d2q9.calc_momentum(f)[0] / d2q9.calc_rho(f)).mean()


def _drive(step, f: torch.Tensor, calls: int, substeps: int = 1,
           watchdog: bool = False) -> torch.Tensor:
    """``calls`` calls of ``step`` (``substeps`` steps each), logging progress
    every ~CHUNK steps and, with ``watchdog``, checking for NaNs there."""
    meter = observe.StepMeter(f[0].numel(), f.device, total_steps=calls * substeps)
    per_chunk = max(1, CHUNK // substeps)
    done = 0
    while done < calls:
        n = min(per_chunk, calls - done)
        for _ in range(n):
            f = step(f)
        done += n
        meter.update(n * substeps)
        if watchdog:
            observe.check_finite(f, done * substeps)
    return f


def ulbm_poiseuille(H: int = 128, W: int = 128, T: int = 300000,
                    nu: float = 1e-4, u_max: float = 0.05,
                    tolerance: float | None = None,
                    t_interval: int = 100,
                    device=None, dtype: torch.dtype | None = None) -> ULBMResult:
    """KBC channel with pressure-periodic inlet/outlet and no-slip side
    walls.  Parameters cite reference test/ulbm_poiseuille.cpp:64-85.

    The reference test runs a flat 300k steps; ``tolerance`` adds the
    relative-mean-u_x convergence watcher of its single-phase siblings
    (horizontal_poiseuille_test.cpp:95,112-120) every ``t_interval`` steps,
    recorded in ``watch``.  ``l2`` is the reference's row-averaged relative
    L2 of u_x against the analytic parabola.  ``device`` defaults to the
    first CUDA device when there is one; ``dtype`` to float64."""
    device = default_device(device)
    dtype = default_float(dtype)
    omega = 1.0 / (0.5 + 3.0 * nu)
    p_grad = 8.0 * nu * u_max / (W * W)
    rho_outlet = 1.0
    rho_inlet = 3.0 * (H - 1) * p_grad + rho_outlet
    model = kbc.KBCModel(s2=omega)
    step = make_channel_fused_step(H, W, omega, rho_inlet, rho_outlet, dtype,
                                   family="kbc")
    # the reference test starts from m0 = 1, u = 0; its first collide
    # rebuilds f from those moments, so the equilibrium there is the same start
    f = model.equilibrium(torch.ones((H, W), dtype=dtype, device=device),
                          torch.zeros((2, H, W), dtype=dtype, device=device))
    f, steps, watch = converged_run(step, f, T, _mean_ux, t_interval, tolerance)
    m0, u = model.macroscopics(f)
    return ULBMResult(f=f, m0=m0, m1=u, steps=steps, l2=_ulbm_l2(u[0], u_max),
                      watch=watch)


def double_shear_init(H: int, W: int, u_max: float, alpha: float = 80.0,
                      delta: float = 0.05, device=None,
                      dtype: torch.dtype | None = None):
    """Double shear layer initial condition (m0, u), made in numpy float64.
    cites reference test/ulbm_double_shear_flow.cpp:42-63"""
    device = default_device(device)
    dtype = default_float(dtype)
    r = np.arange(H)[:, None] * np.ones((1, W))
    c = np.ones((H, 1)) * np.arange(W)[None, :]
    ux = u_max * np.tanh(alpha * (0.25 * H - np.abs(c - 0.5 * H)))
    uy = u_max * delta * np.sin(6.2832 * (r + 0.25 * H) / H)
    m0 = np.ones((H, W))
    u = np.stack([ux, uy], axis=0)
    return (torch.as_tensor(m0, dtype=dtype, device=device),
            torch.as_tensor(u, dtype=dtype, device=device))


def ulbm_double_shear(H: int = 128, W: int = 128, T: int = 10000,
                      nu: float = 1.70766666e-4, u_max: float = 0.02,
                      device=None, dtype: torch.dtype | None = None) -> ULBMResult:
    """Doubly periodic double shear layer under KBC.
    cites reference test/ulbm_double_shear_flow.cpp:65-143 (its per-edge
    periodic copies equal fully periodic streaming).

    The default workload is an under-resolved Re~1.5e4 shear; lbm_tpu
    measured it finite through the 10k steps in float64 (population max
    0.445 -> 0.505) and blowing up near 6k steps in float32, so, as in
    lbm_tpu, this scene runs no NaN watchdog."""
    device = default_device(device)
    dtype = default_float(dtype)
    omega = 1.0 / (0.5 + 3.0 * nu)
    model = kbc.KBCModel(s2=omega)
    m0, u = double_shear_init(H, W, u_max, device=device, dtype=dtype)
    f = _drive(make_kbc_fused_step(H, W, omega, dtype),
               model.equilibrium(m0, u), T)
    m0_f, u_f = model.macroscopics(f)
    return ULBMResult(f=f, m0=m0_f, m1=u_f, steps=T)


def les_double_shear(H: int = 128, W: int = 128, T: int = 10000,
                     nu: float = 1.70766666e-4, u_max: float = 0.02,
                     cs_smag: float = 0.17, substeps: int = 1,
                     device=None, dtype: torch.dtype | None = None) -> ULBMResult:
    """The double shear layer of ulbm_double_shear
    (ulbm_double_shear_flow.cpp:42-63) under the Smagorinsky-BGK model
    (models/les.py) instead of KBC; beyond the reference.  ``substeps``
    steps per call of the step (T must be a multiple); the NaN watchdog
    runs every ~CHUNK steps."""
    device = default_device(device)
    dtype = default_float(dtype)
    if T % substeps:
        raise ValueError("T must be divisible by substeps")
    tau0 = 0.5 + 3.0 * nu
    m0, u = double_shear_init(H, W, u_max, device=device, dtype=dtype)
    step = make_les_fused_step(H, W, tau0=tau0, cs_smag=cs_smag, dtype=dtype,
                               substeps=substeps)
    f = _drive(step, d2q9.equilibrium(u, m0), T // substeps, substeps,
               watchdog=True)
    rho = d2q9.calc_rho(f)
    return ULBMResult(f=f, m0=rho, m1=d2q9.calc_u(f, rho), steps=T)
