"""Channel-flow scenes (counterpart of lbm_tpu/scenes/channel.py).

Ported so far: ``horizontal_poiseuille`` — test/horizontal_poiseuille_test.cpp,
the reference's hard accuracy gate (L2 <= 1e-11 against the analytic
parabola).  The step is kernels/channel.py's: CUDA kernel 2 when the state
lies on a CUDA device, the plain model step on the CPU, both driven by the
one converged-run loop below, which scenes/ulbm.py's ``ulbm_poiseuille``
shares.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..kernels.channel import make_channel_fused_step
from ..ops import d2q9
from ..utils import observe
from ..utils.xmath import default_device, default_float

TAU_DEFAULT = math.sqrt(3.0 / 16.0) + 0.5  # cites horizontal_poiseuille_test.cpp:55


@dataclass
class ChannelResult:
    f: torch.Tensor
    rho: torch.Tensor
    u: torch.Tensor
    steps: int
    l2: float | None = None


def poiseuille_analytic(W: int, u_max: float) -> np.ndarray:
    """Analytic parabola u(y) = -4 u_max/W^2 * y (y - W), y = idx + 1/2.
    cites reference test/horizontal_poiseuille_test.cpp:163-164"""
    y = np.linspace(1, W, W) - 0.5
    return -4.0 * u_max / (W * W) * y * (y - W)


def poiseuille_l2(u_x: np.ndarray, u_max: float) -> float:
    """Reference's L2 metric: row-wise relative L2 averaged over ALL rows
    but summed only over interior rows.
    cites reference test/horizontal_poiseuille_test.cpp:163-173"""
    H, W = u_x.shape
    ua = poiseuille_analytic(W, u_max)
    denom = 1.0 / np.sqrt(np.sum(ua**2))
    errors = np.zeros(H)
    for r in range(1, H - 1):
        errors[r] = np.sqrt(np.sum((u_x[r] - ua) ** 2)) * denom
    return float(np.sum(errors) / H)


def converged_run(step, f: torch.Tensor, T: int,
                  watched: Callable[[torch.Tensor], torch.Tensor],
                  t_interval: int = 100, tolerance: float | None = 1e-12):
    """Run up to T steps: one step, then chunks of ``t_interval`` steps.
    Before each chunk the watcher takes ``mean = watched(f)`` and records
    ``(steps, |mean / old_mean - 1|)``; the run stops when that drops
    below ``tolerance`` (reference test/horizontal_poiseuille_test.cpp:
    93-126; lbm_tpu/scenes/ulbm.py:73-91).  ``tolerance=None`` runs a flat
    T steps with no watcher.  The NaN watchdog runs after every chunk.
    Returns ``(f, steps, watch)``, ``watch`` None without a tolerance."""
    meter = observe.StepMeter(f[0].numel(), f.device, total_steps=T)
    f = step(f)
    steps = 1
    meter.update(1)
    old_mean = 1.0
    watch = None if tolerance is None else []
    while steps < T:
        if tolerance is not None:
            mean = float(watched(f))
            rel = abs(mean / old_mean - 1.0) if old_mean != 0.0 else math.inf
            watch.append((steps, rel))
            if rel < tolerance:
                break
            old_mean = mean
        n = min(t_interval, T - steps)
        for _ in range(n):
            f = step(f)
        steps += n
        meter.update(n)
        observe.check_finite(f, steps)
    return f, steps, watch


def horizontal_poiseuille(H: int = 21, W: int = 21, T: int = 8301,
                          u_max: float = 1.030985714e-1,
                          tau: float = TAU_DEFAULT,
                          device=None, dtype: torch.dtype | None = None) -> ChannelResult:
    """Pressure-driven flow along rows, no-slip walls on the first/last
    column, incompressible equilibrium.  Parameters cite
    reference test/horizontal_poiseuille_test.cpp:50-67.  ``device``
    defaults to the first CUDA device when there is one; ``dtype`` to
    float64, the reference's precision."""
    device = default_device(device)
    dtype = default_float(dtype)
    omega = 1.0 / tau
    nu = (2.0 * tau - 1.0) / 6.0
    p_grad = 8.0 * nu * u_max / (W * W)
    rho_outlet = 1.0
    rho_inlet = 3.0 * (H - 1) * p_grad + rho_outlet

    step = make_channel_fused_step(H, W, omega, rho_inlet, rho_outlet, dtype)
    f = d2q9.incomp_equilibrium(
        torch.zeros((2, H, W), dtype=dtype, device=device),
        torch.ones((H, W), dtype=dtype, device=device))
    f, steps, _ = converged_run(step, f, T,
                                lambda g: d2q9.calc_momentum(g)[0].mean())
    rho = d2q9.calc_rho(f)
    u = d2q9.calc_momentum(f)
    l2 = poiseuille_l2(u[0].cpu().numpy(), u_max)
    return ChannelResult(f=f, rho=rho, u=u, steps=steps, l2=l2)
