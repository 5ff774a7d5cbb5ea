"""Channel-flow scenes (counterpart of lbm_tpu/scenes/channel.py).

Each scene reproduces one reference program or lbm_tpu's extension of it:
  * horizontal_poiseuille: test/horizontal_poiseuille_test.cpp, the hard
    accuracy gate (L2 <= 1e-11 against the analytic parabola); kernel 2;
  * vertical_poiseuille: test/vertical_poiseuille_test.cpp; kernel 9;
  * gravity_channel: test/gravity_test.cpp; kernel 9;
  * specular_channel: test/specular_boundary_test.cpp; kernel 9;
  * free_stream: test/free_stream_test.cpp, with the physical-units TOML
    and its snapshots; kernel 9;
  * trt_poiseuille: the Poiseuille gate under TRT at any tau; kernel 9;
  * power_law_channel: a force-driven power-law / Bingham channel.  It has
    no TPU kernel in lbm_tpu and none here: plain tensor ops on either
    device.
Every kernel scene runs one step function on both devices (the kernel when
the state lies on a CUDA device, the plain model step on the CPU), driven
by the converged-run loop below, which scenes/ulbm.py shares.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..boundary import bc
from ..io.snapshots import SnapshotWriter, to_numpy
from ..kernels.channel import make_channel_fused_step, make_channel_variant_step
from ..models import trt
from ..models.power_law import apparent_tau
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
    snapshots: dict | None = None


class SnapshotRecorder:
    """Records the reference programs' per-snapshot fields at the
    [simulation] cadence: at every t % cadence == 0, t = 0 included
    (free_stream_test.cpp:79-88), in host memory or streamed to disk through
    io.snapshots.SnapshotWriter under ``prefix``.  ``fields(state)`` maps
    the scene's state to {name: tensor}."""

    def __init__(self, cadence: int, fields, prefix: str | None = None):
        self.cadence = cadence
        self.fields = fields
        self.frames: dict[str, list] = {}
        self.writer = SnapshotWriter(prefix) if prefix else None

    def record(self, state) -> None:
        for name, arr in self.fields(state).items():
            if self.writer:
                self.writer.append(name, arr)
            else:
                self.frames.setdefault(name, []).append(to_numpy(arr))

    def run(self, chunk, state, T: int):
        """Advance ``state`` T steps through ``chunk(state, n)``, recording
        before every ``cadence``-step chunk."""
        done = 0
        while done < T:
            self.record(state)
            n = min(self.cadence, T - done)
            state = chunk(state, n)
            done += n
            observe.check_finite(state, done)
        return state

    def result(self) -> dict | None:
        if self.writer:
            self.writer.close()
            return None
        return {k: np.stack(v) for k, v in self.frames.items() if v}


def single_phase_fields(incompressible: bool = True):
    """The single-phase programs' snapshot triple ux, uy, ps = rho/3
    (free_stream_test.cpp:142-145): the momentum when ``incompressible``
    (calc_incomp_u), else momentum / rho."""

    def fields(f):
        rho = d2q9.calc_rho(f)
        u = d2q9.calc_momentum(f) if incompressible else d2q9.calc_u(f, rho)
        return {"ux": u[0], "uy": u[1], "ps": rho / 3.0}

    return fields


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
                  watched: Callable[[torch.Tensor], torch.Tensor] | None,
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
    device, dtype = default_device(device), default_float(dtype)
    step = make_channel_fused_step(H, W, 1.0 / tau, _inlet_density(H, W, u_max, tau),
                                   1.0, dtype)
    f = _equilibrium_state(H, W, True, device, dtype)
    f, steps, _ = converged_run(step, f, T, lambda g: d2q9.calc_momentum(g)[0].mean())
    u = d2q9.calc_momentum(f)
    return ChannelResult(f=f, rho=d2q9.calc_rho(f), u=u, steps=steps,
                         l2=poiseuille_l2(u[0].cpu().numpy(), u_max))


def _inlet_density(H: int, W: int, u_max: float, tau: float) -> float:
    """The virtual inlet density of the pressure-driven programs, outlet 1:
    3 (H-1) dp/dx + 1 with dp/dx = 8 nu u_max / W^2
    (horizontal_poiseuille_test.cpp:50-67)."""
    nu = (2.0 * tau - 1.0) / 6.0
    p_grad = 8.0 * nu * u_max / (W * W)
    return 3.0 * (H - 1) * p_grad + 1.0


def _macroscopics(f: torch.Tensor, incompressible: bool):
    """rho and the advected velocity: the momentum when incompressible,
    else momentum / rho (SinglePhaseModel.macroscopics)."""
    rho = d2q9.calc_rho(f)
    return rho, d2q9.calc_momentum(f) if incompressible else d2q9.calc_u(f, rho)


def _equilibrium_state(H: int, W: int, incompressible: bool, device, dtype,
                       u0: torch.Tensor | None = None) -> torch.Tensor:
    """The equilibrium at rho = 1 and velocity ``u0`` (rest)."""
    eq = d2q9.incomp_equilibrium if incompressible else d2q9.equilibrium
    u = torch.zeros((2, H, W), dtype=dtype, device=device) if u0 is None else u0
    return eq(u, torch.ones((H, W), dtype=dtype, device=device))


def _run_steps(step, f: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        f = step(f)
    return f


def trt_poiseuille(H: int = 21, W: int = 21, T: int = 20000,
                   u_max: float = 1.030985714e-1, tau: float = 1.2,
                   magic: float | None = None, device=None,
                   dtype: torch.dtype | None = None) -> ChannelResult:
    """horizontal_poiseuille under the TRT collision (models/trt.py), beyond
    the reference: the odd parts relax at the rate that keeps Lambda =
    ``magic`` (None = 3/16), which makes the reference's L2 <= 1e-11 gate
    (horizontal_poiseuille_test.cpp:175) hold at any ``tau``.  Geometry and
    boundaries as horizontal_poiseuille_test.cpp:50-67; every step through
    kernel 9 on the card."""
    device, dtype = default_device(device), default_float(dtype)
    omega = 1.0 / tau
    omega_minus = trt.omega_minus_from_magic(
        omega, trt.MAGIC_POISEUILLE if magic is None else magic)
    step = make_channel_variant_step(
        H, W, omega=omega, incompressible=True,
        pressure=(_inlet_density(H, W, u_max, tau), 1.0, 0), col_walls="bounce",
        omega_minus=omega_minus, dtype=dtype)
    f = _equilibrium_state(H, W, True, device, dtype)
    f, steps, _ = converged_run(step, f, T, lambda g: d2q9.calc_momentum(g)[0].mean())
    u = d2q9.calc_momentum(f)
    return ChannelResult(f=f, rho=d2q9.calc_rho(f), u=u, steps=steps,
                         l2=poiseuille_l2(u[0].cpu().numpy(), u_max))


def vertical_poiseuille(H: int = 51, W: int = 51, T: int = 10000,
                        u_max: float = 0.1, tau: float = TAU_DEFAULT,
                        tolerance: float | None = None,
                        incompressible: bool = False, device=None,
                        dtype: torch.dtype | None = None) -> ChannelResult:
    """Flow along the columns with the compressible equilibrium: the pressure
    rewrite acts on the columns, no-slip walls on the first and last row
    (test/vertical_poiseuille_test.cpp:46-123; kernel 9 on the card).

    ``tolerance`` adds the relative-mean watcher on u_y (the horizontal
    program's stop test).  ``l2`` is the reference's row-averaged relative L2
    of the cross-channel u_y profile.  The faithful compressible
    equilibrium floors it at O(delta_rho), since u = j/rho varies along the
    channel (lbm_tpu measured 1.3e-2 at 31x31, u_max = 0.05);
    ``incompressible=True`` takes the horizontal program's equilibrium
    instead, which restores the 1e-11 class at the magic tau."""
    device, dtype = default_device(device), default_float(dtype)
    step = make_channel_variant_step(
        H, W, omega=1.0 / tau, incompressible=incompressible,
        pressure=(_inlet_density(H, W, u_max, tau), 1.0, 1), row_walls="bounce",
        dtype=dtype)
    f = _equilibrium_state(H, W, incompressible, device, dtype)
    f, steps, _ = converged_run(
        step, f, T, lambda g: _macroscopics(g, incompressible)[1][1].mean(),
        tolerance=tolerance)
    rho, u = _macroscopics(f, incompressible)
    l2 = poiseuille_l2(np.ascontiguousarray(u[1].cpu().numpy().T), u_max)
    return ChannelResult(f=f, rho=rho, u=u, steps=steps, l2=l2)


def gravity_channel(H: int = 21, W: int = 21, T: int = 10000, fg: float = -0.0003,
                    tau: float = TAU_DEFAULT, tolerance: float = 1e-12, device=None,
                    dtype: torch.dtype | None = None) -> ChannelResult:
    """Body-force-driven channel: u += Fg, the weak Guo source, equal inlet
    and outlet densities (test/gravity_test.cpp:60-177; kernel 9 on the
    card).  ``u`` on the result includes the +Fg shift."""
    device, dtype = default_device(device), default_float(dtype)
    step = make_channel_variant_step(
        H, W, omega=1.0 / tau, incompressible=True, pressure=(1.0, 1.0, 0),
        force=(fg, 0.0), col_walls="bounce", dtype=dtype)
    f = _equilibrium_state(H, W, True, device, dtype)
    f, steps, _ = converged_run(step, f, T, lambda g: d2q9.calc_momentum(g)[0].mean(),
                                tolerance=tolerance)
    u = d2q9.calc_momentum(f) + torch.tensor([fg, 0.0], dtype=dtype,
                                             device=device)[:, None, None]
    return ChannelResult(f=f, rho=d2q9.calc_rho(f), u=u, steps=steps)


def specular_channel(H: int = 51, W: int = 51, T: int = 10000, u_max: float = 0.1,
                     tau: float = TAU_DEFAULT, device=None,
                     dtype: torch.dtype | None = None) -> ChannelResult:
    """Pressure-driven channel with free-slip (specular) side walls: the
    profile stays flat while the plug accelerates, with no steady state
    (test/specular_boundary_test.cpp; kernel 9 on the card)."""
    device, dtype = default_device(device), default_float(dtype)
    step = make_channel_variant_step(
        H, W, omega=1.0 / tau, incompressible=False,
        pressure=(_inlet_density(H, W, u_max, tau), 1.0, 0), col_walls="specular",
        dtype=dtype)
    f = _equilibrium_state(H, W, False, device, dtype)
    f, _, _ = converged_run(step, f, T, None, tolerance=None)
    rho, u = _macroscopics(f, False)
    return ChannelResult(f=f, rho=rho, u=u, steps=T)


def free_stream(H: int = 54, W: int = 42, T: int = 1000, u_stream: float = 0.1,
                omega: float = 1.0 / 0.55, config_path: str | None = None,
                snapshot_prefix: str | None = None, corner_consistent: bool = False,
                device=None, dtype: torch.dtype | None = None) -> ChannelResult:
    """A uniform stream kept by ABB rows at the stream velocity and specular
    columns (test/free_stream_test.cpp:75-135; kernel 9 on the card).

    The reference applies the specular repair on every row, the ABB corners
    included, and pairs the quadratic ABB coefficient with the linearised
    incompressible equilibrium; both are reproduced by default (~15% bulk
    drift by T=100).  ``corner_consistent=True`` lets the ABB rows own the
    corners (the specular rule on rows 1..R-2) and runs the compressible
    equilibrium the ABB coefficient is exact against, which makes the
    uniform stream an exact fixed point.

    ``config_path`` drives the scene from a physical-units
    [flow]/[lattice]/[simulation] TOML as the reference program does
    (free_stream_test.cpp:23-36): H = lattice.X, W = lattice.Y, omega from
    the relaxation time, T = simulation.total_steps, and (ux, uy, ps = rho/3)
    snapshots every simulation.snapshot_steps, in ``result.snapshots`` or
    streamed to ``snapshot_prefix``.  The stream velocity stays ``u_stream``:
    the program hardcodes 0.1 (:52, :66) rather than using lattice.u."""
    from ..core.params import PhysicalConfig

    device, dtype = default_device(device), default_float(dtype)
    recorder = None
    if config_path is not None:
        cfg = PhysicalConfig.load(config_path)
        H, W = cfg.lattice.X, cfg.lattice.Y
        omega = cfg.lattice.omega
        if cfg.simulation is not None:
            T = cfg.simulation.total_steps
            recorder = SnapshotRecorder(cfg.simulation.snapshot_steps,
                                        single_phase_fields(True), snapshot_prefix)
    incompressible = not corner_consistent
    step = make_channel_variant_step(
        H, W, omega=omega, incompressible=incompressible, row_walls="abb",
        abb_u=(u_stream, 0.0), col_walls="specular",
        corner_consistent=corner_consistent, dtype=dtype)
    u0 = torch.zeros((2, H, W), dtype=dtype, device=device)
    u0[0] = u_stream
    f = _equilibrium_state(H, W, incompressible, device, dtype, u0)
    if recorder is not None:
        f = recorder.run(lambda g, n: _run_steps(step, g, n), f, T)
    else:
        f, _, _ = converged_run(step, f, T, None, tolerance=None)
    rho, u = _macroscopics(f, incompressible)
    return ChannelResult(f=f, rho=rho, u=u, steps=T,
                         snapshots=recorder.result() if recorder else None)


def power_law_analytic_profile(y: np.ndarray, h: float, cons_K: float,
                               n: float, g: float) -> np.ndarray:
    """Steady force-driven planar Poiseuille of a power-law fluid:
    u(y) = n/(n+1) (G/K)^(1/n) (h^((n+1)/n) - |y|^((n+1)/n)), y from the
    centreline, walls at |y| = h (the halfway bounce-back plane)."""
    e = (n + 1.0) / n
    return (n / (n + 1.0)) * (g / cons_K) ** (1.0 / n) * (h ** e - np.abs(y) ** e)


def bingham_analytic_profile(y: np.ndarray, h: float, cons_K: float,
                             sigma_y: float, g: float) -> np.ndarray:
    """Steady force-driven planar Poiseuille of a Bingham plastic: a rigid
    plug inside the yield surface |y| <= y_p = sigma_y/g, the shifted
    parabola outside."""
    y_p = sigma_y / g
    ya = np.minimum(np.abs(y), h)
    outer = g / (2.0 * cons_K) * (h * h - ya * ya) - sigma_y / cons_K * (h - ya)
    plug = g / (2.0 * cons_K) * (h - y_p) ** 2
    return np.where(np.abs(y) <= y_p, plug, outer)


def power_law_channel(H: int = 8, W: int = 41, T: int = 60000, n: float = 0.5,
                      cons_K: float = 0.01, fg: float = 4.2e-5,
                      tau_min: float = 0.52, tau_max: float = 50.0, iters: int = 8,
                      sigma_y: float = 0.0, m_pap: float = 1e4,
                      tolerance: float = 1e-12, device=None,
                      dtype: torch.dtype | None = None) -> ChannelResult:
    """Force-driven channel of a truncated power-law fluid (Herschel-Bulkley
    / Bingham when ``sigma_y > 0``), beyond the reference
    (models/power_law.py).  Periodic along the rows, halfway bounce-back
    side walls, the standard Guo forcing (u* = u + F/2rho, ics2 = 3,
    ics4 = 9) with the per-cell omega in the relaxation and in the source.
    Watches mean(u_x) every 200 steps and returns the per-cell tau in
    ``snapshots['tau']``.  lbm_tpu runs this scene as jnp ops, with no TPU
    kernel; the port runs it as plain tensor ops on either device."""
    device, dtype = default_device(device), default_float(dtype)
    fgv = torch.tensor([fg, 0.0], dtype=dtype, device=device)[:, None, None]

    def tau_of(f, f_eq, rho):
        return apparent_tau(f, f_eq, rho, cons_K, n, tau_min, tau_max, iters,
                            sigma_y, m_pap)

    def macro(f):
        rho = d2q9.calc_rho(f)
        return rho, d2q9.calc_u(f, rho) + 0.5 * fgv / rho

    def step(f):
        rho, u = macro(f)
        f_eq = d2q9.equilibrium(u, rho)
        om = 1.0 / tau_of(f, f_eq, rho)
        f_coll = d2q9.bgk_collision(f, f_eq, om) \
            + d2q9.guo_source(u, fgv, om, ics2=3.0, ics4=9.0)
        f_new = d2q9.stream(f_coll)
        f_new = bc.bounce_back(f_new, f_coll, "colN")
        return bc.bounce_back(f_new, f_coll, "col0")

    f = _equilibrium_state(H, W, False, device, dtype)
    f, steps, _ = converged_run(step, f, T, lambda g: macro(g)[1][0].mean(),
                                t_interval=200, tolerance=tolerance)
    rho, u = macro(f)
    tau = tau_of(f, d2q9.equilibrium(u, rho), rho)
    return ChannelResult(f=f, rho=rho, u=u, steps=steps,
                         snapshots={"tau": to_numpy(tau)})
