"""Thermal convection (counterpart of lbm_tpu/scenes/thermal.py):
Rayleigh-Benard in a periodic slot and the differentially heated cavity.

Beyond the reference program, as in lbm_tpu: the standard double-
distribution Boussinesq scheme, a D2Q9 BGK fluid f driven by the buoyancy
F = (g_beta theta, 0) along the rows (Guo source with the half-force shift)
and an advection-diffusion distribution g of the temperature deviation
theta, D2Q9 or D2Q5 (``scalar_lattice``).  Control parameters: Ra = g_beta
dT L^3 / (nu kappa) and Pr = nu / kappa, with kappa = cs2 (tau_g - 1/2).

Each step is one launch on the card, kernel 23 (Rayleigh-Benard) or 24
(heated cavity) of kernels/thermal.py, on the concatenated state
S = [f, g], and its plain version on the CPU.  lbm_tpu's ``fused`` and
``interpret`` flags have no counterpart (the device decides); its
``mesh_shape`` waits for an ``auto_sharded`` on parallel/ (ROADMAP Queue 1
item 14) and raises if set.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import lattice as lat
from ..kernels import thermal as kth
from ..kernels.thermal import d2q5_stream  # noqa: F401  (lbm_tpu's scene API)
from ..ops import d2q9
from ..utils.xmath import default_device, default_float
from ._common import drive_recorded, no_mesh
from .channel import SnapshotRecorder

CS2 = 1.0 / 3.0


@dataclass
class ThermalResult:
    f: torch.Tensor          # (9, H, W) fluid populations
    g: torch.Tensor          # (9 or 5, H, W) temperature populations
    rho: torch.Tensor
    u: torch.Tensor          # (2, H, W) incl. the half-force shift
    theta: torch.Tensor      # (H, W) temperature deviation
    nusselt: float           # volume-averaged Nusselt number
    steps: int
    series: torch.Tensor | None = None  # (T // record_every, 3): Nu, u_rms, theta_max; host
    snapshots: dict | None = None       # {ux, uy, theta} stacks (snapshot_every)


def conduction_profile(H: int, dtype=np.float64):
    """Steady pure-conduction profile through the cell centres: the halfway
    walls sit at rows -1/2 and H-1/2, so theta(i) linearly interpolates the
    wall values +-1/2 at i + 1/2."""
    x = (np.arange(H, dtype=np.float64) + 0.5) / H
    return np.asarray(0.5 - x, dtype)


def nusselt_number(u_rows: torch.Tensor, theta: torch.Tensor, kappa: float, H: int):
    """Nu = 1 + <u_x theta> / (kappa dT / H), volume-averaged in the state's
    dtype: the ratio of total (advective + conductive) to conductive heat
    transport for the unit temperature drop dT = 1 across height H."""
    return 1.0 + torch.mean(u_rows * theta) * H / kappa


def d2q5_equilibrium(u: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """D2Q5 scalar equilibrium w_k theta (1 + 3 c.u + 4.5 (c.u)^2 - 1.5 u.u)
    on the rest and axis directions (lattice.W5)."""
    uu = u[0] * u[0] + u[1] * u[1]
    out = []
    for k in range(5):
        cu = lat.CX[k] * u[0] + lat.CY[k] * u[1]
        out.append(float(lat.W5[k]) * theta * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * uu))
    return torch.stack(out)


def _carry_step(step):
    """A step on lbm_tpu's carry (f, g) from one on S = [f, g]."""
    def fn(carry):
        S = step(torch.cat(carry))
        return S[:9], S[9:]

    return fn


def make_rb_step(H: int, W: int, *, omega_f: float, omega_g: float, g_beta: float,
                 dtype: torch.dtype = torch.float32, scalar_lattice: str = "d2q9"):
    """Rayleigh-Benard step on lbm_tpu's carry (f, g) -> (f, g): kernel 23 on
    the card, kernels/thermal.py::plain_rb_step on the CPU.  Per step: the
    macroscopics with the Guo half-force shift, both collisions (+ Guo
    source on f), periodic streaming, then the row walls: fluid halfway
    bounce-back, temperature incoming-only ADE-Dirichlet at +-1/2.
    ``scalar_lattice='d2q5'`` carries the temperature on 5 populations."""
    return _carry_step(kth.make_thermal_fused_step(
        H, W, omega_f=omega_f, omega_g=omega_g, g_beta=g_beta, dtype=dtype,
        scalar_lattice=scalar_lattice))


def make_cavity_step(H: int, W: int, *, omega_f: float, omega_g: float, g_beta: float,
                     dtype: torch.dtype = torch.float32, scalar_lattice: str = "d2q9"):
    """Differentially heated cavity step on lbm_tpu's carry (f, g) -> (f, g):
    kernel 24 on the card, plain_heated_cavity_step on the CPU.  Hot column
    0 (+1/2), cold column W-1 (-1/2), adiabatic rows; the fluid no-slip on
    all four walls."""
    return _carry_step(kth.make_heated_cavity_fused_step(
        H, W, omega_f=omega_f, omega_g=omega_g, g_beta=g_beta, dtype=dtype,
        scalar_lattice=scalar_lattice))


def _initial_state(theta0: np.ndarray, scalar_lattice: str, device,
                   dtype: torch.dtype) -> torch.Tensor:
    """S = [f, g] at rest: f the equilibrium at rho = 1, g the temperature's
    equilibrium at theta0."""
    H, W = theta0.shape
    theta = torch.as_tensor(theta0, dtype=dtype, device=device)
    u0 = torch.zeros((2, H, W), dtype=dtype, device=device)
    f = d2q9.equilibrium(u0, torch.ones((H, W), dtype=dtype, device=device))
    g = d2q5_equilibrium(u0, theta) if kth.scalar_planes(scalar_lattice) == 5 \
        else d2q9.equilibrium(u0, theta)
    return torch.cat([f, g]).contiguous()


def _run(step, S: torch.Tensor, T: int, g_beta: float, nusselt, record_every: int,
         substeps: int, snapshot_every: int, snapshot_prefix: str | None,
         checkpoint_dir: str | None = None, checkpoint_every: int = 10000):
    """Drive S through ``step`` with lbm_tpu's checks, series and snapshots;
    ``nusselt(u, theta)`` is the scene's Nusselt number.  Returns a
    ThermalResult."""
    if T % substeps or (record_every and record_every % substeps):
        raise ValueError("T and record_every must be divisible by substeps")
    if record_every and T % record_every:
        raise ValueError("T must be a multiple of record_every")
    recorder = None
    if snapshot_every:
        if record_every:
            raise ValueError("snapshot_every and record_every are mutually exclusive")
        if snapshot_every % substeps:
            raise ValueError("snapshot_every must be divisible by substeps")

        def fields(c):
            _, th, u, _ = kth.buoyant_velocity(c[0][:9], c[0][9:], g_beta)
            return {"ux": u[0], "uy": u[1], "theta": th}

        recorder = SnapshotRecorder(snapshot_every, fields, snapshot_prefix)

    def record(c):
        _, th, u, _ = kth.buoyant_velocity(c[0][:9], c[0][9:], g_beta)
        return torch.stack([nusselt(u, th), torch.sqrt(torch.mean(u * u)), th.abs().max()])

    (S,), series = drive_recorded(lambda c: (step(c[0]),), (S,), T, record_every or None,
                                  record, recorder, substeps, checkpoint_dir=checkpoint_dir,
                                  checkpoint_every=checkpoint_every)
    f, g = S[:9], S[9:]
    rho, theta, u, _ = kth.buoyant_velocity(f, g, g_beta)
    return ThermalResult(f=f, g=g, rho=rho, u=u, theta=theta,
                         nusselt=float(nusselt(u, theta)), steps=T, series=series,
                         snapshots=recorder.result() if recorder else None)


def rayleigh_benard(H: int = 64, W: int = 128, T: int = 20000,
                    Ra: float = 1e4, Pr: float = 0.71,
                    tau_g: float = 0.8, amp: float = 1e-3,
                    record_every: int = 0, substeps: int = 1,
                    snapshot_every: int = 0,
                    snapshot_prefix: str | None = None,
                    checkpoint_dir: str | None = None,
                    checkpoint_every: int = 10000,
                    mesh_shape: tuple[int, int] | None = None,
                    scalar_lattice: str = "d2q9",
                    device=None, dtype: torch.dtype | None = None) -> ThermalResult:
    """Rayleigh-Benard convection between a hot bottom (row 0, theta = +1/2)
    and a cold top wall (row H-1, -1/2), both no-slip, columns periodic.

    Initial state: the pure-conduction profile plus a single-roll
    perturbation ``amp * cos(2 pi y / W) * sin(pi (x + 1/2) / H)`` on theta.
    Below Ra_c = 1708 the perturbation decays; above, convection rolls grow
    and saturate, and ``nusselt`` exceeds 1 (Clever & Busse 1974: Nu ~ 2.66
    at Ra = 1e4, Pr = 0.71 for the critical roll).

    ``record_every`` > 0 records (Nu, u_rms, theta_max) every k steps into
    ``series``, on the device, copied to the host once per 1000 steps;
    ``snapshot_every`` > 0 records (ux, uy, theta) every k steps, t = 0
    included (in ``snapshots``, or streamed to ``snapshot_prefix``); the two
    are exclusive.  ``substeps`` steps run per call of the step (one
    kernel-23 launch each on the card); T, record_every and snapshot_every
    must be divisible by it.  ``checkpoint_dir`` turns on checkpoint/resume
    of S and the series every ``checkpoint_every`` steps
    (``_common.drive_recorded``); it excludes ``snapshot_every``, as in
    lbm_tpu, but takes ``record_every``, where lbm_tpu refuses it."""
    no_mesh(mesh_shape)
    device, dtype = default_device(device), default_float(dtype)
    kappa = CS2 * (tau_g - 0.5)
    nu = Pr * kappa
    omega_f = 1.0 / (nu / CS2 + 0.5)
    omega_g = 1.0 / tau_g
    g_beta = Ra * nu * kappa / float(H) ** 3
    step = kth.make_thermal_fused_step(H, W, omega_f=omega_f, omega_g=omega_g,
                                       g_beta=g_beta, substeps=substeps, dtype=dtype,
                                       scalar_lattice=scalar_lattice)
    x = (np.arange(H) + 0.5) / H
    y = np.arange(W) / W
    theta0 = (conduction_profile(H)[:, None]
              + amp * np.sin(np.pi * x)[:, None] * np.cos(2.0 * np.pi * y)[None, :])
    S = _initial_state(theta0, scalar_lattice, device, dtype)
    return _run(step, S, T, g_beta, lambda u, th: nusselt_number(u[0], th, kappa, H),
                record_every, substeps, snapshot_every, snapshot_prefix, checkpoint_dir,
                checkpoint_every)


def heated_cavity(H: int = 128, W: int = 128, T: int = 40000,
                  Ra: float = 1e4, Pr: float = 0.71,
                  tau_g: float = 0.8, record_every: int = 0,
                  substeps: int = 1, snapshot_every: int = 0,
                  snapshot_prefix: str | None = None,
                  scalar_lattice: str = "d2q9",
                  device=None, dtype: torch.dtype | None = None) -> ThermalResult:
    """Differentially heated square cavity, the de Vahl Davis (1983)
    natural-convection benchmark: hot left / cold right walls, adiabatic
    rows, one buoyancy-driven circulation cell.  Reference Nusselt numbers
    (Pr = 0.71): 1.118 at Ra = 1e3, 2.243 at 1e4, 4.519 at 1e5.

    ``nusselt`` is the volume-averaged transport across the cavity,
    1 + <u_y theta> W / (kappa dT); Ra is defined on the width W.
    ``record_every``, ``snapshot_every`` and ``substeps`` as in
    rayleigh_benard (one kernel-24 launch per step on the card)."""
    device, dtype = default_device(device), default_float(dtype)
    kappa = CS2 * (tau_g - 0.5)
    nu = Pr * kappa
    omega_f = 1.0 / (nu / CS2 + 0.5)
    omega_g = 1.0 / tau_g
    g_beta = Ra * nu * kappa / float(W) ** 3
    step = kth.make_heated_cavity_fused_step(H, W, omega_f=omega_f, omega_g=omega_g,
                                             g_beta=g_beta, substeps=substeps, dtype=dtype,
                                             scalar_lattice=scalar_lattice)
    y = (np.arange(W) + 0.5) / W
    S = _initial_state(np.tile(0.5 - y, (H, 1)), scalar_lattice, device, dtype)
    return _run(step, S, T, g_beta, lambda u, th: nusselt_number(u[1], th, kappa, W),
                record_every, substeps, snapshot_every, snapshot_prefix)
