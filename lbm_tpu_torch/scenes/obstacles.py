"""Obstacle scenes (counterpart of lbm_tpu/scenes/obstacles.py): an IBM
cylinder in a free stream, and rectangle sedimentation with a passive
advection-diffusion scalar.

  * cylinder_flow - test/cylinder_test.cpp:21-175 (IBM multi-direct
    forcing): each step is two launches on the card, kernel 16 (the
    forcing over the marker ROI) and kernel 15 (the grid work), and their
    plain versions on the CPU;
  * rectangle_sedimentation - test/rectangle_sedimentation_test.cpp:23-248:
    one launch of kernel 17 per step on the card, its plain version on the
    CPU.

lbm_tpu's ``fused`` and ``interpret`` flags have no counterpart (the device
decides).  lbm_tpu's two cylinder_flow paths differ: its jnp path always
takes the weak Guo coefficients and records no force series, its fused
path honours ``guo_coeffs`` and ``record_every`` but runs float32 only and
falls back to jnp forcing when no 8x128-aligned window fits
(obstacles.py:135-235).  The port has one step function on both devices
and in both dtypes, which honours both keywords and has no fallback.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.cylinder import WEAK_GUO, make_cylinder_fused_step
from ..kernels.ibm import make_ibm_forcing_step
from ..kernels.sediment import inlet_profile, make_sediment_fused_step
from ..ops import d2q9
from ..ops.ibm import IBM
from ..utils import observe
from ..utils.xmath import default_device, default_float
from .ulbm import CHUNK, _drive


@dataclass
class CylinderResult:
    f: torch.Tensor
    rho: torch.Tensor
    u: torch.Tensor
    F_roi: torch.Tensor          # Eulerian IBM force density over the ROI
    surface_force: torch.Tensor  # (2,) total force on the fluid, summed over the ROI
    steps: int
    forces: torch.Tensor | None = None  # (T // record_every, 2) series, on the host
    snapshots: dict | None = None


def _physical(config_path: str | None):
    """(H, W, u, omega, T, snapshot cadence) from a physical-units TOML, the
    last two None without a [simulation] table."""
    from ..core.params import PhysicalConfig

    cfg = PhysicalConfig.load(config_path)
    sim = cfg.simulation
    return (cfg.lattice.X, cfg.lattice.Y, cfg.lattice.u, cfg.lattice.omega,
            None if sim is None else sim.total_steps,
            None if sim is None else sim.snapshot_steps)


def cylinder_flow(H: int = 160, W: int = 120, T: int = 500,
                  center=(60.0, 60.0), radius: float = 20.0,
                  n_markers: int = 64, u_stream: float = 0.05,
                  omega: float = 1.0 / 0.55,
                  ibm: IBM | None = None,
                  config_path: str | None = None,
                  markers_path: str | None = None,
                  marker_name: str = "cylinder-a",
                  snapshot_prefix: str | None = None,
                  reference_weights: bool = False,
                  guo_coeffs: tuple = WEAK_GUO,
                  record_every: int | None = None,
                  device=None, dtype: torch.dtype | None = None) -> CylinderResult:
    """Uniform stream past an IBM cylinder: anti-bounce-back inlet/outlet
    rows, specular side columns, the multi-direct-forcing body force over
    the marker ROI.  Step order cites test/cylinder_test.cpp: macroscopics
    -> equilibrium -> IBM force (:110) -> Guo source over the ROI only
    (:116-127) -> advect -> ABB rows (:132-154) -> specular cols (:156-163).

    The markers default to a generated circle; pass an ``IBM`` (from
    ``IBM.from_markers``, ``IBM.circle`` or a TOML) or ``markers_path``
    with ``marker_name``.  ``reference_weights`` selects the reference's
    transposed Peskin pairing (src/ibm.cpp:47-57 vs :171).

    ``guo_coeffs`` is (ics2, ics4): the reference's weak (1/3, 1/9) by
    default (cylinder_test.cpp:66-67), with which the body is enforced too
    weakly for shedding to last; the standard (3, 9) sheds at Strouhal
    ~0.18 at Re 96 on 1024x256 (scripts/validate_tpu.py strouhal).
    ``record_every=k`` returns the (T // k, 2) surface-force series in
    ``forces``, summed on the device every k steps and copied to the host
    once per chunk; T must be a multiple of k.

    ``config_path`` + ``markers_path`` drive the scene as the reference
    program's two TOML argv files do (cylinder_test.cpp:24-38, :63, :75-77):
    H = lattice.X, W = lattice.Y, u_stream = lattice.u, omega from the
    relaxation time, T = simulation.total_steps, and (ux, uy, ps,
    surface_force, forces) snapshots, sampled before the step, every
    simulation.snapshot_steps in ``snapshots`` or streamed to
    ``snapshot_prefix``."""
    cadence = None
    if config_path is not None:
        H, W, u_stream, omega, T_cfg, cadence = _physical(config_path)
        T = T if T_cfg is None else T_cfg
    if record_every is not None and (record_every < 1 or T % record_every):
        raise ValueError("T must be a multiple of record_every")
    if markers_path is not None and ibm is None:
        ibm = IBM.from_toml(markers_path, marker_name,
                            reference_transposed_weights=reference_weights)
    ib = ibm or IBM.circle(center[0], center[1], radius, n_markers,
                           reference_transposed_weights=reference_weights)
    device, dtype = default_device(device), default_float(dtype)
    forcing = make_ibm_forcing_step(H, W, ib, dtype)
    grid = make_cylinder_fused_step(H, W, omega, u_wall=(u_stream, 0.0), guo=guo_coeffs,
                                    dtype=dtype)
    origin = (ib.roi_rows[0], ib.roi_cols[0])

    recorder = None
    if cadence is not None:
        from .channel import SnapshotRecorder

        def fields(state):
            f, F = state
            rho = d2q9.calc_rho(f)
            u = d2q9.calc_u(f, rho)
            return {"ux": u[0], "uy": u[1], "ps": rho / 3.0,
                    "surface_force": F.sum(dim=(1, 2)), "forces": F}

        recorder = SnapshotRecorder(cadence, fields, snapshot_prefix)

    u0 = torch.zeros((2, H, W), dtype=dtype, device=device)
    u0[0] = u_stream
    f = d2q9.incomp_equilibrium(u0, torch.ones((H, W), dtype=dtype, device=device))
    F = torch.zeros((2,) + ib.roi_shape, dtype=dtype, device=device)

    meter = observe.StepMeter(H * W, device, total_steps=T)
    series, pending = [], []
    for t in range(T):
        if recorder is not None and t % recorder.cadence == 0:
            recorder.record((f, F))
        F = forcing(f)
        f = grid(f, F, origin)
        if record_every is not None and (t + 1) % record_every == 0:
            pending.append(F.sum(dim=(1, 2)))
        if (t + 1) % CHUNK == 0 or t + 1 == T:
            meter.update(CHUNK if (t + 1) % CHUNK == 0 else T % CHUNK)
            observe.check_finite(f, t + 1)
            if pending:
                series.append(torch.stack(pending).cpu())
                pending = []
    rho = d2q9.calc_rho(f)
    forces = None
    if record_every is not None:
        forces = (torch.cat(series) if series
                  else torch.zeros((0, 2), dtype=dtype))
    return CylinderResult(f=f, rho=rho, u=d2q9.calc_u(f, rho), F_roi=F,
                          surface_force=F.sum(dim=(1, 2)), steps=T, forces=forces,
                          snapshots=recorder.result() if recorder else None)


@dataclass
class SedimentationResult:
    f: torch.Tensor
    g: torch.Tensor
    rho: torch.Tensor
    u: torch.Tensor
    C: torch.Tensor
    steps: int
    snapshots: dict | None = None


def sediment_initial_state(H: int, W: int, u_in: float, C_w: float, inlet_rows: int,
                           device, dtype: torch.dtype) -> torch.Tensor:
    """S = [f, g] at t = 0: f the incompressible equilibrium at rho = 1,
    u = (0, u_in); g the equilibrium at that u with C = C_w on the inlet's
    last ``inlet_rows`` rows of column 0 (rectangle_sedimentation_test.cpp:
    86-110)."""
    u0 = torch.zeros((2, H, W), dtype=dtype, device=device)
    u0[1] = u_in
    C0 = torch.zeros((H, W), dtype=dtype, device=device)
    C0[:, 0] = inlet_profile(H, C_w, inlet_rows, dtype, device)
    f = d2q9.incomp_equilibrium(u0, torch.ones((H, W), dtype=dtype, device=device))
    return torch.cat([f, d2q9.equilibrium(u0, C0)]).contiguous()


def rectangle_sedimentation(H: int = 256, W: int = 320, T: int = 500,
                            u_in: float = 0.02, omega: float = 1.0 / 0.55,
                            w_s: float = 3e-3, C_w: float = 1e-3,
                            R23: int = -151, C28: int = 200, C38: int = 250,
                            inlet_rows: int = 50,
                            config_path: str | None = None,
                            snapshot_prefix: str | None = None,
                            substeps: int = 1,
                            device=None,
                            dtype: torch.dtype | None = None) -> SedimentationResult:
    """Sediment-laden flow along the columns past a bottom-mounted rectangle.

    A BGK fluid drives a passive ADE scalar one way (Sc = 1); the scalar's
    equilibrium advects at u + w_s, the settling velocity added to both
    components as the reference's ``u+w_s`` does
    (rectangle_sedimentation_test.cpp:125,201).  Per step: zero-gradient g
    on row 0 and column C-1 (pre-stream, :134-141); the fluid's ABB inlet on
    column 0 / extrapolated-ABB outlet on column C-1 (:148-172), specular
    row 0 (:174-177), bounce-back row R-1 (:179-182), the rectangle's
    bounce-back (:184-196); the scalar's ADE Dirichlet inlet with 2 g_eq
    (:204-218), the rectangle's anti-bounce-back (:220-232), bounce-back
    row R-1 (:233-236).  A negative R23 counts from the bottom (R23 % H).

    ``substeps`` steps run per call of the step (one kernel-17 launch each
    on the card); it needs T % substeps == 0 and no snapshot cadence, as
    in lbm_tpu.  ``config_path`` takes H = lattice.X, W = lattice.Y,
    u_in = lattice.u, omega and T from the physical-units TOML, with (ux,
    uy, ps, cs) snapshots at the simulation cadence (:112-122, :242-245);
    the rectangle stays at the keywords' geometry (the program hardcodes
    it, :73-75)."""
    cadence = None
    if config_path is not None:
        H, W, u_in, omega, T_cfg, cadence = _physical(config_path)
        T = T if T_cfg is None else T_cfg
    if substeps != 1 and (cadence is not None or T % substeps):
        raise ValueError("substeps requires T % substeps == 0 and no snapshot cadence")
    device, dtype = default_device(device), default_float(dtype)
    step = make_sediment_fused_step(H, W, omega=omega, u_in=u_in, w_s=w_s, C_w=C_w,
                                    R23=R23, C28=C28, C38=C38, inlet_rows=inlet_rows,
                                    substeps=substeps, dtype=dtype)
    S = sediment_initial_state(H, W, u_in, C_w, inlet_rows, device, dtype)
    recorder = None
    if cadence is not None:
        from .channel import SnapshotRecorder

        def fields(S):
            rho = d2q9.calc_rho(S[:9])
            u = d2q9.calc_u(S[:9], rho)
            return {"ux": u[0], "uy": u[1], "ps": rho / 3.0, "cs": d2q9.calc_rho(S[9:])}

        recorder = SnapshotRecorder(cadence, fields, snapshot_prefix)
        S = recorder.run(lambda s, n: _drive(step, s, n), S, T)
    else:
        S = _drive(step, S, T // substeps, substeps, watchdog=True)
    f, g = S[:9], S[9:]
    rho = d2q9.calc_rho(f)
    return SedimentationResult(f=f, g=g, rho=rho, u=d2q9.calc_u(f, rho),
                               C=d2q9.calc_rho(g), steps=T,
                               snapshots=recorder.result() if recorder else None)
