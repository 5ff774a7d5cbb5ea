"""Obstacle scenes (counterpart of lbm_tpu/scenes/obstacles.py): an IBM
cylinder in a free stream, rectangle sedimentation with a passive
advection-diffusion scalar, and bodies falling through a closed box.

  * cylinder_flow - test/cylinder_test.cpp:21-175 (IBM multi-direct
    forcing): each step is two launches on the card, kernel 16 (the
    forcing over the marker ROI) and kernel 15 (the grid work), and their
    plain versions on the CPU;
  * rectangle_sedimentation - test/rectangle_sedimentation_test.cpp:23-248:
    one launch of kernel 17 per step on the card, its plain version on the
    CPU;
  * falling_cylinder, falling_cylinders (the drafting-kissing-tumbling
    pair) and falling_ellipse - moving-marker IBM bodies beyond the
    reference's static markers (src/ibm.cpp:15-191): each step is two
    launches on the card, the body's forcing (kernel 19, 21 or 20, which
    also updates the rigid state on the device) and the box grid step
    (kernel 18), and their plain versions on the CPU.

lbm_tpu's ``fused`` and ``interpret`` flags have no counterpart (the device
decides).  lbm_tpu's two cylinder_flow paths differ: its jnp path always
takes the weak Guo coefficients and records no force series, its fused
path honours ``guo_coeffs`` and ``record_every`` but runs float32 only and
falls back to jnp forcing when no 8x128-aligned window fits
(obstacles.py:135-235).  The port has one step function on both devices
and in both dtypes, which honours both keywords and has no fallback.  The
same holds for the falling bodies, whose fused path in lbm_tpu is float32
only and needs an 8x128-aligned margined window (obstacles.py:1000-1038).
Their ``checkpoint_dir`` turns on checkpoint/resume of the carry (f and
the rigid state) and the trajectory every ``checkpoint_every`` steps
(``_common.drive_recorded``).  ``falling_cylinder`` takes lbm_tpu's ``mesh``
keyword (GSPMD rows) and raises ``NotImplementedError`` when one is given,
as the other scenes do with theirs (``_common.no_mesh``): the scenes'
meshes wait for ROADMAP item 14.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import moving_ibm as kmov
from ..kernels.cylinder import (WEAK_GUO, make_box_fused_step, make_cylinder_fused_step,
                                plain_box_step)
from ..kernels.ibm import make_ibm_forcing_step
from ..kernels.sediment import inlet_profile, make_sediment_fused_step
from ..ops import d2q9
from ..ops.ibm import IBM
from ..ops.moving_ibm import circle_markers, ellipse_markers
from ..utils.xmath import default_device, default_float
from ._common import drive_recorded, no_mesh
from .ulbm import _drive


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


def _check_record(T: int, record_every: int | None) -> None:
    if record_every is not None and (record_every < 1 or T % record_every):
        raise ValueError("T must be a multiple of record_every (>= 1)")


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
    _check_record(T, record_every)
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

    def step(carry):
        F = forcing(carry[0])
        return grid(carry[0], F, origin), F

    (f, F), forces = drive_recorded(step, (f, F), T, record_every,
                                    lambda c: c[1].sum(dim=(1, 2)), recorder)
    rho = d2q9.calc_rho(f)
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


def _drive_bodies(force, grid, f: torch.Tensor, state: torch.Tensor, T: int,
                  record_every: int | None, lanes: int, checkpoint_dir: str | None,
                  checkpoint_every: int):
    """drive_recorded of two calls per step, the body forcing and the box
    grid step, recording the state's first ``lanes`` lanes: (f, state,
    trajectory (T // k, B, lanes) on the host, or None)."""
    def step(carry):
        F, origin, st = force(*carry)
        return grid(carry[0], F, origin), st

    (f, state), trajectory = drive_recorded(step, (f, state), T, record_every,
                                            lambda c: c[1][:, :lanes],
                                            checkpoint_dir=checkpoint_dir,
                                            checkpoint_every=checkpoint_every)
    return f, state, trajectory


def _rest(H: int, W: int, device, dtype) -> torch.Tensor:
    """The fluid at rest, rho = 1: the incompressible equilibrium at u = 0."""
    return d2q9.incomp_equilibrium(torch.zeros((2, H, W), dtype=dtype, device=device),
                                   torch.ones((H, W), dtype=dtype, device=device))


@dataclass
class FallingCylinderResult:
    f: torch.Tensor
    rho: torch.Tensor
    u: torch.Tensor
    center: torch.Tensor     # (2,) final body centre (rows, cols)
    velocity: torch.Tensor   # (2,) final body velocity
    steps: int
    trajectory: torch.Tensor | None = None  # (T // record_every, 6): cen, ub, F_h; host


def falling_cylinder(H: int = 400, W: int = 256, T: int = 2000,
                     center=None, radius: float = 12.0,
                     n_markers: int | None = None, rho_s: float = 1.25,
                     gravity: float = 5e-5, omega: float = 1.0 / 0.6,
                     m_max: int = 5, record_every: int | None = 10,
                     checkpoint_dir: str | None = None,
                     checkpoint_every: int = 10000, mesh=None,
                     device=None, dtype: torch.dtype | None = None) -> FallingCylinderResult:
    """A rigid cylinder of density ``rho_s`` (fluid rho_0 = 1) sedimenting
    along +rows under ``gravity`` in a closed no-slip box, by moving-marker
    IBM.  Each step: macroscopics -> the window following the body (2 half
    cells, half = ceil(r) + 5) -> Peskin factors at the markers ->
    multi-direct forcing toward the body velocity U_b -> the rigid update
    -> BGK -> the standard Guo source over the window -> stream -> halfway
    bounce-back on all four walls.

    Rigid closure (translation only; the symmetric fall is torque-free):
    F_h = -sum_j f_j and rho_s A dU/dt = F_h + (rho_s - 1) A g e_x, A = pi
    r^2, stepped as U += dU, x += U.  The full inertia rho_s A (not
    Uhlmann's buoyant (rho_s - 1) A) is unconditionally stable at the
    scene's density ratios (roughly rho_s r > 2.6; lbm_tpu's docstring,
    scenes/obstacles.py:935-959).  Markers default to ceil(2 pi r).

    ``record_every`` returns the (T // k, 6) trajectory (centre, velocity,
    hydrodynamic force), recorded on the device and copied to the host once
    per chunk; None records nothing.  ``center`` defaults to (H/4, W/2).
    ``mesh`` raises ``NotImplementedError`` (``_common.no_mesh``)."""
    no_mesh(mesh)
    device, dtype = default_device(device), default_float(dtype)
    _check_record(T, record_every)
    if center is None:
        center = (0.25 * H, 0.5 * W)
    if not (radius + 3 <= center[0] <= H - radius - 3
            and radius + 3 <= center[1] <= W - radius - 3):
        raise ValueError(f"center {center} puts markers (+2-cell Peskin "
                         f"support) outside the {H}x{W} grid")
    if n_markers is None:
        n_markers = int(np.ceil(2.0 * np.pi * radius))
    half = int(np.ceil(radius)) + 5     # marker ring, 2-cell support, 3 slack
    if 2 * half > H or 2 * half > W:
        raise ValueError("window exceeds grid; enlarge H/W")
    area = np.pi * radius * radius
    dx, dy = circle_markers(torch.zeros(2, dtype=torch.float64), radius, n_markers)
    force = kmov.make_moving_forcing_step(H, W, dx, dy, half=half,
                                          g_net=(rho_s - 1.0) * area * gravity,
                                          m_eff=rho_s * area, m_max=m_max, dtype=dtype)
    grid = make_box_fused_step(H, W, omega, dtype=dtype)
    f, st, trajectory = _drive_bodies(
        force, grid, _rest(H, W, device, dtype),
        kmov.pack_state(center, dtype=dtype, device=device), T, record_every, 6,
        checkpoint_dir, checkpoint_every)
    rho = d2q9.calc_rho(f)
    return FallingCylinderResult(f=f, rho=rho, u=d2q9.calc_u(f, rho), center=st[0, 0:2],
                                 velocity=st[0, 2:4], steps=T,
                                 trajectory=None if trajectory is None else trajectory[:, 0])


@dataclass
class FallingCylindersResult:
    f: torch.Tensor
    rho: torch.Tensor
    u: torch.Tensor
    centers: torch.Tensor     # (B, 2) final body centres (rows, cols)
    velocities: torch.Tensor  # (B, 2) final body velocities
    steps: int
    trajectory: torch.Tensor | None = None  # (T // record_every, B, 6): cen, ub, F_h; host


def falling_cylinders(H: int = 800, W: int = 128, T: int = 40000,
                      centers=((96.0, 63.0), (130.0, 64.0)),
                      radius: float = 12.0,
                      n_markers: int | None = None, rho_s: float = 1.25,
                      gravity: float = 2e-4, omega: float = 1.0 / 0.6,
                      m_max: int = 5, record_every: int | None = 10,
                      zeta: float = 2.0, eps: float = 50.0,
                      row_slack: int | None = None,
                      checkpoint_dir: str | None = None,
                      checkpoint_every: int = 10000,
                      device=None, dtype: torch.dtype | None = None) -> FallingCylindersResult:
    """B rigid cylinders sedimenting in a closed channel: with the default
    two slightly offset bodies, the drafting-kissing-tumbling (DKT)
    sequence.  All bodies share one union forcing window (their markers
    forced together, so their force fields couple within the multi-direct
    iterations) of the full width x ``2 half + initial row span +
    row_slack`` rows (default 4 radii of slack) that follows the lowest
    centre row; bodies that drift apart beyond it lose forcing support, and
    the scene warns when the trajectory approaches that budget.

    Rigid closure per body: -sum_j f_j over its markers, buoyant gravity and
    the Glowinski barriers (ops/moving_ibm.py barrier_forces, pairwise and
    against all four walls, range ``zeta``, stiffness 1/``eps``), then
    falling_cylinder's update.  ``record_every`` returns the (T // k, B, 6)
    trajectory (centre, velocity, hydrodynamic force per body).

    lbm_tpu validates the defaults on hardware (scripts/validate_tpu.py
    dkt, with row_slack=160): drafting closes the 10-cell gap by t ~ 24k,
    the pair kisses, then tumbles apart laterally."""
    device, dtype = default_device(device), default_float(dtype)
    _check_record(T, record_every)
    cen0 = np.asarray(centers, np.float64)
    B = cen0.shape[0]
    if B < 1:
        raise ValueError("need at least one body")
    if n_markers is None:
        n_markers = int(np.ceil(2.0 * np.pi * radius))
    half = int(np.ceil(radius)) + 5
    for b in range(B):
        if not (radius + 3 <= cen0[b, 0] <= H - radius - 3
                and radius + 3 <= cen0[b, 1] <= W - radius - 3):
            raise ValueError(f"center {tuple(cen0[b])} puts markers "
                             f"(+2-cell support) outside the {H}x{W} grid")
    if row_slack is None:
        row_slack = 4 * int(np.ceil(radius))
    span0 = float(cen0[:, 0].max() - cen0[:, 0].min())
    rw = min(H, int(np.ceil(span0)) + 2 * half + row_slack)
    area = np.pi * radius * radius
    dx, dy = circle_markers(torch.zeros(2, dtype=torch.float64), radius, n_markers)
    force = kmov.make_moving_bodies_step(H, W, dx, dy, n_bodies=B, rw=rw, half=half,
                                         g_net=(rho_s - 1.0) * area * gravity,
                                         m_eff=rho_s * area, radius=radius, m_max=m_max,
                                         zeta=zeta, eps=eps, dtype=dtype)
    grid = make_box_fused_step(H, W, omega, dtype=dtype)
    f, st, trajectory = _drive_bodies(
        force, grid, _rest(H, W, device, dtype),
        kmov.pack_states(cen0, dtype=dtype, device=device), T, record_every, 6,
        checkpoint_dir, checkpoint_every)
    # the window-budget check of lbm_tpu's _finish (obstacles.py:625-642)
    if trajectory is not None and trajectory.numel():
        rows = trajectory[:, :, 0]
        span = float((rows.max(dim=1).values - rows.min(dim=1).values).max())
    else:  # no trajectory: the final spread
        rows = st[:, 0].cpu()
        span = float(rows.max() - rows.min())
    if span + 2 * half > rw:
        import warnings
        warnings.warn(
            f"bodies spread to {span:.1f} rows — beyond the "
            f"{rw}-row forcing window budget; bodies outside the "
            f"window lose hydrodynamic forcing; raise row_slack")
    rho = d2q9.calc_rho(f)
    return FallingCylindersResult(f=f, rho=rho, u=d2q9.calc_u(f, rho), centers=st[:, 0:2],
                                  velocities=st[:, 2:4], steps=T, trajectory=trajectory)


def _ellipse_setup(H: int, W: int, center, a: float, b: float, n_markers, rho_s: float,
                   gravity: float):
    """(dx, dy, half, m_eff, i_eff, g_net) of a falling ellipse, checked
    against the grid."""
    if b > a:
        raise ValueError("require a >= b (semi-major along the body x)")
    if not (a + 3 <= center[0] <= H - a - 3 and a + 3 <= center[1] <= W - a - 3):
        raise ValueError(f"center {center} puts markers (+2-cell support) "
                         f"outside the {H}x{W} grid")
    dx, dy = ellipse_markers(a, b, n_markers)
    half = int(np.ceil(a)) + 5
    if 2 * half > H or 2 * half > W:
        raise ValueError("window exceeds grid; enlarge H/W")
    area = np.pi * a * b
    return (dx, dy, half, rho_s * area, rho_s * area * (a * a + b * b) / 4.0,
            (rho_s - 1.0) * area * gravity)


def ellipse_fsi_step(H: int, W: int, *, dx, dy, half: int, omega: float,
                     m_eff: float, i_eff: float, g_net: float,
                     m_max: int = 5, dtype: torch.dtype = torch.float32):
    """The plain step of the rotating-ellipse fluid-structure problem, on
    lbm_tpu's carry (f (9, H, W), cen (2,), ub (2,), cs (2,) orientation, w
    (), F_h (2,), T_h ()) on any device: the plain versions of kernels 20
    and 18 in turn, all differentiable torch ops (lbm_tpu's builder backs
    its differentiable rollouts, ROADMAP item 13)."""
    wr = 2 * half
    offsets: dict = {}

    def step(carry):
        f, cen, ub, cs, w, F_h, T_h = carry
        if f.device not in offsets:
            offsets[f.device] = tuple(torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                                                      device=f.device) for v in (dx, dy))
        state = torch.cat([cen, ub, F_h, cs, w[None], T_h[None]])[None]
        F_win, origin, new = kmov.plain_moving_rot(
            f, state, *offsets[f.device], half=half, wr=wr, wc=wr, g_net=g_net, m_eff=m_eff,
            i_eff=i_eff, m_max=m_max)
        s = new[0]
        return (plain_box_step(f, F_win, origin, omega), s[0:2], s[2:4], s[6:8], s[8], s[4:6],
                s[9])

    return step


@dataclass
class FallingEllipseResult:
    f: torch.Tensor
    rho: torch.Tensor
    u: torch.Tensor
    center: torch.Tensor       # (2,) final body centre
    velocity: torch.Tensor     # (2,) final body velocity
    orientation: torch.Tensor  # (2,) final (cos, sin) of the body angle
    omega_body: torch.Tensor   # () final angular velocity
    steps: int
    trajectory: torch.Tensor | None = None  # (T // k, 10): cen, ub, F_h, cos, sin, w, T_h; host


def falling_ellipse(H: int = 800, W: int = 256, T: int = 40000,
                    center=None, a: float = 16.0, b: float = 8.0,
                    theta0: float = 0.3,
                    n_markers: int | None = None, rho_s: float = 1.25,
                    gravity: float = 2e-4, omega: float = 1.0 / 0.6,
                    m_max: int = 5, record_every: int | None = 10,
                    checkpoint_dir: str | None = None,
                    checkpoint_every: int = 10000,
                    device=None, dtype: torch.dtype | None = None) -> FallingEllipseResult:
    """A sedimenting rigid ellipse with translation and rotation coupled: a
    body tilted by ``theta0`` (semi-major axis ``a`` from the fall axis,
    the rows) feels a hydrodynamic torque, turns broadside-on and glides
    sideways while tilted.

    Markers (ops/moving_ibm.py ellipse_markers, uniform in arc length) carry
    the rigid velocity U_b + w x r_j, r_j = R(theta) d_j; the per-marker
    forces close momentum and angular momentum, F_h = -sum f_j and T_h =
    -sum r_j x f_j, with falling_cylinder's update (m_eff = rho_s pi a b,
    I_eff = m_eff (a^2 + b^2) / 4) and the orientation advanced by the
    Cayley map (ops/moving_ibm.py cayley_rotate).  ``record_every`` returns
    the (T // k, 10) trajectory: centre, velocity, F_h, (cos, sin), angular
    velocity, torque.  ``center`` defaults to (H/4, W/2)."""
    device, dtype = default_device(device), default_float(dtype)
    _check_record(T, record_every)
    if center is None:
        center = (0.25 * H, 0.5 * W)
    dx, dy, half, m_eff, i_eff, g_net = _ellipse_setup(H, W, center, a, b, n_markers, rho_s,
                                                      gravity)
    force = kmov.make_moving_rot_step(H, W, dx, dy, half=half, g_net=g_net, m_eff=m_eff,
                                      i_eff=i_eff, m_max=m_max, dtype=dtype)
    grid = make_box_fused_step(H, W, omega, dtype=dtype)
    state = kmov.pack_state_rot(center, (float(np.cos(theta0)), float(np.sin(theta0))),
                                dtype=dtype, device=device)
    f, st, trajectory = _drive_bodies(force, grid, _rest(H, W, device, dtype), state, T,
                                      record_every, 10, checkpoint_dir, checkpoint_every)
    rho = d2q9.calc_rho(f)
    return FallingEllipseResult(f=f, rho=rho, u=d2q9.calc_u(f, rho), center=st[0, 0:2],
                                velocity=st[0, 2:4], orientation=st[0, 6:8],
                                omega_body=st[0, 8], steps=T,
                                trajectory=None if trajectory is None else trajectory[:, 0])
