"""Multiphase scenes: static droplets and Rayleigh-Taylor in the MRT-CG,
MRT-CSF and RK colour-gradient families (counterpart of
lbm_tpu/scenes/multiphase.py).

The MRT-CG scenes run lbm_tpu's fused dataflow on either device: the
reduced 10-plane state (12 in CSF mode) for T-1 steps, then one split step
that writes the per-colour populations, and u rebuilt from them.  On a CUDA
state the steps are CUDA kernels 6 (reduced) and 7 (split); on a CPU state
their plain versions (kernels/mrtcg.py).  The step derives its velocity
from the populations, u = (momentum + 0.5 (Fg [+ fst])) / rho, from the
first step on; lbm_tpu's jnp path instead carries the u of ``init_state``
into its first step (ROADMAP Queue 3).

``rk_rayleigh_taylor`` runs the 11-plane RK mixture step (kernel 12 on the
card) and ``csf_static_droplet`` the 20-plane CSF droplet step (kernel 13);
``rk_static_droplet`` has no TPU kernel in lbm_tpu and runs the
RKDropletModel as plain tensor ops on either device.

Not in the port: lbm_tpu's ``fused`` flag (the device decides), the
checkpoint and snapshot-file options (their drive loop, ``_run_reduced``,
does not take them yet, ROADMAP Queue 1 item 12; they raise if set), and
the df64 scene (native float64 replaces it, Queue 1 item 15).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..boundary import bc
from ..core.params import ColourParams, DomainParams, GeneralParams, load_toml
from ..kernels.csf_droplet import make_csf_droplet_fused_step
from ..kernels.mrtcg import (make_mrtcg_reduced_step, make_mrtcg_split_step,
                             reduce_mrtcg_state)
from ..kernels.rk import make_rk_fused_step
from ..models.mrt_cg import ColourFields, MRTCGModel, TwoPhaseState, phase_field
from ..models.mrt_csf_droplet import CSFColour, CSFColourFields, CSFDropletModel, CSFState
from ..models.rk_cg import RKDropletColour, RKDropletModel, RKMixtureModel, RKMixtureState
from ..ops import d2q9
from ..utils import observe
from ..utils.xmath import default_device, default_float

CHUNK = 1000  # steps between progress logs and NaN checks


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def init_rho_droplet(R: int, C: int, rho_0: float, inside: bool,
                     radius: float = 25.0, sharpness: float = 1.0) -> np.ndarray:
    """Sigmoid droplet of given radius centred at (R/2, R/2).
    cites reference test/mrtcg_static_droplet.cpp:182-203"""
    center = R / 2.0
    r = np.arange(R)[:, None]
    c = np.arange(C)[None, :]
    s = np.sqrt((r - center) ** 2 + (c - center) ** 2)
    ans = (1.0 - _sigmoid(sharpness * (s - radius)) if inside
           else _sigmoid(sharpness * (s - radius)))
    return rho_0 * ans


def init_rho_cosine(R: int, C: int, rho_0: float, fill_below: bool,
                    amplitude_sign: float = -1.0) -> np.ndarray:
    """Heavy/light layers split at s(c) = R/2 + sign 0.1 C cos(2 pi c / C);
    ``fill_below`` selects rows r < s.  cites reference
    test/mrtcg_rayleigh_taylor.cpp:182-210 (sign -1) and
    test/mrt_rayleigh_taylor.cpp:184-212 (sign +1)."""
    r = np.arange(R)[:, None] * np.ones((1, C))
    c = np.ones((R, 1)) * np.arange(C)[None, :]
    s = R / 2.0 + amplitude_sign * 0.1 * C * np.cos(2.0 * 3.141592 * c / C)
    mask = (r < s) if fill_below else (r >= s)
    return rho_0 * mask.astype(np.float64)


def init_rho_modes(R: int, C: int, rho_0: float, fill_below: bool,
                   modes=((1, -0.1), (3, 0.03), (5, 0.015))) -> np.ndarray:
    """Multi-mode RT interface s(c) = R/2 + C sum_m a_m cos(2 pi m c / C),
    ``modes`` a sequence of (mode number, amplitude as a fraction of C):
    the study the reference declares (CMakeLists.txt:149-152) but ships no
    source for."""
    r = np.arange(R)[:, None] * np.ones((1, C))
    c = np.ones((R, 1)) * np.arange(C)[None, :]
    s = R / 2.0 + C * sum(a * np.cos(2.0 * 3.141592 * m * c / C) for m, a in modes)
    mask = (r < s) if fill_below else (r >= s)
    return rho_0 * mask.astype(np.float64)


def mrtcg_boundary(f_adve, f_coll):
    """The multiphase drivers' wall rule: periodic left-right (no diagonal
    offset, rows 1..-2), then bounce-back bottom and top.
    cites reference test/mrtcg_rayleigh_taylor.cpp:495-533"""
    f_adve = bc.periodic_edge(f_adve, f_coll, "col0", lane=slice(1, -1),
                              diagonal_shift=False)
    f_adve = bc.periodic_edge(f_adve, f_coll, "colN", lane=slice(1, -1),
                              diagonal_shift=False)
    f_adve = bc.bounce_back(f_adve, f_coll, "rowN")
    return bc.bounce_back(f_adve, f_coll, "row0")


DEFAULT_RED = ColourParams(rho_0=3.0, alpha=0.7, A=0.5, nu=0.04, beta=0.7)
DEFAULT_BLUE = ColourParams(rho_0=1.0, alpha=0.1, A=0.5, nu=0.04, beta=-0.7)


@dataclass
class MultiphaseResult:
    state: object  # TwoPhaseState, RKDropletState, RKMixtureState or CSFState
    steps: int
    snapshots: dict


def _not_ported(**options) -> None:
    for name, value in options.items():
        if value is not None:
            raise NotImplementedError(
                f"{name} waits for the MRT-CG scenes' checkpoint and snapshot files "
                "(ROADMAP Queue 1 item 12); the port does not take it yet")


def _run_reduced(step, split, G: torch.Tensor, T: int, chunk: int, record=None,
                 record_after: bool = False):
    """T-1 reduced steps in chunks of ``chunk``, then the split step.

    ``record(state, reduced)`` takes a frame before each chunk (or after
    it, with ``record_after``: lbm_tpu's CSF scene); the NaN watchdog runs
    after each chunk.  Returns (the split step's output or None when T is
    0, the frames)."""
    meter = observe.StepMeter(G[0].numel(), G.device, total_steps=T)
    frames = []
    done, out = 0, None
    while done < T:
        if record and not record_after:
            frames.append(record(G, True))
        n = min(chunk, T - done)
        last = done + n == T
        for _ in range(n - 1 if last else n):
            G = step(G)
        if last:
            out = split(G)
        done += n
        meter.update(n)
        observe.check_finite(out if last else G, done)
        if record and record_after:
            frames.append(record(out, False) if last else record(G, True))
    return out, frames


def _two_phase(rf, bf, fg, fst=None) -> TwoPhaseState:
    """The per-colour state with u = calc_u + 0.5 (Fg [+ fst]) / rho."""
    r_rho, b_rho = d2q9.calc_rho(rf), d2q9.calc_rho(bf)
    rho = r_rho + b_rho
    shift = torch.as_tensor(fg, dtype=rf.dtype, device=rf.device)[:, None, None]
    if fst is not None:
        shift = shift + fst
    u = d2q9.calc_u(rf + bf, rho) + 0.5 * shift / rho
    return TwoPhaseState(ColourFields(rf, r_rho), ColourFields(bf, b_rho), u)


def _psi_of(red, blue):
    """psi(state, reduced=True): the phase field of a reduced or full state."""
    def psi(G, reduced=True):
        if reduced:
            rho = d2q9.calc_rho(G[:9])
            return phase_field(G[9], red.rho_0, rho - G[9], blue.rho_0)
        return phase_field(d2q9.calc_rho(G[:9]), red.rho_0, d2q9.calc_rho(G[9:18]),
                           blue.rho_0)
    return psi


def _stack(frames, names) -> dict:
    return {k: (np.stack([f[i] for f in frames]) if frames else None)
            for i, k in enumerate(names)}


def mrtcg_static_droplet(R: int = 100, C: int = 100, T: int = 100,
                         red: ColourParams = DEFAULT_RED,
                         blue: ColourParams = DEFAULT_BLUE,
                         sigma: float = 0.1, radius: float = 25.0,
                         snapshot_every: int | None = None,
                         device=None, dtype: torch.dtype | None = None) -> MultiphaseResult:
    """MRT-CG static droplet (the Laplace-law scene).  Workload and
    constants cite reference test/mrtcg_static_droplet.cpp: L=100, T=100,
    sigma=0.1 (:439), Fg=(0, -6.25e-6) with the force source disabled
    (:452, :513).  lbm_tpu measured the converged jump dp = 2 sigma/radius
    (the colour-blind perturbation enters once per colour,
    mrtcg_static_droplet.cpp:505).  Snapshots: "rho" and "psi" every
    ``snapshot_every`` steps.  ``device`` defaults to cuda, ``dtype`` to
    float64."""
    device, dtype = default_device(device), default_float(dtype)
    gravity = (0.0, -6.25e-6)
    model = MRTCGModel(red=red, blue=blue, sigma=sigma, gravity=gravity,
                       apply_gravity_source=False, boundary=mrtcg_boundary)
    r0 = init_rho_droplet(R, C, red.rho_0, inside=True, radius=radius)
    b0 = init_rho_droplet(R, C, blue.rho_0, inside=False, radius=radius)
    st = model.init_state(r0, b0, dtype=dtype, u_init_gravity_shift=True, device=device)
    F = torch.stack([st.red.f, st.blue.f])
    kw = dict(sigma=sigma, gravity=gravity, apply_gravity_source=False, dtype=dtype)
    psi = _psi_of(red, blue)
    out, frames = _run_reduced(
        make_mrtcg_reduced_step(R, C, red, blue, **kw),
        make_mrtcg_split_step(R, C, red, blue, **kw), reduce_mrtcg_state(F), T,
        snapshot_every or CHUNK,
        record=(lambda G, _: (d2q9.calc_rho(G[:9]).cpu().numpy(), psi(G).cpu().numpy()))
        if snapshot_every else None)
    F = F if out is None else out
    return MultiphaseResult(state=_two_phase(F[0], F[1], gravity), steps=T,
                            snapshots=_stack(frames, ("rho", "psi")))


def mrtcg_rayleigh_taylor(config_path: str | None = None,
                          R: int | None = None, C: int | None = None,
                          T: int | None = None,
                          red: ColourParams | None = None,
                          blue: ColourParams | None = None,
                          sigma: float | None = None,
                          gravity_magnitude: float | None = None,
                          snapshot_every: int | None = None,
                          checkpoint_dir: str | None = None,
                          checkpoint_every: int | None = None,
                          modes=None,
                          snapshot_prefix: str | None = None,
                          device=None, dtype: torch.dtype | None = None) -> MultiphaseResult:
    """MRT-CG Rayleigh-Taylor.  Defaults follow the reference's shipped TOML
    (mrtcg-rayleigh-taylor-gamma3.toml:4-22) with the [general] table
    mrtcg_rayleigh_taylor.cpp:360-362 requires: 256x128, 100k steps,
    sigma 1e-4, gravity 6.25e-7 along the rows, heavy (red) fluid in rows
    r < s.  Explicit keywords win over ``config_path``.  ``modes`` switches
    to the multi-mode interface of init_rho_modes.  Snapshots: "psi" and
    "ux" every ``snapshot_every`` steps."""
    _not_ported(checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
                snapshot_prefix=snapshot_prefix)
    device, dtype = default_device(device), default_float(dtype)
    if config_path:
        tbl = load_toml(config_path)
        dom = DomainParams.from_toml(tbl)
        R = R if R is not None else dom.R
        C = C if C is not None else dom.C
        T = T if T is not None else dom.T
        red = red or ColourParams.from_toml(tbl, "red")
        blue = blue or ColourParams.from_toml(tbl, "blue")
        if "general" in tbl:
            gen = GeneralParams.from_toml(tbl)
            sigma = sigma if sigma is not None else gen.sigma
            if gravity_magnitude is None:
                gravity_magnitude = gen.gravity_magnitude
        snapshot_every = snapshot_every or dom.period_snapshots
    R = R if R is not None else 256
    C = C if C is not None else 128
    T = T if T is not None else 100000
    red = red or DEFAULT_RED
    blue = blue or DEFAULT_BLUE
    sigma = sigma if sigma is not None else 1e-4
    gravity_magnitude = gravity_magnitude if gravity_magnitude is not None else 6.25e-7
    gravity = (gravity_magnitude, 0.0)

    model = MRTCGModel(red=red, blue=blue, sigma=sigma, gravity=gravity,
                       apply_gravity_source=True, boundary=mrtcg_boundary)
    if modes is not None:
        r0 = init_rho_modes(R, C, red.rho_0, fill_below=True, modes=modes)
        b0 = init_rho_modes(R, C, blue.rho_0, fill_below=False, modes=modes)
    else:
        r0 = init_rho_cosine(R, C, red.rho_0, fill_below=True, amplitude_sign=-1.0)
        b0 = init_rho_cosine(R, C, blue.rho_0, fill_below=False, amplitude_sign=-1.0)
    st = model.init_state(r0, b0, dtype=dtype, device=device)
    F = torch.stack([st.red.f, st.blue.f])
    kw = dict(sigma=sigma, gravity=gravity, dtype=dtype)
    psi = _psi_of(red, blue)

    def record(G, _):
        rho = d2q9.calc_rho(G[:9])
        ux = d2q9.calc_momentum(G[:9])[0] / rho
        return psi(G).cpu().numpy(), ux.cpu().numpy()

    out, frames = _run_reduced(
        make_mrtcg_reduced_step(R, C, red, blue, **kw),
        make_mrtcg_split_step(R, C, red, blue, **kw), reduce_mrtcg_state(F), T,
        snapshot_every or CHUNK, record=record if snapshot_every else None)
    F = F if out is None else out
    return MultiphaseResult(state=_two_phase(F[0], F[1], gravity), steps=T,
                            snapshots=_stack(frames, ("psi", "ux")))


def mrtcg_multimode_rayleigh_taylor(modes=((1, -0.1), (3, 0.03), (5, 0.015)), **kwargs):
    """Multi-mode MRT-CG Rayleigh-Taylor: mrtcg_rayleigh_taylor with a
    superposition of interface modes (the reference's declared
    `mrtcg_multiple_mode_rayleigh_taylor`, CMakeLists.txt:149-152).  With
    the default sigma and gravity only wavelengths above ~80 cells are
    unstable (lbm_tpu's measurement), so on C=128 the extra modes decay."""
    return mrtcg_rayleigh_taylor(modes=modes, **kwargs)


def mrt_csf_rayleigh_taylor(R: int = 256, C: int = 128, T: int = 10000,
                            red: ColourParams = DEFAULT_RED,
                            blue: ColourParams = DEFAULT_BLUE,
                            sigma: float = 1e-4,
                            gravity_magnitude: float = 6.25e-7,
                            snapshot_every: int | None = None,
                            device=None, dtype: torch.dtype | None = None) -> MultiphaseResult:
    """CSF-curvature variant of the MRT colour-gradient RT.
    cites reference test/mrt_rayleigh_taylor.cpp:392-545 (interface sign
    +1, initial u = 0.5 Fg/red.rho_0, the u shift includes the surface
    force).  The equilibria are built at u = 0 and the surface-force carry
    is seeded with fst0 = Fg (rho/red.rho_0 - 1), so the first step's
    derived velocity is the reference's 0.5 Fg/red.rho_0 (lbm_tpu
    scenes/multiphase.py:474-482).  Snapshots: "psi" after every
    ``snapshot_every`` steps."""
    device, dtype = default_device(device), default_float(dtype)
    gravity = (gravity_magnitude, 0.0)
    model = MRTCGModel(red=red, blue=blue, sigma=sigma, gravity=gravity,
                       boundary=mrtcg_boundary, surface_tension="csf")
    r0 = init_rho_cosine(R, C, red.rho_0, True, 1.0)
    b0 = init_rho_cosine(R, C, blue.rho_0, False, 1.0)
    st = model.init_state(r0, b0, dtype=dtype, device=device)
    fg = torch.as_tensor(gravity, dtype=dtype, device=device)[:, None, None]
    fst0 = fg * ((st.red.rho + st.blue.rho)[None] / red.rho_0 - 1.0)
    S = torch.cat([st.red.f, st.blue.f, fst0])
    kw = dict(sigma=sigma, gravity=gravity, surface_tension="csf", dtype=dtype)
    psi = _psi_of(red, blue)
    out, frames = _run_reduced(
        make_mrtcg_reduced_step(R, C, red, blue, **kw),
        make_mrtcg_split_step(R, C, red, blue, **kw),
        reduce_mrtcg_state(S, "csf"), T, snapshot_every or CHUNK,
        record=(lambda G, reduced: (psi(G, reduced).cpu().numpy(),))
        if snapshot_every else None, record_after=True)
    S = S if out is None else out
    return MultiphaseResult(state=_two_phase(S[:9], S[9:18], gravity, S[18:]), steps=T,
                            snapshots=_stack(frames, ("psi",)))


def _run_steps(step, state, T: int, snapshot_every: int | None, record, watched):
    """T calls of ``step`` from ``state`` in chunks of ``snapshot_every``
    (else CHUNK) steps: a frame ``record(state)`` before each chunk when
    recording, the NaN watchdog on ``watched(state)`` after it.  Returns
    (state, frames)."""
    meter = observe.StepMeter(watched(state)[0].numel(), watched(state).device,
                              total_steps=T)
    frames, done = [], 0
    while done < T:
        if snapshot_every:
            frames.append(tuple(x.cpu().numpy() for x in record(state)))
        n = min(snapshot_every or CHUNK, T - done)
        for _ in range(n):
            state = step(state)
        done += n
        meter.update(n)
        observe.check_finite(watched(state), done)
    return state, frames


def rk_static_droplet(L: int = 101, T: int = 2000, radius: float = 25.0,
                      sigma: float = 5e-3, snapshot_every: int | None = None,
                      exact_periodic: bool = False, device=None,
                      dtype: torch.dtype | None = None) -> MultiphaseResult:
    """RK (Reis-Phillips) static droplet, plain tensor ops on either device
    (lbm_tpu has no TPU kernel for it).  Constants cite reference
    test/rk_static_droplet_test.cpp:504-506: red (rho_0 1.2, alpha 1/3,
    A 1e-4, nu 0.16, beta +0.7), blue (rho_0 1.0, alpha 0.2, A 1e-4,
    nu 0.14, beta -0.7), delta 0.98.  The default edges reproduce the
    driver's full-edge wrap copy, which slowly exchanges colour mass;
    ``exact_periodic=True`` streams exactly periodically.  Snapshots:
    "r_rho" and "b_rho" every ``snapshot_every`` steps."""
    device, dtype = default_device(device), default_float(dtype)
    red = RKDropletColour(rho_0=1.2, alpha=1.0 / 3.0, A=1e-4, nu=0.16, beta=0.7)
    blue = RKDropletColour(rho_0=1.0, alpha=0.2, A=1e-4, nu=0.14, beta=-0.7)
    model = RKDropletModel(red=red, blue=blue, sigma=sigma, delta=0.98,
                           exact_periodic=exact_periodic)
    state = model.init_state(init_rho_droplet(L, L, red.rho_0, True, radius, 2.0),
                             init_rho_droplet(L, L, blue.rho_0, False, radius, 2.0),
                             dtype=dtype, device=device)
    state, frames = _run_steps(model.step, state, T, snapshot_every,
                               lambda s: (s.red.rho, s.blue.rho), lambda s: s.red.f)
    return MultiphaseResult(state=state, steps=T, snapshots=_stack(frames, ("r_rho", "b_rho")))


def rk_rayleigh_taylor(L: int = 256, T: int = 100000, sigma: float = 0.1, nu: float = 0.04,
                       gravity: tuple[float, float] = (-6.25e-6, 0.0),
                       snapshot_every: int | None = None, device=None,
                       dtype: torch.dtype | None = None) -> MultiphaseResult:
    """RK-CG Rayleigh-Taylor on a 4L x L grid, the reference's largest
    single-domain workload (1024x256 at the default L).  Constants cite
    reference test/rk_rayleigh_taylor_test.cpp:81-126: red (alpha 11/15,
    rho_0 3), blue (alpha 0.2, rho_0 1), beta 0.7, Fg (-6.25e-6, 0).  As in
    lbm_tpu the walls are those of the MRT-CG RT driver (periodic columns,
    bounce-back rows; the reference driver does not build) with the +/-beta
    recolouring split.  Each step is the fused 11-plane step of
    kernels/rk.py: CUDA kernel 12 on the card, one launch per step.
    Snapshots: "r_rho" and "ux" every ``snapshot_every`` steps."""
    device, dtype = default_device(device), default_float(dtype)
    R, C = 4 * L, L
    kw = dict(r_alpha=11.0 / 15.0, b_alpha=0.2, r_nu=nu, b_nu=nu, sigma=sigma, beta=0.7,
              gravity=gravity)
    model = RKMixtureModel(r_rho_0=3.0, b_rho_0=1.0, boundary=mrtcg_boundary, **kw)
    st = model.init_state(init_rho_cosine(R, C, 3.0, fill_below=False, amplitude_sign=1.0),
                          init_rho_cosine(R, C, 1.0, fill_below=True, amplitude_sign=1.0),
                          dtype=dtype, device=device)
    step = make_rk_fused_step(R, C, dtype=dtype, **kw)
    S = torch.cat([st.f, st.r_rho[None], st.b_rho[None]]).contiguous()

    def record(S):
        return S[9], d2q9.calc_momentum(S[:9])[0] / (S[9] + S[10])

    S, frames = _run_steps(step, S, T, snapshot_every, record, lambda S: S)
    u = d2q9.calc_u(S[:9], S[9] + S[10])
    return MultiphaseResult(state=RKMixtureState(S[:9], S[9], S[10], u), steps=T,
                            snapshots=_stack(frames, ("r_rho", "ux")))


def csf_static_droplet(L: int = 100, T: int = 100, radius: float = 25.0, sigma: float = 0.1,
                       snapshot_every: int | None = None, device=None,
                       dtype: torch.dtype | None = None) -> MultiphaseResult:
    """Moment-space MRT + CSF static droplet (experimental in lbm_tpu: the
    reference driver is unvalidated work in progress; for Laplace-law
    physics use mrtcg_static_droplet).  Constants cite reference
    test/static_droplet_test.cpp:476-486: L 100, radius 25, sigma 0.1,
    red/blue (rho_0 1, alpha 0.2, nu 0.1667, A 0.5, beta +/-0.7), T 100
    (:500), the sharpness-2 sigmoid (:413-430).  lbm_tpu measured the
    formulation going non-finite between steps 50 and 100 in float32 at
    L = 128; float64 (the default) keeps the colour masses at L = 100.
    Each step is the fused 20-plane step of kernels/csf_droplet.py: CUDA
    kernel 13 on the card.  Snapshots: "rho" and "psi" every
    ``snapshot_every`` steps."""
    device, dtype = default_device(device), default_float(dtype)
    red = CSFColour(rho_0=1.0, alpha=0.2, nu=0.1667, A=0.5, beta=0.7)
    blue = CSFColour(rho_0=1.0, alpha=0.2, nu=0.1667, A=0.5, beta=-0.7)
    model = CSFDropletModel(red=red, blue=blue, sigma=sigma, delta=0.1)
    st = model.init_state(init_rho_droplet(L, L, red.rho_0, True, radius, 2.0),
                          init_rho_droplet(L, L, blue.rho_0, False, radius, 2.0),
                          dtype=dtype, device=device)
    step = make_csf_droplet_fused_step(L, L, red, blue, sigma, dtype=dtype)
    S = torch.cat([st.red.f, st.blue.f, torch.zeros((2, L, L), dtype=dtype, device=device)])

    def record(S):
        r_rho, b_rho = d2q9.calc_rho(S[:9]), d2q9.calc_rho(S[9:18])
        return r_rho + b_rho, (r_rho - b_rho) / (r_rho + b_rho)

    S, frames = _run_steps(step, S, T, snapshot_every, record, lambda S: S)
    rf, bf, fs = S[:9], S[9:18], S[18:]
    r_rho, b_rho = d2q9.calc_rho(rf), d2q9.calc_rho(bf)
    rho = r_rho + b_rho
    u = d2q9.calc_u(rf + bf, rho) + 0.5 * fs / rho[None]
    return MultiphaseResult(state=CSFState(CSFColourFields(rf, r_rho),
                                           CSFColourFields(bf, b_rho), u),
                            steps=T, snapshots=_stack(frames, ("rho", "psi")))
