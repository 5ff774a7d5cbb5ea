"""A one-step dry run of the sharded paths (counterpart of the 1-D part of
lbm_tpu's ``dryrun_multichip``, __graft_entry__.py:30-91).

    dryrun_multichip(8, devices=["cuda:0"] * 8)   # 8 shards on one card
    dryrun_multichip(8, devices=["cpu"] * 8)

Builds an n-shard mesh and runs ONE step at tiny shapes of: the periodic
BGK step with the 2-D halo exchange (an (n/2, 2) mesh when n is even and
above 2, else (n, 1)), the channel step with the pressure coupling across
the row cut, kernel 27 with ``substeps="auto"``, on that (n/2, 2) mesh
kernel 34 (the rows x cols collide-stream, ``substeps=2``) and lbm_tpu's
2-D multiphase and thermal parts (__graft_entry__.py:103-177): kernel 38
(the full MRT-CG state with ``substeps="auto"``, then in CSF mode),
kernel 35 (Shan-Chen, 4 steps per exchange) and kernel 36 (the
Rayleigh-Benard step); and on the (n, 1) mesh kernel 31 (the full MRT-CG
state, :179-197), kernel 32 (Shan-Chen, 4 steps per exchange, :221-237)
and kernel 33 (the D3Q19 lid cavity with every wall, 2 steps per exchange,
:270-286); each kernel on CUDA devices, its plain version on CPU ones.
"""

from __future__ import annotations

import torch

from ..kernels import sharded as ksh
from ..kernels import sharded2d as k2d
from ..kernels.bgk import bgk_collide_fn
from ..ops import d2q9, d3q19
from ..scenes.multiphase import DEFAULT_BLUE, DEFAULT_RED, init_rho_cosine
from ..scenes.thermal import CS2, conduction_profile
from . import mesh as meshmod
from . import sharded


def _rest_state(R: int, C: int, ux: float, device, incompressible: bool = False):
    u = torch.zeros((2, R, C), dtype=torch.float32, device=device)
    u[0] = ux
    rho = torch.ones((R, C), dtype=torch.float32, device=device)
    return (d2q9.incomp_equilibrium if incompressible else d2q9.equilibrium)(u, rho)


def _rt_layers(R: int, C: int, device) -> torch.Tensor:
    """The full MRT-CG state F (2, 9, R, C) of the RT layers, float32."""
    r, b = (torch.as_tensor(init_rho_cosine(R, C, c.rho_0, below, -1.0), dtype=torch.float32,
                            device=device)
            for c, below in ((DEFAULT_RED, True), (DEFAULT_BLUE, False)))
    f = _rest_state(R, C, 0.0, device)
    tot = torch.clamp_min(r + b, 1e-30)[None]
    return torch.stack([r[None] * f / tot, b[None] * f / tot])


def _sc_liquid(R: int, C: int, device) -> torch.Tensor:
    """The dry run's Shan-Chen state: 0.7 + 0.01 cos(row) at rest."""
    f32 = torch.float32
    rho = 0.7 + 0.01 * torch.cos(torch.arange(R, dtype=f32, device=device))[:, None] \
        * torch.ones((1, C), dtype=f32, device=device)
    return d2q9.equilibrium(torch.zeros((2, R, C), dtype=f32, device=device), rho)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """One step of each sharded path on an ``n_devices``-shard mesh over
    ``devices`` (default: every CUDA device of the process, which must
    number ``n_devices``).  Returns each result gathered, finite-checked."""
    devs = list(meshmod.make_mesh(devices).flat)
    if len(devs) != n_devices:
        raise ValueError(f"{len(devs)} devices for a {n_devices}-shard dry run")
    dev0 = devs[0]
    out = {}

    # periodic BGK with the 2-D halo exchange (rows x cols when possible)
    ny = 2 if n_devices % 2 == 0 and n_devices > 2 else 1
    nx = n_devices // ny
    m = meshmod.make_mesh(devs, shape=(nx, ny))
    f = _rest_state(4 * nx, 8 * ny, 0.01, dev0)
    out["periodic_bgk"] = sharded.make_periodic_bgk_step(m, omega=1.0)(
        meshmod.shard_state(m, f)).gather()

    # the channel step with the coupled pressure BC across the row cut
    m1 = meshmod.make_mesh(devs, shape=(n_devices, 1))
    f1 = _rest_state(4 * n_devices, 8, 0.0, dev0, incompressible=True)
    out["channel_bgk"] = sharded.make_channel_bgk_step(m1, 1.0, 1.01, 1.0)(
        meshmod.shard_state(m1, f1)).gather()

    # kernel 27 with the "auto" cadence (8 steps per exchange for BGK)
    f32 = torch.float32
    R2 = 8 * n_devices
    sf = ksh.make_sharded_fused_step(m1, R2, 128, bgk_collide_fn(1.0, f32), dtype=f32,
                                     substeps="auto")
    out["sharded_fused"] = sf(meshmod.shard_state(m1, _rest_state(R2, 128, 0.02, dev0))).gather()

    if ny > 1:
        # kernel 34 on the rows x cols mesh, 2 steps per exchange
        R3, C3 = 16 * nx, 128 * ny
        sf2 = k2d.make_sharded_fused_step_2d(m, R3, C3, bgk_collide_fn(1.0, f32), dtype=f32,
                                             substeps=2)
        out["sharded_fused_2d"] = sf2(meshmod.shard_state(
            m, _rest_state(R3, C3, 0.02, dev0))).gather()

        # kernel 38: the full MRT-CG state with the "auto" cadence (2 steps
        # per exchange), then in CSF mode with a zero surface-force carry
        R4, C4 = 24 * nx, 32 * ny
        kw = dict(sigma=1e-4, gravity=(6.25e-7, 0.0), dtype=f32)
        F4 = _rt_layers(R4, C4, dev0)
        s4 = k2d.make_sharded2d_mrtcg_step(m, R4, C4, DEFAULT_RED, DEFAULT_BLUE,
                                           substeps="auto", **kw)
        out["sharded2d_mrtcg"] = s4(meshmod.shard_state(m, F4.reshape(18, R4, C4))).gather()
        s4c = k2d.make_sharded2d_mrtcg_step(m, R4, C4, DEFAULT_RED, DEFAULT_BLUE,
                                            surface_tension="csf", **kw)
        S4 = torch.cat([F4[0], F4[1], torch.zeros((2, R4, C4), dtype=f32, device=dev0)])
        out["sharded2d_csf"] = s4c(meshmod.shard_state(m, S4)).gather()

        # kernel 35: Shan-Chen, 4 steps per exchange
        s5 = k2d.make_sharded2d_sc_step(m, 16 * nx, C4, omega=1.0, G=-5.0, substeps=4,
                                        dtype=f32)
        out["sharded2d_sc"] = s5(meshmod.shard_state(m, _sc_liquid(16 * nx, C4, dev0))).gather()

        # kernel 36: the Rayleigh-Benard step from the conduction profile
        kap = CS2 * 0.3
        s6 = k2d.make_sharded2d_thermal_step(
            m, R4, C4, omega_f=1.0 / (0.71 * kap / CS2 + 0.5), omega_g=1.25,
            g_beta=4e3 * 0.71 * kap * kap / float(R4) ** 3, dtype=f32)
        theta = torch.as_tensor(conduction_profile(R4), dtype=f32, device=dev0)[:, None] \
            * torch.ones((1, C4), dtype=f32, device=dev0)
        u0 = torch.zeros((2, R4, C4), dtype=f32, device=dev0)
        S6 = torch.cat([d2q9.equilibrium(u0, torch.ones((R4, C4), dtype=f32, device=dev0)),
                        d2q9.equilibrium(u0, theta)])
        out["sharded2d_thermal"] = s6(meshmod.shard_state(m, S6)).gather()

    # kernel 31: the full MRT-CG state F (2, 9, R, C) of the RT layers
    Rm, Cm = 24 * n_devices, 128
    sm = ksh.make_sharded_mrtcg_step(m1, Rm, Cm, DEFAULT_RED, DEFAULT_BLUE, sigma=1e-4,
                                     gravity=(6.25e-7, 0.0), dtype=f32)
    F = _rt_layers(Rm, Cm, dev0)
    out["sharded_mrtcg"] = sm(meshmod.shard_state(m1, F.reshape(18, Rm, Cm))).gather()

    # kernel 32: Shan-Chen, 4 steps per exchange
    Rs = 24 * n_devices
    s_sc = ksh.make_sharded_sc_step(m1, Rs, 128, omega=1.0, G=-5.0, substeps=4, dtype=f32)
    out["sharded_sc"] = s_sc(meshmod.shard_state(m1, _sc_liquid(Rs, 128, dev0))).gather()

    # kernel 33: the D3Q19 lid cavity, y sharded, 2 steps per exchange
    X3, Y3, Z3 = 2, 24 * n_devices, 128
    s_3d = ksh.make_sharded_d3q19_step(m1, X3, Y3, Z3, omega=1.0, x_walls=True,
                                       y_walls=True, z_walls=True, lid_u=0.05, substeps=2,
                                       dtype=f32)
    f3 = d3q19.equilibrium(torch.zeros((3, X3, Y3, Z3), dtype=f32, device=dev0),
                           torch.ones((X3, Y3, Z3), dtype=f32, device=dev0))
    out["sharded_d3q19"] = s_3d(meshmod.shard_state(m1, f3.reshape(19 * X3, Y3, Z3))).gather()

    for name, x in out.items():
        if not bool(torch.isfinite(x).all()):
            raise FloatingPointError(f"dry run {name}: non-finite values")
    return out

