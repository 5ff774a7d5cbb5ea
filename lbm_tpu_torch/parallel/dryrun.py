"""A one-step dry run of the sharded paths (counterpart of the 1-D part of
lbm_tpu's ``dryrun_multichip``, __graft_entry__.py:30-91).

    dryrun_multichip(8, devices=["cuda:0"] * 8)   # 8 shards on one card
    dryrun_multichip(8, devices=["cpu"] * 8)

Builds an n-shard mesh and runs ONE step at tiny shapes of: the periodic
BGK step with the 2-D halo exchange (an (n/2, 2) mesh when n is even and
above 2, else (n, 1)), the channel step with the pressure coupling across
the row cut, and kernel 27 (on CUDA devices; its plain version on CPU
ones) with ``substeps="auto"``.  The 2-D kernel part of lbm_tpu's dry run
waits for its sharded2d kernels.
"""

from __future__ import annotations

import torch

from ..kernels.bgk import bgk_collide_fn
from ..kernels.sharded import make_sharded_fused_step
from ..ops import d2q9
from . import mesh as meshmod
from . import sharded


def _rest_state(R: int, C: int, ux: float, device, incompressible: bool = False):
    u = torch.zeros((2, R, C), dtype=torch.float32, device=device)
    u[0] = ux
    rho = torch.ones((R, C), dtype=torch.float32, device=device)
    return (d2q9.incomp_equilibrium if incompressible else d2q9.equilibrium)(u, rho)


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
    R2 = 8 * n_devices
    sf = make_sharded_fused_step(m1, R2, 128, bgk_collide_fn(1.0, torch.float32),
                                 dtype=torch.float32, substeps="auto")
    out["sharded_fused"] = sf(meshmod.shard_state(m1, _rest_state(R2, 128, 0.02, dev0))).gather()

    for name, x in out.items():
        if not bool(torch.isfinite(x).all()):
            raise FloatingPointError(f"dry run {name}: non-finite values")
    return out

