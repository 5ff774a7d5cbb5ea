"""Sharded LBM steps with an explicit halo exchange (counterpart of the
shard_map path of lbm_tpu/parallel/sharded.py).

Each step takes a ``ShardedState`` and returns one: every shard collides
locally, the exchange (parallel/halo.py) brings the neighbours' edge lines,
and each shard streams its padded block and keeps the interior, as the
reference's advect plus "bind the domains" copies do
(decompose_domain.cpp:159-187).  These steps are plain PyTorch in lbm_tpu
too: it has no kernel for them.  They equal the single-device steps bit
for bit (same elementwise arithmetic; the exchange and the rolls only move
values).

lbm_tpu's ``auto_sharded`` (the GSPMD path) has no counterpart yet; the
row-sharded kernel steps live in kernels/sharded.py.
"""

from __future__ import annotations

import torch

from ..boundary import bc
from ..ops import d2q9
from . import halo
from .mesh import Mesh, ShardedState


def _grid(state: ShardedState, blocks) -> list:
    ny = state.mesh.shape["y"]
    return [list(blocks[i * ny:(i + 1) * ny]) for i in range(state.mesh.shape["x"])]


def sweep_block(padded: torch.Tensor, width: int, collide_fn=None, substeps: int = 1,
                body=None, rows: torch.Tensor | None = None,
                cols: torch.Tensor | None = None) -> torch.Tensor:
    """``substeps`` sweeps over a block padded with ``width`` lines on every
    side, each the periodic ``collide_fn`` (none: streaming alone) then the
    push streaming, or with ``body`` a family's step ``body(block, rows,
    cols)`` that takes the block's global rows ``rows`` and wrapped global
    columns ``cols`` (the rows x cols body steps of kernels/sharded2d.py).
    Every sweep leaves as many lines stale on each side as it reaches (one
    for the collide-stream), so ``substeps`` times that is at most
    ``width``.  Returns the block's interior."""
    for _ in range(substeps):
        if body is not None:
            padded = body(padded, rows, cols)
        else:
            padded = d2q9.stream(padded if collide_fn is None else collide_fn(padded))
    return padded[..., width:-width, width:-width].contiguous()


def stream_halo(grid, collide_fn=None, substeps: int = 1, width: int = 1) -> list:
    """Periodic streaming of a row-major grid of ``(9, r, c)`` blocks: a
    ``width``-line halo exchange in both mesh axes, ``sweep_block`` over
    each padded block (by default the streaming of collided blocks, one
    line wide).  Returns the blocks in row-major order."""
    return [sweep_block(padded, width, collide_fn, substeps)
            for row in halo.halo_pad_2d(grid, width) for padded in row]


def _check_state(state: ShardedState, mesh: Mesh) -> None:
    if state.mesh != mesh:
        raise ValueError("the state is sharded over another mesh than the step's")


def make_periodic_bgk_step(mesh: Mesh, omega: float, incompressible: bool = False):
    """Fully periodic BGK step on any (nx, ny) mesh (doubly periodic
    scenes): ShardedState -> ShardedState."""

    def step(state: ShardedState) -> ShardedState:
        _check_state(state, mesh)
        colls = []
        for f in state.shards:
            rho = d2q9.calc_rho(f)
            u = d2q9.calc_momentum(f) if incompressible else d2q9.calc_u(f, rho)
            feq = (d2q9.incomp_equilibrium if incompressible else d2q9.equilibrium)(u, rho)
            colls.append(d2q9.bgk_collision(f, feq, omega))
        return ShardedState(mesh, stream_halo(_grid(state, colls)))

    return step


def _virtual_line(u_line, fc_line, fe_line, rho_target: float):
    """The pressure-periodic virtual line of bc.pressure_periodic, from one
    (2 + 9 + 9)-value line of the far side, in its arithmetic."""
    ones = torch.ones_like(fc_line[0])
    return d2q9.incomp_equilibrium(u_line, rho_target * ones) + fc_line - fe_line


def make_channel_bgk_step(mesh: Mesh, omega: float, rho_inlet: float, rho_outlet: float):
    """The horizontal-Poiseuille step sharded over rows (mesh (n, 1)),
    columns local: incompressible BGK, the pressure-periodic rows coupled
    across the cut, no-slip column walls.  Rank 0's virtual inlet is built
    from rank n-1's outlet line (global row R-2) and rank n-1's virtual
    outlet from rank 0's inlet line (global row 1), each line copied to
    the rank that uses it, as decompose_domain.cpp:50-73 couples its two
    domains.  ShardedState -> ShardedState, equal to the single-device
    channel step (kernels/channel.py channel_model) bit for bit."""
    if mesh.shape["y"] != 1:
        raise ValueError(f"the channel step shards rows only, got mesh {mesh.shape}")

    def step(state: ShardedState) -> ShardedState:
        _check_state(state, mesh)
        if state.shards[-1].shape[1] < 2:
            raise ValueError("the channel step needs at least 2 rows per shard")
        parts = []
        for f in state.shards:
            rho = d2q9.calc_rho(f)
            u = d2q9.calc_momentum(f)
            f_equi = d2q9.incomp_equilibrium(u, rho)
            parts.append((u, d2q9.bgk_collision(f, f_equi, omega), f_equi))
        colls = [fc for _, fc, _ in parts]
        # the coupled pressure BC: the lines cross the cut as copies
        first, last = colls[0].device, colls[-1].device
        u_n, fc_n, fe_n = (halo.copy_to(x[:, -2:-1], first) for x in parts[-1])
        u_0, fc_0, fe_0 = (halo.copy_to(x[:, 1:2], last) for x in parts[0])
        # (the lines are copies: writing the virtual lines in place is safe)
        colls[0][:, 0:1] = _virtual_line(u_n, fc_n, fe_n, rho_inlet)
        colls[-1][:, -1:] = _virtual_line(u_0, fc_0, fe_0, rho_outlet)
        streamed = stream_halo(_grid(state, colls))
        out = []
        for f_new, f_coll in zip(streamed, colls):
            f_new = bc.bounce_back(f_new, f_coll, "colN")
            out.append(bc.bounce_back(f_new, f_coll, "col0"))
        return ShardedState(mesh, out)

    return step
