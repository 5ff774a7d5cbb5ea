"""Halo exchange between the shards of a mesh (counterpart of
lbm_tpu/parallel/halo.py).

lbm_tpu exchanges halos inside ``shard_map`` with ``lax.ppermute`` rings.
Here one process holds every shard, so an exchange is a copy of each
neighbour's edge lines into a buffer on the receiving shard's device: a
kernel on the device when both shards share it, a device-to-device copy
when they do not.  Copies run on the current CUDA streams, ordered against
the kernels by stream order (PyTorch joins the two devices' streams with
events for a cross-device copy), so an exchange never waits on the host.

The payload is the full edge line of every plane: streaming it locally is
algebraically the reference's inter-domain binding
(decompose_domain.cpp:181-187).  Corners take the two-pass route: rows
first, then the columns of the row-padded blocks, so a diagonal cell comes
from the diagonal neighbour.
"""

from __future__ import annotations

import torch


def copy_to(src: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A fresh contiguous copy of ``src`` on ``device`` (always a copy, even on
    ``src``'s own device)."""
    out = torch.empty(src.shape, dtype=src.dtype, device=device)
    out.copy_(src, non_blocking=True)
    return out


def halo_pad_axis(grid, axis: str, width: int = 1):
    """Pad every block of a row-major grid of blocks (``grid[i][j]``, any
    leading component axes) with ``width`` lines from its ring neighbours
    along mesh axis 'x' (rows, tensor axis -2) or 'y' (columns, axis -1),
    periodically.  With one block along the axis, a block wraps to itself."""
    dim = -2 if axis == "x" else -1
    nx, ny = len(grid), len(grid[0])
    out = []
    for i in range(nx):
        row = []
        for j in range(ny):
            x = grid[i][j]
            if axis == "x":
                prev, nxt = grid[(i - 1) % nx][j], grid[(i + 1) % nx][j]
            else:
                prev, nxt = grid[i][(j - 1) % ny], grid[i][(j + 1) % ny]
            lo = copy_to(prev.narrow(dim, prev.shape[dim] - width, width), x.device)
            hi = copy_to(nxt.narrow(dim, 0, width), x.device)
            row.append(torch.cat([lo, x, hi], dim=dim))
        out.append(row)
    return out


def halo_pad_2d(grid, width: int = 1):
    """Periodic 2-D halo pad: rows, then the columns of the row-padded
    blocks, so the corner cells arrive from the diagonal neighbour."""
    return halo_pad_axis(halo_pad_axis(grid, "x", width), "y", width)


def exchange_rows(shards, width: int):
    """The row-ring exchange of a row-sharded field (mesh (n, 1)): for each
    shard i, ``(top, bot)`` with top = the last ``width`` rows of shard i-1
    and bot = the first ``width`` rows of shard i+1 (periodic; one shard
    wraps to itself), each a ``(planes, width, C)`` buffer on shard i's
    device."""
    n = len(shards)
    return [(copy_to(shards[(i - 1) % n][..., -width:, :], f.device),
             copy_to(shards[(i + 1) % n][..., :width, :], f.device))
            for i, f in enumerate(shards)]
