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
from the diagonal neighbour.  ``exchange_rows`` and ``exchange_2d`` send
the strips of the kernel steps (kernels/sharded.py, kernels/sharded2d.py):
edge strips only, never a copy of a whole shard.  ``ring_rows`` and
``ring_2d`` hand a kernel the lines of a neighbour on its own device in
place, as views, and copy only across devices (kernels 27 and 33; 34 takes
``ring_2d``'s 3 x 3 parts of each padded block).
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
    periodically: ``exchange_rows``' strips, along 'y' those of the
    transposed blocks.  With one block along the axis, a block wraps to
    itself."""
    if axis == "y":
        flip = [[x.transpose(-2, -1) for x in col] for col in zip(*grid)]
        return [[x.transpose(-2, -1).contiguous() for x in col]
                for col in zip(*halo_pad_axis(flip, "x", width))]
    nx, ny = len(grid), len(grid[0])
    strips = [exchange_rows([grid[i][j] for i in range(nx)], width) for j in range(ny)]
    return [[torch.cat([strips[j][i][0], grid[i][j], strips[j][i][1]], dim=-2)
             for j in range(ny)] for i in range(nx)]


def pad_block(f: torch.Tensor, top, bot, left, right) -> torch.Tensor:
    """A block with the four strips of ``exchange_2d`` around it."""
    return torch.cat([left, torch.cat([top, f, bot], dim=-2), right], dim=-1)


def halo_pad_2d(grid, width: int = 1):
    """Periodic 2-D halo pad: each block with ``exchange_2d``'s strips around
    it, so the corner cells arrive from the diagonal neighbour."""
    ny = len(grid[0])
    padded = [pad_block(x, *strips) for x, strips in
              zip((x for row in grid for x in row), exchange_2d(grid, width))]
    return [padded[i:i + ny] for i in range(0, len(padded), ny)]


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


def ring_rows(shards, width: int):
    """``exchange_rows``' strips without the copies a card does not need: for
    each shard i, ``(top, bot)``, each a view of the neighbour's own rows
    (``shards[i-1][..., -width:, :]`` and ``shards[i+1][..., :width, :]``,
    plane stride that shard's ``R_loc * C``) where the neighbour lies on
    shard i's device, else ``copy_to`` its rows there.  The views hold the
    values of ``exchange_rows``' copies as long as nothing writes the shards
    (the sharded steps never write their input)."""
    n = len(shards)

    def rows(j: int, part: slice, device):
        src = shards[j % n][..., part, :]
        return src if src.device == device else copy_to(src, device)

    return [(rows(i - 1, slice(-width, None), f.device), rows(i + 1, slice(0, width), f.device))
            for i, f in enumerate(shards)]


def exchange_2d(grid, width: int):
    """The two-pass exchange of a field sharded over rows and columns (any
    (nx, ny) mesh), for each block of the row-major grid ``grid[i][j]`` in
    row-major order: ``(top, bot, left, right)`` on its device.  ``top`` and
    ``bot`` are ``exchange_rows``' strips within the block's mesh column,
    ``(planes, width, C_loc)`` each; ``left`` and ``right`` are
    ``(planes, width + R_loc + width, width)`` column strips of the left and
    right neighbours, each with that neighbour's own row strips attached,
    so a corner comes from the diagonal neighbour (lbm_tpu sharded2d_pallas
    ``_exchange_halos``).  Periodic in both axes; a block alone on an axis
    wraps to itself.  Only strips are copied, never a whole block."""
    nx, ny = len(grid), len(grid[0])
    rows = [exchange_rows([grid[i][j] for i in range(nx)], width) for j in range(ny)]

    def strip(i: int, j: int, cols: slice, device) -> torch.Tensor:
        top, bot = rows[j][i]
        part = torch.cat([top[..., cols], grid[i][j][..., cols], bot[..., cols]], dim=-2)
        return part.to(device, non_blocking=True)

    out = []
    for i in range(nx):
        for j in range(ny):
            dev = grid[i][j].device
            out.append((*rows[j][i], strip(i, (j - 1) % ny, slice(-width, None), dev),
                        strip(i, (j + 1) % ny, slice(0, width), dev)))
    return out


def ring_2d(grid, width: int):
    """``exchange_2d``'s padded blocks without the copies a card does not
    need: for each block of the row-major grid ``grid[i][j]``, in row-major
    order, the 3 x 3 parts of its padded block, ``parts[a][b]`` the lines of
    the block at ((i + a - 1) mod nx, (j + b - 1) mod ny): its last ``width``
    rows (a = 0), all its rows (a = 1) or its first ``width`` (a = 2), and
    its columns the same way by b; ``parts[1][1]`` is the block itself.  Each
    is a view of that block's own buffer (plane and row strides its own)
    where it lies on the receiving block's device, else a ``copy_to`` there.
    The views hold ``exchange_2d``'s values (``strip_parts``) as long as
    nothing writes the blocks (the sharded steps never write their input)."""
    nx, ny = len(grid), len(grid[0])
    lines = (slice(-width, None), slice(None), slice(0, width))

    def part(i: int, j: int, a: int, b: int, device):
        src = grid[(i + a - 1) % nx][(j + b - 1) % ny][..., lines[a], lines[b]]
        return src if src.device == device else copy_to(src, device)

    return [[[part(i, j, a, b, grid[i][j].device) for b in range(3)] for a in range(3)]
            for i in range(nx) for j in range(ny)]


def strip_parts(f: torch.Tensor, top, bot, left, right):
    """The 3 x 3 parts of ``ring_2d`` as views of the block ``f`` and
    ``exchange_2d``'s four strips around it (``left`` and ``right`` carry the
    corners in their first and last ``width`` rows)."""
    width, rows = top.shape[-2], f.shape[-2]
    bands = (slice(0, width), slice(width, width + rows), slice(width + rows, None))
    return [[left[..., bands[a], :], (top, f, bot)[a], right[..., bands[a], :]]
            for a in range(3)]


def parts_block(parts) -> torch.Tensor:
    """The padded block that 3 x 3 parts tile (``pad_block`` of the strips)."""
    return torch.cat([torch.cat(row, dim=-1) for row in parts], dim=-2)
