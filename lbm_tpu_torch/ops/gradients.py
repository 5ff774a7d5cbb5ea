"""Isotropic finite-difference gradients, 5x5 and 3x3 (counterpart of
lbm_tpu/ops/gradients.py).

The reference computes gradients with torch Conv2d (a cross-correlation:
no kernel flip) and **replicate** edge padding (src/differential.hpp:9-40,
src/differential.cpp:3-39).  Here the correlation is replicate padding
plus an explicit weighted sum of shifted views, taps in row-major order,
zero weights skipped: no convolution and no matmul, so no TF32 whatever
the backend flags say, and the CUDA kernels (csrc/mrtcg.cuh) sum the taps
in the same order.

Quirk preserved for parity: in the reference's 3x3 variant the kernels
named partial_x / partial_y differentiate along *cols* / *rows*, swapped
against the 5x5 convention (x = rows); ``reference_swapped=False`` gives
the consistent orientation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# 5x5 isotropic weights.  cites reference src/differential.hpp:9-18
XI_5 = (1.0 / 5040.0) * np.array(
    [
        [1.0, 32.0, 84.0, 32.0, 1.0],
        [32.0, 448.0, 960.0, 448.0, 32.0],
        [84.0, 960.0, 0.0, 960.0, 84.0],
        [32.0, 448.0, 960.0, 448.0, 32.0],
        [1.0, 32.0, 84.0, 32.0, 1.0],
    ]
)

# Displacement factors (cross-correlation): w_x[i,j] = i-2, w_y[i,j] = j-2.
# cites reference src/differential.hpp:20-40
_ROW_OFF5 = np.arange(5, dtype=np.float64)[:, None] - 2.0
_COL_OFF5 = np.arange(5, dtype=np.float64)[None, :] - 2.0
KERNEL_X5 = XI_5 * np.broadcast_to(_ROW_OFF5, (5, 5))
KERNEL_Y5 = XI_5 * np.broadcast_to(_COL_OFF5, (5, 5))

# 3x3 D2Q9-weight kernels, as written in the drivers.
# cites reference test/rk_static_droplet_test.cpp:52-62
KERNEL_X3 = 3.0 * np.array(
    [
        [-1.0 / 36.0, 0.0, 1.0 / 36.0],
        [-1.0 / 9.0, 0.0, 1.0 / 9.0],
        [-1.0 / 36.0, 0.0, 1.0 / 36.0],
    ]
)
KERNEL_Y3 = -3.0 * np.array(
    [
        [1.0 / 36.0, 1.0 / 9.0, 1.0 / 36.0],
        [0.0, 0.0, 0.0],
        [-1.0 / 36.0, -1.0 / 9.0, -1.0 / 36.0],
    ]
)


def wall_rows(rows: torch.Tensor, R: int, h: int) -> torch.Tensor:
    """The padded-row gather of a block of consecutive grid rows ``rows``
    (global indices) in a grid of ``R`` rows: padded row j reads block row
    clamp(rows[0] + j - h, 0, R-1), itself clamped into the block.  At the
    grid's walls that is the replicate padding; at a block edge away from a
    wall it repeats the edge row, whose stencil results a halo step
    discards."""
    g = torch.arange(-h, rows.numel() + h, device=rows.device) + rows[0]
    return (g.clamp(0, R - 1) - rows[0]).clamp(0, rows.numel() - 1)


def tap_cols(cols: torch.Tensor, C: int, h: int) -> torch.Tensor:
    """The column gather of each tap of a block whose columns are the grid
    columns ``cols`` (global indices wrapped into [0, C), a shard's padded
    columns): row d + h holds, for each block column q, the block column
    that the tap d columns off q reads, the one holding clamp(cols[q] + d,
    0, C-1), itself clamped into the block.  At the grid's columns 0 and C-1
    that is the replicate padding, wherever they fall in the block; at the
    block's own edges it repeats the edge column, whose stencil results a
    halo step discards."""
    q = torch.arange(cols.numel(), device=cols.device)
    d = torch.arange(-h, h + 1, device=cols.device)[:, None]
    return (q + (cols + d).clamp(0, C - 1) - cols).clamp(0, cols.numel() - 1)


def correlate2d_replicate(psi: torch.Tensor, kernel: np.ndarray,
                          rows: torch.Tensor | None = None,
                          grid_rows: int | None = None,
                          cols: torch.Tensor | None = None,
                          grid_cols: int | None = None) -> torch.Tensor:
    """Cross-correlate a (R, C) field with a small odd kernel under
    replicate padding (torch Conv2d with kReplicate, src/differential.cpp:3-15):
    out[r, c] = sum_{a,b} k[a, b] psi[clamp(r+a-h), clamp(c+b-h)].

    With ``rows`` (the global indices of psi's rows, consecutive) and
    ``grid_rows``, psi is a block of a taller grid and its rows clamp at the
    grid's walls only (``wall_rows``); with ``cols`` (the wrapped global
    indices of its columns) and ``grid_cols``, a block of a wider periodic
    grid whose columns clamp at the grid's columns 0 and C-1 only
    (``tap_cols``).  The taps sum in the same order."""
    n = kernel.shape[0]
    h = n // 2
    R, C = psi.shape
    if rows is None:
        padded = F.pad(psi[None, None], (0, 0, h, h), mode="replicate")[0, 0]
    else:
        padded = psi[wall_rows(rows, grid_rows, h)]
    if cols is None:
        padded = F.pad(padded[None, None], (h, h, 0, 0), mode="replicate")[0, 0]
        shifted = [padded[:, b:b + C] for b in range(n)]
    else:
        shifted = [padded[:, taps] for taps in tap_cols(cols, grid_cols, h)]
    acc = None
    for a in range(n):
        for b in range(n):
            w = float(kernel[a, b])
            if w == 0.0:
                continue
            term = w * shifted[b][a:a + R]
            acc = term if acc is None else acc + term
    return acc


def dx5(psi: torch.Tensor, rows: torch.Tensor | None = None,
        grid_rows: int | None = None, cols: torch.Tensor | None = None,
        grid_cols: int | None = None) -> torch.Tensor:
    """d/dx (rows) via the 5x5 isotropic stencil (``rows``/``grid_rows``,
    ``cols``/``grid_cols``: a block of a larger grid, see
    correlate2d_replicate).  cites src/differential.cpp:23-27"""
    return correlate2d_replicate(psi, KERNEL_X5, rows, grid_rows, cols, grid_cols)


def dy5(psi: torch.Tensor, rows: torch.Tensor | None = None,
        grid_rows: int | None = None, cols: torch.Tensor | None = None,
        grid_cols: int | None = None) -> torch.Tensor:
    """d/dy (cols) via the 5x5 isotropic stencil (the block arguments as in
    dx5).  cites src/differential.cpp:29-33"""
    return correlate2d_replicate(psi, KERNEL_Y5, rows, grid_rows, cols, grid_cols)


def grad5(psi: torch.Tensor) -> torch.Tensor:
    """(2, R, C) gradient via the 5x5 stencil.  cites src/differential.cpp:35-39"""
    return torch.stack([dx5(psi), dy5(psi)])


def dx3(psi: torch.Tensor, reference_swapped: bool = True) -> torch.Tensor:
    """The reference's 3x3 'partial_x' (along cols when ``reference_swapped``,
    test/rk_static_droplet_test.cpp:52-56; along rows otherwise)."""
    return correlate2d_replicate(psi, KERNEL_X3 if reference_swapped else KERNEL_X3.T)


def dy3(psi: torch.Tensor, reference_swapped: bool = True) -> torch.Tensor:
    """The reference's 3x3 'partial_y' (along rows when ``reference_swapped``,
    test/rk_static_droplet_test.cpp:58-62; along cols otherwise)."""
    return correlate2d_replicate(psi, KERNEL_Y3 if reference_swapped else KERNEL_X3)


def grad3(psi: torch.Tensor, reference_swapped: bool = True) -> torch.Tensor:
    """(2, R, C) gradient via the 3x3 stencil (component 0 = 'x' in the
    reference's swapped sense).  cites test/rk_static_droplet_test.cpp:101-105"""
    return torch.stack([dx3(psi, reference_swapped), dy3(psi, reference_swapped)])
