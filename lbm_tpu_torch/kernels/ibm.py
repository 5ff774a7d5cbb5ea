"""The static IBM forcing step: plain version and CUDA kernel 16
(counterpart of lbm_tpu/kernels/ibm_pallas.py).

``make_ibm_forcing_step(R, C, ib, dtype)`` returns ``fn(f) -> F_roi``: the
multi-direct-forcing Eulerian force density (2, roi_r, roi_c) over the
marker ROI of the state f (9, R, C).  On a CPU state it runs the plain
version, ``IBM.force_from_populations`` (the dense operator's two matmuls
per iteration); on a CUDA state it launches kernel 16
(csrc/ibm_forcing.cu), one block for the whole ROI, or raises.

lbm_tpu's kernel needs an 8x128-aligned window inside the grid and returns
None otherwise, and its scene then falls back to jnp
(lbm_tpu/scenes/obstacles.py:145-166).  Kernel 16 takes the ROI where it
lies, so the port has no fallback: a ROI that leaves the grid raises here.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops.ibm import IBM
from ..utils.xmath import resolve_fused
from . import _build
from .collide_stream import check_step_state

# the dynamic shared memory a block may take on Hopper (csrc/ibm_forcing.cu)
SMEM_LIMIT = 232448

IBM_FORCING = _build.CudaKernel(
    "lbm_ibm_forcing",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
    + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p])


def check_roi(R: int, C: int, ib: IBM) -> None:
    """The ROI must lie inside the (R, C) grid."""
    (r0, r1), (c0, c1) = ib.roi_rows, ib.roi_cols
    if r0 < 0 or c0 < 0 or r1 > R or c1 > C:
        raise ValueError(f"the marker ROI rows [{r0}, {r1}) x cols [{c0}, {c1}) "
                         f"leaves the {R}x{C} grid")


def marker_tables(ib: IBM) -> tuple[np.ndarray, ...]:
    """Kernel 16's tables from the separable factors: the (M, 16) weights
    row_w[j, a] col_w[j, b] in float64 (equal to ``ib.weights``); each
    support box's first row and column relative to the ROI, int32; and the
    compressed cell -> weight table the spread reads: cell i's entries are
    cell_ent[cell_ptr[i]:cell_ptr[i + 1]], each 16 j + slot (the weight's
    index in the (M, 16) table), in ascending marker j, int32."""
    w16 = (ib.row_w[:, :, None] * ib.col_w[:, None, :]).reshape(-1, 16)
    rows0 = (ib.rows0 - ib.roi_rows[0]).astype(np.int32)
    cols0 = (ib.cols0 - ib.roi_cols[0]).astype(np.int32)
    cells = (rows0[:, None, None] + np.arange(4)[None, :, None]) * ib.roi_shape[1] \
        + cols0[:, None, None] + np.arange(4)[None, None, :]   # (M, 4, 4) ROI cells
    cells = cells.reshape(-1)
    ent = np.arange(cells.size)                                # 16 j + slot
    order = np.lexsort((ent, cells))                           # by cell, then by j
    counts = np.bincount(cells, minlength=ib.roi_shape[0] * ib.roi_shape[1])
    cell_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return w16, rows0, cols0, cell_ptr, ent[order].astype(np.int32)


def scratch_bytes(ib: IBM, itemsize: int) -> int:
    """Bytes of kernel 16's working set: per ROI cell 5 window fields and an
    int32 pointer (+ 1), per marker 3 values, 16 weights and 18 int32s."""
    M = ib.row_w.shape[0]
    n = ib.roi_shape[0] * ib.roi_shape[1]
    return (5 * n + 19 * M) * itemsize + 4 * (18 * M + n + 1)


def make_ibm_forcing_step(R: int, C: int, ib: IBM, dtype: torch.dtype):
    """Forcing step f (9, R, C) -> F_roi (2, roi_r, roi_c) for a ROI inside
    the grid: kernel 16 on a CUDA state, the plain version on a CPU state."""
    check_roi(R, C, ib)
    tables = marker_tables(ib)
    on_device: dict = {}
    r0, c0 = ib.roi_rows[0], ib.roi_cols[0]
    rw, cw = ib.roi_shape
    M = ib.row_w.shape[0]
    itemsize = torch.empty((), dtype=dtype).element_size()
    need = scratch_bytes(ib, itemsize)
    use_scratch = need > SMEM_LIMIT

    def launch(f: torch.Tensor) -> torch.Tensor:
        _build.check_state(f)
        if f.device not in on_device:
            on_device[f.device] = [torch.as_tensor(tables[0], dtype=dtype, device=f.device)] \
                + [torch.as_tensor(t, device=f.device) for t in tables[1:]]
        w16, rows0, cols0, cell_ptr, cell_ent = on_device[f.device]
        out = torch.empty((2, rw, cw), dtype=dtype, device=f.device)
        scratch = (torch.empty(-(-need // itemsize), dtype=dtype, device=f.device)
                   if use_scratch else None)
        with torch.cuda.device(f.device):
            IBM_FORCING.launch(
                f.data_ptr(), out.data_ptr(), R, C, r0, c0, rw, cw, M, max(ib.m_max - 1, 0),
                w16.data_ptr(), rows0.data_ptr(), cols0.data_ptr(), cell_ptr.data_ptr(),
                cell_ent.data_ptr(), None if scratch is None else scratch.data_ptr(),
                int(dtype == torch.float64), _build.stream_handle(f))
        return out

    def step(f: torch.Tensor) -> torch.Tensor:
        check_step_state(f, R, C, dtype)
        if resolve_fused(f):
            return launch(f)
        return ib.force_from_populations(f)

    return step
