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
    + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
MAX_THREADS = 1024  # csrc/ibm_forcing.cu


def check_roi(R: int, C: int, ib: IBM) -> None:
    """The ROI must lie inside the (R, C) grid."""
    (r0, r1), (c0, c1) = ib.roi_rows, ib.roi_cols
    if r0 < 0 or c0 < 0 or r1 > R or c1 > C:
        raise ValueError(f"the marker ROI rows [{r0}, {r1}) x cols [{c0}, {c1}) "
                         f"leaves the {R}x{C} grid")


def forcing_tables(ib: IBM) -> tuple[np.ndarray, ...]:
    """Kernel 16's tables from the separable factors, built once:
      w16 (M, 16): the weights row_w[j, a] col_w[j, b] in float64 (equal to
        ``ib.weights``), tap t = 4 a + b;
      tap (M, 16) int32: each tap's index into the support;
      sup (nS,) int32: the support, the ROI cells that some marker's box
        covers, as flat ROI indices in ascending order;
      cell_ptr (nS + 1,), ent_j (16 M,) int32 and ent_w (16 M,) float64:
        support cell s's entries are ent_j / ent_w[cell_ptr[s]:cell_ptr[s +
        1]], the markers whose box covers it in ascending order and their
        weights there."""
    w16 = (ib.row_w[:, :, None] * ib.col_w[:, None, :]).reshape(-1, 16)
    rows0 = ib.rows0 - ib.roi_rows[0]
    cols0 = ib.cols0 - ib.roi_cols[0]
    cells = ((rows0[:, None, None] + np.arange(4)[None, :, None]) * ib.roi_shape[1]
             + cols0[:, None, None] + np.arange(4)[None, None, :]).reshape(-1)
    sup, tap = np.unique(cells, return_inverse=True)            # (M 16,) -> support
    ent = np.arange(cells.size)                                # 16 j + t
    order = np.lexsort((ent, tap))                             # by cell, then by j
    counts = np.bincount(tap, minlength=sup.size)
    cell_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return (w16, tap.reshape(-1, 16).astype(np.int32), sup.astype(np.int32), cell_ptr,
            (ent[order] // 16).astype(np.int32), w16.reshape(-1)[order])


def block_threads(M: int, n_sup: int) -> int:
    """Kernel 16's block: 8 lanes a marker (2 taps a lane) or a thread per
    support cell, whichever is more, in whole warps, at most MAX_THREADS
    (the kernel loops past that)."""
    return min(MAX_THREADS, -(-max(8 * M, n_sup) // 32) * 32)


def scratch_bytes(n_sup: int, M: int, itemsize: int) -> int:
    """Bytes of kernel 16's working set: per support cell 5 values and an
    int32 pointer (+ 1), per marker 3 values and 16 entries of a value and
    an int32."""
    return (5 * n_sup + 19 * M) * itemsize + 4 * (16 * M + n_sup + 1)


def make_ibm_forcing_step(R: int, C: int, ib: IBM, dtype: torch.dtype):
    """Forcing step f (9, R, C) -> F_roi (2, roi_r, roi_c) for a ROI inside
    the grid: kernel 16 on a CUDA state, the plain version on a CPU state."""
    check_roi(R, C, ib)
    w16, tap, sup, cell_ptr, ent_j, ent_w = forcing_tables(ib)
    on_device: dict = {}
    r0, c0 = ib.roi_rows[0], ib.roi_cols[0]
    rw, cw = ib.roi_shape
    M, n_sup = w16.shape[0], sup.size
    threads = block_threads(M, n_sup)
    itemsize = torch.empty((), dtype=dtype).element_size()
    need = scratch_bytes(n_sup, M, itemsize)
    use_scratch = need > SMEM_LIMIT

    def launch(f: torch.Tensor) -> torch.Tensor:
        _build.check_state(f)
        if f.device not in on_device:
            on_device[f.device] = [torch.as_tensor(t, dtype=dtype if t.dtype == np.float64
                                                   else torch.int32, device=f.device)
                                   for t in (w16, tap, sup, cell_ptr, ent_j, ent_w)]
        tables = on_device[f.device]
        out = torch.empty((2, rw, cw), dtype=dtype, device=f.device)
        scratch = (torch.empty(-(-need // itemsize), dtype=dtype, device=f.device)
                   if use_scratch else None)
        with torch.cuda.device(f.device):
            IBM_FORCING.launch(
                f.data_ptr(), out.data_ptr(), R, C, r0, c0, rw, cw, M, max(ib.m_max - 1, 0),
                n_sup, *(t.data_ptr() for t in tables),
                None if scratch is None else scratch.data_ptr(), threads,
                int(dtype == torch.float64), _build.stream_handle(f))
        return out

    def step(f: torch.Tensor) -> torch.Tensor:
        check_step_state(f, R, C, dtype)
        if resolve_fused(f):
            return launch(f)
        return ib.force_from_populations(f)

    return step
