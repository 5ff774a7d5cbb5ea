"""Multi-direct-forcing immersed boundary method (counterpart of lbm_tpu/ops/ibm.py).

The reference loops over markers on the host, a 16-point gather and
spread per marker per forcing iteration (src/ibm.cpp:158-190).  Markers
are static, so here every marker's 4x4 support box is a row of a
precomputed (M, 16) weight and index table, and the dense (roi cells, M)
operator ``spread`` holds the same weights: interpolation and spreading
are two small matmuls per iteration, as in lbm_tpu.  Those matmuls are
the plain version of CUDA kernel 16 (kernels/ibm.py), which consumes the
separable factors ``row_w``, ``col_w``, ``rows0`` and ``cols0`` instead.

Peskin 4-point kernel (src/ibm.cpp:39-45):
    phi(r) = 1/8 (3 - 2r + sqrt(1 + 4r - 4r^2))   for |r| <= 1
           = 1/8 (5 - 2r - sqrt(-7 + 12r - 4r^2)) for 1 < |r| <= 2
           = 0 otherwise

Parity note: the reference pairs the x-fraction weights with the column
axis of the support box (its phi vector is laid out transposed relative to
the reshaped box, src/ibm.cpp:47-57 vs :171).  The default pairs x-weights
with rows (the mathematically intended pairing);
``reference_transposed_weights=True`` reproduces the reference.

lbm_tpu's ``aligned_window`` and ``window_operators`` (Mosaic's 8x128 DMA
tiling of its forcing kernel) have no counterpart: kernel 16 takes the ROI
where it lies.
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass

import numpy as np
import torch

from . import d2q9


def peskin4(r: np.ndarray) -> np.ndarray:
    """Peskin 4-point kernel, vectorised, in float64.  cites src/ibm.cpp:39-45"""
    r = np.abs(np.asarray(r, dtype=np.float64))
    inner = 0.125 * (3.0 - 2.0 * r + np.sqrt(np.maximum(1.0 + 4.0 * r - 4.0 * r * r, 0.0)))
    outer = 0.125 * (5.0 - 2.0 * r - np.sqrt(np.maximum(-7.0 + 12.0 * r - 4.0 * r * r, 0.0)))
    return np.where(r <= 1.0, inner, np.where(r <= 2.0, outer, 0.0))


@dataclass(frozen=True)
class IBM:
    """Static-marker immersed boundary with precomputed interpolation maps.

    Attributes:
      weights: (M, 16) float64 kernel weights per marker support point.
      flat_idx: (M, 16) int32 indices into the flattened ROI.
      spread: (roi cells, M) float64 dense interpolation/spreading operator.
      roi_rows / roi_cols: ROI slice bounds (absolute grid coordinates).
      roi_shape: (rows, cols) of the ROI.
      m_max: forcing iterations + 1 (reference default 5 -> 4 iterations,
             src/ibm.cpp:59-66, :166).
      row_w / col_w: (M, 4) separable Peskin factors along rows / cols, so
             weights[j, 4 a + b] = row_w[j, a] * col_w[j, b].
      rows0 / cols0: (M,) absolute grid coordinate of each support box's
             first row / column.
    """

    weights: torch.Tensor
    flat_idx: torch.Tensor
    spread: torch.Tensor
    roi_rows: tuple[int, int]
    roi_cols: tuple[int, int]
    roi_shape: tuple[int, int]
    m_max: int = 5
    row_w: np.ndarray | None = None
    col_w: np.ndarray | None = None
    rows0: np.ndarray | None = None
    cols0: np.ndarray | None = None

    @classmethod
    def from_markers(cls, xs, ys, m_max: int = 5,
                     reference_transposed_weights: bool = False) -> "IBM":
        """Build from absolute marker coordinates (x along rows, y along
        cols, the [name].x/[name].y TOML arrays, src/ibm.cpp:78-101)."""
        xs = np.asarray(xs, dtype=np.float64)
        ys = np.asarray(ys, dtype=np.float64)
        # ROI bounds.  cites src/ibm.cpp:95-99
        r_min = int(np.floor(xs).min()) - 2
        r_max = int(np.floor(xs).max()) + 2
        c_min = int(np.floor(ys).min()) - 2
        c_max = int(np.floor(ys).max()) + 2
        roi_shape = (r_max - r_min + 1, c_max - c_min + 1)

        # ROI-relative marker positions (src/ibm.cpp:101) and the fractional
        # distances to the 4 support nodes along each axis
        xr = xs - r_min
        yr = ys - c_min
        offs = np.arange(4, dtype=np.float64)
        sx = xr[:, None] - (offs[None, :] + np.floor(xr)[:, None] - 1.0)
        sy = yr[:, None] - (offs[None, :] + np.floor(yr)[:, None] - 1.0)
        wx = peskin4(sx)
        wy = peskin4(sy)
        if reference_transposed_weights:
            w = (wy[:, :, None] * wx[:, None, :]).reshape(len(xs), 16)
            row_w, col_w = wy, wx
        else:
            w = (wx[:, :, None] * wy[:, None, :]).reshape(len(xs), 16)
            row_w, col_w = wx, wy

        rows0 = (np.floor(xr) - 1.0).astype(np.int64)
        cols0 = (np.floor(yr) - 1.0).astype(np.int64)
        rr = rows0[:, None] + np.arange(4)[None, :]
        cc = cols0[:, None] + np.arange(4)[None, :]
        flat = (rr[:, :, None] * roi_shape[1] + cc[:, None, :]).reshape(len(xs), 16)
        # column j of the dense operator holds marker j's 16 weights at
        # their flat ROI positions
        M = len(xs)
        S = np.zeros((roi_shape[0] * roi_shape[1], M), dtype=np.float64)
        np.add.at(S, (flat.ravel(), np.repeat(np.arange(M), 16)), w.ravel())
        return cls(
            weights=torch.as_tensor(w),
            flat_idx=torch.as_tensor(flat, dtype=torch.int32),
            spread=torch.as_tensor(S),
            roi_rows=(r_min, r_max + 1),
            roi_cols=(c_min, c_max + 1),
            roi_shape=roi_shape,
            m_max=m_max,
            row_w=row_w,
            col_w=col_w,
            rows0=rows0 + r_min,
            cols0=cols0 + c_min,
        )

    @classmethod
    def from_toml(cls, path: str, name: str, **kw) -> "IBM":
        """Marker coordinates from a TOML table [name] with x/y arrays, the
        schema of the reference's ibm ctor (src/ibm.cpp:78-101)."""
        with open(path, "rb") as fh:
            tbl = tomllib.load(fh)
        return cls.from_markers(tbl[name]["x"], tbl[name]["y"], **kw)

    @classmethod
    def circle(cls, center_x: float, center_y: float, radius: float,
               n_markers: int, **kw) -> "IBM":
        """A cylinder boundary of ``n_markers`` equally spaced markers."""
        theta = np.linspace(0.0, 2.0 * np.pi, n_markers, endpoint=False)
        return cls.from_markers(center_x + radius * np.cos(theta),
                                center_y + radius * np.sin(theta), **kw)

    def roi(self, field: torch.Tensor) -> torch.Tensor:
        """Slice a (..., R, C) grid field down to the ROI."""
        return field[..., self.roi_rows[0]:self.roi_rows[1],
                     self.roi_cols[0]:self.roi_cols[1]]

    def eulerian_force_density(self, u: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
        """Multi-direct-forcing force density over the ROI from full-grid
        u, rho; see force_density_roi."""
        return self.force_density_roi(self.roi(u), self.roi(rho))

    def force_density_roi(self, u_roi: torch.Tensor, rho_roi: torch.Tensor) -> torch.Tensor:
        """Multi-direct-forcing force density over the ROI, shape
        (2, roi_r, roi_c), from ROI-sized u and rho.
        cites src/ibm.cpp:158-190: per iteration, interpolate u at the
        markers, f_j = -2 rho_j u_j, spread back with the same weights,
        u += 0.5 F_n / rho.

        Interpolation (u @ S) and spreading (f_j @ S^T) are the dense
        operator's two matmuls (lbm_tpu/ops/ibm.py:210-217), in the state's
        dtype; the package keeps TF32 off, so float32 sums in float32."""
        nflat = self.roi_shape[0] * self.roi_shape[1]
        S = self.spread.to(device=u_roi.device, dtype=u_roi.dtype)
        rho_j = rho_roi.reshape(nflat) @ S
        u_work = u_roi
        F = torch.zeros((2,) + self.roi_shape, dtype=u_roi.dtype, device=u_roi.device)
        for _ in range(self.m_max - 1):
            u_j = u_work.reshape(2, nflat) @ S               # (2, M)
            f_j = -2.0 * rho_j[None] * u_j                   # (2, M)
            F_n = (f_j @ S.T).reshape((2,) + self.roi_shape)
            u_work = u_work + 0.5 * F_n / rho_roi[None]
            F = F + F_n
        return F

    def force_from_populations(self, f: torch.Tensor) -> torch.Tensor:
        """force_density_roi at the macroscopics of a (9, R, C) state's ROI:
        the plain version of kernel 16."""
        f_roi = self.roi(f)
        rho = d2q9.calc_rho(f_roi)
        return self.force_density_roi(d2q9.calc_u(f_roi, rho), rho)
