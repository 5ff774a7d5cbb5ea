"""Carry a population state between numpy and the port.

Both packages store populations as planes ``(9, R, C)``, so moving a state
from lbm_tpu (or a saved ``.npy``) into the port is a checked device and
dtype move.  The reference C++ stores ``{R, C, 9}``;
``from_reference_layout`` takes that, as lbm_tpu/io/compare.py does.
The two-phase states carry across the same way: the per-colour
``(2, 9, R, C)`` and the reduced ``(10 | 12, R, C)`` of kernels/mrtcg.py,
the RK mixture's ``(11, R, C)`` of kernels/rk.py and the CSF droplet's
``(20, R, C)`` of kernels/csf_droplet.py and the sedimentation state's
``(18, R, C)`` of kernels/sediment.py.  ``colour_params``,
``rk_droplet_colour`` and ``csf_colour`` carry the colour constants (all
five fields floats); ``ibm_from_numpy`` carries a static immersed
boundary, and ``cylinder_carry_from_numpy`` cylinder_flow's (f, F_roi).
``rigid_state_from_numpy`` / ``rigid_state_to_numpy`` carry the falling
bodies' rigid state: lbm_tpu's (1, 128) or (B, 128) rows
(kernels/moving_ibm_pallas.py pack_state*) against the port's (B, 10)
(kernels/moving_ibm.py, the same lane order without Mosaic's padding).
The D3Q19 states carry to the port's (19, X, Y, Z) from lbm_tpu's three
layouts: its jnp scenes' own (``d3q19_from_numpy``), its Pallas kernel's
depth-as-planes (19 X, Y, Z) (``d3q19_from_planes``, the inverse of
scenes/three_d.py ``_pack``) and its lanes (19, Y, X*Z), lane = z*X + x
(``d3q19_from_lanes``, kernels/d3q19_lanes_pallas.py ``unpack_lanes``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import ColourParams
from ..kernels.d3q19 import unpack_lanes
from ..kernels.moving_ibm import STATE_LANES
from ..models.mrt_csf_droplet import CSFColour
from ..models.rk_cg import RKDropletColour
from ..ops.ibm import IBM

_LBM_TPU_LANES = 128    # lbm_tpu's rigid-state row: the 128-lane axis of a Mosaic vreg


def _planes(arr: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
    if not np.issubdtype(arr.dtype, np.floating):
        raise TypeError(f"expected a float array, got {arr.dtype}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"state dtype must be float32 or float64, got {dtype}")
    return torch.as_tensor(arr, dtype=dtype, device=device).contiguous()


def state_from_numpy(f, device, dtype: torch.dtype) -> torch.Tensor:
    """A (9, R, C) float array as a contiguous tensor on ``device``."""
    arr = np.asarray(f)
    if arr.ndim != 3 or arr.shape[0] != 9:
        raise ValueError(f"expected a (9, R, C) planes state, got {arr.shape}")
    return _planes(arr, device, dtype)


def two_phase_from_numpy(red_f, blue_f, device, dtype: torch.dtype) -> torch.Tensor:
    """Red and blue (9, R, C) arrays as the (2, 9, R, C) per-colour state."""
    red, blue = np.asarray(red_f), np.asarray(blue_f)
    if red.shape != blue.shape or red.ndim != 3 or red.shape[0] != 9:
        raise ValueError(f"expected two (9, R, C) states, got {red.shape} and {blue.shape}")
    return _planes(np.stack([red, blue]), device, dtype)


def reduced_from_numpy(G, device, dtype: torch.dtype) -> torch.Tensor:
    """A reduced MRT-CG state, (10, R, C) or (12, R, C) in CSF mode."""
    return _checked_planes(G, (10, 12), "reduced", device, dtype)


def rk_state_from_numpy(S, device, dtype: torch.dtype) -> torch.Tensor:
    """An RK mixture state [f (9), r_rho, b_rho] as the (11, R, C) tensor."""
    return _checked_planes(S, (11,), "RK mixture", device, dtype)


def csf_droplet_state_from_numpy(S, device, dtype: torch.dtype) -> torch.Tensor:
    """A CSF droplet state [red f (9), blue f (9), fs (2)] as the (20, R, C)
    tensor."""
    return _checked_planes(S, (20,), "CSF droplet", device, dtype)


def sediment_state_from_numpy(S, device, dtype: torch.dtype) -> torch.Tensor:
    """A sedimentation state [f (9), g (9)] as the (18, R, C) tensor."""
    return _checked_planes(S, (18,), "sedimentation", device, dtype)


def ibm_from_numpy(ib) -> IBM:
    """lbm_tpu's IBM (or any object with IBM's fields, as arrays or numpy)
    as the port's: weights and spread float64, flat_idx int32, the separable
    factors as float64 / int64 numpy arrays."""
    def arr(name, dtype):
        return np.array(getattr(ib, name), dtype=dtype)  # a writable copy

    return IBM(weights=torch.as_tensor(arr("weights", np.float64)),
               flat_idx=torch.as_tensor(arr("flat_idx", np.int32)),
               spread=torch.as_tensor(arr("spread", np.float64)),
               roi_rows=tuple(int(v) for v in ib.roi_rows),
               roi_cols=tuple(int(v) for v in ib.roi_cols),
               roi_shape=tuple(int(v) for v in ib.roi_shape),
               m_max=int(ib.m_max),
               row_w=arr("row_w", np.float64), col_w=arr("col_w", np.float64),
               rows0=arr("rows0", np.int64), cols0=arr("cols0", np.int64))


def cylinder_carry_from_numpy(f, F_roi, ib: IBM, device,
                              dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """cylinder_flow's carry: the (9, R, C) state and the (2, roi_r, roi_c)
    force over ``ib``'s ROI (lbm_tpu's fused carry holds the force on the
    full grid: pass its ROI, ``F_full[:, r0:r1, c0:c1]``)."""
    F = np.asarray(F_roi)
    if F.shape != (2,) + tuple(ib.roi_shape):
        raise ValueError(f"expected a (2, {ib.roi_shape[0]}, {ib.roi_shape[1]}) ROI "
                         f"force, got {F.shape}")
    return state_from_numpy(f, device, dtype), _planes(F, device, dtype)


def rigid_state_from_numpy(rows, device, dtype: torch.dtype) -> torch.Tensor:
    """lbm_tpu's (B, 128) rigid-state rows as the port's (B, STATE_LANES)
    state: the first STATE_LANES lanes; the padding lanes must be zero."""
    arr = np.asarray(rows)
    if arr.ndim != 2 or arr.shape[1] < STATE_LANES:
        raise ValueError(f"expected (B, >= {STATE_LANES}) rigid-state rows, got {arr.shape}")
    if np.any(arr[:, STATE_LANES:] != 0):
        raise ValueError(f"rigid-state lanes past {STATE_LANES} hold values the port "
                         "does not carry")
    return _planes(np.array(arr[:, :STATE_LANES]), device, dtype)  # a writable copy


def rigid_state_to_numpy(state: torch.Tensor) -> np.ndarray:
    """The port's (B, STATE_LANES) rigid state as lbm_tpu's (B, 128) rows,
    zero past STATE_LANES, in the state's dtype."""
    arr = state.detach().cpu().numpy()
    if arr.ndim != 2 or arr.shape[1] != STATE_LANES:
        raise ValueError(f"expected a (B, {STATE_LANES}) rigid state, got {arr.shape}")
    out = np.zeros((arr.shape[0], _LBM_TPU_LANES), arr.dtype)
    out[:, :STATE_LANES] = arr
    return out


def _checked_planes(S, planes, what, device, dtype) -> torch.Tensor:
    arr = np.asarray(S)
    if arr.ndim != 3 or arr.shape[0] not in planes:
        raise ValueError(f"expected a ({' | '.join(map(str, planes))}, R, C) {what} state, "
                         f"got {arr.shape}")
    return _planes(arr, device, dtype)


def _fields(cls, params):
    return cls(**{f.name: float(getattr(params, f.name)) for f in dataclasses.fields(cls)})


def colour_params(params) -> ColourParams:
    """Any object with ColourParams' five fields (lbm_tpu's among them) as
    the port's ColourParams."""
    return _fields(ColourParams, params)


def rk_droplet_colour(params) -> RKDropletColour:
    """lbm_tpu's RKDropletColour (or any object with its fields) as the
    port's."""
    return _fields(RKDropletColour, params)


def csf_colour(params) -> CSFColour:
    """lbm_tpu's CSFColour (or any object with its fields) as the port's."""
    return _fields(CSFColour, params)


def state_to_numpy(f: torch.Tensor) -> np.ndarray:
    """A state tensor from any device as a numpy array of its own dtype."""
    return f.detach().cpu().numpy()


def from_reference_layout(f, device, dtype: torch.dtype) -> torch.Tensor:
    """A reference ``{R, C, 9}`` array as a (9, R, C) planes tensor."""
    arr = np.asarray(f)
    if arr.ndim != 3 or arr.shape[-1] != 9:
        raise ValueError(f"expected a reference {{R, C, 9}} state, got {arr.shape}")
    return state_from_numpy(np.moveaxis(arr, -1, 0), device=device, dtype=dtype)


def d3q19_from_numpy(f, device, dtype: torch.dtype) -> torch.Tensor:
    """A (19, X, Y, Z) float array as the port's D3Q19 state."""
    arr = np.asarray(f)
    if arr.ndim != 4 or arr.shape[0] != 19:
        raise ValueError(f"expected a (19, X, Y, Z) D3Q19 state, got {arr.shape}")
    return _planes(arr, device, dtype)


def d3q19_from_planes(S, device, dtype: torch.dtype) -> torch.Tensor:
    """lbm_tpu's depth-as-planes (19 X, Y, Z) state, plane 19 x + k, as the
    port's (19, X, Y, Z)."""
    arr = np.asarray(S)
    if arr.ndim != 3 or arr.shape[0] % 19:
        raise ValueError(f"expected a (19 X, Y, Z) planes state, got {arr.shape}")
    X, Y, Z = arr.shape[0] // 19, arr.shape[1], arr.shape[2]
    return _planes(np.ascontiguousarray(arr.reshape(X, 19, Y, Z).transpose(1, 0, 2, 3)),
                   device, dtype)


def d3q19_from_lanes(S, X: int, device, dtype: torch.dtype) -> torch.Tensor:
    """lbm_tpu's lanes (19, Y, X*Z) state, lane = z*X + x, as the port's
    (19, X, Y, Z)."""
    arr = np.asarray(S)
    if arr.ndim != 3 or arr.shape[0] != 19 or arr.shape[2] % X:
        raise ValueError(f"expected a (19, Y, {X}*Z) lanes state, got {arr.shape}")
    return unpack_lanes(_planes(arr, device, dtype), X, arr.shape[1], arr.shape[2] // X)
