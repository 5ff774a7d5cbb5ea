"""Carry a population state between numpy and the port.

Both packages store populations as planes ``(9, R, C)``, so moving a state
from lbm_tpu (or a saved ``.npy``) into the port is a checked device and
dtype move.  The reference C++ stores ``{R, C, 9}``;
``from_reference_layout`` takes that, as lbm_tpu/io/compare.py does.
The two-phase states carry across the same way: the per-colour
``(2, 9, R, C)`` and the reduced ``(10 | 12, R, C)`` of kernels/mrtcg.py;
``colour_params`` carries a ColourParams (all five fields floats).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import ColourParams


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
    arr = np.asarray(G)
    if arr.ndim != 3 or arr.shape[0] not in (10, 12):
        raise ValueError(f"expected a (10 | 12, R, C) reduced state, got {arr.shape}")
    return _planes(arr, device, dtype)


def colour_params(params) -> ColourParams:
    """Any object with ColourParams' five fields (lbm_tpu's among them) as
    the port's ColourParams."""
    return ColourParams(**{f.name: float(getattr(params, f.name))
                           for f in dataclasses.fields(ColourParams)})


def state_to_numpy(f: torch.Tensor) -> np.ndarray:
    """A state tensor from any device as a numpy array of its own dtype."""
    return f.detach().cpu().numpy()


def from_reference_layout(f, device, dtype: torch.dtype) -> torch.Tensor:
    """A reference ``{R, C, 9}`` array as a (9, R, C) planes tensor."""
    arr = np.asarray(f)
    if arr.ndim != 3 or arr.shape[-1] != 9:
        raise ValueError(f"expected a reference {{R, C, 9}} state, got {arr.shape}")
    return state_from_numpy(np.moveaxis(arr, -1, 0), device=device, dtype=dtype)
