"""Carry a population state between numpy and the port.

Both packages store populations as planes ``(9, R, C)``, so moving a state
from lbm_tpu (or a saved ``.npy``) into the port is a checked device and
dtype move.  The reference C++ stores ``{R, C, 9}``;
``from_reference_layout`` takes that, as lbm_tpu/io/compare.py does.
"""

from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(f, device, dtype: torch.dtype) -> torch.Tensor:
    """A (9, R, C) float array as a contiguous tensor on ``device``."""
    arr = np.asarray(f)
    if arr.ndim != 3 or arr.shape[0] != 9:
        raise ValueError(f"expected a (9, R, C) planes state, got {arr.shape}")
    if not np.issubdtype(arr.dtype, np.floating):
        raise TypeError(f"expected a float array, got {arr.dtype}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"state dtype must be float32 or float64, got {dtype}")
    return torch.as_tensor(arr, dtype=dtype, device=device).contiguous()


def state_to_numpy(f: torch.Tensor) -> np.ndarray:
    """A state tensor from any device as a numpy array of its own dtype."""
    return f.detach().cpu().numpy()


def from_reference_layout(f, device, dtype: torch.dtype) -> torch.Tensor:
    """A reference ``{R, C, 9}`` array as a (9, R, C) planes tensor."""
    arr = np.asarray(f)
    if arr.ndim != 3 or arr.shape[-1] != 9:
        raise ValueError(f"expected a reference {{R, C, 9}} state, got {arr.shape}")
    return state_from_numpy(np.moveaxis(arr, -1, 0), device=device, dtype=dtype)
