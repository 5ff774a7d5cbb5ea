"""Dtype, device and dispatch defaults for the port's entry points.

The JAX package pins ``Precision.HIGHEST`` on its contractions
(lbm_tpu/utils/xmath.py); the port has no contractions on the lattice (the
moment sums are explicit 9-term sums) and pins TF32 off at import
(``lbm_tpu_torch/__init__.py``), so neither ``tdot`` nor ``esum`` exists
here.
"""

from __future__ import annotations

import torch


def default_float(dtype: torch.dtype | None = None) -> torch.dtype:
    """``None`` means float64, the reference's precision
    (torch::set_default_dtype(kDouble), test/horizontal_poiseuille_test.cpp:69).
    Never ``torch.get_default_dtype()``: test modules change it at import."""
    return torch.float64 if dtype is None else dtype


def default_device(device=None) -> torch.device:
    """``None`` means the current CUDA device: the entry points run on the
    card unless the caller asks for the CPU (``device="cpu"``).  Without a
    card, the first CUDA allocation then raises; nothing falls back."""
    return torch.device("cuda" if device is None else device)


def resolve_fused(f: torch.Tensor) -> bool:
    """Whether a step takes its CUDA kernel: exactly when the state is not on
    the CPU.  A CPU tensor takes the plain PyTorch version; any other tensor
    goes to the kernel wrapper, which launches or raises.  There is no shape
    or dtype condition: the kernels take float32 and float64 at any grid."""
    return f.device.type != "cpu"


def rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a Python float: a scalar constant as
    lbm_tpu's ``dt(...)`` makes it, for the plain versions and the kernels."""
    return torch.tensor(x, dtype=dtype).item()
