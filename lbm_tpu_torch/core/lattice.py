"""D2Q9 lattice constants, single-sourced from ``lbm_tpu/core/lattice.py``.

That file is numpy-only.  It is executed here by path, under a module name
of this package, so that the port registers no module of the JAX package
(the machine with the card has no JAX) while the numbers keep one source.
``csrc/d2q9.cuh`` writes the same constants in C++; the card tests hold
the kernels to the plain functions built on these.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

_SOURCE = Path(__file__).resolve().parents[2] / "lbm_tpu" / "core" / "lattice.py"


def _load_source():
    spec = importlib.util.spec_from_file_location(
        "lbm_tpu_torch.core._lattice_source", _SOURCE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_src = _load_source()

Q = _src.Q
C = _src.C
W = _src.W
OPP = _src.OPP
SPEC_X = _src.SPEC_X
SPEC_Y = _src.SPEC_Y
CS2 = _src.CS2
ICS2 = _src.ICS2
ICS4 = _src.ICS4

# Python-scalar views for explicit per-direction arithmetic (scalar
# constants broadcast against tensors of any dtype and device).
CX = tuple(int(v) for v in C[0])
CY = tuple(int(v) for v in C[1])
WQ = tuple(float(v) for v in W)
OPPQ = tuple(int(v) for v in OPP)


def tensor(a, *, device, dtype) -> torch.Tensor:
    """One of the numpy constants above as a tensor on ``device``."""
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
