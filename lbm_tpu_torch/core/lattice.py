"""D2Q9 lattice constants of the port (the numbers of lbm_tpu/core/lattice.py).

The port keeps its own copy: it reads no file of the JAX package.  The
CPU tests hold every constant here to lbm_tpu's with ``np.array_equal``,
and ``csrc/d2q9.cuh`` / ``csrc/mrtcg.cuh`` write the same numbers in C++.

Conventions (identical to the reference):
  * axis 0 of the grid is "x"/rows, axis 1 is "y"/cols;
  * velocity set, column k of C:
      c = [(0,0),(1,0),(0,1),(-1,0),(0,-1),(1,1),(-1,1),(-1,-1),(1,-1)]
  * opposite pairs (1,3), (2,4), (5,7), (6,8); W = [4/9, 1/9 x4, 1/36 x4].
"""

from __future__ import annotations

import numpy as np
import torch

Q = 9

# Velocity set: row 0 = x (grid rows), row 1 = y (grid cols).
# cites reference src/solver.cpp:18-21
C = np.array(
    [
        [0, 1, 0, -1, 0, 1, -1, -1, 1],
        [0, 0, 1, 0, -1, 1, 1, -1, -1],
    ],
    dtype=np.int64,
)

# Quadrature weights.  cites reference src/solver.cpp:12-16
W = np.array([4.0 / 9.0] + [1.0 / 9.0] * 4 + [1.0 / 36.0] * 4, dtype=np.float64)

# OPP[k] is the direction with -c_k.
OPP = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int64)

# Specular permutations: SPEC_Y mirrors the cols component, SPEC_X the rows
# component (reference test/specular_boundary_test.cpp:122-128,
# test/rectangle_sedimentation_test.cpp:175-177).
SPEC_Y = np.array([0, 1, 4, 3, 2, 8, 7, 6, 5], dtype=np.int64)
SPEC_X = np.array([0, 3, 2, 1, 4, 6, 5, 8, 7], dtype=np.int64)

CS2 = 1.0 / 3.0
ICS2 = 3.0
ICS4 = 9.0

# MRT moment matrix (Gram-Schmidt D2Q9) and its exact inverse.
# cites reference test/mrtcg_static_droplet.cpp:130-156
M_MRT = np.array(
    [
        [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
        [-4.0, -1.0, -1.0, -1.0, -1.0, 2.0, 2.0, 2.0, 2.0],
        [4.0, -2.0, -2.0, -2.0, -2.0, 1.0, 1.0, 1.0, 1.0],
        [0.0, 1.0, 0.0, -1.0, 0.0, 1.0, -1.0, -1.0, 1.0],
        [0.0, -2.0, 0.0, 2.0, 0.0, 1.0, -1.0, -1.0, 1.0],
        [0.0, 0.0, 1.0, 0.0, -1.0, 1.0, 1.0, -1.0, -1.0],
        [0.0, 0.0, -2.0, 0.0, 2.0, 1.0, 1.0, -1.0, -1.0],
        [0.0, 1.0, -1.0, 1.0, -1.0, 0.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 0.0, 0.0, 1.0, -1.0, 1.0, -1.0],
    ],
    dtype=np.float64,
)

MI_MRT = (1.0 / 36.0) * np.array(
    [
        [4.0, -4.0, 4.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [4.0, -1.0, -2.0, 6.0, -6.0, 0.0, 0.0, 9.0, 0.0],
        [4.0, -1.0, -2.0, 0.0, 0.0, 6.0, -6.0, -9.0, 0.0],
        [4.0, -1.0, -2.0, -6.0, 6.0, 0.0, 0.0, 9.0, 0.0],
        [4.0, -1.0, -2.0, 0.0, 0.0, -6.0, 6.0, -9.0, 0.0],
        [4.0, 2.0, 1.0, 6.0, 3.0, 6.0, 3.0, 0.0, 9.0],
        [4.0, 2.0, 1.0, -6.0, -3.0, 6.0, 3.0, 0.0, -9.0],
        [4.0, 2.0, 1.0, -6.0, -3.0, -6.0, -3.0, 0.0, 9.0],
        [4.0, 2.0, 1.0, 6.0, 3.0, -6.0, -3.0, 0.0, -9.0],
    ],
    dtype=np.float64,
)

# Colour-gradient perturbation constants B.
# cites reference test/mrtcg_static_droplet.cpp:158-163
B_CG = np.array([-4.0 / 27.0] + [2.0 / 27.0] * 4 + [5.0 / 108.0] * 4, dtype=np.float64)

# Unit velocity set (diagonals scaled by 1/sqrt(2)).
# cites reference test/mrtcg_static_droplet.cpp:176-178
UNIT_C = C / np.array([1.0, 1.0, 1.0, 1.0, 1.0] + [np.sqrt(2.0)] * 4)

# Python-scalar views for explicit per-direction arithmetic (scalar
# constants broadcast against tensors of any dtype and device).
CX = tuple(int(v) for v in C[0])
CY = tuple(int(v) for v in C[1])
WQ = tuple(float(v) for v in W)
OPPQ = tuple(int(v) for v in OPP)


def tensor(a, *, device, dtype) -> torch.Tensor:
    """One of the numpy constants above as a tensor on ``device``."""
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
