"""Boundary conditions on the planes layout (counterpart of lbm_tpu/boundary/bc.py).

The reference's ordering contract holds:

    collide -> (pressure BC edits f_coll) -> fully periodic stream
            -> wall rules overwrite f_adve from post-collision f_coll

Sides name the wall line of the grid: 'row0' (r=0), 'rowN' (r=-1),
'col0' (c=0), 'colN' (c=-1).  ``lane`` restricts the along-wall extent.
Each public function returns a new tensor and leaves its inputs alone.
Ported so far: ``bounce_back``, ``periodic_edge`` and ``pressure_periodic``;
the specular, anti-bounce-back, ADE-Dirichlet, zero-gradient and obstacle
rules are still to port (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core import lattice as lat
from ..ops import d2q9

# Outgoing (wall-ward) directions per side.
SIDE_OUT = {
    "row0": (3, 6, 7),  # cx < 0
    "rowN": (1, 5, 8),  # cx > 0
    "col0": (4, 7, 8),  # cy < 0
    "colN": (2, 5, 6),  # cy > 0
}

_SIDE_INDEX = {"row0": 0, "rowN": -1, "col0": 0, "colN": -1}
_SIDE_AXIS = {"row0": 0, "rowN": 0, "col0": 1, "colN": 1}


def _line(f_k: torch.Tensor, side: str, lane: slice) -> torch.Tensor:
    """View of the wall line of one (R, C) plane."""
    if _SIDE_AXIS[side] == 0:
        return f_k[_SIDE_INDEX[side], lane]
    return f_k[lane, _SIDE_INDEX[side]]


def _set_line(f: torch.Tensor, k: int, side: str, lane: slice, values) -> None:
    """Write ``values`` (broadcast) into plane k's wall line, in place.

    lbm_tpu writes lines by masked select to dodge an XLA SPMD mis-lowering
    (lbm_tpu/boundary/bc.py ``_write_grid_line``); a view write is exact."""
    _line(f[k], side, lane).copy_(values)


def bounce_back(f_adve: torch.Tensor, f_coll: torch.Tensor, side: str,
                lane: slice = slice(None)) -> torch.Tensor:
    """Halfway no-slip: f_adve[wall, opp(k)] = f_coll[wall, k] for the
    outgoing k.  cites reference test/horizontal_poiseuille_test.cpp:146-152"""
    out = f_adve.clone()
    for k in SIDE_OUT[side]:
        _set_line(out, lat.OPPQ[k], side, lane, _line(f_coll[k], side, lane))
    return out


def periodic_edge(f_adve: torch.Tensor, f_coll: torch.Tensor, side: str,
                  lane: slice = slice(None),
                  diagonal_shift: bool = True) -> torch.Tensor:
    """Repair the wall line of a periodic edge from the opposite wall's
    post-collision populations.  With ``diagonal_shift`` the diagonals are
    offset by one cell along the wall (true periodic streaming, cites
    reference test/ulbm_double_shear_flow.cpp:122-138); without it they are
    copied straight across, the multiphase drivers' variant (cites
    reference test/mrtcg_rayleigh_taylor.cpp:517-523)."""
    src_index = 0 if _SIDE_INDEX[side] == -1 else -1
    axis = _SIDE_AXIS[side]
    opposite = {"row0": "rowN", "rowN": "row0", "col0": "colN", "colN": "col0"}[side]
    out = f_adve.clone()
    for k in SIDE_OUT[opposite]:
        # along-wall displacement of direction k
        shift = (lat.CY if axis == 0 else lat.CX)[k] if diagonal_shift else 0
        src = f_coll[k, src_index, lane] if axis == 0 else f_coll[k, lane, src_index]
        _set_line(out, k, side, lane, torch.roll(src, shift) if shift else src)
    return out


def pressure_periodic(f_coll: torch.Tensor, f_equi: torch.Tensor,
                      u: torch.Tensor, rho_inlet: float, rho_outlet: float,
                      axis: int = 0,
                      eq_fn: Callable = d2q9.incomp_equilibrium) -> torch.Tensor:
    """Generalised periodic BC with a pressure drop (virtual inlet/outlet).

    f_coll[virtual_in]  = eq(u[outlet], rho_in)  + (f_coll - f_equi)[outlet]
    f_coll[virtual_out] = eq(u[inlet],  rho_out) + (f_coll - f_equi)[inlet]

    with virtual_in = line 0, inlet = line 1, outlet = line -2,
    virtual_out = line -1 along ``axis``.
    cites reference test/horizontal_poiseuille_test.cpp:25-45 (axis 0,
    incompressible), test/vertical_poiseuille_test.cpp:24-44 (compressible).
    """
    dim = 1 + axis  # arrays carry a leading component axis

    def take(arr, idx):
        return arr.narrow(dim, idx % arr.shape[dim], 1)

    ones = torch.ones_like(take(f_coll, 0)[0])  # (1, C) or (R, 1)
    eq_in = eq_fn(take(u, -2), rho_inlet * ones)
    eq_out = eq_fn(take(u, 1), rho_outlet * ones)
    out = f_coll.clone()
    take(out, 0).copy_(eq_in + take(f_coll, -2) - take(f_equi, -2))
    take(out, -1).copy_(eq_out + take(f_coll, 1) - take(f_equi, 1))
    return out
