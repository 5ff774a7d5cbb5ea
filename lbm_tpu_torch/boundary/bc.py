"""Boundary conditions on the planes layout (counterpart of lbm_tpu/boundary/bc.py).

The reference's ordering contract holds:

    collide -> (pressure BC edits f_coll) -> fully periodic stream
            -> wall rules overwrite f_adve from post-collision f_coll

Sides name the wall line of the grid: 'row0' (r=0), 'rowN' (r=-1),
'col0' (c=0), 'colN' (c=-1).  ``lane`` restricts the along-wall extent.
Each public function returns a new tensor and leaves its inputs alone.
All of lbm_tpu's rules are here: bounce-back, specular, anti-bounce-back,
ADE-Dirichlet, pressure-periodic, zero-gradient, periodic-edge and the
interior obstacle assignments.
"""

from __future__ import annotations

from typing import Callable, Sequence

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

# All eight moving directions (ABB walls rewrite every one of them,
# reference test/free_stream_test.cpp:107-114).
_MOVING = (1, 2, 3, 4, 5, 6, 7, 8)


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


def specular(f_adve: torch.Tensor, f_coll: torch.Tensor, side: str,
             lane: slice = slice(None)) -> torch.Tensor:
    """Free-slip: mirror only the wall-normal velocity component,
    f_adve[wall, spec(k)] = f_coll[wall, k] for the outgoing k.
    cites reference test/specular_boundary_test.cpp:122-128"""
    spec = lat.SPEC_X if _SIDE_AXIS[side] == 0 else lat.SPEC_Y
    out = f_adve.clone()
    for k in SIDE_OUT[side]:
        _set_line(out, int(spec[k]), side, lane, _line(f_coll[k], side, lane))
    return out


def anti_bounce_back(f_adve: torch.Tensor, f_coll: torch.Tensor, side: str,
                     u_w, lane: slice = slice(None),
                     scale: float = 1.0) -> torch.Tensor:
    """Moving-wall velocity BC: for every moving direction k,
    f_adve[wall, opp(k)] = -f_coll[wall, k] + scale*(2 + 9(u_w.c_k)^2 - 3 u_w.u_w) W_k.

    ``u_w`` is a (2,) or (2, N) wall velocity along the lane, taken in the
    state's dtype.  cites reference test/free_stream_test.cpp:104-125"""
    u_w = torch.as_tensor(u_w, dtype=f_coll.dtype, device=f_coll.device)
    coeff = scale * d2q9.abb_coefficient(u_w)
    out = f_adve.clone()
    for k in _MOVING:
        ck = coeff[k] if coeff.ndim == 1 else coeff[k][lane]
        _set_line(out, lat.OPPQ[k], side, lane, -_line(f_coll[k], side, lane) + ck)
    return out


def ade_dirichlet(f_adve: torch.Tensor, f_coll: torch.Tensor, side: str,
                  g_eq_wall: torch.Tensor, lane: slice = slice(None),
                  incoming_only: bool = False) -> torch.Tensor:
    """ADE Dirichlet (concentration) inlet via anti-bounce-back with twice the
    wall equilibrium: g_adve[opp(k)] = -g_coll[k] + 2 g_eq_wall[k], with
    ``g_eq_wall`` (9, N) along the wall (N the full wall length).
    cites reference test/rectangle_sedimentation_test.cpp:204-218

    The default overwrites all 8 moving directions, as the reference program
    does (the concentration sits on the boundary node); ``incoming_only``
    repairs only the 3 populations entering through the wall (the halfway
    scheme: the value sits on the halfway wall, where bounce_back puts
    its no-slip plane)."""
    out = f_adve.clone()
    for k in (SIDE_OUT[side] if incoming_only else _MOVING):
        _set_line(out, lat.OPPQ[k], side, lane,
                  -_line(f_coll[k], side, lane) + 2.0 * g_eq_wall[k][lane])
    return out


def zero_gradient(f_coll: torch.Tensor, side: str,
                  lane: slice = slice(None)) -> torch.Tensor:
    """Outflow: copy every post-collision population of the adjacent interior
    line onto the wall line, before streaming.
    cites reference test/rectangle_sedimentation_test.cpp:134-141"""
    inner = 1 if _SIDE_INDEX[side] == 0 else -2
    out = f_coll.clone()
    if _SIDE_AXIS[side] == 0:
        out[:, _SIDE_INDEX[side], lane] = f_coll[:, inner, lane]
    else:
        out[:, lane, _SIDE_INDEX[side]] = f_coll[:, lane, inner]
    return out


def obstacle_bounce_back(f_adve: torch.Tensor, f_coll: torch.Tensor,
                         assignments: Sequence[tuple[int, tuple, int, float]]
                         ) -> torch.Tensor:
    """Interior-wall bounce-back as raw (dst_dir, index, src_dir, sign)
    assignments, f_adve[dst, idx] = sign * f_coll[src, idx], applied in
    order (a later one overwrites an earlier one).  The sedimentation
    rectangle's walls are written so in the reference
    (test/rectangle_sedimentation_test.cpp:184-196)."""
    out = f_adve.clone()
    for dst, idx, src, sign in assignments:
        out[(dst,) + tuple(idx)] = sign * f_coll[(src,) + tuple(idx)]
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
