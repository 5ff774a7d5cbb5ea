"""Channel step: pressure-periodic rows + no-slip column walls.

Counterpart of lbm_tpu/kernels/channel_pallas.py::make_channel_fused_step,
both families:

  * "bgk", the horizontal-Poiseuille step: CUDA kernel 2
    (csrc/channel_bgk.cu), plain version ``channel_model(...).step``;
  * "kbc", the ulbm_poiseuille step: CUDA kernel 4 (csrc/channel_kbc.cu),
    plain version ``kbc_channel_step``.

``make_channel_fused_step`` runs the family's kernel on a CUDA state and
its plain version on a CPU state.  ``make_channel_variant_step`` (gravity,
specular, free-stream, vertical and TRT channels) is not ported yet
(ROADMAP).
"""

from __future__ import annotations

import ctypes

import torch

from ..boundary import bc
from ..models import kbc
from ..models.single_phase import SinglePhaseModel
from ..ops import d2q9
from ..utils.xmath import resolve_fused
from . import _build
from .collide_stream import check_step_state

FAMILIES = ("bgk", "kbc")

_CHANNEL_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
                     ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
CHANNEL_BGK = _build.CudaKernel("lbm_channel_bgk", _CHANNEL_ARGTYPES)
CHANNEL_KBC = _build.CudaKernel("lbm_channel_kbc", _CHANNEL_ARGTYPES)


def _check_grid(R: int, C: int) -> None:
    if R < 4 or C < 2:
        raise ValueError(f"channel step needs R >= 4 and C >= 2, got {R}x{C}")


def channel_model(omega: float, rho_inlet: float, rho_outlet: float) -> SinglePhaseModel:
    """The plain BGK channel step: incompressible BGK, pressure-periodic
    rows, halfway bounce-back on both column walls
    (test/horizontal_poiseuille_test.cpp:128-152)."""
    return SinglePhaseModel(
        omega=omega,
        incompressible=True,
        pre_stream_bcs=(
            lambda fc, fe, u, rho: bc.pressure_periodic(
                fc, fe, u, rho_inlet, rho_outlet, axis=0,
                eq_fn=d2q9.incomp_equilibrium),
        ),
        post_stream_bcs=(
            lambda fa, fc: bc.bounce_back(fa, fc, "colN"),
            lambda fa, fc: bc.bounce_back(fa, fc, "col0"),
        ),
    )


def kbc_channel_step(s2: float, rho_inlet: float, rho_outlet: float):
    """The plain KBC channel step, the jnp step of lbm_tpu/scenes/ulbm.py
    (reference test/ulbm_poiseuille.cpp:119-130): KBC collide at
    m0, u = m1/m0; pressure-periodic rows with the KBC product-form
    equilibrium as f_equi and the incompressible virtual-line equilibrium;
    stream; bounce-back on columns C-1, then 0.  (``SinglePhaseModel.eq`` is
    the BGK equilibrium, so the step is written out here.)"""
    model = kbc.KBCModel(s2=s2)

    def step(f: torch.Tensor) -> torch.Tensor:
        m0, u = model.macroscopics(f)
        f_coll = model.collide(f, m0, u)
        f_coll = bc.pressure_periodic(
            f_coll, model.equilibrium(m0, u), u, rho_inlet, rho_outlet,
            axis=0, eq_fn=d2q9.incomp_equilibrium)
        f_new = d2q9.stream(f_coll)
        f_new = bc.bounce_back(f_new, f_coll, "colN")
        return bc.bounce_back(f_new, f_coll, "col0")

    return step


def _launch_channel(kernel: _build.CudaKernel, f: torch.Tensor, omega: float,
                    rho_inlet: float, rho_outlet: float) -> torch.Tensor:
    """One channel step on the card into a fresh buffer.  Raises on a tensor
    the kernel does not take and on a refused launch."""
    R, C = _build.check_state(f)
    _check_grid(R, C)
    out = torch.empty_like(f)
    with torch.cuda.device(f.device):
        kernel.launch(f.data_ptr(), out.data_ptr(), R, C, float(omega),
                      float(rho_inlet), float(rho_outlet),
                      int(f.dtype == torch.float64), _build.stream_handle(f))
    return out


def channel_bgk(f: torch.Tensor, omega: float, rho_inlet: float,
                rho_outlet: float) -> torch.Tensor:
    """One BGK channel step on the card (kernel 2)."""
    return _launch_channel(CHANNEL_BGK, f, omega, rho_inlet, rho_outlet)


def channel_kbc(f: torch.Tensor, s2: float, rho_inlet: float,
                rho_outlet: float) -> torch.Tensor:
    """One KBC channel step on the card (kernel 4, factored gamma)."""
    return _launch_channel(CHANNEL_KBC, f, s2, rho_inlet, rho_outlet)


def make_channel_fused_step(R: int, C: int, omega: float, rho_inlet: float,
                            rho_outlet: float, dtype: torch.dtype,
                            family: str = "bgk"):
    """Channel step f (9, R, C) -> (9, R, C) for any R >= 4, C >= 2: the
    family's kernel on a CUDA state, its plain step on a CPU state.
    ``omega`` is the BGK rate, or the KBC shear rate s2 for family "kbc"."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}")
    _check_grid(R, C)
    if family == "bgk":
        plain, kernel = channel_model(omega, rho_inlet, rho_outlet).step, channel_bgk
    else:
        plain, kernel = kbc_channel_step(omega, rho_inlet, rho_outlet), channel_kbc

    def step(f: torch.Tensor) -> torch.Tensor:
        check_step_state(f, R, C, dtype)
        if resolve_fused(f):
            return kernel(f, omega, rho_inlet, rho_outlet)
        return plain(f)

    return step
