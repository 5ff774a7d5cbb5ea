"""Channel step: pressure-periodic rows + no-slip column walls, BGK family.

Counterpart of lbm_tpu/kernels/channel_pallas.py::make_channel_fused_step
(family "bgk", the horizontal-Poiseuille case).  ``make_channel_fused_step``
returns a step that runs CUDA kernel 2 (csrc/channel_bgk.cu) on a CUDA state
and the plain ``channel_model(...).step`` on a CPU state.  The KBC family
and ``make_channel_variant_step`` are not ported yet (ROADMAP).
"""

from __future__ import annotations

import ctypes

import torch

from ..boundary import bc
from ..models.single_phase import SinglePhaseModel
from ..ops import d2q9
from ..utils.xmath import resolve_fused
from . import _build
from .collide_stream import check_step_state

CHANNEL_BGK = _build.CudaKernel(
    "lbm_channel_bgk",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
     ctypes.c_void_p])


def _check_grid(R: int, C: int) -> None:
    if R < 4 or C < 2:
        raise ValueError(f"channel step needs R >= 4 and C >= 2, got {R}x{C}")


def channel_model(omega: float, rho_inlet: float, rho_outlet: float) -> SinglePhaseModel:
    """The plain channel step: incompressible BGK, pressure-periodic rows,
    halfway bounce-back on both column walls
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


def channel_bgk(f: torch.Tensor, omega: float, rho_inlet: float,
                rho_outlet: float) -> torch.Tensor:
    """One channel step on the card (kernel 2), into a fresh buffer.
    Raises on a tensor the kernel does not take and on a refused launch."""
    R, C = _build.check_state(f)
    _check_grid(R, C)
    out = torch.empty_like(f)
    with torch.cuda.device(f.device):
        CHANNEL_BGK.launch(f.data_ptr(), out.data_ptr(), R, C, float(omega),
                           float(rho_inlet), float(rho_outlet),
                           int(f.dtype == torch.float64), _build.stream_handle(f))
    return out


def make_channel_fused_step(R: int, C: int, omega: float, rho_inlet: float,
                            rho_outlet: float, dtype: torch.dtype):
    """Channel step f (9, R, C) -> (9, R, C) for any R >= 4, C >= 2: kernel 2
    on a CUDA state, the plain model step on a CPU state."""
    _check_grid(R, C)
    model = channel_model(omega, rho_inlet, rho_outlet)

    def step(f: torch.Tensor) -> torch.Tensor:
        check_step_state(f, R, C, dtype)
        if resolve_fused(f):
            return channel_bgk(f, omega, rho_inlet, rho_outlet)
        return model.step(f)

    return step
