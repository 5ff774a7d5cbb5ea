"""Fused periodic TRT collide-stream (counterpart of
lbm_tpu/kernels/trt_pallas.py).

``trt_collide_fn`` is the plain paired-direction collision (the algebra of
models/trt.py, reassociated per opposite pair as lbm_tpu's kernel does);
``make_trt_fused_step`` returns a step that runs CUDA kernel 10
(csrc/collide_stream_trt.cu) on a CUDA state and the plain
stream(trt_collide_fn(f)) on a CPU state.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.xmath import resolve_fused
from . import _build, collide_stream

WQ = collide_stream.WQ


def trt_collide_fn(omega_plus: float, omega_minus: float, dtype: torch.dtype):
    """TRT collision on a (9, R, C) state: the paired-direction compressible
    equilibrium, then per pair the even and odd non-equilibria relaxed at
    ``omega_plus`` and ``omega_minus`` (lbm_tpu.kernels.trt_pallas.
    trt_collide_fn).  ``dtype`` is the state's: the rates round to it as a
    scalar of an elementwise op does, as lbm_tpu's ``dt(...)`` scalars are
    rounded; kernel 10 computes the same in the same order."""

    def fn(f: torch.Tensor) -> torch.Tensor:
        rho = f[0]
        for k in range(1, 9):
            rho = rho + f[k]
        mx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8]
        my = f[2] - f[4] + f[5] + f[6] - f[7] - f[8]
        inv_rho = 1.0 / rho
        ux = mx * inv_rho
        uy = my * inv_rho

        t0, pairs = collide_stream.d2q9_pairs(ux, uy)
        out = [None] * 9
        feq0 = WQ[0] * rho * t0
        out[0] = f[0] - omega_plus * (f[0] - feq0)
        for kp, km, w, cu, cc in pairs:
            wr = w * rho
            even_eq = wr * (t0 + 4.5 * cc)
            odd_eq = wr * (3.0 * cu)
            ne_even = 0.5 * (f[kp] + f[km]) - even_eq
            ne_odd = 0.5 * (f[kp] - f[km]) - odd_eq
            d_even = omega_plus * ne_even
            d_odd = omega_minus * ne_odd
            out[kp] = f[kp] - (d_even + d_odd)
            out[km] = f[km] - (d_even - d_odd)
        return torch.stack(out)

    return fn


COLLIDE_STREAM_TRT = _build.CudaKernel(
    "lbm_collide_stream_trt",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_void_p])


def collide_stream_trt(f: torch.Tensor, omega_plus: float, omega_minus: float,
                       substeps: int = 1) -> torch.Tensor:
    """``substeps`` periodic TRT collide-stream steps on the card (kernel 10)."""
    return collide_stream.launch_periodic(COLLIDE_STREAM_TRT, f, substeps,
                                          float(omega_plus), float(omega_minus))


def make_trt_fused_step(R: int, C: int, *, omega_plus: float, omega_minus: float,
                        dtype: torch.dtype, substeps: int = 1):
    """Fully periodic TRT step f (9, R, C) -> (9, R, C), ``substeps`` steps
    per call: kernel 10 on a CUDA state (one launch per step), the plain
    version on a CPU state."""
    plain = collide_stream.make_fused_step(
        R, C, trt_collide_fn(omega_plus, omega_minus, dtype), dtype, substeps)

    def step(f: torch.Tensor) -> torch.Tensor:
        if resolve_fused(f):
            collide_stream.check_step_state(f, R, C, dtype)
            return collide_stream_trt(f, omega_plus, omega_minus, substeps)
        return plain(f)

    return step
