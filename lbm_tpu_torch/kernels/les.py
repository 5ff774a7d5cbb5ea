"""Fused periodic Smagorinsky-BGK collide-stream (counterpart of
lbm_tpu/kernels/les_pallas.py).

``les_collide_fn`` is the plain paired-direction collision (the algebra of
models/les.py, fused); ``make_les_fused_step`` returns a step that runs CUDA
kernel 5 (csrc/collide_stream_les.cu) on a CUDA state and the plain
stream(les_collide_fn(f)) on a CPU state.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.les import SQRT2_18
from ..utils.xmath import resolve_fused, rounded
from . import _build, collide_stream



def les_collide_fn(tau0: float, cs_smag: float, dtype: torch.dtype):
    """Smagorinsky-BGK collision on a (9, R, C) state: the paired-direction
    compressible equilibrium, the three non-equilibrium stress sums and the
    per-cell ``omega = 1/tau_eff`` (lbm_tpu.kernels.les_pallas.
    les_collide_fn).  The constants are rounded to ``dtype`` as lbm_tpu's
    ``dt(...)`` scalars are, and tau0^2 is taken in ``dtype``; kernel 5
    computes the same in the same order."""
    t00 = rounded(tau0, dtype)
    t00_sq = rounded(t00 * t00, dtype)
    a_cs = rounded(SQRT2_18 * (float(cs_smag) * float(cs_smag)), dtype)

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
        feq = [None] * 9
        feq[0] = collide_stream.WQ[0] * rho * t0
        for kp, km, w, cu, cc in pairs:
            wr = w * rho
            even = wr * (t0 + 4.5 * cc)
            odd = wr * (3.0 * cu)
            feq[kp] = even + odd
            feq[km] = even - odd
        dq = [f[k] - feq[k] for k in range(9)]

        # non-equilibrium stress |Q|: cx^2 = 1 on {1,3,5,6,7,8}, cy^2 = 1 on
        # {2,4,5,6,7,8}, cx*cy = +1 on {5,7}, -1 on {6,8}
        qxx = dq[1] + dq[3] + dq[5] + dq[6] + dq[7] + dq[8]
        qyy = dq[2] + dq[4] + dq[5] + dq[6] + dq[7] + dq[8]
        qxy = dq[5] - dq[6] + dq[7] - dq[8]
        qn = torch.sqrt(qxx * qxx + 2.0 * qxy * qxy + qyy * qyy)
        tau = 0.5 * (t00 + torch.sqrt(t00_sq + a_cs * qn * inv_rho))
        om = 1.0 / tau
        return torch.stack([f[k] - om * dq[k] for k in range(9)])

    return fn


COLLIDE_STREAM_LES = _build.CudaKernel(
    "lbm_collide_stream_les",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_void_p])


def collide_stream_les(f: torch.Tensor, tau0: float, cs_smag: float,
                       substeps: int = 1) -> torch.Tensor:
    """``substeps`` periodic Smagorinsky-BGK collide-stream steps on the card
    (kernel 5)."""
    return collide_stream.launch_periodic(COLLIDE_STREAM_LES, f, substeps,
                                          float(tau0), float(cs_smag))


def make_les_fused_step(R: int, C: int, *, tau0: float, cs_smag: float,
                        dtype: torch.dtype, substeps: int = 1):
    """Smagorinsky step f (9, R, C) -> (9, R, C), ``substeps`` steps per
    call: kernel 5 on a CUDA state (one launch per step), the plain version
    on a CPU state."""
    plain = collide_stream.make_fused_step(
        R, C, les_collide_fn(tau0, cs_smag, dtype), dtype, substeps)

    def step(f: torch.Tensor) -> torch.Tensor:
        if resolve_fused(f):
            collide_stream.check_step_state(f, R, C, dtype)
            return collide_stream_les(f, tau0, cs_smag, substeps)
        return plain(f)

    return step
