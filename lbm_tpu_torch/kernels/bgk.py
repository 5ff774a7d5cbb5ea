"""Fused D2Q9 BGK collide-stream (counterpart of lbm_tpu/kernels/bgk_pallas.py).

``bgk_collide_fn`` is the plain paired-direction BGK collision;
``make_fused_step`` returns a step that runs CUDA kernel 1
(csrc/collide_stream_bgk.cu) on a CUDA state and the plain
stream(bgk_collide_fn(f)) on a CPU state.
"""

from __future__ import annotations

import torch

from ..utils.xmath import resolve_fused
from . import collide_stream


def bgk_collide_fn(omega: float, dtype: torch.dtype):
    """Explicit-sum BGK collision on a (9, R, C) state, compressible
    equilibrium with u = m / rho, in the paired-direction form: each
    opposite pair shares the even term W rho (t0 + 4.5 cu^2) and the odd
    term W rho 3 cu, combined by +/- (lbm_tpu.kernels.bgk_pallas.
    bgk_collide_fn; csrc/collide_stream_bgk.cu does the same arithmetic).
    Equals ops.d2q9 bgk_collision(f, equilibrium(u, rho), omega) up to
    round-off (same algebra, reassociated)."""
    one_m_omega = torch.tensor(1.0 - omega, dtype=dtype).item()
    omega_c = torch.tensor(omega, dtype=dtype).item()

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
        return torch.stack([one_m_omega * f[k] + omega_c * feq[k]
                            for k in range(9)])

    fn.halo_kernel = ("bgk", (float(omega),), (0, 0))  # kernels/sharded.py, kernel 27
    return fn


def make_fused_step(R: int, C: int, omega: float, dtype: torch.dtype,
                    substeps: int = 1):
    """Periodic BGK collide-stream f (9, R, C) -> (9, R, C), ``substeps``
    steps per call: kernel 1 on a CUDA state (one launch per step), the
    plain version on a CPU state."""
    plain = collide_stream.make_fused_step(R, C, bgk_collide_fn(omega, dtype),
                                           dtype, substeps)

    def step(f: torch.Tensor) -> torch.Tensor:
        if resolve_fused(f):
            collide_stream.check_step_state(f, R, C, dtype)
            return collide_stream.collide_stream_bgk(f, omega, substeps)
        return plain(f)

    return step
