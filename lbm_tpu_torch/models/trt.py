"""Two-relaxation-time (TRT) collision (counterpart of lbm_tpu/models/trt.py).

The even and odd parts of each opposite-direction pair relax at separate
rates.  With the "magic" combination

    Lambda = (tau_plus - 1/2)(tau_minus - 1/2) = 3/16

halfway bounce-back puts the wall where the parabolic Poiseuille solution
is exact at any viscosity; the reference's L2 <= 1e-11 gate
(test/horizontal_poiseuille_test.cpp:175) holds for BGK only at
tau = sqrt(3/16) + 1/2, where Lambda_BGK = (tau - 1/2)^2 = 3/16.

    f_k^+ = (f_k + f_opp(k)) / 2        f_k^- = (f_k - f_opp(k)) / 2
    f_k'  = f_k - omega_plus (f_k^+ - feq_k^+) - omega_minus (f_k^- - feq_k^-)

omega_minus = omega_plus is BGK up to the reassociation.  The fused
periodic form is kernels/trt.py (CUDA kernel 10); the walled channel form
is kernels/channel.py's variant step (kernel 9).
"""

from __future__ import annotations

import torch

from ..core import lattice as lat

MAGIC_POISEUILLE = 3.0 / 16.0


def omega_minus_from_magic(omega_plus: float,
                           magic: float = MAGIC_POISEUILLE) -> float:
    """The odd relaxation rate that realises Lambda = magic:
    tau_minus = 1/2 + magic / (tau_plus - 1/2)."""
    tau_plus = 1.0 / omega_plus
    tau_minus = 0.5 + magic / (tau_plus - 0.5)
    return 1.0 / tau_minus


def trt_collision(f: torch.Tensor, f_eq: torch.Tensor, omega_plus: float,
                  omega_minus: float) -> torch.Tensor:
    """One TRT relaxation on (9, R, C) planes."""
    fo = f[list(lat.OPPQ)]
    eo = f_eq[list(lat.OPPQ)]
    ne_even = 0.5 * ((f + fo) - (f_eq + eo))
    ne_odd = 0.5 * ((f - fo) - (f_eq - eo))
    return f - omega_plus * ne_even - omega_minus * ne_odd
