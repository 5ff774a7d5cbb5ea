"""Single-phase BGK step (counterpart of lbm_tpu/models/single_phase.py).

Composes the reference's exact step ordering:

    macroscopics -> equilibrium -> BGK collide (+ optional Guo force)
    -> pre-stream BCs on f_coll -> fully periodic stream
    -> post-stream wall BCs overwrite f_adve from f_coll

Call stack parity: reference test/horizontal_poiseuille_test.cpp:128-152.
This is the plain version of the channel kernel (kernels/channel.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import torch

from ..ops import d2q9

PreStreamBC = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
PostStreamBC = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class SinglePhaseModel:
    """A configurable BGK step.

    A frozen dataclass, not an ``nn.Module``: the model holds no tensors and
    nothing to train, only the step's configuration, and it is hashable and
    immutable like its JAX counterpart.

    Attributes:
      omega: BGK relaxation rate (1/tau).
      incompressible: use the linearised equilibrium and the momentum (not
        u) as the advected velocity, as in the horizontal Poiseuille case.
      collision: optional (f, f_eq) -> f_coll in place of BGK relaxation.
      force: optional (fx, fy) body-force density; applied as a velocity
        shift u += force (test/gravity_test.cpp:146) plus a Guo source on
        f_coll (:154) with ``guo_coeffs``.
      pre_stream_bcs: edits to f_coll before streaming (pressure BCs).
      post_stream_bcs: wall rules overwriting f_adve from f_coll.
    """

    omega: float
    incompressible: bool = False
    collision: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None
    force: Optional[tuple[float, float]] = None
    # the reference's gravity test uses the 9x-weaker (1/3, 1/9) variant
    # (gravity_test.cpp:81-82,154)
    guo_coeffs: tuple[float, float] = (1.0 / 3.0, 1.0 / 9.0)
    pre_stream_bcs: Sequence[PreStreamBC] = field(default_factory=tuple)
    post_stream_bcs: Sequence[PostStreamBC] = field(default_factory=tuple)

    def macroscopics(self, f: torch.Tensor):
        rho = d2q9.calc_rho(f)
        u = d2q9.calc_momentum(f) if self.incompressible else d2q9.calc_u(f, rho)
        return rho, u

    def eq(self, u: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
        if self.incompressible:
            return d2q9.incomp_equilibrium(u, rho)
        return d2q9.equilibrium(u, rho)

    def step(self, f_adve: torch.Tensor) -> torch.Tensor:
        rho, u = self.macroscopics(f_adve)
        if self.force is not None:
            fg = torch.as_tensor(self.force, dtype=f_adve.dtype,
                                 device=f_adve.device)
            u = u + fg[:, None, None]
        f_equi = self.eq(u, rho)
        if self.collision is not None:
            f_coll = self.collision(f_adve, f_equi)
        else:
            f_coll = d2q9.bgk_collision(f_adve, f_equi, self.omega)
        if self.force is not None:
            f_coll = f_coll + d2q9.guo_source(
                u, fg, self.omega, ics2=self.guo_coeffs[0],
                ics4=self.guo_coeffs[1])
        for bc in self.pre_stream_bcs:
            f_coll = bc(f_coll, f_equi, u, rho)
        f_new = d2q9.stream(f_coll)
        for bc in self.post_stream_bcs:
            f_new = bc(f_new, f_coll)
        return f_new

    def init(self, R: int, C: int, *, device, dtype: torch.dtype,
             rho0: float = 1.0, u0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Equilibrium state at density ``rho0`` and velocity ``u0`` (rest)."""
        rho = torch.full((R, C), rho0, dtype=dtype, device=device)
        u = torch.zeros((2, R, C), dtype=dtype, device=device) if u0 is None \
            else torch.as_tensor(u0, dtype=dtype, device=device)
        return self.eq(u, rho)

    def run_chunk(self, f: torch.Tensor, n: int) -> torch.Tensor:
        """n plain steps."""
        for _ in range(n):
            f = self.step(f)
        return f
