"""Channel steps: walls, pressure-periodic lines and body forces.

Counterpart of lbm_tpu/kernels/channel_pallas.py:

  * ``make_channel_fused_step`` (pressure-periodic rows + no-slip column
    walls), both families: "bgk", the horizontal-Poiseuille step, CUDA
    kernel 2 (csrc/channel_bgk.cu), plain version ``channel_model(...).step``;
    "kbc", the ulbm_poiseuille step, CUDA kernel 4 (csrc/channel_kbc.cu),
    plain version ``kbc_channel_step``;
  * ``make_channel_variant_step``, the gravity, specular, free-stream,
    vertical-Poiseuille and TRT channels: CUDA kernel 9
    (csrc/channel_variant.cu), plain version ``ChannelVariant(...).model()``,
    the SinglePhaseModel composition of lbm_tpu's jnp scene path.

Each factory runs its kernel on a CUDA state and its plain version on a CPU
state.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..boundary import bc
from ..core import lattice as lat
from ..models import kbc, trt
from ..models.single_phase import SinglePhaseModel
from ..ops import d2q9
from ..utils.xmath import resolve_fused, rounded
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


# --- the channel variants (kernel 9) ---------------------------------------------

ROW_WALLS = {None: 0, "bounce": 1, "abb": 2}
COL_WALLS = {None: 0, "bounce": 1, "specular": 2}

CHANNEL_VARIANT = _build.CudaKernel(
    "lbm_channel_variant",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.POINTER(ctypes.c_double)] + [ctypes.c_int] * 8 + [ctypes.c_void_p])



@dataclass(frozen=True)
class ChannelVariant:
    """One configuration of the channel-variant step: the arguments of
    lbm_tpu's make_channel_variant_step (channel_pallas.py:158-202).

      pressure   (rho_in, rho_out, axis): the virtual inlet / outlet rewrite
                 on rows (axis 0) or columns (axis 1); None = none
                 (horizontal_poiseuille_test.cpp:25-45,
                 vertical_poiseuille_test.cpp:24-44).
      force      (fx, fy) uniform body force: the velocity shift and the
                 reference's weak (1/3, 1/9) Guo source
                 (gravity_test.cpp:81-82,146-154).
      col_walls  None | 'bounce' | 'specular' on columns 0 and C-1.
      row_walls  None | 'bounce' | 'abb' on rows 0 and R-1; 'abb' at the
                 constant wall velocity ``abb_u`` (free_stream_test.cpp:104-125).
      omega_minus  None = BGK; a rate = TRT, the even parts at ``omega``,
                 the odd at ``omega_minus``.  Not with ``force`` (the Guo
                 prefactor depends on the parity under TRT).
      corner_consistent  the specular rule skips rows 0 and R-1 (lane 1:-1),
                 which the ABB rows own: free_stream's corner-consistent
                 mode.  Needs row_walls 'abb' and col_walls 'specular'.
    """

    omega: float
    incompressible: bool
    pressure: tuple | None = None
    force: tuple | None = None
    col_walls: str | None = None
    row_walls: str | None = None
    abb_u: tuple = (0.0, 0.0)
    omega_minus: float | None = None
    corner_consistent: bool = False

    def __post_init__(self):
        if self.col_walls not in COL_WALLS:
            raise ValueError(self.col_walls)
        if self.row_walls not in ROW_WALLS:
            raise ValueError(self.row_walls)
        if self.omega_minus is not None and self.force is not None:
            raise ValueError("TRT (omega_minus) + body force not supported: "
                             "the Guo prefactor is parity-dependent")
        if self.pressure is not None and self.pressure[2] not in (0, 1):
            raise ValueError(f"pressure axis must be 0 or 1, got {self.pressure[2]!r}")
        if self.corner_consistent and (self.row_walls, self.col_walls) != ("abb", "specular"):
            raise ValueError("corner_consistent needs row_walls='abb' and "
                             "col_walls='specular'")

    def model(self) -> SinglePhaseModel:
        """The plain step: lbm_tpu's jnp scene composition, with the row
        walls (N, then 0) before the column walls (N, then 0)."""
        eq_fn = d2q9.incomp_equilibrium if self.incompressible else d2q9.equilibrium
        pre = ()
        if self.pressure is not None:
            rho_in, rho_out, axis = self.pressure
            pre = (lambda fc, fe, u, rho: bc.pressure_periodic(
                fc, fe, u, rho_in, rho_out, axis=axis, eq_fn=eq_fn),)
        post = []
        if self.row_walls == "bounce":
            post += [lambda fa, fc: bc.bounce_back(fa, fc, "rowN"),
                     lambda fa, fc: bc.bounce_back(fa, fc, "row0")]
        elif self.row_walls == "abb":
            post += [lambda fa, fc: bc.anti_bounce_back(fa, fc, "row0", self.abb_u),
                     lambda fa, fc: bc.anti_bounce_back(fa, fc, "rowN", self.abb_u)]
        lane = slice(1, -1) if self.corner_consistent else slice(None)
        if self.col_walls == "bounce":
            post += [lambda fa, fc: bc.bounce_back(fa, fc, "colN"),
                     lambda fa, fc: bc.bounce_back(fa, fc, "col0")]
        elif self.col_walls == "specular":
            post += [lambda fa, fc: bc.specular(fa, fc, "colN", lane),
                     lambda fa, fc: bc.specular(fa, fc, "col0", lane)]
        collision = None
        if self.omega_minus is not None:
            collision = lambda f, fe: trt.trt_collision(  # noqa: E731
                f, fe, self.omega, self.omega_minus)
        return SinglePhaseModel(omega=self.omega, incompressible=self.incompressible,
                                collision=collision, force=self.force,
                                pre_stream_bcs=pre, post_stream_bcs=tuple(post))

    def constants(self, dtype: torch.dtype):
        """Kernel 9's 28 scalars, each as the plain version rounds it in
        ``dtype``: omega, 1 - omega, omega_minus, fx, fy, 1 - omega/2, 1/3,
        1/9, c_k.F (9, taken in ``dtype``), rho_in, rho_out, and the ABB
        coefficients (9, d2q9.abb_coefficient in ``dtype``)."""
        fg = torch.tensor(self.force or (0.0, 0.0), dtype=dtype)
        cf = [(lat.CX[k] * fg[0] + lat.CY[k] * fg[1]).item() for k in range(9)]
        rho_in, rho_out = self.pressure[:2] if self.pressure is not None else (1.0, 1.0)
        abb = d2q9.abb_coefficient(torch.tensor(self.abb_u, dtype=dtype)).tolist()
        omega_minus = self.omega if self.omega_minus is None else self.omega_minus
        vals = [rounded(x, dtype) for x in (
            self.omega, 1.0 - self.omega, omega_minus)] + fg.tolist() + [
            rounded(x, dtype) for x in (1.0 - 0.5 * self.omega, 1.0 / 3.0, 1.0 / 9.0)
        ] + cf + [rounded(rho_in, dtype), rounded(rho_out, dtype)] + abb
        return (ctypes.c_double * len(vals))(*vals)


def channel_variant(f: torch.Tensor, variant: ChannelVariant, consts=None) -> torch.Tensor:
    """One channel-variant step on the card (kernel 9) into a fresh buffer;
    ``consts`` are ``variant.constants(f.dtype)``, made here when None.
    Raises on a tensor the kernel does not take and on a refused launch."""
    R, C = _build.check_state(f)
    _check_variant_grid(R, C)
    if consts is None:
        consts = variant.constants(f.dtype)
    out = torch.empty_like(f)
    axis = -1 if variant.pressure is None else int(variant.pressure[2])
    with torch.cuda.device(f.device):
        CHANNEL_VARIANT.launch(
            f.data_ptr(), out.data_ptr(), R, C, consts, int(variant.incompressible),
            int(variant.omega_minus is not None), int(variant.force is not None), axis,
            ROW_WALLS[variant.row_walls], COL_WALLS[variant.col_walls],
            int(variant.corner_consistent), int(f.dtype == torch.float64),
            _build.stream_handle(f))
    return out


def _check_variant_grid(R: int, C: int) -> None:
    if R < 4 or C < 4:
        raise ValueError(f"channel variant step needs R >= 4 and C >= 4, got {R}x{C}")


def make_channel_variant_step(R: int, C: int, *, omega: float, incompressible: bool,
                              pressure: tuple | None = None, force: tuple | None = None,
                              col_walls: str | None = None, row_walls: str | None = None,
                              abb_u=(0.0, 0.0), omega_minus: float | None = None,
                              dtype: torch.dtype, corner_consistent: bool = False):
    """Single-phase channel-variant step f (9, R, C) -> (9, R, C) for any
    R, C >= 4 (the arguments are ChannelVariant's): kernel 9 on a CUDA
    state, the plain model step on a CPU state."""
    _check_variant_grid(R, C)
    variant = ChannelVariant(
        omega=omega, incompressible=incompressible, pressure=pressure, force=force,
        col_walls=col_walls, row_walls=row_walls, abb_u=tuple(abb_u),
        omega_minus=omega_minus, corner_consistent=corner_consistent)
    plain = variant.model().step
    consts = variant.constants(dtype)

    def step(f: torch.Tensor) -> torch.Tensor:
        check_step_state(f, R, C, dtype)
        if resolve_fused(f):
            return channel_variant(f, variant, consts)
        return plain(f)

    return step
