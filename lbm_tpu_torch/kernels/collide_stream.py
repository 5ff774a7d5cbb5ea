"""Fused periodic collide-stream: the plain harness and the CUDA launches.

Counterpart of lbm_tpu/kernels/collide_stream.py.  The Pallas harness there
runs any local collision inside the block pipeline of kernels/pipeline.py;
that pipeline has no counterpart here (each CUDA kernel indexes device
memory directly).  This module holds

  * ``pair_cu`` / ``d2q9_pairs``: the paired-direction subexpressions every
    paired collision shares (csrc/d2q9.cuh writes the same in C++);
  * ``make_fused_step``: the plain step stream(collide_fn(f)), any local
    collision, ``substeps`` steps per call;
  * ``launch_steps``: ``substeps`` launches of a one-step kernel (kernels
    1, 3, 5, 10-14), ping-ponging two buffers;
  * ``collide_stream_bgk``: CUDA kernel 1 (csrc/collide_stream_bgk.cu), the
    BGK collision;
  * ``kbc_collide_fn`` / ``make_kbc_fused_step`` / ``collide_stream_kbc``:
    the cascaded KBC collision, plain and as CUDA kernel 3
    (csrc/collide_stream_kbc.cu).
"""

from __future__ import annotations

import ctypes

import torch

from ..core import lattice as lat
from ..models import kbc
from ..ops import d2q9
from ..utils.xmath import resolve_fused
from . import _build

WQ = lat.WQ
MAX_SUBSTEPS = 8  # lbm_tpu's halo depth bounds substeps; kept as the API range

# opposite-direction pairs (kp, km) with c_km = -c_kp
PAIR_KS = ((1, 3), (2, 4), (5, 7), (8, 6))


def pair_cu(ux, uy):
    """{kp: c_kp . u} for the four pair leaders — ux, uy, ux+uy, ux-uy."""
    return {1: ux, 2: uy, 5: ux + uy, 8: ux - uy}


def d2q9_pairs(ux, uy):
    """Shared subexpressions of the paired-direction equilibrium: the even
    base ``t0 = 1 - 1.5|u|^2`` and, per opposite pair, ``(kp, km, W, cu,
    cu^2)`` with ``cu = c_kp . u = -c_km . u`` (see
    lbm_tpu.kernels.collide_stream.d2q9_pairs)."""
    uxx = ux * ux
    uyy = uy * uy
    t0 = 1.0 - 1.5 * (uxx + uyy)
    cu = pair_cu(ux, uy)
    cc = {1: uxx, 2: uyy, 5: cu[5] * cu[5], 8: cu[8] * cu[8]}
    return t0, tuple((kp, km, WQ[kp], cu[kp], cc[kp]) for kp, km in PAIR_KS)


def _check_substeps(substeps: int) -> None:
    if not 1 <= substeps <= MAX_SUBSTEPS:
        raise ValueError(f"substeps must be in [1, {MAX_SUBSTEPS}]")


def check_step_state(f: torch.Tensor, R: int, C: int, dtype: torch.dtype,
                     planes: int = 9) -> None:
    """A step built for (planes, R, C) ``dtype`` takes nothing else."""
    if tuple(f.shape) != (planes, R, C) or f.dtype != dtype:
        raise ValueError(f"state {tuple(f.shape)} {f.dtype}, step built for "
                         f"({planes}, {R}, {C}) {dtype}")


def make_fused_step(R: int, C: int, collide_fn, dtype: torch.dtype,
                    substeps: int = 1):
    """Plain periodic collide-stream with an arbitrary local collision:
    f (9, R, C) -> stream(collide_fn(f)), applied ``substeps`` times."""
    _check_substeps(substeps)

    def step(f: torch.Tensor) -> torch.Tensor:
        check_step_state(f, R, C, dtype)
        for _ in range(substeps):
            f = d2q9.stream(collide_fn(f))
        return f

    return step


def launch_steps(kernel: _build.CudaKernel, f: torch.Tensor, substeps: int,
                 *params, planes: int = 9) -> torch.Tensor:
    """``substeps`` launches of a one-step kernel on a (planes, R, C) state,
    whose C entry point takes (f_in, f_out, R, C, *params, is_f64, stream).

    One launch per step: the steps ping-pong between two fresh buffers, and
    ``f`` itself is never written.  Raises on a tensor the kernel does not
    take and on a refused launch."""
    _check_substeps(substeps)
    R, C = _build.check_state(f, planes)
    bufs = [torch.empty_like(f)]
    if substeps > 1:
        bufs.append(torch.empty_like(f))
    with torch.cuda.device(f.device):
        stream = _build.stream_handle(f)
        src = f
        for i in range(substeps):
            dst = bufs[i % 2]
            kernel.launch(src.data_ptr(), dst.data_ptr(), R, C, *params,
                          int(f.dtype == torch.float64), stream)
            src = dst
    return src


COLLIDE_STREAM_BGK = _build.CudaKernel(
    "lbm_collide_stream_bgk",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.c_double, ctypes.c_int, ctypes.c_void_p])


def collide_stream_bgk(f: torch.Tensor, omega: float, substeps: int = 1) -> torch.Tensor:
    """``substeps`` periodic BGK collide-stream steps on the card (kernel 1)."""
    return launch_steps(COLLIDE_STREAM_BGK, f, substeps, float(omega))


def kbc_collide_fn(s2: float, gamma_impl: str = "factored"):
    """The KBC cascaded collision as a function of f (9, R, C): m0 and m1
    as explicit 9-term sums, u = m1 / m0, then ``models.kbc.collide``
    (lbm_tpu.kernels.collide_stream.kbc_collide_fn).  The plain version of
    kernel 3."""

    def fn(f: torch.Tensor) -> torch.Tensor:
        m0 = f[0]
        for k in range(1, 9):
            m0 = m0 + f[k]
        mx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8]
        my = f[2] - f[4] + f[5] + f[6] - f[7] - f[8]
        u = torch.stack([mx / m0, my / m0])
        return kbc.collide(f, m0, u, s2, gamma_impl=gamma_impl)

    # the kind and scalars of kernel 27's KBC instance (kernels/sharded.py)
    fn.halo_kernel = ("kbc", (float(s2),), (int(gamma_impl == "factored"), 0))
    return fn


COLLIDE_STREAM_KBC = _build.CudaKernel(
    "lbm_collide_stream_kbc",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def collide_stream_kbc(f: torch.Tensor, s2: float, substeps: int = 1,
                       gamma_impl: str = "factored") -> torch.Tensor:
    """``substeps`` periodic KBC collide-stream steps on the card (kernel 3)."""
    kbc.check_gamma_impl(gamma_impl)
    return launch_steps(COLLIDE_STREAM_KBC, f, substeps, float(s2),
                           int(gamma_impl == "factored"))


def make_kbc_fused_step(R: int, C: int, s2: float, dtype: torch.dtype,
                        substeps: int = 1, gamma_impl: str = "factored"):
    """Periodic KBC collide-stream f (9, R, C) -> (9, R, C), ``substeps``
    steps per call (the ULBM family's step, test/ulbm_double_shear_flow.cpp):
    kernel 3 on a CUDA state (one launch per step), the plain
    stream(kbc_collide_fn(f)) on a CPU state."""
    kbc.check_gamma_impl(gamma_impl)
    plain = make_fused_step(R, C, kbc_collide_fn(s2, gamma_impl), dtype, substeps)

    def step(f: torch.Tensor) -> torch.Tensor:
        if resolve_fused(f):
            check_step_state(f, R, C, dtype)
            return collide_stream_kbc(f, s2, substeps, gamma_impl)
        return plain(f)

    return step
