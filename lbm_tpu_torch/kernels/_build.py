"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

``csrc/*.cu`` compile by hand, at first use, into one shared library with a
plain C interface, for ``sm_90a`` (Hopper).  The library lands in
``lbm_tpu_torch/_build/`` under a name keyed by a hash of the sources and
the flags, so an edited source rebuilds and an unchanged one loads in
milliseconds.  There is no fallback: a missing nvcc, a failed build or a
launch that returns a nonzero ``cudaError_t`` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default /usr/local/cuda)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the "
                       "CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblbm_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless this exact build exists; return its path.

    nvcc's output, with ptxas' register and spill report per kernel, is
    kept beside the library as ``.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    units = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *units],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    return ctypes.CDLL(str(build()))


class CudaKernel:
    """One C entry point of the library, with the count of its launches.

    ``launches`` goes up by one for every kernel launch that the C side
    reported as accepted, and nowhere else."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: launch failed with "
                               f"cudaError_t {err}")
        self.launches += 1


def check_state(f: torch.Tensor) -> tuple[int, int]:
    """What the kernels take: a contiguous (9, R, C) float32 or float64 CUDA
    tensor.  Returns (R, C); raises on anything else."""
    if f.device.type != "cuda":
        raise ValueError(f"kernel state must be a CUDA tensor, got {f.device}")
    if f.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel state must be float32 or float64, got {f.dtype}")
    if f.ndim != 3 or f.shape[0] != 9:
        raise ValueError(f"kernel state must be (9, R, C), got {tuple(f.shape)}")
    if not f.is_contiguous():
        raise ValueError("kernel state must be contiguous")
    return f.shape[1], f.shape[2]


def stream_handle(f: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``f``'s device, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)
