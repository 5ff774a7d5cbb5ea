"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

``csrc/*.cu`` compile by hand, at first use, one nvcc per source in
parallel, and link into one shared library with a plain C interface, for
``sm_90a`` (Hopper).  The library lands in ``lbm_tpu_torch/_build/``, or,
where the package directory is not writable (an installed
site-packages), in a per-user cache directory
(``$XDG_CACHE_HOME/lbm_tpu_torch``, default ``~/.cache/lbm_tpu_torch``),
under a name keyed by a hash of the sources and the flags, so an edited
source rebuilds and an unchanged one loads in milliseconds.  There is no
fallback: a missing nvcc, a failed build or a launch that returns a
nonzero ``cudaError_t`` raises.
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

from ..utils.observe import logger

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Flags of single sources, by file stem.  The MRT-CG kernels and kernels
# 9-26 contract no multiply-add, so that they reproduce their plain PyTorch
# versions, whose elementwise ops each round once.
UNIT_FLAGS = {stem: ("-fmad=false",) for stem in (
    "mrtcg_reduced", "mrtcg_split", "mrtcg_full", "channel_variant",
    "collide_stream_trt", "collide_stream_power_law", "rk_cg", "csf_droplet",
    "shan_chen", "cylinder", "ibm_forcing", "sediment", "moving_ibm", "cavity",
    "thermal", "d3q19")}


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default /usr/local/cuda)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the "
                       "CUDA kernels cannot be built")


def _writable(path: Path) -> bool:
    """Whether ``path`` is, or could be made as, a writable directory: its
    nearest existing ancestor is writable."""
    for p in (path, *path.parents):
        if p.exists():
            return p.is_dir() and os.access(p, os.W_OK | os.X_OK)
    return False


def cache_dir() -> Path:
    """The per-user build directory: ``$XDG_CACHE_HOME/lbm_tpu_torch``, by
    default ``~/.cache/lbm_tpu_torch``."""
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"),
                                                            ".cache")
    return Path(base) / "lbm_tpu_torch"


def build_dir() -> Path:
    """``BUILD_DIR`` in the package when it is writable, else ``cache_dir()``."""
    return BUILD_DIR if _writable(BUILD_DIR) else cache_dir()


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(UNIT_FLAGS.items())).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"liblbm_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless this exact build exists; return its path.

    One nvcc per ``.cu`` file, all started together, then one link into
    the shared library.  nvcc's output, with ptxas' register and spill
    report per kernel, is kept beside the library as ``.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    out_dir = lib.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    logger.info(f"building the CUDA kernels into {out_dir}")
    tag = f"{lib.stem}.{os.getpid()}"
    tmp = lib.with_name(f"{tag}.tmp.so")
    units = sorted(CSRC.glob("*.cu"))
    objs = [out_dir / f"{tag}.{u.stem}.o" for u in units]
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *UNIT_FLAGS.get(u.stem, ()),
                                   "-c", "-o", str(o), str(u)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for u, o in zip(units, objs)]
        outs = [p.communicate()[0] for p in procs]
        log = "".join(f"== {u.name}\n{out}" for u, out in zip(units, outs))
        failed = [u.name for u, p in zip(units, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (rc {link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
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


#: the most shards one launch of a batched halo kernel takes (kernels 32, 33,
#: 35 and 36; csrc/shan_chen.cu, csrc/d3q19.cu and csrc/thermal.cu MAX_SHARDS)
MAX_SHARDS = 8


def shard_batches(keys) -> list[list[int]]:
    """The launches of one sweep of a batched halo kernel (32, 33, 35, 36) over
    shards whose (device, dtype) are ``keys``: the shards' indices grouped by
    key, in order, at most ``MAX_SHARDS`` a launch."""
    groups: dict = {}
    for i, key in enumerate(keys):
        groups.setdefault(key, []).append(i)
    return [m[c:c + MAX_SHARDS] for m in groups.values() for c in range(0, len(m), MAX_SHARDS)]


def check_state(f: torch.Tensor, planes: int = 9) -> tuple[int, int]:
    """What the kernels take: a contiguous (planes, R, C) float32 or float64
    CUDA tensor.  Returns (R, C); raises on anything else."""
    if f.device.type != "cuda":
        raise ValueError(f"kernel state must be a CUDA tensor, got {f.device}")
    if f.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel state must be float32 or float64, got {f.dtype}")
    if f.ndim != 3 or f.shape[0] != planes:
        raise ValueError(f"kernel state must be ({planes}, R, C), got {tuple(f.shape)}")
    if not f.is_contiguous():
        raise ValueError("kernel state must be contiguous")
    return f.shape[1], f.shape[2]


def c_doubles(values) -> ctypes.Array:
    """A kernel's scalar parameters as the C double array it reads."""
    return (ctypes.c_double * len(values))(*values)


def stream_handle(f: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``f``'s device, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)
