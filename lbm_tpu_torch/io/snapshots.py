"""Snapshot writing (counterpart of lbm_tpu/io/snapshots.py).

The reference keeps time-stacked tensors in RAM and writes them once at the
end with torch::save (horizontal_poiseuille_test.cpp:157-160).  Here each
frame appends to an on-disk .npy stream (constant host memory, a valid file
after every close), with a torch .pt export for the reference's tooling.
Only the synchronous ``python`` backend is ported; lbm_tpu's ``native``
C++ writer thread (io/native.py, native/) is not, and asking for it raises.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

BACKENDS = ("auto", "python")


def to_numpy(array) -> np.ndarray:
    """A tensor on any device, or anything numpy takes, as a host array."""
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


@dataclass
class SnapshotWriter:
    """Appends snapshots as raw .npy streams under a prefix.

    Files: {prefix}-{name}.npy (frames stacked along axis 0) and
    {prefix}-meta.json.  ``backend`` 'python' (or 'auto', which here means
    python) writes synchronously; 'native' raises NotImplementedError."""

    prefix: str
    backend: str = "auto"
    _files: dict = field(default_factory=dict)
    _shapes: dict = field(default_factory=dict)
    _counts: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.backend == "native":
            raise NotImplementedError(
                "the native snapshot writer (lbm_tpu io/native.py) is not ported; "
                "use backend='python'")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown snapshot backend {self.backend!r}")

    def append(self, name: str, array) -> None:
        arr = np.ascontiguousarray(to_numpy(array))
        if name not in self._files:
            path = f"{self.prefix}-{name}.npy"
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            fh = open(path, "wb")
            # placeholder header, rewritten on close with the true count
            np.lib.format.write_array_header_2_0(
                fh, {"descr": np.lib.format.dtype_to_descr(arr.dtype),
                     "fortran_order": False, "shape": (0,) + arr.shape})
            self._files[name] = fh
            self._shapes[name] = (arr.shape, arr.dtype)
            self._counts[name] = 0
        shape, dtype = self._shapes[name]
        if arr.shape != shape or arr.dtype != dtype:
            raise ValueError(f"snapshot {name}: shape/dtype changed")
        arr.tofile(self._files[name])
        self._files[name].flush()
        self._counts[name] += 1

    def close(self) -> None:
        for name, fh in self._files.items():
            shape, dtype = self._shapes[name]
            fh.seek(0)
            np.lib.format.write_array_header_2_0(
                fh, {"descr": np.lib.format.dtype_to_descr(dtype),
                     "fortran_order": False, "shape": (self._counts[name],) + shape})
            fh.close()
        with open(f"{self.prefix}-meta.json", "w") as fh:
            json.dump({k: {"count": self._counts[k], "shape": list(self._shapes[k][0]),
                           "dtype": str(self._shapes[k][1])}
                       for k in self._counts}, fh, indent=1)
        self._files.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_torch(path: str, array) -> None:
    """torch-format export, for parity with the reference's .pt dumps."""
    torch.save(torch.from_numpy(to_numpy(array)), path)


def load_stream(prefix: str, name: str) -> np.ndarray:
    return np.load(f"{prefix}-{name}.npy")
