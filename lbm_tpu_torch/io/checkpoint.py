"""Checkpoint / resume of simulation state (counterpart of
lbm_tpu/io/checkpoint.py).

A state is a tuple of tensors.  The file is lbm_tpu's own format: one
``.npz`` with the leaves as ``leaf_0``, ``leaf_1``, ... and a ``_treedef``
entry, the UTF-8 bytes of a JSON object holding ``n`` (the leaf count) and
``step``, written atomically (a ``.tmp`` file, then ``os.replace``), so a
crash never leaves a torn checkpoint.  A port checkpoint and an lbm_tpu
checkpoint of the same carry therefore read each other (rayleigh_benard's
carries differ: ROADMAP Queue 3).  No pickle.
lbm_tpu's ``OrbaxCheckpointer`` belongs to a JAX library and has no
counterpart (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, state, step: int | None = None) -> None:
    """Write the tensors (or arrays) of the tuple ``state`` to ``path``."""
    leaves = [_numpy(leaf) for leaf in state]
    payload = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    meta = {"repr": f"PyTreeDef(({', '.join('*' * len(leaves))}))", "n": len(leaves),
            "step": step}
    payload["_treedef"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    os.replace(tmp, path)


def load(path: str, like):
    """Read a state written by ``save`` (or by lbm_tpu).  ``like`` is a tuple
    of tensors with the leaves' count and shapes: each leaf must have its
    like's shape and comes back on its device, in its dtype.  A ``None`` in
    ``like`` takes that leaf as stored, a CPU tensor.  Returns
    ``(state tuple, step)``."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["_treedef"].tobytes()).decode())
        leaves = [data[f"leaf_{i}"] for i in range(meta["n"])]
    if len(leaves) != len(like):
        raise ValueError(f"checkpoint {path} has {len(leaves)} leaves, expected {len(like)}")
    out = []
    for i, (leaf, ref) in enumerate(zip(leaves, like)):
        if ref is None:
            out.append(torch.as_tensor(leaf))
            continue
        if tuple(leaf.shape) != tuple(ref.shape):
            raise ValueError(f"checkpoint {path} leaf {i} has shape {tuple(leaf.shape)}, "
                             f"expected {tuple(ref.shape)}")
        out.append(torch.as_tensor(leaf, dtype=ref.dtype, device=ref.device))
    return tuple(out), meta.get("step")


def _steps(directory: str, stem: str) -> list[tuple[int, str]]:
    """(step, file name) of every {stem}-{step}.npz in ``directory``."""
    entries = []
    for name in os.listdir(directory):
        if name.startswith(stem + "-") and name.endswith(".npz"):
            try:
                entries.append((int(name[len(stem) + 1:-4]), name))
            except ValueError:
                pass
    return sorted(entries)


def latest(directory: str, stem: str = "ckpt") -> str | None:
    """The newest checkpoint path matching {stem}-{step}.npz, or None."""
    if not os.path.isdir(directory):
        return None
    entries = _steps(directory, stem)
    return os.path.join(directory, entries[-1][1]) if entries else None


class Checkpointer:
    """Periodic checkpointing: ``maybe_save(step, state)`` writes every
    ``every`` steps and keeps the newest ``keep`` files."""

    def __init__(self, directory: str, every: int, keep: int = 2, stem: str = "ckpt"):
        self.directory = directory
        self.every = every
        self.keep = keep
        self.stem = stem

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.stem}-{step}.npz")

    def maybe_save(self, step: int, state) -> bool:
        if self.every <= 0 or step % self.every != 0:
            return False
        self.force_save(step, state)
        return True

    def force_save(self, step: int, state) -> None:
        """Write a checkpoint at ``step`` whatever the cadence (a drive loop
        whose chunks end past the cadence's multiples), then prune to
        ``keep``."""
        save(self.path(step), state, step=step)
        for _, name in _steps(self.directory, self.stem)[:-self.keep or None]:
            os.remove(os.path.join(self.directory, name))

    def restore_latest(self, like):
        """``load`` of the newest checkpoint, or (None, None) if there is none."""
        path = latest(self.directory, self.stem)
        if path is None:
            return None, None
        return load(path, like)
