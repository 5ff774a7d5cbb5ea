"""Helpers shared by the scene modules."""

from __future__ import annotations

import torch

from ..utils import observe
from .ulbm import CHUNK


def not_ported(checkpoint_dir, checkpoint_every) -> None:
    """Raise if a scene is asked to checkpoint: io/checkpoint is not ported."""
    if checkpoint_dir is not None or checkpoint_every is not None:
        raise NotImplementedError(
            "checkpoint_dir/checkpoint_every wait for io/checkpoint (ROADMAP Queue 1 "
            "item 12); the port does not take them yet")


def no_mesh(mesh_shape) -> None:
    """Raise if a scene is asked to shard: parallel/ is not ported."""
    if mesh_shape is not None:
        raise NotImplementedError(
            "mesh_shape waits for parallel/ (ROADMAP Queue 1 item 14); the port "
            "runs on one device")


def drive_recorded(step, carry: tuple, T: int, record_every: int | None, record,
                   recorder=None, substeps: int = 1):
    """T // substeps calls ``carry = step(carry)``, each advancing ``substeps``
    steps, with nothing between them on the host.  Every ``record_every``
    steps ``record(carry)``, a device tensor, joins the series, stacked on
    the device and copied to the host once per CHUNK steps, when the NaN
    watchdog checks carry[0]; ``recorder`` (a SnapshotRecorder) samples the
    carry before each step of its cadence.  T, record_every and the cadence
    are multiples of ``substeps``.  Returns (carry, the (T // k, ...) series
    on the host, or None)."""
    f = carry[0]
    meter = observe.StepMeter(f[0].numel(), f.device, total_steps=T)
    series, pending, logged = [], [], 0
    for t in range(0, T, substeps):
        if recorder is not None and t % recorder.cadence == 0:
            recorder.record(carry)
        carry = step(carry)
        done = t + substeps
        if record_every is not None and done % record_every == 0:
            pending.append(record(carry))
        if done // CHUNK > t // CHUNK or done == T:
            meter.update(done - logged)
            logged = done
            observe.check_finite(carry[0], done)
            if pending:
                series.append(torch.stack(pending).cpu())
                pending = []
    if record_every is None:
        return carry, None
    if not series:  # T == 0
        return carry, torch.zeros((0,) + tuple(record(carry).shape), dtype=f.dtype)
    return carry, torch.cat(series)
