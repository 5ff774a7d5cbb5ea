"""Helpers shared by the scene modules."""

from __future__ import annotations

import torch

from ..io.checkpoint import Checkpointer
from ..utils import observe

CHUNK = 1000  # steps between progress logs (and NaN checks where taken)


def no_mesh(mesh) -> None:
    """Raise if a scene is asked to shard (its ``mesh_shape``, or the falling
    cylinder's ``mesh``): the scenes' meshes wait for an ``auto_sharded`` on
    parallel/'s exchange."""
    if mesh is not None:
        raise NotImplementedError(
            "a scene's mesh (mesh_shape, mesh) waits for an auto_sharded on parallel/'s "
            "exchange (ROADMAP Queue 1 item 14); the scenes run on one device, the "
            "sharded steps are in kernels/sharded.py and kernels/sharded2d.py")


def _resume(ckpt: Checkpointer, carry: tuple, T: int, substeps: int,
            record_every: int | None):
    """(carry, done, series) from the newest checkpoint of ``ckpt``, or the
    fresh start (carry, 0, []).  Each carry tensor must keep its shape; the
    step must be a multiple of ``substeps`` within T, and the saved series
    must hold its records."""
    restored, at = ckpt.restore_latest((*carry, None))
    if restored is None:
        return carry, 0, []
    done, saved = int(at), restored[-1]
    if done % substeps or done > T:
        raise ValueError(f"the newest checkpoint in {ckpt.directory} is at step {done}: "
                         f"not a multiple of substeps={substeps} within T={T}; resume with "
                         "the run's substeps and a T at least as large")
    if record_every is not None and saved.shape[0] != done // record_every:
        raise ValueError(f"the checkpoint at step {done} holds {saved.shape[0]} records, "
                         f"not {done // record_every} at record_every={record_every}")
    observe.logger.info(f"resumed from {ckpt.directory} at step {done}")
    return tuple(restored[:-1]), done, [saved] if record_every is not None and len(saved) else []


def drive_recorded(step, carry: tuple, T: int, record_every: int | None, record,
                   recorder=None, substeps: int = 1, watchdog: bool = True,
                   checkpoint_dir: str | None = None, checkpoint_every: int = 10000):
    """T // substeps calls ``carry = step(carry)``, each advancing ``substeps``
    steps, with nothing between them on the host.  Every ``record_every``
    steps ``record(carry)``, a device tensor, joins the series, stacked on
    the device and copied to the host at each chunk boundary: every CHUNK
    steps and at T, where, with ``watchdog``, the NaN watchdog checks
    carry[0].  ``recorder`` (a SnapshotRecorder) samples the carry before
    each step of its cadence.  T, record_every and the cadence are multiples
    of ``substeps``.

    ``checkpoint_dir`` turns on checkpoint/resume (lbm_tpu/utils/observe.py
    drive_chunked): a chunk boundary also falls where ``checkpoint_every``
    steps have passed since the last checkpoint, and there the carry and the
    series recorded so far are written to the directory (io.checkpoint, the
    file's step counting steps); a run started on a directory that holds a
    checkpoint resumes from the newest one, and gives the uninterrupted
    run's result bit for bit.  Returns (carry, the (T // k, ...) series on
    the host, or None)."""
    ckpt, done, series = None, 0, []
    if checkpoint_dir is not None:
        if recorder is not None:
            raise ValueError("snapshot_every and checkpoint_dir are mutually exclusive "
                             "(one drive mode per run)")
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
        ckpt = Checkpointer(checkpoint_dir, every=checkpoint_every)
        carry, done, series = _resume(ckpt, carry, T, substeps, record_every)
    f = carry[0]
    meter = observe.StepMeter(f[0].numel(), f.device, total_steps=T, start_steps=done)
    pending, logged, last_ckpt = [], done, done
    for t in range(done, T, substeps):
        if recorder is not None and t % recorder.cadence == 0:
            recorder.record(carry)
        carry = step(carry)
        done = t + substeps
        if record_every is not None and done % record_every == 0:
            pending.append(record(carry))
        due = ckpt is not None and done - last_ckpt >= checkpoint_every
        if done // CHUNK > t // CHUNK or done == T or due:
            meter.update(done - logged)
            logged = done
            if watchdog:
                observe.check_finite(carry[0], done)
            if pending:
                series.append(torch.stack(pending).cpu())
                pending = []
            if due:
                saved = torch.cat(series) if series else torch.zeros(0, dtype=torch.float64)
                ckpt.force_save(done, (*carry, saved))
                last_ckpt = done
    if record_every is None:
        return carry, None
    if not series:  # no record yet
        return carry, torch.zeros((0,) + tuple(record(carry).shape), dtype=f.dtype)
    return carry, torch.cat(series)
