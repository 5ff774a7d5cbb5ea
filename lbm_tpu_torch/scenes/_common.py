"""Helpers shared by the scene modules."""

from __future__ import annotations


def not_ported(checkpoint_dir, checkpoint_every) -> None:
    """Raise if a scene is asked to checkpoint: io/checkpoint is not ported."""
    if checkpoint_dir is not None or checkpoint_every is not None:
        raise NotImplementedError(
            "checkpoint_dir/checkpoint_every wait for io/checkpoint (ROADMAP Queue 1 "
            "item 12); the port does not take them yet")
