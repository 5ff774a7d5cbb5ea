"""Observability: logging, the run gate, MLUPS metering, the NaN watchdog.

Counterpart of lbm_tpu/utils/observe.py.  ``StepMeter`` times with CUDA
events when the run is on the card (the host clock would time the enqueue,
not the work) and with the host clock on the CPU.
"""

from __future__ import annotations

import logging
import sys
import time

import torch

logger = logging.getLogger("lbm_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[%(asctime)s lbm_tpu_torch] %(message)s",
                                      datefmt="%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def confirm(auto_yes: bool = True, prompt: str = "Do you want to continue (y/n)? ") -> bool:
    """The reference's interactive gate (src/utils.cpp:7-19) behind a flag;
    defaults to proceeding so batch runs never hang."""
    if auto_yes or not sys.stdin.isatty():
        return True
    while True:
        choice = input(prompt).strip().lower()
        if choice in ("y", "yes"):
            return True
        if choice in ("n", "no"):
            return False
        print("Invalid input. Please enter 'y' or 'n'.")


class StepMeter:
    """Steps and MLUPS across a chunked run on ``device``."""

    def __init__(self, cells: int, device, total_steps: int | None = None,
                 log_every_s: float = 10.0):
        self.cells = cells
        self.total = total_steps
        self.log_every_s = log_every_s
        self.steps = 0
        self._cuda = torch.device(device).type == "cuda"
        if self._cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()
        self._last_log = time.perf_counter()

    def seconds(self) -> float:
        """Time since the meter started; on the card, device time up to the
        work enqueued so far (waits for it)."""
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return self._start.elapsed_time(end) / 1e3
        return time.perf_counter() - self._start

    def update(self, n_steps: int) -> None:
        self.steps += n_steps
        now = time.perf_counter()
        if now - self._last_log >= self.log_every_s:
            self._last_log = now
            logger.info(self.summary())

    def mlups(self) -> float:
        return self.cells * self.steps / max(self.seconds(), 1e-9) / 1e6

    def summary(self) -> str:
        frac = f"/{self.total}" if self.total else ""
        return (f"step {self.steps}{frac}  {self.mlups():.6g} MLUPS  "
                f"{self.seconds():.3f}s elapsed")


def check_finite(f: torch.Tensor, step_count: int) -> None:
    """Raise the moment a chunk produced non-finite populations, naming the
    step count (one reduction and one host sync per call)."""
    if not bool(torch.isfinite(f).all()):
        raise FloatingPointError(
            f"non-finite fields after step {step_count}: the run left the "
            "lattice stability envelope (see the scene docstring); use a "
            "smaller force/velocity or float64 (--x64).")
