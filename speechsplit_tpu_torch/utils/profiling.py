"""Profiling and step timing (counterpart of
speechsplit_tpu/utils/profiling.py).

:func:`profile_trace` wraps a region in a ``torch.profiler`` trace that
TensorBoard's profiler plugin (or Perfetto) loads.

:class:`StepTimer` keeps an EMA of the interval between train-step
dispatches without a host synchronization; the solver's loss read at
each ``log_step`` is the loop's only sync, so over a logging window the
dispatch rate follows the card's rate.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the enclosed region with ``torch.profiler`` if ``log_dir`` is
    set (JAX profiling.py:23-33): CPU activity, and the card's where CUDA
    is present; the trace is written into ``log_dir`` as TensorBoard's
    ``*.pt.trace.json``. With no ``log_dir`` it only yields."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield


class StepTimer:
    """EMA step timer: call ``tick(k)`` once a dispatch of k train steps
    (JAX profiling.py:48); the average is of the time a step."""

    def __init__(self, ema: float = 0.98):
        self.ema = ema
        self.avg: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self, steps: int = 1) -> None:
        now = time.perf_counter()
        if self._last is not None:
            dt = (now - self._last) / max(steps, 1)
            self.avg = (
                dt if self.avg is None
                else self.ema * self.avg + (1 - self.ema) * dt
            )
        self._last = now

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / self.avg if self.avg else float("nan")
