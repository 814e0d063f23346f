"""Tracing and timing hooks (torch counterpart of
nicediffusion_tpu/utils/profiling.py).

:func:`trace` wraps ``torch.profiler`` and writes a Chrome trace of the
enclosed block (viewable in Perfetto or ``chrome://tracing``), with the CUDA
activity when a card is present; :class:`StepTimer` is a rolling wall-clock
timer of train or sample steps.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "StepTimer"]


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True):
    """Profile the enclosed block and write ``<logdir>/trace_<pid>_<n>.json``
    (a Chrome trace). Yields the ``torch.profiler.profile`` object, whose
    ``key_averages()`` the caller may read after the block; ``enabled=False``
    yields None and writes nothing."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    n = sum(name.startswith(f"trace_{os.getpid()}_") for name in os.listdir(logdir))
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


class StepTimer:
    """Rolling wall-clock timing of train/sample steps."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._last: float | None = None

    def tick(self) -> float | None:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    @property
    def steps_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / sum(self._times)
