"""Profiling helpers: a device trace and a step timer.

The port's copy of the JAX package's `utils/profiling.py`. `trace` is a
`torch.profiler` context in place of `jax.profiler`'s trace; `StepTimer`
keeps the warm-up exclusion and synchronises the CUDA device when a step
ends, so a reading holds the device's work and not the host's dispatch
alone.
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the block on the host and, where CUDA is available, on the
    device, and write a Chrome trace into `logdir` (TensorBoard's
    `torch.profiler` plugin reads it): `with trace('runs/profile') as prof:
    step(...)`. Yields the profiler, whose `key_averages()` hold the
    readings."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


class StepTimer:
    """Wall-clock step timing with the first `warmup` steps left out. Each
    step's time ends after `torch.cuda.synchronize()` when CUDA is in use,
    so it includes the device's work, not the host's dispatch alone."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times = []
        self._n = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)
