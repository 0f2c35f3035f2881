"""Profiling: the program's span recorder and a device trace.

`span(name, device=False, ids=None)` marks a stage of the program. While
recording is off (the default) it returns one shared no-op context: one
global check, no allocation, no clock read, no CUDA call; a caller builds
`ids` only where `recording()` says it is on. Between `start()` and
`stop()` each span is kept in memory as a `Span`: its name, the span that
caused it (the innermost span open on the same thread when it began), its
thread, its identifiers and its start and end on the host's Unix clock
(`time.time_ns`, the clock torch.profiler gives device timestamps in, so
program spans and device operations share one clock). `device=True` also
records a pair of CUDA events on the current stream, read by `stop()` and
never before, so a span synchronises nothing. `stop()` returns the spans;
there is no exporter.

`host_sync(device)` wraps a read of a device value on the host: where
`device` is not the CPU it counts one wait for the stream on the calling
thread (`host_syncs()`, counted whether or not a recording is on), and it
records a `host_sync` span while one is on.

The spans the port records:

- `pipelines/expert_server.py`, the submitting thread: `submit` →
  `encode_prompt`, `encode_negative`, `route`, `route_to_host`; under an
  SDXL pipeline (`pipelines/pruning_pipeline.py`) each encode that runs the
  towers → `clip_l`, `clip_bigg` (device).
- the same module, the flush's thread: `flush` (flush, rids) →
  `flush_lock`, `join`, for each expert `expert_pipe` and one `tier` per
  tier batch (expert or `gated`, tier, rows, layout) → {`latents`,
  `denoise` (device), `decode` (device)}, then `to_host`.
- `training/pruner.py`: `step` → `encode`, `router`, `teacher`, `student`,
  `losses`, `backward`, `optimizer`, at the step's `mark` boundaries;
  `host_sync` at the step's skip and clip tests and, in `core/resource.py`,
  at each of the resource model's tables copied to the device.

`count_tier(layout)` counts each served tier batch by the U-Net's layout
("nhwc" or "nchw"), whether or not a recording is on; `tiers_served()`
reads the counts.

`trace` is a `torch.profiler` context in place of `jax.profiler`'s trace.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch


@dataclasses.dataclass
class Span:
    """One recorded span. Times are host Unix-clock nanoseconds; `end_ns` is
    None while it is open. `device_ms`: the device time between its CUDA
    events (a `device=True` span on a card), filled in by `stop()`."""
    id: int
    name: str
    parent: Optional[int]      # the id of the span open on this thread when it began
    thread: int                # threading.get_ident() of the thread it ran on
    ids: dict
    start_ns: int
    end_ns: Optional[int] = None
    device_ms: Optional[float] = None


class _Recording:
    def __init__(self):
        self.spans: List[Span] = []
        self.timed: list = []        # (span, start event, end event)
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()


_recording: Optional[_Recording] = None
_numbers = itertools.count()
_local = threading.local()


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class _Open:
    def __init__(self, recording: _Recording, name: str, device: bool, ids: Optional[dict]):
        self.recording, self.name, self.device, self.ids = recording, name, device, ids
        self.events = None

    def __enter__(self):
        stack = _stack()
        span = Span(next(_numbers), self.name, stack[-1].id if stack else None,
                    threading.get_ident(), self.ids or {}, time.time_ns())
        rec = self.recording
        if self.device and rec.cuda and not torch.cuda.is_current_stream_capturing():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        rec.spans.append(span)
        stack.append(span)
        self.span = span
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
            self.recording.timed.append((self.span, *self.events))
        self.span.end_ns = time.time_ns()
        _stack().pop()
        return False


def span(name: str, device: bool = False, ids: Optional[dict] = None):
    """A context that records the block as a span, with its identifiers
    `ids`, while recording is on."""
    recording = _recording
    if recording is None:
        return _OFF
    return _Open(recording, name, device, ids)


def recording() -> bool:
    """Whether a recording is on: build a span's `ids` only then."""
    return _recording is not None


def host_sync(device: torch.device):
    """A context around a read of a device value on the host: counts one
    host sync of this thread where `device` is not the CPU, and records a
    `host_sync` span while recording is on."""
    if device.type != "cpu":
        _local.syncs = getattr(_local, "syncs", 0) + 1
    return span("host_sync")


def host_syncs() -> int:
    """The host syncs `host_sync` has counted on this thread."""
    return getattr(_local, "syncs", 0)


_tiers: Dict[str, int] = {}
_tiers_lock = threading.Lock()


def count_tier(layout: str) -> None:
    """Count one tier batch served by a U-Net of `layout` ("nhwc" or
    "nchw")."""
    with _tiers_lock:
        _tiers[layout] = _tiers.get(layout, 0) + 1


def tiers_served() -> Dict[str, int]:
    """{layout: tier batches} that `count_tier` has counted in this
    process."""
    with _tiers_lock:
        return dict(_tiers)


def start() -> None:
    """Start a recording; spans open from now on are kept."""
    global _recording
    _recording = _Recording()


def stop() -> List[Span]:
    """End the recording and return its spans in the order they began, each
    device span's CUDA events read. A span still open keeps `end_ns` None."""
    global _recording
    rec, _recording = _recording, None
    if rec is None:
        return []
    for span_, begin, end in rec.timed:
        end.synchronize()
        span_.device_ms = begin.elapsed_time(end)
    return rec.spans


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
