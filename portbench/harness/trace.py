"""The traced run's device timeline: torch.profiler (CUPTI) over whole
flushes or steps, recording the device alone.

`Tracer` starts the profiler just before the first unit of work (a flush,
a train step) that starts in the last `last_s` seconds of the window and
stops it when the run's last unit has completed, so the profiled slice
holds whole units, and stopping the profiler (which takes seconds) delays
no request. The profiler records no host activity: with the host's
operations recorded, the eager host code between device work runs several
times slower (an eager training step's idle share read 43.0 % against
9.2 %). The harness's own spans (`Tracer.span`: embed, submit, wait, a
flush's call, collect; a step's draws, call and synchronise) are taken on
the host's Unix clock (`time.time_ns`), the clock the profiler gives its
device timestamps in; two marker kernels (`torch.cuda._sleep`) launched
after a synchronise, at the slice's start and end, measure the offset
between the two where the profiler keeps them (in a large slice it can
lose its first events, a marker among them). `Timeline` reduces the slice to what the per-layer readers take: each
device operation with its interval, the busy time as the union of those
intervals, and the spans, which name the idle gaps.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(e, f"{what}_us")() * 1000)


MARKER = "spin_kernel"   # the kernel of torch.cuda._sleep


@dataclasses.dataclass
class Timeline:
    window_s: float                            # the profiled slice, host clock
    ops: List[Tuple[str, int, int]]            # device operations (name, start ns, end ns)
    spans: List[Tuple[str, int, int]]          # the harness's host spans, device clock
    offsets_ns: List[int] = dataclasses.field(default_factory=list)   # of the markers kept

    @classmethod
    def from_profile(cls, prof, window_s: float, spans=(), marks=()) -> "Timeline":
        """`spans` (name, start, end) and `marks` (the markers' launch
        times) in host Unix-clock nanoseconds."""
        ops, markers = [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            name = e.name()
            start = _ns(e, "start")
            if MARKER in name:
                markers.append(start)
            else:
                ops.append((name, start, start + _ns(e, "duration")))
        ops.sort(key=lambda o: o[1])
        return cls(window_s, ops, *align(sorted(markers), list(marks), list(spans)))

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, s, e in self.ops:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_seconds(self, names) -> float:
        """Device seconds of the operations whose name contains one of
        `names`."""
        return sum(e - s for n, s, e in self.ops if any(k in n for k in names)) / 1e9

    def count(self, names) -> int:
        return sum(1 for n, _, _ in self.ops if any(k in n for k in names))

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s) / 1e9
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle device time between operations, summed by the harness's
        host span that covers each gap's midpoint ("no span" where the
        main thread was in none)."""
        busy = self.busy_intervals()
        by: Dict[str, float] = {}
        spans = sorted(self.spans, key=lambda s: s[1])   # the main thread's: none overlap
        starts = [s for _, s, _ in spans]
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = (a + b) // 2
            name = "no span"
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and spans[i][2] >= mid:
                name = spans[i][0]
            by[name] = by.get(name, 0.0) + (b - a) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

def align(markers: List[int], marks: List[int], spans: List[tuple]):
    """(spans on the device clock, the offsets the markers measured). Each
    marker kept is paired with the launch whose offset is smallest: the
    launches are seconds apart, a marker starts microseconds after its
    own. Without a marker kept the offset is taken as 0: the profiler's
    timestamps are on the host's Unix clock."""
    offsets = [min((m - h for h in marks), key=abs) for m in markers] if marks else []
    off = offsets[0] if offsets else 0
    return [(name, a + off, b + off) for name, a, b in spans], offsets


class Tracer:
    """The traced run's profiler and the harness's spans."""

    def __init__(self, start_s: float):
        self.start_s = start_s
        self.prof = None
        self.active = False
        self.first: Optional[int] = None
        self.t0 = 0.0
        self.spans: List[tuple] = []
        self.marks: List[int] = []
        self._raw = None        # (profile, slice seconds) until `reduce` reads it
        self.timeline: Optional[Timeline] = None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile
        cuda = torch.cuda.is_available()
        return profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])

    def warm(self, device) -> None:
        """Initialise the profiler once at set-up, so that the window's
        start does not pay for it."""
        prof = self._profile()
        prof.start()
        torch.ones(1, device=device).add_(1)
        self._mark(device)
        prof.stop()

    def _mark(self, device) -> None:
        if device.type != "cuda":
            return
        torch.cuda.synchronize(device)
        self.marks.append(time.time_ns())
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(device)

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span of the harness, kept while the slice is profiled."""
        if not self.active:
            yield
            return
        a = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, a, time.time_ns()))

    def begin(self, index: int, t: float, device) -> None:
        """Before unit `index` (a flush, a step) starts at `t` seconds into
        the window: start profiling at the first unit at or after
        `start_s`."""
        if self.prof is None and t >= self.start_s:
            self.prof = self._profile()
            self.prof.start()
            self.marks = []
            self._mark(device)
            self.first, self.t0, self.active = index, time.perf_counter(), True

    def finish(self, holder, last: int, device) -> None:
        """After the run's last unit, `last`, has completed: stop, and note
        (first unit, last unit, seconds) of the slice in `holder.traced`."""
        if not self.active:
            return
        window_s = time.perf_counter() - self.t0
        self._mark(device)
        self.active = False
        self.prof.stop()
        holder.traced = (self.first, last, window_s)
        self._raw = (self.prof, window_s)

    def reduce(self) -> Optional[Timeline]:
        """The slice's timeline, read after the window has closed."""
        if self.timeline is None and self._raw is not None:
            prof, window_s = self._raw
            self.timeline = Timeline.from_profile(prof, window_s, self.spans, self.marks)
            self._raw = None
        return self.timeline
