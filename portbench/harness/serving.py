"""Serving cells: requests through the `submit` / `flush_async` of the
serving entry point the mix names (`portbench/entries/<entry>.py`; `experts`:
the `ServingQueue` of an `ExpertServer` on CUDA graphs, the path of
`cli/serve.py --mode experts`).

One driver serves every arrival law. Each request is one prompt: its MPNet
sentence embedding (the router's input, as `cli/serve.py` computes it),
then `submit` with its routing noise (which steers it to the expert the
traffic drew, the router's compute still running) and its initial latents.
Whenever no flush is in flight and requests are pending, every request due
so far goes into one `flush_async`. A request's latency runs from its due
time to its image on the host. The window's requests that are still in
flight when it closes are waited for, and their time counts.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.harness import named
from portbench.harness import traffic as T
from portbench.harness import weights as W

DRAIN_S = 60.0     # how long past the window's close an answer may still come


@dataclasses.dataclass
class Flush:
    index: int
    rids: List[int]
    start: float
    end: Optional[float] = None
    slots: int = 0


@dataclasses.dataclass
class Window:
    """What a window did: per request (by request id) its pool row, expert,
    due, submit span, flush and completion; per flush its requests, span and
    slots; the images by request id (on the host)."""
    seconds: float
    row: Dict[int, int] = dataclasses.field(default_factory=dict)
    expert: Dict[int, int] = dataclasses.field(default_factory=dict)
    due: Dict[int, float] = dataclasses.field(default_factory=dict)
    submit_s: Dict[int, float] = dataclasses.field(default_factory=dict)
    flush_of: Dict[int, int] = dataclasses.field(default_factory=dict)
    done: Dict[int, float] = dataclasses.field(default_factory=dict)
    images: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    flushes: List[Flush] = dataclasses.field(default_factory=list)
    routes: Dict[int, int] = dataclasses.field(default_factory=dict)
    elapsed: float = 0.0
    traced: Optional[tuple] = None   # (first flush, last flush, seconds) of the profiled slice

    @property
    def attempted(self) -> int:
        return len(self.due)

    def latencies(self) -> np.ndarray:
        """Seconds from due to image, inf for a request that never came."""
        return np.asarray([self.done[r] - self.due[r] if r in self.done else np.inf
                           for r in sorted(self.due)])


class Requests:
    """The pool of prompts, MPNet inputs and initial latents a run sends,
    made on the device at set-up, and the routing noise of each expert."""

    def __init__(self, mix, sched, seed, program, device):
        cfg = program.spec
        rows = T.pool_size(sched)
        self.clip_ids, self.mp_ids, self.mp_mask = T.prompts(mix, seed, rows, device)
        self.neg = T.negative_prompt(device)
        self.latents = T.initial_latents(seed, rows, cfg.sample_size, cfg.in_channels, device)
        rc = program.router
        self.noise = W.steering_noise(program.codes, torch.arange(program.codes.shape[0],
                                                                  device=device),
                                      program.layout.num_width, rc["depth_order"])
        self.rows = rows


class Driver:
    """Runs one window of a schedule through a serving queue, the mix's
    arrival law (`portbench/arrivals/<loop>.py`) deciding what is sent
    when."""

    def __init__(self, program, queue, requests: Requests, sched: T.Schedule, seconds: float,
                 trace=None):
        self.program, self.queue, self.req, self.sched = program, queue, requests, sched
        self.w = Window(seconds)
        self.trace = trace
        self.pending: List[int] = []
        self.law = named.load("arrivals", sched.loop).Sender(sched, seconds)

    # -- one request -----------------------------------------------------
    def submit(self, k: int, due: float, now) -> None:
        from diffusion_pruning_tpu_torch.models.text_encoders import mean_pool
        r = self.req
        row = k % r.rows
        e = int(self.sched.experts[k])
        with self._span("embed"):
            with torch.inference_mode():
                mask = r.mp_mask[row:row + 1]
                feats = mean_pool(self.program.mpnet(r.mp_ids[row:row + 1], mask), mask).float()
        t0 = now()
        with self._span("submit"):
            (rid,) = self.queue.submit(r.clip_ids[row:row + 1], r.neg,
                                       hyper_net_input=feats, route_noise=r.noise[e:e + 1],
                                       latents=r.latents[row:row + 1])
        w = self.w
        w.submit_s[rid] = now() - t0
        w.row[rid], w.expert[rid], w.due[rid] = row, e, due
        self.pending.append(rid)

    def _span(self, name):
        return self.trace.span(name) if self.trace is not None else contextlib.nullcontext()

    # -- the window ------------------------------------------------------
    def run(self) -> Window:
        w, seconds, law = self.w, self.w.seconds, self.law
        t_origin = time.perf_counter()

        def now():
            return time.perf_counter() - t_origin

        inflight = None   # (Flush, Future)
        done_at: Dict[int, float] = {}
        while True:
            t = now()
            for k, due in law.send(t):
                self.submit(k, due, now)
            if inflight is not None and inflight[1].done():
                self._collect(inflight, done_at, now)
                inflight = None
            if inflight is None and self.pending:
                inflight = self._start_flush(now, done_at)
                continue
            if inflight is None and law.finished(t):
                break
            if t > seconds + DRAIN_S:
                break
            wait = law.next_due(t) - t
            with self._span("wait"):
                if inflight is not None:
                    concurrent.futures.wait([inflight[1]], timeout=max(0.0, min(wait, 0.05)))
                elif wait > 0:
                    time.sleep(min(wait, 0.05))
        if inflight is not None and inflight[1].done():
            self._collect(inflight, done_at, now)
        w.elapsed = max(seconds, max(w.done.values(), default=0.0))
        if self.trace is not None:
            self.trace.finish(w, len(w.flushes) - 1, self.program.codes.device)
        return w

    def _start_flush(self, now, done_at):
        index = len(self.w.flushes)
        if self.trace is not None:
            self.trace.begin(index, now(), self.program.codes.device)
        f = Flush(index, self.pending, now())
        self.pending = []
        for rid in f.rids:
            self.w.flush_of[rid] = f.index
        with self._span("flush_async"):
            fut = self.queue.flush_async()
        fut.add_done_callback(lambda _f, i=f.index: done_at.__setitem__(i, now()))
        self.w.flushes.append(f)
        return f, fut

    def _collect(self, inflight, done_at, now) -> None:
        f, fut = inflight
        with self._span("collect"):
            try:
                images = fut.result()
            except Exception as e:  # its requests are never answered: `failed` counts them
                print(f"portbench: flush {f.index} raised {type(e).__name__}: {e}",
                      file=sys.stderr, flush=True)
                images = {}
        f.end = done_at.get(f.index, now())
        f.slots = int(self.queue.last_slots_used)
        for rid in f.rids:
            if rid in images:
                self.w.images[rid] = images[rid]
                self.w.done[rid] = f.end
                self.law.answered(f.end)


def plan_tiers(n: int, sizes: List[int]) -> List[tuple]:
    """(tier, real requests) of n requests of one expert: the largest tier
    while it fills, then the smallest tier that holds the rest (the
    server's tier plan)."""
    plan = []
    while n >= sizes[-1]:
        plan.append((sizes[-1], sizes[-1]))
        n -= sizes[-1]
    if n > 0:
        plan.append((next(s for s in sizes if s >= n), n))
    return plan


def flush_tiers(window: Window, flush: Flush, sizes: List[int]) -> List[tuple]:
    """(expert, tier, real requests) of every tier batch the flush ran."""
    per: Dict[int, int] = {}
    for rid in flush.rids:
        per[window.expert[rid]] = per.get(window.expert[rid], 0) + 1
    return [(e, t, r) for e, n in sorted(per.items()) for t, r in plan_tiers(n, sizes)]
