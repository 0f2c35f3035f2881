"""One run of one serving cell: set-up, the measured window, the metrics the
cell reports, then the comparison that decides `correct`.

Metrics are found by name: `portbench/metrics/<name>.py` defines
`read(ctx) -> float | None` (None: nothing to read, the metric is left out
of the line). `ctx` is a `Context` or a `TrainContext`. A serving mix names
its entry point, `portbench/entries/<entry>.py`, and its arrival law,
`portbench/arrivals/<loop>.py`.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.harness import check, family, named, serving, traffic
from portbench.harness.trace import Tracer


@dataclasses.dataclass
class Context:
    config: dict
    mix: dict
    spec: object          # the family reference's `unet_spec`
    layout: object        # the family reference's `gate_layout`
    codes: torch.Tensor   # (K, vq_dim) hard codes, host
    window: serving.Window
    setup_s: float
    timeline: Optional[object] = None   # trace.Timeline of the traced run
    program: list = dataclasses.field(default_factory=list)   # the program's spans, host clock
    dispatch: Optional[tuple] = None    # (hits, misses) of the dispatch tables over the window

    @property
    def steps(self) -> int:
        return self.config["serving"]["num_inference_steps"]

    @property
    def tier_sizes(self) -> List[int]:
        b, s, out = self.config["serving"]["batch_size"], 1, []
        while s < b:
            out.append(s)
            s *= 2
        return out + [b]

    def traced_flushes(self) -> List[serving.Flush]:
        if self.window.traced is None:
            return []
        first, last, _ = self.window.traced
        return [f for f in self.window.flushes[first:last + 1] if f.end is not None]


def dispatch_counts(prog):
    """(hits, misses) summed over the server's dispatch tables, or None where
    the program does not count them."""
    tables = [d for c in getattr(prog.server, "_expert_caches", {}).values() for d in c.values()
              if hasattr(d, "programs")]
    if not tables or not hasattr(tables[0], "hits"):
        return None
    return sum(d.hits for d in tables), sum(d.misses for d in tables)


def log_coverage(program, roots) -> None:
    """Share of each root span's host time that its children cover."""
    kids: Dict[int, list] = {}
    for s in program:
        kids.setdefault(s.parent, []).append(s)
    for name in roots:
        shares = []
        for s in program:
            if s.name != name or s.end_ns is None or s.end_ns == s.start_ns:
                continue
            ivs = sorted((c.start_ns, c.end_ns) for c in kids.get(s.id, []) if c.end_ns)
            cov, hi = 0, s.start_ns
            for a, b in ivs:
                a = max(a, hi)
                if b > a:
                    cov += b - a
                    hi = b
            shares.append(cov / (s.end_ns - s.start_ns))
        if shares:
            shares.sort()
            log("coverage " + json.dumps({"root": name, "n": len(shares), "min": shares[0],
                                          "p10": shares[len(shares) // 10],
                                          "median": shares[len(shares) // 2]}))


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def read_metrics(root: str, entries: List[dict], ctx: Context) -> Dict[str, dict]:
    out = {}
    for m in entries:
        value = named.load("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def warm_path(entry, prog, requests, config) -> None:
    """One request through submit and flush on a queue of its own: the
    MPNet and CLIP calls at one prompt, the route, a tier-1 replay, the
    decode and the copy to the host, before the window."""
    from diffusion_pruning_tpu_torch.models.text_encoders import mean_pool
    q = entry.queue(prog, config)
    with torch.inference_mode():
        mask = requests.mp_mask[:1]
        feats = mean_pool(prog.mpnet(requests.mp_ids[:1], mask), mask).float()
    q.submit(requests.clip_ids[:1], requests.neg, hyper_net_input=feats,
             route_noise=requests.noise[:1], latents=requests.latents[:1])
    q.flush_async().result()


@dataclasses.dataclass
class TrainContext:
    config: dict
    mix: dict
    spec: object          # the family reference's `unet_spec`
    layout: object        # the family reference's `gate_layout`
    run: object           # training.Run
    setup_s: float
    timeline: Optional[object] = None
    program: list = dataclasses.field(default_factory=list)

    def traced_steps(self) -> list:
        if self.run.traced is None:
            return []
        first, last, _ = self.run.traced
        return self.run.steps[first:last + 1]


def aligned(timeline) -> str:
    offs = ", ".join(f"{o / 1e3:.1f}" for o in timeline.offsets_ns)
    return (f"{len(timeline.spans)} host spans; offsets of the {len(timeline.offsets_ns)} "
            f"markers kept: [{offs}] us")


def run(root: str, workload: dict, metrics: List[dict], config: dict, mix: dict, seed: int,
        seconds: float, trace: bool, device, t_process: float, control: bool = False):
    """Returns (result fields, checks); `control` adds the precision
    control's readings to the checks."""
    if mix["loop"] == "train":
        return run_training(root, workload, metrics, config, mix, seed, seconds, trace, device,
                            t_process, control)
    return run_serving(root, workload, metrics, config, mix, seed, seconds, trace, device,
                       t_process, control)


def run_training(root, workload, metrics, config, mix, seed, seconds, trace, device, t_process,
                 control):
    from portbench.harness import training
    log(f"set-up: imports {time.perf_counter() - t_process:.1f} s")
    tracer = Tracer(max(0.0, seconds - mix["trace"]["last_s"])) if trace else None
    r = training.run(config, mix, seed, seconds, device, tracer, log)
    setup_s = r.setup_end - t_process
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    timeline = tracer.reduce() if tracer is not None else None
    if timeline is not None:
        log(f"traced {len(r.steps) - r.traced[0]} steps in {timeline.window_s:.2f} s: "
            f"{len(timeline.ops)} device operations, busy {timeline.busy_s():.3f} s; "
            f"{aligned(timeline)}")
    ref = family.reference(config)
    spec = ref.unet_spec(config)
    ctx = TrainContext(config, mix, spec, ref.gate_layout(spec), r, setup_s, timeline,
                       r.program)
    log_coverage(ctx.program, ("step",))
    values = read_metrics(root, metrics, ctx)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    checks = training.train_checks(r, config, seed, device,
                                   check.load_limits(root, workload["name"]), control, mix)
    log(f"window {r.elapsed:.1f} s, {len(r.steps)} steps; reference of {len(r.losses)} steps "
        f"{time.perf_counter() - t2:.1f} s")
    return {"attempted": len(r.steps), "failed": r.skipped, "metrics": values, "peak": peak,
            "timeline": timeline}, checks


def run_serving(root, workload, metrics, config, mix, seed, seconds, trace, device, t_process,
                control):
    t0 = time.perf_counter()
    entry = named.load("entries", mix["entry"])
    prog = entry.build(config, seed, device)
    t1 = time.perf_counter()
    sched = traffic.schedule(mix, seed, seconds, prog.codes.shape[0])
    requests = serving.Requests(mix, sched, seed, prog, device)
    warm_path(entry, prog, requests, config)
    log(f"set-up: imports {t0 - t_process:.1f} s, models, experts and graphs {t1 - t0:.1f} s "
        f"({prog.warmup}), inputs and the warm-up request {time.perf_counter() - t1:.1f} s")
    tracer = None
    if trace:
        tracer = Tracer(max(0.0, seconds - mix["trace"]["last_s"]))
        tracer.warm(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_process

    queue = entry.queue(prog, config)
    d0 = dispatch_counts(prog)
    window = serving.Driver(prog, queue, requests, sched, seconds, tracer).run()
    d1 = dispatch_counts(prog)
    window.routes = dict(queue.routes)
    lat = window.latencies()
    if len(lat):
        done = lat[np.isfinite(lat)]
        lat = np.where(np.isfinite(lat), lat, seconds + serving.DRAIN_S)
        log(f"latency over {len(lat)} requests ({len(lat) - len(done)} never answered): "
            f"p50 {np.median(lat):.4f} s, mean {done.mean() if len(done) else np.inf:.4f} s, "
            f"p90 {np.percentile(lat, 90):.4f} s, p95 {np.percentile(lat, 95):.4f} s")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    timeline = tracer.reduce() if tracer is not None else None

    ctx = Context(config, mix, prog.spec, prog.layout, prog.codes.cpu(), window, setup_s,
                  timeline, tracer.program if tracer is not None else [],
                  None if d0 is None else (d1[0] - d0[0], d1[1] - d0[1]))
    log_coverage(ctx.program, ("submit", "flush"))
    values = read_metrics(root, metrics, ctx)
    if timeline is not None:
        flushes = ctx.traced_flushes()
        counts = family.counts(config)
        want = sum(ctx.steps * len(counts.attention_calls(ctx.spec, ctx.layout, ctx.codes[e],
                                                          2 * tier))
                   for f in flushes for e, tier, _ in serving.flush_tiers(window, f,
                                                                          ctx.tier_sizes))
        log(f"traced {len(flushes)} flushes in {timeline.window_s:.2f} s: {len(timeline.ops)} "
            f"device operations, busy {timeline.busy_s():.3f} s, attention forwards "
            f"{timeline.count(('gated_flash_fwd',))} of {want} planned; {aligned(timeline)}")

    inputs = {"clip_ids": requests.clip_ids.cpu(), "neg": requests.neg.cpu(),
              "latents": requests.latents.cpu(), "codes": prog.codes.cpu(),
              "noise": requests.noise.cpu()}
    del prog, queue, requests, tracer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sample = traffic.reference_rows(list(window.images), window.expert,
                                    int(mix["reference_sample"]), seed)
    t2 = time.perf_counter()
    checks = check.serving_checks(window, config, seed, device, sample, inputs,
                                  check.load_limits(root, workload["name"]), control)
    log(f"window {window.elapsed:.1f} s, {len(window.flushes)} flushes; reference on "
        f"{len(sample)} requests {time.perf_counter() - t2:.1f} s")
    fields = {"attempted": window.attempted, "failed": window.attempted - len(window.done),
              "metrics": values, "peak": peak, "timeline": timeline}
    return fields, checks
