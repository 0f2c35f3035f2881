"""The recorder's cost on the card: the port's span recorder
(`utils/profiling.py`) off and on over the benchmark's open serving cell
and its stage-1 cell, with the profiler off in both.

    python3 scripts/torch_port/span_probe.py cost serve --seeds 1,2,3 --seconds 50
    python3 scripts/torch_port/span_probe.py cost train --windows 8 --seconds 25

One set-up, then windows with the recorder off and on in turns, one JSON
line a window: the open cell's img/s and submit and flush medians, or
stage 1's samples/s.

The benchmark does not read the spans yet. `span_harness.patch`, beside
this file, holds the edits to `portbench/` and `BENCHMARK.json` that do:
the recorder on for the whole traced window, the spans on the device's
clock, `breakdown.program_idle_gaps`, nine per-layer readers and their
tests. To run them, from the root of the checkout:

    rm -rf build/span_probe && mkdir -p build/span_probe
    cp -r portbench BENCHMARK.json build/span_probe/
    git apply --directory=build/span_probe scripts/torch_port/span_harness.patch
    PYTHONPATH=$PWD python3 build/span_probe/portbench/run.py \
        --workload aptp256-experts-poisson --seed 7 --seconds 50 --trace 1
"""
import argparse
import json
import os
import statistics
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def emit(d: dict) -> None:
    print(json.dumps(d), flush=True)


def config_of(name):
    with open(os.path.join(REPO, "portbench/configs", name + ".json")) as f:
        return json.load(f)


def serve(seeds, seconds):
    from diffusion_pruning_tpu_torch.utils import profiling
    from portbench.harness import cell, named, serving, traffic
    device = torch.device("cuda", 0)
    config = config_of("aptp-sd21-256")
    mix = traffic.load_mix(REPO, "experts-poisson")
    t0 = time.perf_counter()
    entry = named.load("entries", mix["entry"])
    prog = entry.build(config, seeds[0], device)
    emit({"cell": "poisson", "setup_s": time.perf_counter() - t0})
    for i, seed in enumerate(seeds):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            sched = traffic.schedule(mix, seed, seconds, prog.codes.shape[0])
            requests = serving.Requests(mix, sched, seed, prog, device)
            cell.warm_path(entry, prog, requests, config)
            torch.cuda.synchronize()
            if on:
                profiling.start()
            w = serving.Driver(prog, entry.queue(prog, config), requests, sched, seconds).run()
            spans = profiling.stop()
            flush = [f.end - f.start for f in w.flushes if f.end is not None]
            emit({"cell": "poisson", "seed": seed, "recorder": on, "spans": len(spans),
                  "img_per_s": len(w.done) / w.elapsed, "requests": w.attempted,
                  "missing": w.attempted - len(w.done),
                  "submit_ms_p50": 1e3 * statistics.median(w.submit_s.values()),
                  "flush_ms_p50": 1e3 * statistics.median(flush), "flushes": len(flush)})


def train(windows, seconds):
    from diffusion_pruning_tpu_torch.utils import profiling
    from portbench.harness import training, traffic
    device = torch.device("cuda", 0)
    config = config_of("aptp-sd21-256")
    mix = traffic.load_mix(REPO, "stage1-b64")
    t0 = time.perf_counter()
    tr = training.Trainer(config, mix, 2147489011, device)
    for _ in range(3):
        tr.step()
    emit({"cell": "stage1", "setup_s": time.perf_counter() - t0})
    for i in range(windows):
        on = i % 4 in (1, 2)      # off, on, on, off, ...
        if on:
            profiling.start()
        t = time.perf_counter()
        steps = 0
        while time.perf_counter() - t < seconds:
            tr.step()
            steps += 1
        elapsed = time.perf_counter() - t
        spans = profiling.stop()
        emit({"cell": "stage1", "window": i, "recorder": on, "spans": len(spans),
              "steps": steps, "train_samples_per_s": steps * tr.config["training"]
              ["train_batch_size"] / elapsed})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="what", required=True)
    c = sub.add_parser("cost")
    c.add_argument("cell", choices=("serve", "train"))
    c.add_argument("--seeds", default="2147489001,2147489002,2147489003")
    c.add_argument("--windows", type=int, default=8)
    c.add_argument("--seconds", type=float, default=50.0)
    a = p.parse_args(argv)
    sys.path.insert(0, REPO)
    from portbench.run import set_cache_dirs
    set_cache_dirs(REPO)
    if a.cell == "serve":
        serve([int(s) for s in a.seeds.split(",")], a.seconds)
    else:
        train(a.windows, a.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
