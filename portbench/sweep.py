"""Rate sweep of an open-loop serving cell: one set-up, then a window of
`--seconds` at each offered rate in turn, to find the knee (the highest rate
whose backlog does not grow over the window). The open cell's `rate_per_s`
is set at 0.8 × the knee; run the sweep again when a change moves the knee.

    python3 portbench/sweep.py --workload aptp256-experts-poisson --seed 7 \
        --rates 4,5,6,7,8 --seconds 30

One JSON line a rate: offered and completed rates, latency median and 95th
percentile, the median latency of the first and last quarter of the
requests by due time, the lag of the last image behind the last due time,
and the mean flush size. A backlog that grows shows as a completed rate
under the offered one and a lag of more than a flush or two; the quarter
medians of a short window swing more than they grow. Needs a CUDA card.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.run import ROOT, cuda_device, set_cache_dirs  # noqa: E402


def summary(window, rate: float) -> dict:
    import numpy as np
    lat = window.latencies()
    order = sorted(window.due, key=window.due.get)
    q = max(1, len(order) // 4)
    first = [window.done[r] - window.due[r] for r in order[:q] if r in window.done]
    last = [window.done[r] - window.due[r] for r in order[-q:] if r in window.done]
    sizes = [len(f.rids) for f in window.flushes]
    return {"offered_per_s": rate, "requests": window.attempted,
            "completed_per_s": len(window.done) / window.elapsed,
            "missing": window.attempted - len(window.done),
            "latency_p50_s": float(np.median(lat)), "latency_p95_s": float(np.percentile(lat, 95)),
            "first_quarter_p50_s": float(np.median(first)) if first else None,
            "last_quarter_p50_s": float(np.median(last)) if last else None,
            "last_image_lag_s": max(window.done.values(), default=0.0) - max(window.due.values()),
            "mean_flush_requests": float(np.mean(sizes)) if sizes else 0.0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    workload = {w["name"]: w for w in bench["workloads"]}[args.workload]
    set_cache_dirs(ROOT)
    device = cuda_device(workload["chips"])
    if device is None:
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    from portbench.harness import traffic
    conf = {c["name"]: c for c in bench["configs"]}[workload["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    mix = traffic.load_mix(ROOT, workload["traffic"])
    if mix["loop"] != "open":
        print("sweep: an open-loop mix is swept", file=sys.stderr)
        return 2
    for row in sweep(config, mix, args.seed, [float(r) for r in args.rates.split(",")],
                     args.seconds, device):
        print(json.dumps(row), flush=True)
    return 0


def sweep(config: dict, mix: dict, seed: int, rates, seconds: float, device):
    """One set-up, then a window at each rate: yields the set-up's seconds,
    then each rate's `summary`."""
    from portbench.harness import cell, named, serving, traffic
    t0 = time.perf_counter()
    entry = named.load("entries", mix["entry"])
    prog = entry.build(config, seed, device)
    yield {"setup_s": time.perf_counter() - t0}
    for rate in rates:
        m = {k: v for k, v in mix.items() if k != "rate_cycle"}
        m["rate_per_s"] = rate
        sched = traffic.schedule(m, seed, seconds, prog.codes.shape[0])
        requests = serving.Requests(m, sched, seed, prog, device)
        cell.warm_path(entry, prog, requests, config)
        window = serving.Driver(prog, entry.queue(prog, config), requests, sched,
                                seconds).run()
        yield summary(window, rate)


if __name__ == "__main__":
    sys.exit(main())
