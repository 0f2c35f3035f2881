"""The benchmark of the PyTorch/CUDA port (`diffusion_pruning_tpu_torch`).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One fresh process a run: it builds the cell's models from the seed on the
card, warms up every shape the cell's traffic uses (set-up), serves the
cell's traffic or takes its train steps for `--seconds`, then compares what
the window served, or the first steps, with the plain reference, and prints
one JSON line last on standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` `breakdown`,
and `checks`, each number compared beside its limit (also the last lines of
standard error).

Cells, configurations, traffic mixes and metrics are found by name from
`BENCHMARK.json` (see `portbench/README.md`). Without a CUDA card, or with
fewer cards than the cell asks for, the run fails and prints no result. It
also fails if JAX, Flax or the JAX package `diffusion_pruning_tpu` was
loaded into the process.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "diffusion_pruning_tpu")


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: `diffusion_pruning_tpu_torch` is not
    `diffusion_pruning_tpu`."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int = 2) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def set_cache_dirs(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths. The
    port's nvcc libraries are cached by source hash in build/torch_kernels/
    of the checkout (`ops/build.py`)."""
    base = os.path.join(root, "build", "portbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def cuda_device(chips: int):
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return None
    return torch.device("cuda", 0)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
    except OSError as e:
        return fail(f"no BENCHMARK.json: {e}")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        return fail(f"no workload {args.workload!r} in BENCHMARK.json")
    workload = cells[args.workload]
    metrics = [m for m in bench["per_layer" if args.trace else "end_to_end"]
               if applies(m, workload["name"])]
    set_cache_dirs(ROOT)
    device = cuda_device(workload["chips"])
    if device is None:
        return fail(f"{workload['chips']} CUDA card(s) needed; the benchmark never runs on the "
                    "CPU")
    sys.path.insert(0, ROOT)
    import torch
    from portbench.harness import cell, check, traffic
    conf = {c["name"]: c for c in bench["configs"]}[workload["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    mix = traffic.load_mix(ROOT, workload["traffic"])
    fields, checks = cell.run(ROOT, workload, metrics, config, mix, args.seed, args.seconds,
                              bool(args.trace), device, T_PROCESS)
    found = forbidden_modules(sys.modules)
    if found:
        return fail(f"the process loaded {', '.join(found)}: the port must not", 3)
    detail = {k[1:]: checks.pop(k) for k in list(checks) if k.startswith("_")}
    if detail:
        print(f"portbench: detail {json.dumps(detail)}", file=sys.stderr)
    result = {"correct": check.correct(checks), "attempted": fields["attempted"],
              "failed": fields["failed"], "metrics": fields["metrics"],
              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                         "count": workload["chips"], "memory_peak_bytes": fields["peak"]}}
    timeline = fields["timeline"]
    if args.trace and timeline is not None:
        result["device"]["busy_s"] = timeline.busy_s()
        result["device"]["window_s"] = timeline.window_s
        result["breakdown"] = {"device_ops": timeline.top_ops(10),
                               "idle_gaps": timeline.idle_gaps(10)}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
