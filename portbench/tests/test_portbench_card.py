"""On the card, at each cell's own size, on three seeds: the program passes
the cell's limits while the precision control (the reference computed in
float8) fails them on the same requests or steps, and in the training cell
so does the reference with half of each batch left out. Each seed's
readings, the program's beside the control's and the fault's, are printed
as one JSON line: they are what the limits in `portbench/limits/` are set
from. Run on the card with

    python -m pytest -q -s -p no:cacheprovider -m cuda portbench/tests/test_portbench_card.py

(about 3 minutes a cell); skips without a card."""
import json
import os
import time

import pytest

from portbench.tests.tiny import ROOT

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def judged(checks: dict, readings: dict) -> dict:
    """The checks with the compared numbers replaced by `readings`."""
    return {k: (dict(c, value=readings[k]) if k in readings else c)
            for k, c in checks.items() if not k.startswith("_")}


@pytest.mark.cuda
@pytest.mark.parametrize("name", cells())
def test_control_fails_the_limit_at_cell_size(card, name):
    from portbench.harness import cell, check, traffic
    from portbench.run import applies, set_cache_dirs
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    workload = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[workload["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    mix = traffic.load_mix(ROOT, workload["traffic"])
    metrics = [m for m in bench["end_to_end"] if applies(m, name)]
    set_cache_dirs(ROOT)
    for seed in SEEDS:
        fields, checks = cell.run(ROOT, workload, metrics, config, mix, seed, 8.0, False, card,
                                  time.perf_counter(), control=True)
        if mix["loop"] == "train":   # the control and the half-batch fault each fail a number
            wrong = {key: checks[key] for key in ("_control", "_fault_half_batch")}
        else:
            wrong = {"_control": {"image_rel_l2_max": max(checks["_control_readings"])}}
        print(json.dumps({"cell": name, "seed": seed, "checks": checks,
                          "metrics": fields["metrics"], "peak": fields["peak"]}), flush=True)
        assert check.correct(checks), checks
        for key, readings in wrong.items():
            assert not check.correct(judged(checks, readings)), (key, readings)
