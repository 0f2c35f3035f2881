"""BENCHMARK.json against the benchmark's contract, and the run's refusals:
no card, no JAX."""
import json
import os
import re
import shutil
import subprocess
import sys

from portbench.run import forbidden_modules
from portbench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_units_and_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and all(PATH.match(p) for p in b["paths"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "portbench", "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(ROOT, "portbench", "limits", f"{w['name']}.json"))
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                 "higher")
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", f"{m['name']}.py"))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in b["workloads"]:   # setup_s, another end-to-end metric and a per-layer one each
        mine = [m["name"] for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in b["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layer and all(m["moves"] in mine for m in layer)


def test_every_configuration_names_a_family_whose_three_files_exist():
    for c in bench()["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            name = json.load(f)["family"]
        assert NAME.match(name), c["name"]
        for folder in ("reference", "counts", "programs"):
            assert os.path.exists(os.path.join(ROOT, "portbench", folder, f"{name}.py")), \
                (c["name"], folder)


def test_forbidden_modules_compare_whole_top_level_names():
    assert forbidden_modules(["diffusion_pruning_tpu_torch", "diffusion_pruning_tpu_torch.ops",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "diffusion_pruning_tpu.models", "flax", "jaxlib"]) \
        == ["diffusion_pruning_tpu", "flax", "jax", "jaxlib"]


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|diffusion_pruning_tpu)(\s|\.|$)",
                         re.M)
    for d, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    assert not pattern.search(fh.read()), os.path.join(d, f)


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "aptp256-experts-poisson", "--seed", "3000000000", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=env)


def test_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(ROOT, env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_fails_in_a_folder_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
