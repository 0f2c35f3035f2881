"""The seam between the harness and a model family (`harness/family.py`): the
harness reaches a U-Net's shape only through the family's three files, a
family added as new files is reached through them alone, and the counts
moved into `counts/sd.py` are the ones the benchmark has always used."""
import ast
import dataclasses
import hashlib
import json
import os
import shutil
import time
import types

import pytest
import torch

from portbench.harness import cell, check, family, named, training
from portbench.harness import weights as W
from portbench.harness.readings import served_flops
from portbench.harness.trace import Timeline
from portbench.tests.tiny import ROOT, tiny_config, tiny_mix, tiny_train_mix

PORTBENCH = os.path.join(ROOT, "portbench")

# What only a family's files may define or read: the walks over a U-Net and
# the spec's shape fields that they walk.
WALKERS = {"_levels", "unet_forward_flops", "attention_calls", "request_flops",
           "stage1_step_flops", "unet_spec", "gate_layout", "unet_config", "frozen_models"}
SHAPE = {"block_out_channels", "layers_per_block", "down_block_types", "up_block_types",
         "num_levels", "attention_head_dim", "transformer_layers_per_block"}
SD_MODULES = {"portbench.reference.sd", "portbench.reference.train"}


def harness_files():
    for folder in ("harness", "metrics", "entries"):
        for f in sorted(os.listdir(os.path.join(PORTBENCH, folder))):
            if f.endswith(".py"):
                yield os.path.join(PORTBENCH, folder, f)
    yield os.path.join(PORTBENCH, "run.py")


def test_the_harness_reaches_no_family_but_through_its_files():
    for path in harness_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert not {a.name for a in node.names} & SD_MODULES, path
            elif isinstance(node, ast.ImportFrom):
                names = {f"{node.module}.{a.name}" for a in node.names} | {node.module}
                assert not names & SD_MODULES, path
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                assert node.name not in WALKERS, (path, node.name)
            elif isinstance(node, ast.Attribute):
                assert node.attr not in SHAPE, (path, node.attr)
            elif isinstance(node, ast.Constant):
                assert node.value != "sd", path


# ------------------------------------------------------------ a spy family

SPY = '''"""The family `sd`'s {folder} file under the name `spy`, each call of
one of its functions recorded in CALLS."""
from portbench.harness import named

_sd = named.load({folder!r}, "sd")
CALLS = []


def _spy(name, fn):
    def call(*args, **kw):
        CALLS.append(name)
        return fn(*args, **kw)
    return call


def __getattr__(name):
    value = getattr(_sd, name)
    return _spy(name, value) if callable(value) and not isinstance(value, type) else value
'''
SPY_MODULES = '''
MODULES = tuple((tag, _spy("MODULES." + tag, ctor), key) for tag, ctor, key in _sd.MODULES)
'''


@pytest.fixture
def spy_family(tmp_path, monkeypatch):
    """The name loader pointed at a copy of portbench/ that also holds the
    family `spy`; returns the calls each of its three files recorded."""
    root = tmp_path / "portbench"
    shutil.copytree(PORTBENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    for folder in ("reference", "counts", "programs"):
        extra = SPY_MODULES if folder == "reference" else ""
        (root / folder / "spy.py").write_text(SPY.format(folder=folder) + extra)
    monkeypatch.setattr(named, "PORTBENCH", str(root))
    monkeypatch.setattr(named, "_loaded", {})
    return lambda folder: set(named.load(folder, "spy").CALLS)


def captured(monkeypatch, module, name):
    """Wraps `module.name` so that the arguments of each call are kept."""
    calls = []
    orig = getattr(module, name)

    def wrapper(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)
    monkeypatch.setattr(module, name, wrapper)
    return calls


CASES = {
    "serving": dict(
        workload="aptp256-experts-poisson", mix=tiny_mix("open"), seconds=1.5,
        checks=(check, "serving_checks"),
        readers=("mfu.poisson", "mfu.serve", "attn_fwd_roofline.poisson"),
        reference={"unet_spec", "gate_layout", "route", "serve", "float32_matmuls",
                   "MODULES.unet", "MODULES.text_encoder", "MODULES.vae"},
        counts={"attention_calls", "request_flops"}, programs={"frozen_models", "pipeline"}),
    "training": dict(
        workload="aptp256-stage1-b64", mix=tiny_train_mix(), seconds=1.0,
        checks=(training, "train_checks"),
        readers=("mfu.train", "attn_train_roofline.train"),
        reference={"unet_spec", "gate_layout", "float32_matmuls", "MODULES.unet",
                   "MODULES.text_encoder", "MODULES.vae"},
        counts={"attention_calls", "stage1_step_flops"}, programs={"frozen_models"}),
}


def per_layer(workload: str) -> list:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [m for m in json.load(f)["per_layer"] if workload in m.get("workloads", [])]


# A traced slice that holds an attention forward and backward, so that every
# reader of the counts finds something to count.
SLICE = Timeline(1.0, [("gated_flash_fwd_small", 0, 10 ** 6),
                       ("gated_flash_bwd_dq", 10 ** 6, 2 * 10 ** 6)], [])


def read(ctx, readers) -> dict:
    return {m: named.load("metrics", m).read(ctx) for m in readers}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_a_family_of_new_files_is_reached_through_them_alone(spy_family, monkeypatch, kind):
    """The tiny cell, traced, under the family `spy` (new files wrapping
    `sd`): the harness reaches spec, layout, reference modules, route and
    serve, every count and the program through the spy; its checks,
    recomputed under `sd` on the same window or steps, and its counts equal
    those of `sd`."""
    case = CASES[kind]
    config = dict(tiny_config(), family="spy")
    contexts = captured(monkeypatch, cell, "read_metrics")
    judged = captured(monkeypatch, *case["checks"])
    _, checks = cell.run(ROOT, {"name": case["workload"]}, per_layer(case["workload"]), config,
                         case["mix"], 2 ** 31 + 17, case["seconds"], True, torch.device("cpu"),
                         time.perf_counter())
    assert check.correct({k: v for k, v in checks.items() if not k.startswith("_")}), checks
    ctx = contexts[0][0][2]
    ctx.timeline = SLICE
    counted = read(ctx, case["readers"])
    calls = {folder: spy_family(folder) for folder in ("reference", "counts", "programs")}
    (args, kw), = judged

    monkeypatch.undo()   # the harness as it is: `sd` from the tree
    for folder, seen in calls.items():
        assert case[folder] <= seen, (folder, seen)
    sd_args = [dict(a, family="sd") if a is config else a for a in args]
    assert getattr(*case["checks"])(*sd_args, **kw) == checks
    assert None not in counted.values()
    assert read(dataclasses.replace(ctx, config=dict(config, family="sd")),
                case["readers"]) == counted


@pytest.fixture
def no_stage1_family(tmp_path, monkeypatch):
    root = tmp_path / "portbench"
    shutil.copytree(PORTBENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "reference" / "nostage1.py").write_text(
        "from portbench.harness import named\n\n"
        "_sd = named.load('reference', 'sd')\nSTAGE1 = None\n\n\n"
        "def __getattr__(name):\n    return getattr(_sd, name)\n")
    monkeypatch.setattr(named, "PORTBENCH", str(root))
    monkeypatch.setattr(named, "_loaded", {})


def test_a_family_without_a_stage1_reference_has_no_training_cell(no_stage1_family):
    config = dict(tiny_config(), family="nostage1")
    with pytest.raises(ValueError, match="no stage-1 reference"):
        cell.run(ROOT, {"name": "aptp256-stage1-b64"}, [], config, tiny_train_mix(), 5, 1.0,
                 False, torch.device("cpu"), time.perf_counter())


# ------------------------------------------------------------ pinned counts

# The counts of the parent of the change that moved them into counts/sd.py,
# on both published configurations: for the dense U-Net, then each of the 8
# seeded expert codes, at batch 2, (`unet_forward_flops`, number of
# `attention_calls`, the first 16 hex digits of the SHA-256 of their repr);
# `stage1_step_flops` at B = 64; and `readings.served_flops` of 13 requests
# in two flushes, request r routed to expert 5r mod 8.
PINNED = {
    "aptp-sd21-256": {
        "forward_and_calls": [
            (362180935680, 32, "c4d97d8a83d50088"), (238439788544, 32, "a896a121ab8ed47f"),
            (239249903616, 30, "1b05d9c329bd8c65"), (249984808960, 32, "be6044ab5fc34cd9"),
            (227341271040, 28, "8ec409c6de296bd6"), (248210157568, 32, "c6a21d9e27796072"),
            (233589708800, 30, "f025854b1b1e0a5e"), (250146949120, 32, "10f86eedc25b952a"),
            (225265401856, 30, "754b34d35a4fdadc")],
        "stage1_b64": 55658631921664,
        "served": 86954689124352.0},
    "sd21-base-512": {
        "forward_and_calls": [
            (1608514928640, 32, "b4ceb692e5e463d9"), (1041386467328, 32, "2a41a5a248eeca48"),
            (1093644595200, 30, "6f46be7cd1926823"), (1109511706624, 32, "b6a8f5198b5c29cd"),
            (1013337907200, 28, "14e216f3ee909a68"), (1108368977920, 32, "700040e59244209f"),
            (1048851519488, 30, "2df467328f962ac9"), (1104282019840, 32, "9da0b002e6d34b0b"),
            (985221308416, 30, "4faa5850b41b7265")],
        "stage1_b64": 236839063257088,
        "served": 378810666252288.0},
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_moved_counts_equal_the_parents_to_the_last_digit(name):
    with open(os.path.join(PORTBENCH, "configs", f"{name}.json")) as f:
        config = json.load(f)
    ref, counts = family.reference(config), family.counts(config)
    spec = ref.unet_spec(config)
    layout = ref.gate_layout(spec)
    codes = W.expert_codes(layout, 8, config["codebook"])
    got = []
    for code in [None] + list(codes):
        calls = counts.attention_calls(spec, layout, code, 2)
        got.append((counts.unet_forward_flops(spec, layout, code, 2), len(calls),
                    hashlib.sha256(repr(calls).encode()).hexdigest()[:16]))
    assert got == PINNED[name]["forward_and_calls"]
    assert counts.stage1_step_flops(config, spec, layout, 64) == PINNED[name]["stage1_b64"]
    ctx = types.SimpleNamespace(config=config, spec=spec, layout=layout, codes=codes,
                                window=types.SimpleNamespace(expert={r: 5 * r % 8
                                                                     for r in range(13)}),
                                steps=config["serving"]["num_inference_steps"])
    flushes = [types.SimpleNamespace(rids=list(range(5))),
               types.SimpleNamespace(rids=list(range(5, 13)))]
    assert served_flops(ctx, flushes) == PINNED[name]["served"]
