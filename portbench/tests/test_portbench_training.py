"""The stage-1 training cell at a tiny configuration on the CPU: the plain
reference follows the program's first steps, and every fault a training cell
can have, planted in the program's step, makes `correct` false."""
import contextlib
import time

import pytest
import torch

from portbench.harness import cell, check
from portbench.tests.tiny import ROOT, tiny_config, tiny_train_mix

WORKLOAD = {"name": "aptp256-stage1-b64"}


def run_once(control=False):
    return cell.run(ROOT, WORKLOAD, [], tiny_config(), tiny_train_mix(), 2 ** 31 + 9, 1.0, False,
                    torch.device("cpu"), time.perf_counter(), control=control)


def test_reference_follows_the_programs_first_steps():
    fields, checks = run_once()
    assert check.correct({k: v for k, v in checks.items() if not k.startswith("_")}), checks
    assert fields["attempted"] > 0 and fields["failed"] == 0
    # float32 at a tiny size: the two agree to rounding
    for k in ("loss_gap", "first_grad_norm_gap", "change_norm_gap"):
        assert checks[k]["value"] < 1e-4, checks


def test_resource_model_matches_the_programs():
    from diffusion_pruning_tpu_torch.core.resource import ResourceModel
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    from portbench.harness import family
    from portbench.reference import sd as ref
    from portbench.reference import train as rt
    import json
    import os
    for config in (tiny_config(),
                   json.load(open(os.path.join(ROOT, "portbench", "configs",
                                               "aptp-sd21-256.json")))):
        spec = ref.unet_spec(config)
        layout = ref.gate_layout(spec)
        with torch.device("meta"):
            port = GatedUNet(family.program(config).unet_config(config)).spec
        mine = rt.Resource(spec, layout, "cpu")
        theirs = ResourceModel(port)
        arch = torch.rand(5, layout.vq_dim, generator=torch.Generator().manual_seed(3))
        assert torch.allclose(mine.ratio(arch), theirs.resource_ratio(arch), rtol=1e-6)
        assert mine.keep_target(0.6) == pytest.approx(theirs.actual_pruning_target(0.6), rel=1e-9)


@contextlib.contextmanager
def patched(module, name, make):
    saved = getattr(module, name)
    setattr(module, name, make(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)


def state_unchanged(orig):
    """The optimizer's step does nothing: parameters and moments stay."""
    def make(*args, **kw):
        opt = orig(*args, **kw)
        opt.step = lambda closure=None: None
        return opt
    return make


def half_the_batch(orig):
    """The losses of the first half of the batch only, their mean taken."""
    def compute(mods, cfg, batch, draws, *args, **kw):
        b = batch["input_ids"].shape[0]
        half = {k: v[:b // 2] for k, v in batch.items()}
        hd = {k: (v if k == "codebook_gumbel" else v[:b // 2]) for k, v in draws.items()}
        return orig(mods, cfg, half, hd, *args, **kw)
    return compute


def altered_loss(orig):
    """The loss altered where it is produced."""
    def compute(*args, **kw):
        total, aux = orig(*args, **kw)
        return total * 1.05, dict(aux, loss=aux["loss"] * 1.05)
    return compute


@pytest.mark.parametrize("fault,name,make", [("state_unchanged", "make_optimizer", state_unchanged),
                                             ("half_the_batch", "compute_losses", half_the_batch),
                                             ("altered_loss", "compute_losses", altered_loss)])
def test_planted_fault_makes_the_run_incorrect(fault, name, make):
    from diffusion_pruning_tpu_torch.training import pruner
    with patched(pruner, name, make):
        _, checks = run_once()
    assert not check.correct({k: v for k, v in checks.items() if not k.startswith("_")}), checks


def test_precision_control_reads_far_above_the_sound_run():
    _, checks = run_once(control=True)
    sound = max(checks[k]["value"] for k in ("loss_gap", "first_grad_norm_gap"))
    assert max(checks["_control"]["loss_gap"], checks["_control"]["first_grad_norm_gap"]) \
        > 100 * sound
