"""A whole serving run at a tiny configuration on the CPU: the reference
agrees with the program, and every fault the cell can have, planted in the
program's timed path, makes `correct` false. The run skips only the look for
a card (`run.py`); everything after it is the run's own code."""
import contextlib
import json
import os
import time

import pytest
import torch

from portbench.harness import cell, check
from portbench.harness import weights as W
from portbench.reference import sd as ref
from portbench.tests.tiny import ROOT, tiny_config, tiny_mix

WORKLOAD = {"name": "aptp256-experts-poisson"}


def bench_metrics(kind="end_to_end"):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    name = WORKLOAD["name"]
    return [m for m in b[kind] if name in m.get("workloads", [name])]


def run_once(loop="open", seed=2 ** 31 + 5, trace=False):
    fields, checks = cell.run(ROOT, WORKLOAD, bench_metrics("per_layer" if trace else "end_to_end"),
                              tiny_config(), tiny_mix(loop), seed, 1.5, trace,
                              torch.device("cpu"), time.perf_counter())
    return fields, checks


@pytest.mark.parametrize("loop", ["open", "closed"])
def test_reference_agrees_with_the_program(loop):
    fields, checks = run_once(loop)
    assert check.correct(checks), checks
    assert fields["attempted"] > 0 and fields["failed"] == 0
    # float32 at a tiny size: the two agree to rounding
    assert checks["image_rel_l2_max"]["value"] < 1e-4
    assert {m["name"] for m in bench_metrics()} <= set(fields["metrics"])


def test_traced_run_reads_its_spans_and_counters_on_the_cpu():
    """The traced run's plumbing (the profiler over the last flushes, the
    harness's spans, the readers) on the CPU, where no device operation is
    recorded: the metrics of spans and counters are read, the device's are
    left out, and `correct` is decided as in any run."""
    fields, checks = run_once("open", trace=True)
    assert check.correct(checks), checks
    device = {"attn_fwd_roofline.poisson", "device_idle_share.poisson",
              "decode_stream_share.poisson", "flush_idle_share.poisson"}
    want = {m["name"] for m in bench_metrics("per_layer")} - device
    assert want <= set(fields["metrics"]) and not device & set(fields["metrics"])
    assert fields["timeline"] is not None and fields["timeline"].offsets_ns == []
    assert fields["timeline"].spans   # the harness's spans of the slice
    assert 0 < fields["metrics"]["mfu.poisson"]["value"] < 100


def test_weights_match_leaf_for_leaf_at_full_size():
    """Every module the reference rebuilds has the program's state-dict
    names, shapes and kinds of leaf, so the seed gives both the same values."""
    from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from portbench.harness import family
    for name in ("aptp-sd21-256", "sd21-base-512"):
        with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
            config = json.load(f)
        te, vc = config["text_encoder"], config["vae"]
        with torch.device("meta"):
            pairs = [
                (GatedUNet(family.program(config).unet_config(config)),
                 ref.UNet(ref.unet_spec(config))),
                (CLIPTextEncoder(CLIPTextConfig(
                    vocab_size=te["vocab_size"], hidden_size=te["hidden_size"],
                    num_layers=te["num_hidden_layers"], num_heads=te["num_attention_heads"],
                    intermediate_size=te["intermediate_size"],
                    max_positions=te["max_position_embeddings"])), ref.CLIPText(te)),
                (AutoencoderKL(VAEConfig(block_out_channels=tuple(vc["block_out_channels"]))),
                 ref.VAE(vc))]
        for prog, mine in pairs:
            a = [(n, tuple(p.shape), k, f) for n, p, k, f in W.leaves(prog)]
            b = [(n, tuple(p.shape), k, f) for n, p, k, f in W.leaves(mine)]
            assert a == b


@contextlib.contextmanager
def patched(obj, name, make):
    saved = getattr(obj, name)
    setattr(obj, name, make(saved))
    try:
        yield
    finally:
        setattr(obj, name, saved)


def state_unchanged(orig):
    """The denoise returns the initial latents: the trajectory's steps leave
    the state as it was."""
    def denoise(self, generator, pe, ne, arch, steps=50, scale=7.5, height=None, width=None,
                latents=None):
        return latents.to(self.device, torch.float32)
    return denoise


def half_the_batch(orig):
    """A flush serves the first half of the requests pending (rounded up);
    the rest are dropped."""
    def take_pending(self):
        pending, embeds = orig(self)
        return pending[:(len(pending) + 1) // 2], embeds
    return take_pending


def altered_image(orig):
    """The VAE decode's images altered where they are produced."""
    def decode(self, latents):
        images = orig(self, latents)
        return torch.clamp(images * 0.9 + 0.05, 0.0, 1.0)
    return decode


def wrong_route(orig):
    """The router sends every prompt to the next expert."""
    def forward_eval(self, z, noise=None):
        arch, idx = orig(self, z, noise)
        return arch, (idx + 1) % self.n_e
    return forward_eval


def faults():
    from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
    from diffusion_pruning_tpu_torch.pipelines.expert_server import ServingQueue
    from diffusion_pruning_tpu_torch.pipelines.pruning_pipeline import PruningPipeline
    return {"state_unchanged": (PruningPipeline, "denoise", state_unchanged),
            "half_the_batch": (ServingQueue, "_take_pending", half_the_batch),
            "altered_image": (PruningPipeline, "decode", altered_image),
            "wrong_route": (StructureQuantizer, "forward_eval", wrong_route)}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "altered_image",
                                   "wrong_route"])
def test_planted_fault_makes_the_run_incorrect(fault):
    obj, name, make = faults()[fault]
    with patched(obj, name, make):   # closed loop: each flush carries all 4 clients' requests
        _, checks = run_once("closed")
    assert not check.correct(checks), checks


def test_precision_control_reads_far_above_the_sound_run():
    """The control (the reference in float8) on the same requests reads far
    above the program; at cell size, on the card, it has to fail the cell's
    limit (`test_control_fails_the_limit_at_cell_size`)."""
    fields, checks = cell.run(ROOT, WORKLOAD, bench_metrics(), tiny_config(), tiny_mix(), 7, 1.5,
                              False, torch.device("cpu"), time.perf_counter(), control=True)
    assert min(checks["_control_readings"]) > 100 * max(checks["_readings"])


def test_rate_sweep_serves_each_rate_on_one_set_up():
    from portbench import sweep
    rows = list(sweep.sweep(tiny_config(), tiny_mix("open"), 11, [2.0, 4.0], 1.0,
                            torch.device("cpu")))
    assert "setup_s" in rows[0] and [r["offered_per_s"] for r in rows[1:]] == [2.0, 4.0]
    for r in rows[1:]:
        assert r["missing"] == 0 and r["requests"] == round(r["offered_per_s"] * 1.0)
        assert r["completed_per_s"] > 0 and r["latency_p50_s"] > 0
