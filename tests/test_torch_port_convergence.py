"""The port's convergence run (`cli/convergence_run.py`) on the CPU.

Its synthetic pool and window means equal the JAX script's on the same
arguments (the script loaded as a module, unchanged); a `--tiny` run of a few
steps writes the JAX script's files and summary keys and exits 1 when a
criterion fails. The port's counterpart of tests/test_convergence_tiny.py
(250 tiny steps, marked slow as that one is) holds the mechanism: the
resource ratio closes on its target, every code stays in use, and the
contrastive loss falls."""
import argparse
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from diffusion_pruning_tpu_torch.cli import convergence_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "scripts", "other", "convergence_run.py")


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location("jax_convergence_run", JAX_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("seed, pool, clusters, mp_dim, vocab, latent",
                         [(0, 64, 16, 24, 128, 8), (3, 100, 5, 768, 49408, 32)])
def test_synth_pool_and_window_mean_equal_the_jax_scripts(jax_script, seed, pool, clusters,
                                                          mp_dim, vocab, latent):
    args = argparse.Namespace(seed=seed, pool=pool, clusters=clusters)
    got = convergence_run.synth_pool(args, mp_dim, vocab, latent)
    want = jax_script.synth_pool(args, mp_dim, vocab, latent)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    rng = np.random.RandomState(seed)
    rows = [{"step": i, "loss": float(rng.rand())} | ({"x": float(i)} if i % 3 else {})
            for i in range(40)]
    for key, lo, hi in (("loss", 0, 20), ("x", 5, 41), ("loss", 50, 60), ("y", 0, 40)):
        a, b = convergence_run.window_mean(rows, key, lo, hi), jax_script.window_mean(rows, key,
                                                                                   lo, hi)
        assert a == b or (np.isnan(a) and np.isnan(b)), (key, lo, hi)


def test_tiny_run_writes_the_jax_files_and_summary_keys(tmp_path):
    """A few tiny steps on the CPU: metrics.jsonl (logged every 10 steps),
    heatmaps/, the checkpoint with its hypernet/ and quantizer/ exports, the
    fine-tuned expert's metrics and CONVERGENCE_SUMMARY.json with the JAX
    script's keys and criteria; the exit code is 1 when a criterion fails."""
    run_dir = tmp_path / "conv"
    rc = convergence_run.main(["--tiny", "--device", "cpu", "--run_dir", str(run_dir),
                               "--steps", "10", "--pretrain_steps", "4", "--ft_steps", "2",
                               "--pool", "32", "--batch", "2", "--ft_batch", "2",
                               "--ft_experts", "1"])
    with open(run_dir / "CONVERGENCE_SUMMARY.json") as f:
        summary = json.load(f)
    with open(JAX_SCRIPT) as f:
        jax_text = f.read()
    assert set(summary["checks"]) == set(re.findall(r'checks\["(C\d_[a-z_0-9]+)"\]', jax_text))
    assert set(summary) == {"steps", "pretrain_steps", "p_actual", "wall_clock_s",
                            "samples_per_sec", "pool_assignment", "checks", "all_pass"}
    assert rc == (0 if summary["all_pass"] else 1)
    assert sum(summary["pool_assignment"]) == 32
    rows = [json.loads(line) for line in open(run_dir / "metrics.jsonl")]
    train = [r for r in rows if "loss" in r]
    assert [r["step"] for r in train] == [10]
    assert all(np.isfinite(r["loss"]) for r in train)
    assert {f"expert_usage/{e}" for e in range(8)} <= set(train[0])
    assert any(f.startswith("codebook_sim_") for f in os.listdir(run_dir / "heatmaps"))
    ckpt = run_dir / "checkpoint-10"
    for name in ("quantizer_embeddings.pt", "state", "hypernet", "quantizer"):
        assert (ckpt / name).exists(), name
    (expert,) = [k for k in summary["checks"]["C5_expert_finetune_distill_decreases"]
                 if k != "pass"]
    assert (run_dir / f"ft_expert{expert}_metrics.jsonl").exists()


STEPS = 250
BATCH = 8
N_E = 4
CLUSTERS = 8
MP_DIM = 24


@pytest.mark.slow
def test_resource_ratio_converges_to_target():
    """tests/test_convergence_tiny.py on the port: 250 tiny steps with
    planted redundancy, the teacher's prediction as the target and the JAX
    test's compressed router learning rates."""
    from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
    from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
    from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from diffusion_pruning_tpu_torch.schedulers import DiffusionSchedule
    from diffusion_pruning_tpu_torch.training import (PrunerConfig, PrunerModules,
                                                      make_optimizer, make_pruner_step)
    from diffusion_pruning_tpu_torch.utils.init_utils import random_init_
    from diffusion_pruning_tpu_torch.utils.synthetic import plant_redundancy

    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(0)
    tcfg = CLIPTextConfig.tiny()
    unet = GatedUNet(UNetConfig.tiny(cross_attention_dim=32))
    spec = unet.spec
    text = CLIPTextEncoder(tcfg)
    hypernet = HyperStructure(spec, input_dim=MP_DIM)
    quantizer = StructureQuantizer(spec, n_e=N_E, base=3.0)
    for module in (unet, text, hypernet):
        random_init_(module, gen)
    quantizer.init_params(gen)
    quantizer.init_state()
    damped, _ = plant_redundancy(spec, unet.state_dict(), keep=0.5, seed=5)
    unet.load_state_dict(damped)
    with torch.device("meta"):
        vae = AutoencoderKL(VAEConfig.tiny())
    mods = PrunerModules(unet=unet.eval(), vae=vae, text_encoder=text.eval(), hypernet=hypernet,
                         quantizer=quantizer, schedule=DiffusionSchedule())
    cfg = PrunerConfig(pruning_target=0.6, lr_warmup_steps=10, scale_lr=False,
                       self_distill_target=True, hypernet_lr=1e-3, quantizer_lr=4e-2)
    p_actual = mods.resource_model.actual_pruning_target(0.6)
    step = make_pruner_step(mods, cfg, make_optimizer(cfg, mods, global_batch=BATCH))

    host = np.random.RandomState(1)
    centers = host.randn(CLUSTERS, MP_DIM).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    s = unet.cfg.sample_size
    ratios, usages, contrast = [], [], []
    for i in range(STEPS):
        cl = host.randint(0, CLUSTERS, BATCH)
        batch = {
            "latent_mean": torch.from_numpy(host.randn(BATCH, s, s, 4).astype(np.float32)),
            "latent_logvar": torch.full((BATCH, s, s, 4), -6.0),
            "input_ids": torch.from_numpy(host.randint(0, tcfg.vocab_size, (BATCH, 77))),
            "mpnet_embeddings": torch.from_numpy(
                (centers[cl] + 0.25 * host.randn(BATCH, MP_DIM)).astype(np.float32)),
        }
        metrics, aux = step(batch, generator=gen)
        if i % 10 == 0 or i >= STEPS - 20:
            ratios.append((i, float(metrics["resource_ratio"])))
            contrast.append((i, float(metrics["contrastive_loss"])))
            usages.append(np.bincount(aux["expert_indices"].numpy(), minlength=N_E))

    start = np.mean([r for i, r in ratios if i < 30])
    final = np.mean([r for i, r in ratios if i >= STEPS - 20])
    gap0, gap1 = abs(start - p_actual), abs(final - p_actual)
    assert gap1 < 0.08, (start, final, p_actual)
    assert gap1 < 0.5 * max(gap0, 1e-6) or gap0 < 0.08, (start, final, p_actual)
    tail_usage = np.sum(usages[-10:], axis=0)
    assert (tail_usage > 0).all(), tail_usage
    c0 = np.mean([c for i, c in contrast if i < 30])
    c1 = np.mean([c for i, c in contrast if i >= STEPS - 20])
    assert c1 < c0, (c0, c1)
