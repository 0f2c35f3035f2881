"""Stage-1 APTP convergence run, then expert fine-tuning, on one device.

The port's counterpart of the JAX package's `scripts/other/convergence_run.py`:
the same flags (plus `--device`), defaults, synthetic pool, schedule,
criteria and files. It shows that the training loop converges, not only
that one step is right: the reference stage-1 schedule (5,000 steps at
B = 64, 256px latents, 500 hypernet-pretraining steps) runs on random
SD-2.1-width weights with planted redundancy (`utils/synthetic.py`),
clustered synthetic prompt embeddings and cached latents. The router needs
no real SD weights to converge: the U-Net is frozen in stage 1, and every
loss that trains the router (resource, contrastive, std/max, the Sinkhorn
balance) runs. Then the most-used experts of the codebook are cut from the
dense weights, each fine-tuned on the pool prompts the router gives it, and
the mechanism is judged:

  C1 resource_ratio descends to p_actual +- tol and stays there
  C2 expert usage stays non-degenerate across all K codes (Sinkhorn balance)
  C3 contrastive loss decreases (the router clusters prompts)
  C4 the pretrain->quantized phase switch does not blow the loss up
  C5 stage-2 expert fine-tuning: distillation loss decreases

  python -m diffusion_pruning_tpu_torch.cli.convergence_run --run_dir runs/convergence_s1
  ... --steps 60 --pretrain_steps 20 --ft_steps 10 --batch 8 --ft_experts 1   # smoke
  ... --tiny --device cpu --steps 24 --pretrain_steps 8 --ft_steps 8 --pool 512 --batch 4

The kernels take a head size of 64 only, so on the card the run uses the
SD-2.1 U-Net; `--tiny` (heads of 16) runs on the CPU. Writes metrics.jsonl,
heatmaps/, the checkpoint with its exports and CONVERGENCE_SUMMARY.json into
--run_dir (and ft_expert{e}_metrics.jsonl per fine-tuned expert); exits 1
if any criterion fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

# configs/pruning/sd-2-1_coco2014.yaml's depth order
SD21_DEPTH_ORDER = (-1, -2, 0, 1, -3, -4, 2, 3, -5, -6, 4, 5, -7, 6)


def log(m):
    print(f"# convergence: {m}", file=sys.stderr, flush=True)


def parse(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run_dir", default="runs/convergence_s1")
    p.add_argument("--steps", type=int, default=5000)
    p.add_argument("--pretrain_steps", type=int, default=500)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--pool", type=int, default=4096)
    p.add_argument("--clusters", type=int, default=16)
    p.add_argument("--n_experts", type=int, default=8)
    p.add_argument("--pruning_target", type=float, default=0.6)
    p.add_argument("--ft_steps", type=int, default=300)
    p.add_argument("--ft_batch", type=int, default=32)
    p.add_argument("--ft_experts", type=int, default=2)
    p.add_argument("--redundancy_keep", type=float, default=0.5,
                   help="fraction of gate units kept at full magnitude; the rest are "
                        "eps-damped (planted prunable capacity)")
    p.add_argument("--redundancy_eps", type=float, default=0.02)
    p.add_argument("--real_target", action="store_true",
                   help="use the raw eps/v diffusion target instead of the dense teacher's "
                        "prediction (see PrunerConfig.self_distill_target: with random frozen "
                        "weights the raw target is unlearnable gradient noise)")
    p.add_argument("--stage2_only", action="store_true",
                   help="skip stage 1: restore hypernet/quantizer from the latest checkpoint "
                        "in --run_dir (frozen weights and the synthetic pool regenerate "
                        "deterministically from --seed), recompute C1-C4 from the existing "
                        "metrics.jsonl, and re-run expert fine-tuning only")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="tiny U-Net topology (CPU-runnable smoke)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'.")
    return p.parse_args(argv)


def build(args, device):
    """(PrunerModules, spec, text config, MPNet width): the frozen U-Net and
    text encoder random from the seed in bf16, redundancy planted in the
    U-Net; the VAE on the meta device (cached latents: the step never runs
    it); a fresh hypernet and codebook in f32."""
    from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
    from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
    from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from diffusion_pruning_tpu_torch.schedulers import DiffusionSchedule
    from diffusion_pruning_tpu_torch.training import PrunerModules
    from diffusion_pruning_tpu_torch.utils.init_utils import random_init_

    if args.tiny:
        ucfg, tcfg, vcfg = UNetConfig.tiny(cross_attention_dim=32), CLIPTextConfig.tiny(), \
            VAEConfig.tiny()
        depth_order, mp_dim = None, 24
    else:
        ucfg, tcfg, vcfg = UNetConfig.sd21(args.res), CLIPTextConfig.sd21(), VAEConfig.sd()
        depth_order, mp_dim = SD21_DEPTH_ORDER, 768
    log("materialising frozen weights on the device (bf16: frozen in stage 1)")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.device(device):
        unet = GatedUNet(ucfg)
        text = CLIPTextEncoder(tcfg)
        hypernet = HyperStructure(unet.spec, input_dim=mp_dim)
        quantizer = StructureQuantizer(unet.spec, n_e=args.n_experts, base=3.0,
                                       **({"depth_order": depth_order} if depth_order else {}))
    for module in (unet, text, hypernet):
        random_init_(module, gen)
    quantizer.init_params(gen)
    quantizer.init_state()
    spec = unet.spec
    unet = unet.to(torch.bfloat16).eval()
    if args.redundancy_keep < 1.0:
        from diffusion_pruning_tpu_torch.utils.synthetic import plant_redundancy
        damped, planted = plant_redundancy(spec, unet.state_dict(), keep=args.redundancy_keep,
                                           eps=args.redundancy_eps, seed=args.seed + 5)
        unet.load_state_dict(damped)
        log(f"planted redundancy: {planted:.3f} of gate units at full magnitude, rest "
            f"damped x{args.redundancy_eps}")
    with torch.device("meta"):
        vae = AutoencoderKL(vcfg)
    mods = PrunerModules(unet=unet, vae=vae, text_encoder=text.to(torch.bfloat16).eval(),
                         hypernet=hypernet, quantizer=quantizer, schedule=DiffusionSchedule())
    return mods, spec, tcfg, mp_dim


def synth_pool(args, mp_dim, vocab, latent_size):
    """Clustered prompt embeddings + fixed random latents: the contrastive
    loss needs prompt-space structure for the router to learn (the reference
    trains on real MPNet embeddings of COCO captions)."""
    rng = np.random.RandomState(args.seed + 1)
    centers = rng.randn(args.clusters, mp_dim).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.randint(0, args.clusters, args.pool)
    mp = centers[assign] + 0.25 * rng.randn(args.pool, mp_dim).astype(np.float32)
    return {
        "mpnet": mp.astype(np.float32),
        "cluster": assign,
        "latent_mean": rng.randn(args.pool, latent_size, latent_size, 4).astype(np.float32),
        "input_ids": rng.randint(0, vocab, (args.pool, 77)).astype(np.int32),
    }


def window_mean(rows, key, lo, hi):
    vals = [r[key] for r in rows if lo <= r["step"] < hi and key in r]
    return float(np.mean(vals)) if vals else float("nan")


def stage1_checks(args, rows, p_actual):
    """C1-C4 from the training rows of metrics.jsonl."""
    S, P = args.steps, args.pretrain_steps
    tail_lo = max(P, S - max(S // 10, 50))
    checks = {}
    ratio_final = window_mean(rows, "resource_ratio", tail_lo, S + 1)
    ratio_start = window_mean(rows, "resource_ratio", 0, max(S // 20, 20))
    checks["C1_resource_ratio_converges"] = {
        "start": ratio_start, "final": ratio_final, "target": p_actual,
        "tol": 0.02, "pass": bool(abs(ratio_final - p_actual) <= 0.02)}

    usage = np.zeros(args.n_experts)
    for r in rows:
        if r["step"] >= tail_lo and "expert_usage/0" in r:
            usage += np.array([r.get(f"expert_usage/{e}", 0.0) for e in range(args.n_experts)])
    share = usage / max(usage.sum(), 1)
    ent = float(-(share * np.log(np.maximum(share, 1e-12))).sum() / np.log(args.n_experts))
    checks["C2_expert_balance"] = {
        "final_shares": [round(float(s), 4) for s in share],
        "normalized_entropy": round(ent, 4), "min_share": round(float(share.min()), 4),
        "pass": bool(share.min() >= 0.03 and ent >= 0.85)}

    c_early = window_mean(rows, "contrastive_loss", P, P + max(S // 20, 20))
    c_late = window_mean(rows, "contrastive_loss", tail_lo, S + 1)
    checks["C3_contrastive_decreases"] = {
        "early_quantized": c_early, "final": c_late, "pass": bool(c_late < c_early)}

    pre = window_mean(rows, "loss", max(0, P - max(S // 50, 10)), P)
    post = window_mean(rows, "loss", P, P + max(S // 50, 10))
    checks["C4_phase_switch_continuous"] = {
        "loss_before_switch": pre, "loss_after_switch": post,
        "pass": bool(np.isfinite(post) and post <= 2.0 * max(pre, 1e-6))}
    return checks


def placed(batch, device):
    """A host batch on the device: token ids as int64, the rest f32."""
    return {k: torch.as_tensor(v, device=device).long() if k == "input_ids"
            else torch.as_tensor(v, device=device).float() for k, v in batch.items()}


def finetune_expert(args, mods, spec, pool, pool_idx, counts, embedding_gs, e, latent_size,
                    device):
    """Cut expert e from the dense weights, fine-tune it on its pool prompts
    and return its C5 entry."""
    from diffusion_pruning_tpu_torch.models.unet.pruned import expert_macs_ratio, make_expert_plan
    from diffusion_pruning_tpu_torch.training import (
        FineTuneConfig,
        FineTunerModules,
        MasterWeights,
        make_finetune_optimizer,
        make_finetune_step,
    )
    from diffusion_pruning_tpu_torch.training.factory import build_student

    arch = (embedding_gs[e] >= 0.5).astype(np.float32)
    plan = make_expert_plan(spec, arch)
    macs = expert_macs_ratio(spec, plan)
    log(f"expert {e}: MACs ratio {macs:.3f}, {int(counts[e])} pool prompts")
    # the dense (planted) weights' slices, f32 masters, bf16 compute
    student = build_student(mods.unet, plan)
    masters = MasterWeights(student, separate=True)
    student.to(torch.bfloat16)
    ft_mods = FineTunerModules(student=student, teacher=mods.unet, vae=mods.vae,
                               text_encoder=mods.text_encoder, schedule=mods.schedule)
    ft_cfg = FineTuneConfig(lr_warmup_steps=min(100, args.ft_steps // 3), unet_lr=1e-5,
                            self_distill_target=not args.real_target)
    optimizer = make_finetune_optimizer(ft_cfg, masters, args.ft_batch)
    step = make_finetune_step(ft_mods, ft_cfg, optimizer)

    subset = np.nonzero(pool_idx == e)[0]
    if len(subset) == 0:
        subset = np.arange(args.pool)
    frng = np.random.RandomState(args.seed + 10 + e)
    gen = torch.Generator(device=device).manual_seed(args.seed + 20 + e)
    losses = []
    with open(os.path.join(args.run_dir, f"ft_expert{e}_metrics.jsonl"), "w") as fh:
        for i in range(args.ft_steps):
            idx = subset[frng.randint(0, len(subset), args.ft_batch)]
            batch = {
                "latent_mean": pool["latent_mean"][idx],
                "latent_logvar": np.full((args.ft_batch, latent_size, latent_size, 4), -6.0,
                                         np.float32),
                "input_ids": pool["input_ids"][idx],
            }
            m = step(placed(batch, device), generator=gen)
            if i % 10 == 0 or i == args.ft_steps - 1:
                mm = {k: float(v) for k, v in m.items()}
                losses.append((i, mm["distillation_loss"]))
                fh.write(json.dumps({"step": i, **mm}) + "\n")
                fh.flush()
    head = float(np.mean([l for s, l in losses if s < args.ft_steps // 4]))
    tail = float(np.mean([l for s, l in losses if s >= args.ft_steps - args.ft_steps // 4]))
    log(f"expert {e}: distill {head:.4f} -> {tail:.4f}")
    del student, masters, optimizer, step
    return {"macs_ratio": round(macs, 4), "distill_first_quarter": head,
            "distill_last_quarter": tail, "pass": bool(tail < head)}


def run(argv=None) -> dict:
    """Run it; returns the summary written to CONVERGENCE_SUMMARY.json."""
    from diffusion_pruning_tpu_torch.training import PrunerConfig, make_optimizer
    from diffusion_pruning_tpu_torch.training import make_pruner_step, make_validation_step
    from diffusion_pruning_tpu_torch.training.loop import LoopConfig, PrunerLoop
    from diffusion_pruning_tpu_torch.utils.device import resolve_device
    from diffusion_pruning_tpu_torch.utils.logging_utils import Tracker

    args = parse(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    os.makedirs(args.run_dir, exist_ok=True)
    mods, spec, tcfg, mp_dim = build(args, device)
    latent_size = mods.unet.cfg.sample_size
    pool = synth_pool(args, mp_dim, tcfg.vocab_size, latent_size)
    p_actual = mods.resource_model.actual_pruning_target(args.pruning_target)
    log(f"p_actual (prunable-space target for total {args.pruning_target}) = {p_actual:.4f}")

    cfg = PrunerConfig(pruning_target=args.pruning_target,
                       self_distill_target=not args.real_target)
    optimizer = make_optimizer(cfg, mods, global_batch=args.batch)
    loop_cfg = LoopConfig(
        max_train_steps=args.steps,
        hypernet_pretraining_steps=args.pretrain_steps,
        validation_steps=max(args.steps // 5, 1),
        image_logging_steps=max(args.steps // 5, 1),
        checkpoints_total_limit=1,
        log_every=10,
        resume_from="latest" if args.stage2_only else None,
    )
    loop = PrunerLoop(mods, cfg, loop_cfg, optimizer, make_pruner_step, make_validation_step,
                      args.run_dir, tracker=Tracker(args.run_dir), seed=args.seed + 7)

    step_rng = np.random.RandomState(args.seed + 2)

    def draw(rng, batch_size):
        idx = rng.randint(0, args.pool, batch_size)
        return {
            "latent_mean": pool["latent_mean"][idx],
            "latent_logvar": np.full((batch_size, latent_size, latent_size, 4), -6.0,
                                     np.float32),
            "input_ids": pool["input_ids"][idx],
            "mpnet_embeddings": pool["mpnet"][idx],
        }

    def train_batches(_epoch):
        for _ in range(args.steps):
            yield draw(step_rng, args.batch)

    val_rng = np.random.RandomState(args.seed + 3)

    def val_batches():
        for _ in range(2):
            yield draw(val_rng, args.batch)

    if args.stage2_only:
        loop.maybe_resume()
        log(f"stage2_only: restored checkpoint at step {loop.global_step}")
        prev = os.path.join(args.run_dir, "CONVERGENCE_SUMMARY.json")
        wall_s1 = (json.load(open(prev)).get("wall_clock_s", -1.0)
                   if os.path.exists(prev) else -1.0)
    else:
        t0 = time.perf_counter()
        loop.train(train_batches, val_batches)
        wall_s1 = time.perf_counter() - t0
        log(f"stage-1 {args.steps} steps in {wall_s1 / 60:.1f} min "
            f"({args.steps * args.batch / wall_s1:.1f} smp/s)")

    # ----------------------- analysis: C1-C4 -----------------------
    with open(os.path.join(args.run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    rows = [r for r in rows if "loss" in r]  # training rows only
    summary = {"steps": args.steps, "pretrain_steps": args.pretrain_steps, "p_actual": p_actual,
               "wall_clock_s": round(wall_s1, 1),
               "samples_per_sec": (round(args.steps * args.batch / wall_s1, 1)
                                   if wall_s1 > 0 else None)}
    checks = stage1_checks(args, rows, p_actual)

    # ----------------------- stage 2: materialise + fine-tune -----------------------
    with torch.no_grad():  # the router's assignment of the whole pool (filter_dataset)
        logits = mods.hypernet(torch.as_tensor(pool["mpnet"], device=device))
        _, idx = mods.quantizer.forward_eval(logits)
    pool_idx = idx.cpu().numpy()
    counts = np.bincount(pool_idx, minlength=args.n_experts)
    log(f"router pool assignment: {counts.tolist()}")
    summary["pool_assignment"] = counts.tolist()
    chosen = np.argsort(-counts)[: args.ft_experts]
    embedding_gs = mods.quantizer.embedding_gs.detach().float().cpu().numpy()
    ft_results = {str(e): finetune_expert(args, mods, spec, pool, pool_idx, counts,
                                          embedding_gs, e, latent_size, device)
                  for e in chosen.tolist()}
    checks["C5_expert_finetune_distill_decreases"] = {
        **ft_results, "pass": all(v["pass"] for v in ft_results.values())}

    summary["checks"] = checks
    summary["all_pass"] = all(c["pass"] for c in checks.values())
    with open(os.path.join(args.run_dir, "CONVERGENCE_SUMMARY.json"), "w") as fh:
        json.dump(summary, fh, indent=2)
    print(json.dumps({k: v["pass"] for k, v in checks.items()}
                     | {"all_pass": summary["all_pass"]}), flush=True)
    return summary


def main(argv=None) -> int:
    """The exit code: 0 when every criterion passes, else 1."""
    return 0 if run(argv)["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
