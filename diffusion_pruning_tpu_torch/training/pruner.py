"""Stage-1 (APTP pruning) train step, on one device.

  VAE encode (frozen) → noise and timestep draws → CLIP text encode (frozen)
  → hypernet → quantizer `forward_train` (Sinkhorn assignment over the batch)
  → contrastive loss → teacher U-Net pass (dense, no grad, the inference
  kernel) → student U-Net pass (per-prompt gates, the training kernels)
  → min-SNR diffusion + distillation + block-distillation + resource + std
  and max losses → backward into the hypernet and codebook only (the U-Net,
  VAE and text encoder are frozen) → NaN/Inf skip → AdamW with per-group
  learning rates, √batch scaling and linear warmup.

The same step as the JAX package's `training/pruner.py` (`make_pruner_step`
with no mesh). Randomness comes in a `draws` mapping; whatever it lacks is
drawn from an explicit `torch.Generator` on the step's device:

  vae_eps      (B, h, w, 4) standard normals of the latent sample
  noise        (B, h, w, 4) the diffusion noise
  timesteps    (B,) int64 in [0, max_t)
  gumbel       (B, vq_dim) gumbel noise of the student's gates
  codebook_gumbel (K, vq_dim), gates_gumbel (B, vq_dim): the two draws of
               `StructureQuantizer.forward_train`
  noise_offset (B, 1, 1, 4), perturbation (B, h, w, 4): only when the config
               turns those options on.

A batch holds `input_ids` (B, 77), `mpnet_embeddings` (B, D) and either
`pixel_values` (B, H, W, 3) or the latent-cache moments `latent_mean` and
`latent_logvar` (B, h, w, 4). Under the hypernet's `single_arch_param` the
gumbel draws of the router (`gumbel`, `gates_gumbel`) have one row, as its
logits do.

Gradient accumulation (`accum_steps` > 1, the original APTP code's
`gradient_accumulation_steps`): the batch splits into that many equal
micro-batches, each its own forward and backward (Sinkhorn and the
contrastive loss span one micro-batch); the loss terms and the gradients
are their means, the codebook snapshot is the last micro-batch's, and the
per-sample outputs cover the whole batch. The skip test and the update run
once, on the mean gradients, and the warmup advances once. `draws` is then a
list with one mapping per micro-batch.

Stage boundaries: a step called with `mark=fn` calls fn(name) as each stage
ends, in this order: "encode", "router", "teacher", "student", "losses",
"backward", "optimizer". Recording a CUDA event there times the stages on
the device's clock without synchronising.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from diffusion_pruning_tpu_torch.core.estimators import sample_gumbel
from diffusion_pruning_tpu_torch.core.resource import ResourceModel
from diffusion_pruning_tpu_torch.losses import (
    contrastive_loss,
    diffusion_loss,
    resource_loss,
    snr_weights,
)
from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextEncoder
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL
from diffusion_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule

LOSS_TERMS = ("loss", "diffusion_loss", "distillation_loss", "block_loss",
              "contrastive_loss", "resource_loss", "resource_ratio")


@dataclasses.dataclass(frozen=True)
class PrunerConfig:
    # loss weights (configs/pruning/sd-2-1_coco2014.yaml)
    diffusion_weight: float = 1.0
    snr_gamma: Optional[float] = 5.0
    resource_weight: float = 2.0
    resource_type: str = "log"
    pruning_target: float = 0.6        # keep fraction of the total MACs
    contrastive_weight: float = 100.0
    arch_temperature: float = 0.03
    prompt_temperature: float = 0.03
    distillation_weight: float = 0.2
    block_weight: float = 0.2
    std_weight: float = 0.1
    max_weight: float = 0.1
    # optimiser
    hypernet_lr: float = 2e-4
    quantizer_lr: float = 2e-4
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    lr_warmup_steps: int = 100
    scale_lr: bool = True
    max_grad_norm: Optional[float] = None
    # schedule options
    noise_offset: float = 0.0
    input_perturbation: float = 0.0
    max_scheduler_steps: Optional[int] = None
    # use the dense teacher's prediction as the diffusion target instead of
    # ε/v (synthetic-weight convergence runs; off for real training)
    self_distill_target: bool = False


@dataclasses.dataclass
class PrunerModules:
    """The step's modules. The U-Net, VAE and text encoder are frozen here."""
    unet: GatedUNet
    vae: AutoencoderKL
    text_encoder: CLIPTextEncoder
    hypernet: HyperStructure
    quantizer: StructureQuantizer
    schedule: DiffusionSchedule

    def __post_init__(self):
        for frozen in (self.unet, self.vae, self.text_encoder):
            frozen.requires_grad_(False)

    @property
    def resource_model(self) -> ResourceModel:
        return ResourceModel(self.unet.spec)


def make_optimizer(cfg: PrunerConfig, mods: PrunerModules,
                   global_batch: int) -> torch.optim.AdamW:
    """AdamW over two groups, `hypernet` (all its parameters) and `quantizer`
    (the codebook), each at its peak learning rate × √global_batch (with
    `scale_lr`). The step sets each group's rate from its warmup before every
    update it applies (`warmup_lr`)."""
    scale = global_batch ** 0.5 if cfg.scale_lr else 1.0
    groups = [
        {"name": "hypernet", "params": list(mods.hypernet.parameters()),
         "peak_lr": cfg.hypernet_lr * scale},
        {"name": "quantizer", "params": [mods.quantizer.embedding.weight],
         "peak_lr": cfg.quantizer_lr * scale},
    ]
    for g in groups:
        g["lr"] = g["peak_lr"]
    return torch.optim.AdamW(groups, betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
                             weight_decay=cfg.weight_decay)


def warmup_lr(cfg: PrunerConfig, peak: float, applied: int) -> float:
    """Linear warmup from 0 over `lr_warmup_steps` applied updates, then
    constant; the update that follows `applied` earlier ones uses this."""
    if cfg.lr_warmup_steps > 0 and applied < cfg.lr_warmup_steps:
        return peak * applied / cfg.lr_warmup_steps
    return peak


def _applied_updates(optimizer: torch.optim.Optimizer, group: dict) -> int:
    """Updates the group has taken: AdamW's own step count, which a skipped
    step does not advance."""
    state = optimizer.state.get(group["params"][0])
    return int(state["step"]) if state else 0


def complete_draws(mods: PrunerModules, cfg: PrunerConfig, batch: Dict[str, torch.Tensor],
                   draws: Optional[Dict[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """`draws` with every entry the step needs; missing ones come from
    `generator` (required then), on its device."""
    b = batch["input_ids"].shape[0]
    if "latent_mean" in batch:
        lat = tuple(batch["latent_mean"].shape)
    else:
        px, vcfg = batch["pixel_values"], mods.vae.cfg
        lat = (b, px.shape[1] // vcfg.spatial_scale, px.shape[2] // vcfg.spatial_scale,
               vcfg.latent_channels)
    vq = mods.quantizer.spec.vq_dim
    rows = 1 if mods.hypernet.single_arch_param else b  # the router's logits
    max_t = cfg.max_scheduler_steps or mods.schedule.num_train_timesteps

    def normal(shape):
        return torch.randn(shape, generator=generator, device=generator.device)

    makers = {
        "vae_eps": lambda: normal(lat),
        "noise": lambda: normal(lat),
        "timesteps": lambda: torch.randint(0, max_t, (b,), generator=generator,
                                           device=generator.device),
        "gumbel": lambda: sample_gumbel((rows, vq), generator),
        "codebook_gumbel": lambda: sample_gumbel((mods.quantizer.n_e, vq), generator),
        "gates_gumbel": lambda: sample_gumbel((rows, vq), generator),
    }
    if cfg.noise_offset:
        makers["noise_offset"] = lambda: normal((b, 1, 1, lat[-1]))
    if cfg.input_perturbation:
        makers["perturbation"] = lambda: normal(lat)
    out = dict(draws or {})
    missing = [k for k in makers if k not in out]
    if missing and generator is None:
        raise ValueError(f"draws lack {missing}: pass them or a torch.Generator")
    for key in missing:
        out[key] = makers[key]()
    return out


def _no_mark(name: str) -> None:
    pass


def compute_losses(mods: PrunerModules, cfg: PrunerConfig, batch: Dict[str, torch.Tensor],
                   draws: Dict[str, torch.Tensor], pretrain: bool, p_actual: float,
                   mark: Callable[[str], None] = _no_mark):
    """(total loss, aux) for one batch; differentiable in the hypernet and the
    codebook. `draws` must be complete (`complete_draws`)."""
    vae, sched, q = mods.vae, mods.schedule, mods.quantizer
    with torch.no_grad():
        if "latent_mean" in batch:
            std = torch.exp(0.5 * batch["latent_logvar"].float())
            latents = (batch["latent_mean"].float() + std * draws["vae_eps"]) * vae.cfg.scaling_factor
        else:
            latents = vae.encode(batch["pixel_values"], draws["vae_eps"]).float()
        ehs = mods.text_encoder(batch["input_ids"])
        noise = draws["noise"].float()
        if cfg.noise_offset:
            noise = noise + cfg.noise_offset * draws["noise_offset"]
        timesteps = draws["timesteps"]
        noise_for_q = noise
        if cfg.input_perturbation:
            noise_for_q = noise + cfg.input_perturbation * draws["perturbation"]
        noisy = sched.add_noise(latents, noise_for_q, timesteps)
    mark("encode")

    # router
    text_emb = batch["mpnet_embeddings"].float()
    logits = mods.hypernet(text_emb)
    z_q, indices, embedding_gs = q.forward_train(logits, draws["codebook_gumbel"],
                                                 draws["gates_gumbel"])
    gates = q.gumbel_sigmoid_trick(logits, draws["gumbel"])
    if mods.hypernet.single_arch_param:  # one arch vector, tiled over the batch
        gates = gates.expand(text_emb.shape[0], -1)
    c_loss, arch_sim = contrastive_loss(text_emb, q.width_depth_normalize(gates),
                                        cfg.prompt_temperature, cfg.arch_temperature)
    arch_used = gates if pretrain else z_q
    mark("router")

    with torch.no_grad():
        teacher_pred, teacher_feats = mods.unet(noisy, timesteps, ehs, arch=None,
                                                return_features=True)
    mark("teacher")
    student_pred, student_feats = mods.unet(noisy, timesteps, ehs, arch=arch_used,
                                            return_features=True)
    mark("student")

    target = teacher_pred if cfg.self_distill_target else sched.target(latents, noise, timesteps)
    w = snr_weights(sched.alphas_cumprod_on(timesteps.device), timesteps, cfg.snr_gamma,
                    sched.prediction_type)
    d_loss = diffusion_loss(student_pred, target, w)
    distill = (student_pred.float() - teacher_pred.float()).square().mean()
    block = torch.stack([(student_feats[k].float() - teacher_feats[k].float()).square().mean()
                         for k in sorted(student_feats)]).mean()

    ratios = mods.resource_model.resource_ratio(arch_used)
    mean_ratio = ratios.mean()
    r_loss = resource_loss(mean_ratio, p_actual, cfg.resource_type)
    max_loss = 1.0 - ratios.max()
    # eps-guarded std: a batch routed to one expert has zero variance, where
    # the plain std's gradient is NaN
    std_loss = -torch.sqrt(ratios.var(unbiased=False) + 1e-12)

    total = (cfg.diffusion_weight * d_loss
             + cfg.resource_weight * r_loss
             + cfg.contrastive_weight * c_loss
             + cfg.distillation_weight * distill
             + cfg.block_weight * block
             + cfg.std_weight * std_loss
             + cfg.max_weight * max_loss)
    mark("losses")
    aux = {
        "loss": total, "diffusion_loss": d_loss, "distillation_loss": distill,
        "block_loss": block, "contrastive_loss": c_loss, "resource_loss": r_loss,
        "resource_ratio": mean_ratio, "batch_resource_ratios": ratios,
        "expert_indices": indices, "embedding_gs": embedding_gs, "arch_similarity": arch_sim,
    }
    return total, aux


def _global_norm(grads) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float())
                                                 for g in grads]))


def _micro_batches(batch, draws, accum_steps: int):
    """[(micro-batch, its draws)]: the batch split into `accum_steps` equal
    parts along the batch axis, with `draws` a list of one mapping each (or
    None)."""
    if accum_steps == 1:
        return [(batch, draws)]
    b = batch["input_ids"].shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} does not split into {accum_steps} micro-batches")
    draws = [None] * accum_steps if draws is None else list(draws)
    if len(draws) != accum_steps:
        raise ValueError(f"pass one draws mapping per micro-batch ({accum_steps})")
    parts = {k: v.chunk(accum_steps) for k, v in batch.items()}
    return [({k: p[i] for k, p in parts.items()}, draws[i]) for i in range(accum_steps)]


def make_pruner_step(mods: PrunerModules, cfg: PrunerConfig, optimizer: torch.optim.Optimizer,
                     pretrain: bool = False, accum_steps: int = 1) -> Callable:
    """The train step: step(batch, draws=None, generator=None) -> (metrics,
    aux), with an optional `mark` (module docstring). pretrain=True trains on
    the hypernet's own gates, else on the codebook rows z_q; `accum_steps`
    splits the batch into micro-batches (module docstring).

    It updates the hypernet and codebook in place through `optimizer` (from
    `make_optimizer`) and writes the codebook snapshot into
    `quantizer.embedding_gs`. After it, each trainable's `.grad` holds this
    step's gradient. A step whose loss or gradient norm is not finite is
    skipped: parameters and optimizer state stay as they were, and the
    warmup does not advance. metrics: the loss terms, `grad_norm` and
    `skipped` (tensors); aux: `expert_indices`, `batch_resource_ratios`."""
    p_actual = mods.resource_model.actual_pruning_target(cfg.pruning_target)
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(batch, draws=None, generator=None, mark=_no_mark):
        optimizer.zero_grad(set_to_none=True)
        auxes = []
        for mb, mb_draws in _micro_batches(batch, draws, accum_steps):
            mb_draws = complete_draws(mods, cfg, mb, mb_draws, generator)
            loss, aux = compute_losses(mods, cfg, mb, mb_draws, pretrain, p_actual, mark)
            loss.backward()
            mark("backward")
            auxes.append(aux)
        for p in params:  # a parameter the loss does not reach gets a zero update
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif accum_steps > 1:
                p.grad.div_(accum_steps)
        terms = {k: sum(a[k].detach() for a in auxes) / accum_steps if accum_steps > 1
                 else auxes[0][k].detach() for k in LOSS_TERMS}
        gnorm = _global_norm([p.grad for p in params])
        skipped = not bool(torch.isfinite(terms["loss"]) & torch.isfinite(gnorm))
        if not skipped:
            for group in optimizer.param_groups:
                if cfg.max_grad_norm:
                    norm = _global_norm([p.grad for p in group["params"]])
                    if norm > cfg.max_grad_norm:
                        for p in group["params"]:
                            p.grad.mul_(cfg.max_grad_norm / norm)
                group["lr"] = warmup_lr(cfg, group["peak_lr"], _applied_updates(optimizer, group))
            optimizer.step()
        with torch.no_grad():
            mods.quantizer.embedding_gs.copy_(auxes[-1]["embedding_gs"])
        mark("optimizer")
        metrics = dict(terms, grad_norm=gnorm, skipped=skipped)
        return metrics, {
            "expert_indices": torch.cat([a["expert_indices"] for a in auxes]),
            "batch_resource_ratios": torch.cat([a["batch_resource_ratios"].detach()
                                                for a in auxes])}

    return step


def make_validation_step(mods: PrunerModules, cfg: PrunerConfig,
                         pretrain: bool = False) -> Callable:
    """Loss-only step for the held-out split: val(batch, draws=None,
    generator=None) -> the loss terms, with no gradient and no update."""
    p_actual = mods.resource_model.actual_pruning_target(cfg.pruning_target)

    @torch.no_grad()
    def val(batch, draws=None, generator=None):
        draws = complete_draws(mods, cfg, batch, draws, generator)
        _, aux = compute_losses(mods, cfg, batch, draws, pretrain, p_actual)
        return {k: aux[k] for k in LOSS_TERMS}

    return val
