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

Data parallel (`mesh`, a `parallel.mesh.DataMesh`): the JAX step under a
mesh, with torch DDP's semantics. Each rank takes its rows of the global
batch and the trainables replicated. One `codebook_gumbel` draw is shared by
every rank (from `shared_generator`, the stream every rank seeds alike);
every other draw is the rank's own (from `generator`, its rank stream).
Sinkhorn balances the global batch (`core/sinkhorn.py`). The contrastive
loss compares each prompt with the global batch: the MPNet embeddings and
the detached normalised gates are gathered, and this rank's live rows are
spliced back in at its slot, so a rank differentiates the global similarity
matrix through its own rows only and the ranks' mean gradient is the
one-process gradient ÷ world, as under DDP. The resource, std and max terms
use the local batch. After the backward the gradients, the loss terms and
the metrics are averaged over the ranks; the skip test reads the mean
gradients, so every rank skips together; then the per-group clip and the
update run on every rank alike. `expert_indices` and
`batch_resource_ratios` cover the global batch on every rank, rank by rank.
Under `accum_steps` Sinkhorn and the contrastive loss span one micro-batch
× the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

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
from diffusion_pruning_tpu_torch.parallel.mesh import (
    DataMesh,
    all_gather,
    axis_index,
    pmean_,
    pmean_dict,
)
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


def latent_shape(vae: AutoencoderKL, batch: Dict[str, torch.Tensor]) -> tuple:
    """(B, h, w, 4): the latents of a batch of pixels or of cached moments."""
    if "latent_mean" in batch:
        return tuple(batch["latent_mean"].shape)
    px, vcfg = batch["pixel_values"], vae.cfg
    return (px.shape[0], px.shape[1] // vcfg.spatial_scale, px.shape[2] // vcfg.spatial_scale,
            vcfg.latent_channels)


def encode_latents(vae: AutoencoderKL, batch: Dict[str, torch.Tensor],
                   vae_eps: torch.Tensor) -> torch.Tensor:
    """f32 latents of a batch: the VAE's sample with `vae_eps`, or the cached
    moments' (mean + σ·eps) × the VAE's scaling factor."""
    if "latent_mean" in batch:
        std = torch.exp(0.5 * batch["latent_logvar"].float())
        return (batch["latent_mean"].float() + std * vae_eps) * vae.cfg.scaling_factor
    return vae.encode(batch["pixel_values"], vae_eps).float()


def fill_draws(vae: AutoencoderKL, cfg, batch: Dict[str, torch.Tensor], max_t: int,
               draws: Optional[Dict[str, torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None,
               extra: Optional[Dict[str, Callable[[], torch.Tensor]]] = None
               ) -> Dict[str, torch.Tensor]:
    """`draws` completed with the entries both stages' steps take: vae_eps,
    noise, timesteps in [0, max_t), then a stage's own (`extra`, name →
    maker), then noise_offset and perturbation when `cfg` turns them on.
    Missing ones come from `generator` (required then), on its device, in
    that order."""
    b = batch["input_ids"].shape[0]
    lat = latent_shape(vae, batch)

    def normal(shape):
        return torch.randn(shape, generator=generator, device=generator.device)

    makers = {
        "vae_eps": lambda: normal(lat),
        "noise": lambda: normal(lat),
        "timesteps": lambda: torch.randint(0, max_t, (b,), generator=generator,
                                           device=generator.device),
        **(extra or {}),
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


def noisy_latents(sched: DiffusionSchedule, cfg, latents: torch.Tensor,
                  draws: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(noise, noisy latents): the diffusion noise with its offset, and
    `latents` noised at the draws' timesteps by that noise plus the input
    perturbation (which the target does not see)."""
    noise = draws["noise"].float()
    if cfg.noise_offset:
        noise = noise + cfg.noise_offset * draws["noise_offset"]
    noise_in = noise
    if cfg.input_perturbation:
        noise_in = noise + cfg.input_perturbation * draws["perturbation"]
    return noise, sched.add_noise(latents, noise_in, draws["timesteps"])


def complete_draws(mods: PrunerModules, cfg: PrunerConfig, batch: Dict[str, torch.Tensor],
                   draws: Optional[Dict[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None,
                   shared_generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """`draws` with every entry the step needs (`fill_draws` with the
    router's gumbel draws); missing ones come from `generator`, except
    `codebook_gumbel`, which comes from `shared_generator` when it is given."""
    b = batch["input_ids"].shape[0]
    vq = mods.quantizer.spec.vq_dim
    if shared_generator is not None and "codebook_gumbel" not in (draws or {}):
        draws = dict(draws or {}, codebook_gumbel=sample_gumbel((mods.quantizer.n_e, vq),
                                                                shared_generator))
    rows = 1 if mods.hypernet.single_arch_param else b  # the router's logits
    router = {
        "gumbel": lambda: sample_gumbel((rows, vq), generator),
        "codebook_gumbel": lambda: sample_gumbel((mods.quantizer.n_e, vq), generator),
        "gates_gumbel": lambda: sample_gumbel((rows, vq), generator),
    }
    return fill_draws(mods.vae, cfg, batch,
                      cfg.max_scheduler_steps or mods.schedule.num_train_timesteps, draws,
                      generator, router)


def _no_mark(name: str) -> None:
    pass


def gather_spliced(mesh: DataMesh, local: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of `local`, rank by rank: the other ranks' rows
    gathered without gradient and this rank's live rows spliced back in at
    its slot, so a loss of the result differentiates through this rank's
    rows only (torch DDP's all_gather; the JAX package's stop-gradient gather
    and `dynamic_update_index_in_dim`)."""
    parts = list(all_gather(mesh, local).chunk(mesh.world_size))
    parts[axis_index(mesh)] = local
    return torch.cat(parts)


def compute_losses(mods: PrunerModules, cfg: PrunerConfig, batch: Dict[str, torch.Tensor],
                   draws: Dict[str, torch.Tensor], pretrain: bool, p_actual: float,
                   mark: Callable[[str], None] = _no_mark, mesh: Optional[DataMesh] = None):
    """(total loss, aux) for one batch (this rank's rows under a `mesh`);
    differentiable in the hypernet and the codebook. `draws` must be
    complete (`complete_draws`)."""
    vae, sched, q = mods.vae, mods.schedule, mods.quantizer
    with torch.no_grad():
        latents = encode_latents(vae, batch, draws["vae_eps"])
        ehs = mods.text_encoder(batch["input_ids"])
        noise, noisy = noisy_latents(sched, cfg, latents, draws)
        timesteps = draws["timesteps"]
    mark("encode")

    # router
    text_emb = batch["mpnet_embeddings"].float()
    logits = mods.hypernet(text_emb)
    z_q, indices, embedding_gs = q.forward_train(logits, draws["codebook_gumbel"],
                                                 draws["gates_gumbel"], mesh=mesh)
    gates = q.gumbel_sigmoid_trick(logits, draws["gumbel"])
    if mods.hypernet.single_arch_param:  # one arch vector, tiled over the batch
        gates = gates.expand(text_emb.shape[0], -1)
    gates_norm = q.width_depth_normalize(gates)
    if mesh is None:
        text_all, arch_all = text_emb, gates_norm
    else:
        text_all, arch_all = all_gather(mesh, text_emb), gather_spliced(mesh, gates_norm)
    c_loss, arch_sim = contrastive_loss(text_all, arch_all,
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
                     pretrain: bool = False, accum_steps: int = 1,
                     mesh: Optional[DataMesh] = None) -> Callable:
    """The train step: step(batch, draws=None, generator=None) -> (metrics,
    aux), with an optional `mark` (module docstring). pretrain=True trains on
    the hypernet's own gates, else on the codebook rows z_q; `accum_steps`
    splits the batch into micro-batches (module docstring). With a `mesh`
    the step is data parallel (module docstring) and also takes
    `shared_generator`, the stream of the shared codebook noise, which it
    needs whenever `draws` lack `codebook_gumbel`.

    It updates the hypernet and codebook in place through `optimizer` (from
    `make_optimizer`) and writes the codebook snapshot into
    `quantizer.embedding_gs`. After it, each trainable's `.grad` holds this
    step's gradient. A step whose loss or gradient norm is not finite is
    skipped: parameters and optimizer state stay as they were, and the
    warmup does not advance. metrics: the loss terms, `grad_norm` and
    `skipped` (tensors); aux: `expert_indices`, `batch_resource_ratios`."""
    p_actual = mods.resource_model.actual_pruning_target(cfg.pruning_target)
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(batch, draws=None, generator=None, mark=_no_mark, shared_generator=None):
        optimizer.zero_grad(set_to_none=True)
        auxes = []
        for mb, mb_draws in _micro_batches(batch, draws, accum_steps):
            _check_shared(mesh, mb_draws, shared_generator)
            mb_draws = complete_draws(mods, cfg, mb, mb_draws, generator, shared_generator)
            loss, aux = compute_losses(mods, cfg, mb, mb_draws, pretrain, p_actual, mark, mesh)
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
        if mesh is not None:
            pmean_(mesh, [p.grad for p in params])
            terms = pmean_dict(mesh, terms)
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
        per_sample = {
            "expert_indices": torch.cat([a["expert_indices"] for a in auxes]),
            "batch_resource_ratios": torch.cat([a["batch_resource_ratios"].detach()
                                                for a in auxes])}
        if mesh is not None:  # the global batch on every rank
            per_sample = {k: all_gather(mesh, v) for k, v in per_sample.items()}
        return metrics, per_sample

    return step


def _check_shared(mesh, draws, shared_generator) -> None:
    """Under a mesh the codebook noise must come from the shared stream."""
    if (mesh is not None and shared_generator is None
            and "codebook_gumbel" not in (draws or {})):
        raise ValueError("a data-parallel step draws the codebook noise from "
                         "`shared_generator` (the stream every rank shares): pass it, or "
                         "`codebook_gumbel` in the draws")


def make_validation_step(mods: PrunerModules, cfg: PrunerConfig,
                         pretrain: bool = False, mesh: Optional[DataMesh] = None) -> Callable:
    """Loss-only step for the held-out split: val(batch, draws=None,
    generator=None) -> the loss terms, with no gradient and no update. With
    a `mesh` it takes this rank's rows and `shared_generator` as the step
    does, and the terms are the ranks' mean."""
    p_actual = mods.resource_model.actual_pruning_target(cfg.pruning_target)

    @torch.no_grad()
    def val(batch, draws=None, generator=None, shared_generator=None):
        _check_shared(mesh, draws, shared_generator)
        draws = complete_draws(mods, cfg, batch, draws, generator, shared_generator)
        _, aux = compute_losses(mods, cfg, batch, draws, pretrain, p_actual, mesh=mesh)
        terms = {k: aux[k] for k in LOSS_TERMS}
        return terms if mesh is None else pmean_dict(mesh, terms)

    return val
