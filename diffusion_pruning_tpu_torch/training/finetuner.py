"""Stage 2 (expert fine-tuning) train step, on one device.

  VAE encode (frozen) → noise and timestep draws → CLIP text encode (frozen)
  → teacher U-Net pass (dense, no grad) → student U-Net pass (a physically
  pruned expert, or a baseline's student) → min-SNR diffusion + output
  distillation + block distillation → backward into the student's weights
  → NaN/Inf skip → AdamW on f32 master weights (√batch-scaled learning rate,
  linear warmup, optional global-norm clip and bf16 first moment).

The same step as the JAX package's `training/finetuner.py`
(`make_finetune_step` with no mesh). Randomness comes in a `draws` mapping;
whatever it lacks is drawn from an explicit `torch.Generator` on the step's
device:

  vae_eps      (B, h, w, 4) standard normals of the latent sample
  noise        (B, h, w, 4) the diffusion noise
  timesteps    (B,) int64 in [0, num_train_timesteps)
  noise_offset (B, 1, 1, 4), perturbation (B, h, w, 4): only when the config
               turns those options on.

A batch holds `input_ids` (B, 77) and either `pixel_values` (B, H, W, 3) or
the latent-cache moments `latent_mean` and `latent_logvar` (B, h, w, 4).

Precision. The JAX student computes in bf16 over f32 parameters (flax's
`dtype` and `param_dtype`). Here the optimizer keeps f32 masters
(`MasterWeights`, taken from the student while it holds f32 values) and the
caller then casts the student to the compute dtype, which makes its
parameters the compute copy: forward and backward run on the copy, its gradients are added (cast)
onto the masters after each micro-batch, AdamW updates the masters and the
copy is refreshed from them with a tracked in-place copy (so the version
counter, which the fused conv's packed-weight cache keys on, moves with every
update). Where the compute dtype is f32 the masters are the module's own
parameters.

Gradient accumulation (`accum_steps` > 1): the batch splits into that many
equal micro-batches, each its own forward and backward; the loss terms and
gradients are their means and the update runs once. `draws` is then a list
with one mapping per micro-batch.

Stage boundaries: a step called with `mark=fn` calls fn(name) as each stage
ends: "encode", "teacher", "student", "losses", "backward" (once per
micro-batch), then "optimizer".

Data parallel (`mesh`, a `parallel.mesh.DataMesh`): each rank takes its rows
of the global batch and its own draws (its rank stream); the masters'
gradients, the loss terms and the metrics are averaged over the ranks after
the backward, and the skip test reads the mean gradients, so every rank
skips together. With `zero1` the AdamW moments are sharded over the ranks
(`parallel/zero1.py`, `Zero1AdamW`): the full mean gradients are clipped by
`min(1, max_grad_norm / (‖g‖ + 1e-12))` (the JAX package's ZeRO-1 clip, not
the one-device formula), AdamW's arithmetic updates this rank's row of the
flat f32 masters, the rows are gathered back and the compute copy is
refreshed. The masters stay replicated.

The 2-D data × model step (`make_finetune_step_gspmd`, the JAX package's
GSPMD step) runs a student and a teacher sharded on the model axis of a
`parallel.tp.DpTpMesh` (`parallel.tp.shard_unet`) with global-batch
semantics: it equals the one-process step at the same global batch and
draws. Each rank takes its data rows of the global batch; the draws are the
global batch's (given, or drawn from one generator every rank seeds alike)
cut to those rows, so every rank of a model group sees the same ones. The
gradients of split leaves stay this rank's slices; every leaf's gradient and
the metrics are averaged over the data axis only; the skip and the clip read
the global norm (the split leaves' squares summed over the model axis, the
replicated ones counted once). AdamW runs on the f32 master shards, its
moments at their shapes; there is no ZeRO-1 under tensor parallelism.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn

from diffusion_pruning_tpu_torch.losses import diffusion_loss, snr_weights
from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextEncoder
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL
from diffusion_pruning_tpu_torch.parallel.mesh import (
    DataMesh,
    all_gather,
    pmean_,
    pmean_dict,
    psum,
    rank_slice,
)
from diffusion_pruning_tpu_torch.parallel.tp import DpTpMesh
from diffusion_pruning_tpu_torch.parallel.zero1 import (
    flat_size,
    gather_shards,
    local_shard,
    row,
    shard_len,
    unflatten,
)
from diffusion_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule
from diffusion_pruning_tpu_torch.training.pruner import (
    _applied_updates,
    _global_norm,
    _micro_batches,
    _no_mark,
    encode_latents,
    fill_draws,
    noisy_latents,
    warmup_lr,
)

LOSS_TERMS = ("loss", "diffusion_loss", "distillation_loss", "block_loss")


@dataclasses.dataclass(frozen=True)
class FineTuneConfig:
    snr_gamma: Optional[float] = 5.0
    diffusion_weight: float = 1.0
    distillation_weight: float = 0.2
    block_weight: float = 0.2
    unet_lr: float = 1e-5
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    lr_warmup_steps: int = 100
    scale_lr: bool = True
    max_grad_norm: Optional[float] = None
    noise_offset: float = 0.0
    input_perturbation: float = 0.0
    # AdamW's first moment in bf16 (optax's mu_dtype)
    adam_mu_bf16: bool = False
    # the dense teacher's prediction as the diffusion target instead of ε/v
    # (synthetic-weight convergence runs; off for real training)
    self_distill_target: bool = False


@dataclasses.dataclass
class FineTunerModules:
    """The step's modules. The student trains and must own every tensor it
    holds: a student that shared storage with the teacher would rewrite the
    teacher's uncut weights as it trains, and the distillation terms would
    measure the student against itself. The teacher, VAE and text encoder are
    frozen."""
    student: GatedUNet
    teacher: GatedUNet
    vae: AutoencoderKL
    text_encoder: CLIPTextEncoder
    schedule: DiffusionSchedule

    def __post_init__(self):
        for frozen in (self.teacher, self.vae, self.text_encoder):
            frozen.requires_grad_(False)
        teacher = {t.untyped_storage().data_ptr() for t in self.teacher.state_dict().values()}
        shared = [n for n, p in self.student.named_parameters()
                  if p.untyped_storage().data_ptr() in teacher]
        if shared:
            raise ValueError(f"the student shares the teacher's storage at {shared[:4]}: build "
                             "it with training.factory.build_student")


class MasterWeights:
    """A module's trainable parameters (its compute copy) and their f32
    masters: f32 clones when `separate`, else the parameters themselves.

    Taken while the parameters hold their f32 values. The owner of the
    student's precision casts the module afterwards (`student.to(bf16)`),
    which keeps each parameter object, so the copy list stays the module's."""

    def __init__(self, module: nn.Module, separate: bool = False):
        named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
        low = [n for n, p in named if p.dtype != torch.float32]
        if low:
            raise ValueError(f"the masters take f32 values; {low[:4]} are not f32")
        self.names = [n for n, _ in named]
        self.copies = [p for _, p in named]
        self.masters = ([p.detach().clone() for p in self.copies] if separate
                        else self.copies)

    @property
    def separate(self) -> bool:
        return self.masters is not self.copies

    def accumulate_grads(self) -> None:
        """Add the compute copy's gradients onto the masters' (cast), and
        clear the copy's."""
        if not self.separate:
            return
        for master, copy in zip(self.masters, self.copies):
            if copy.grad is None:
                continue
            if master.grad is None:
                master.grad = copy.grad.to(master.dtype)
            else:
                master.grad.add_(copy.grad)
            copy.grad = None

    @torch.no_grad()
    def refresh(self) -> None:
        """The compute copy from the masters, by a tracked in-place copy
        (it moves each parameter's version counter; a write through `.data`
        would not)."""
        if self.separate:
            torch._foreach_copy_(self.copies, self.masters)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {n: m.detach() for n, m in zip(self.names, self.masters)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        missing = sorted(set(self.names) ^ set(state))
        if missing:
            raise KeyError(f"master weights differ from the saved ones at {missing[:8]}")
        for name, master in zip(self.names, self.masters):
            master.copy_(state[name])
        self.refresh()


class AdamW(torch.optim.Optimizer):
    """optax.adamw (with its `mu_dtype`) on the f32 masters of a
    `MasterWeights`; after each update the module's compute copy is refreshed.

    Per step, with count c after the increment: mu = (1 − b1)·g + b1·mu,
    nu = (1 − b2)·g² + b2·nu, update = (mu / (1 − b1^c)) / (√(nu / (1 − b2^c))
    + eps) + weight_decay·p, p −= lr·update. With `mu_dtype` the first moment
    is stored in that dtype and the update uses the new f32 value, as optax
    does. Each group's `lr` is set by the caller before each step."""

    def __init__(self, masters: MasterWeights, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, mu_dtype: Optional[torch.dtype] = None):
        super().__init__(masters.masters, dict(lr=lr, peak_lr=lr, betas=betas, eps=eps,
                                               weight_decay=weight_decay))
        self.masters = masters
        self.mu_dtype = mu_dtype

    def zero_grad(self, set_to_none: bool = True) -> None:
        super().zero_grad(set_to_none)
        if self.masters.separate:
            for p in self.masters.copies:
                p.grad = None

    @torch.no_grad()
    def step(self, closure=None):
        self._update()
        self.masters.refresh()

    def _update(self) -> None:
        """AdamW's arithmetic on the optimizer's own parameters and their
        `.grad` (the masters here, one flat row under ZeRO-1)."""
        for group in self.param_groups:
            params: List[torch.Tensor] = group["params"]
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32)
                    state["mu"] = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                    state["nu"] = torch.zeros_like(p)
            states = [self.state[p] for p in params]
            count = int(states[0]["step"]) + 1
            for state in states:
                state["step"] += 1
            b1, b2 = group["betas"]
            grads = [p.grad for p in params]
            mus = [s["mu"] for s in states]
            nus = [s["nu"] for s in states]
            mu = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(mu, torch._foreach_mul(mus, b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                        1.0 - b2))
            torch._foreach_copy_(mus, mu)
            torch._foreach_div_(mu, 1.0 - b1 ** count)
            denom = torch._foreach_div(nus, 1.0 - b2 ** count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(mu, denom)
            del denom
            if group["weight_decay"]:
                torch._foreach_add_(mu, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(mu, -group["lr"])
            torch._foreach_add_(params, mu)

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        if self.mu_dtype is not None:  # the base class casts state to the params' dtype
            for state in self.state.values():
                state["mu"] = state["mu"].to(self.mu_dtype)


class Zero1AdamW(AdamW):
    """ZeRO-1 AdamW: the arithmetic of `AdamW` on this rank's row of the flat
    f32 masters, its moments at the row's shape (`shard_len(P, world)`
    elements each) for the whole run. `step` takes the full mean gradients
    on the masters' `.grad` (replicated), updates the row, gathers every
    rank's row back into the masters and refreshes the compute copy.

    Its `state_dict` gathers the unpadded flat moments from every rank, a
    collective every rank must call; `load_state_dict` takes this rank's row
    of them, so a checkpoint resumes at any world size (bit for bit at the
    same one)."""

    def __init__(self, masters: MasterWeights, mesh: DataMesh, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 mu_dtype: Optional[torch.dtype] = None):
        self.mesh = mesh
        self.total = flat_size(masters.masters)
        ref = masters.masters[0]
        self.shard = torch.zeros(shard_len(self.total, mesh.world_size), dtype=ref.dtype,
                                 device=ref.device)
        torch.optim.Optimizer.__init__(self, [self.shard], dict(
            lr=lr, peak_lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.masters = masters
        self.mu_dtype = mu_dtype

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.shard.grad = None
        for p in self.masters.masters + self.masters.copies:
            p.grad = None

    @torch.no_grad()
    def step(self, closure=None):
        masters = self.masters.masters
        self.shard.copy_(local_shard(self.mesh, masters))
        self.shard.grad = local_shard(self.mesh, [m.grad for m in masters])
        self._update()
        flat = gather_shards(self.mesh, self.shard, self.total)
        torch._foreach_copy_(masters, unflatten(flat, masters))
        self.shard.grad = None
        self.masters.refresh()

    def state_dict(self):
        out = super().state_dict()
        state = out["state"].get(0)
        if state:  # every rank's rows of the moments, unpadded (f32 on the wire)
            out["state"][0] = dict(state, **{
                k: all_gather(self.mesh, state[k].float())[:self.total].to(state[k].dtype)
                for k in ("mu", "nu")})
        out["zero1_total"] = self.total
        return out

    def load_state_dict(self, state_dict) -> None:
        total = state_dict.get("zero1_total")
        if total != self.total:
            raise ValueError(f"not a ZeRO-1 state of {self.total} elements "
                             f"(zero1_total {total}): resume with the optimizer that saved it")
        state_dict = dict(state_dict, state={
            i: dict(s, **{k: row(self.mesh, s[k].to(self.shard.device)) for k in ("mu", "nu")})
            for i, s in state_dict["state"].items()})
        state_dict.pop("zero1_total")
        super().load_state_dict(state_dict)


def make_finetune_optimizer(cfg: FineTuneConfig, masters: MasterWeights,
                            global_batch: int, zero1_mesh: Optional[DataMesh] = None) -> AdamW:
    """AdamW on `masters` at unet_lr × √global_batch (with `scale_lr`); the
    step sets the learning rate from the warmup before each update it applies
    and clips by the global norm first when `max_grad_norm` is set. With
    `zero1_mesh`, the `Zero1AdamW` of that mesh."""
    lr = cfg.unet_lr * (global_batch ** 0.5 if cfg.scale_lr else 1.0)
    kw = dict(betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
              weight_decay=cfg.weight_decay,
              mu_dtype=torch.bfloat16 if cfg.adam_mu_bf16 else None)
    if zero1_mesh is not None:
        return Zero1AdamW(masters, zero1_mesh, lr, **kw)
    return AdamW(masters, lr, **kw)


def complete_draws(mods: FineTunerModules, cfg: FineTuneConfig, batch: Dict[str, torch.Tensor],
                   draws: Optional[Dict[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """`draws` with every entry the step needs (`fill_draws`); missing ones
    come from `generator` (required then), on its device."""
    return fill_draws(mods.vae, cfg, batch, mods.schedule.num_train_timesteps, draws, generator)


def compute_losses(mods: FineTunerModules, cfg: FineTuneConfig, batch: Dict[str, torch.Tensor],
                   draws: Dict[str, torch.Tensor], mark: Callable[[str], None] = _no_mark):
    """(total loss, the loss terms) for one batch, differentiable in the
    student. `draws` must be complete (`complete_draws`)."""
    sched = mods.schedule
    with torch.no_grad():
        latents = encode_latents(mods.vae, batch, draws["vae_eps"])
        ehs = mods.text_encoder(batch["input_ids"])
        noise, noisy = noisy_latents(sched, cfg, latents, draws)
        timesteps = draws["timesteps"]
    mark("encode")
    with torch.no_grad():
        teacher_pred, teacher_feats = mods.teacher(noisy, timesteps, ehs, return_features=True)
    mark("teacher")
    student_pred, student_feats = mods.student(noisy, timesteps, ehs, return_features=True)
    mark("student")

    target = teacher_pred if cfg.self_distill_target else sched.target(latents, noise, timesteps)
    w = snr_weights(sched.alphas_cumprod_on(timesteps.device), timesteps, cfg.snr_gamma,
                    sched.prediction_type)
    d_loss = diffusion_loss(student_pred, target, w)
    distill = (student_pred.float() - teacher_pred.float()).square().mean()
    block = torch.stack([(student_feats[k].float() - teacher_feats[k].float()).square().mean()
                         for k in sorted(student_feats)]).mean()
    total = (cfg.diffusion_weight * d_loss
             + cfg.distillation_weight * distill
             + cfg.block_weight * block)
    mark("losses")
    return total, {"loss": total, "diffusion_loss": d_loss, "distillation_loss": distill,
                   "block_loss": block}


def make_finetune_step(mods: FineTunerModules, cfg: FineTuneConfig, optimizer: AdamW,
                       accum_steps: int = 1, zero1: bool = False,
                       mesh: Optional[DataMesh] = None) -> Callable:
    """The train step: step(batch, draws=None, generator=None, mark=...) ->
    metrics (the loss terms, `grad_norm` and `skipped`). It updates the
    student in place through `optimizer` (`make_finetune_optimizer`); after
    it the masters' `.grad` hold this step's mean gradient. A step whose loss
    or gradient norm is not finite is skipped: the masters, the compute copy
    and the optimizer state (its step count too) stay as they were, so the
    warmup does not advance. With a `mesh` the step is data parallel, and
    `zero1` (which needs the `Zero1AdamW` of that mesh) shards the moments
    (module docstring)."""
    if zero1 and (mesh is None or not isinstance(optimizer, Zero1AdamW)
                  or optimizer.mesh != mesh):
        raise ValueError("zero1 needs a mesh and make_finetune_optimizer(..., zero1_mesh=mesh)")
    if not zero1 and isinstance(optimizer, Zero1AdamW):
        raise ValueError("a Zero1AdamW steps only under zero1=True")
    return _step(mods, cfg, optimizer, accum_steps, zero1, mesh, None)


def _step(mods: FineTunerModules, cfg: FineTuneConfig, optimizer: AdamW, accum_steps: int,
          zero1: bool, mesh: Optional[DataMesh], tp: Optional[DpTpMesh]) -> Callable:
    """The step of `make_finetune_step` (`tp` None) and of
    `make_finetune_step_gspmd` (`mesh` its data axis)."""
    masters = optimizer.masters
    split = tp is not None and tp.model.distributed  # a model axis of one splits nothing
    norm = _tp_global_norm(mods.student, masters, tp) if split else _global_norm

    def step(batch, draws=None, generator=None, mark=_no_mark):
        optimizer.zero_grad(set_to_none=True)
        terms = []
        for mb, mb_draws in _micro_batches(batch, draws, accum_steps):
            mb_draws = (complete_draws(mods, cfg, mb, mb_draws, generator) if tp is None
                        else rank_draws(mods, cfg, mb, mb_draws, generator, tp))
            loss, aux = compute_losses(mods, cfg, mb, mb_draws, mark)
            loss.backward()
            masters.accumulate_grads()
            mark("backward")
            terms.append({k: v.detach() for k, v in aux.items()})
        grads = []
        for p in masters.masters:  # a parameter the loss does not reach gets a zero update
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if accum_steps > 1:
            torch._foreach_div_(grads, accum_steps)
        metrics = {k: sum(t[k] for t in terms) / accum_steps if accum_steps > 1 else terms[0][k]
                   for k in LOSS_TERMS}
        if mesh is not None:
            pmean_(mesh, grads)
            metrics = pmean_dict(mesh, metrics)
        gnorm = norm(grads)
        skipped = not bool(torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm))
        if not skipped:
            if zero1:
                if cfg.max_grad_norm:  # the clip on the full gradients, before sharding
                    torch._foreach_mul_(grads, torch.clamp(
                        cfg.max_grad_norm / (gnorm + 1e-12), max=1.0))
            elif cfg.max_grad_norm and not bool(gnorm < cfg.max_grad_norm):
                # optax.clip_by_global_norm: g / ‖g‖ · max_norm
                torch._foreach_div_(grads, gnorm)
                torch._foreach_mul_(grads, cfg.max_grad_norm)
            for group in optimizer.param_groups:
                group["lr"] = warmup_lr(cfg, group["peak_lr"], _applied_updates(optimizer, group))
            optimizer.step()
        mark("optimizer")
        return dict(metrics, grad_norm=gnorm, skipped=skipped)

    return step


def make_finetune_validation_step(mods: FineTunerModules, cfg: FineTuneConfig,
                                  mesh: Optional[DataMesh] = None) -> Callable:
    """Loss-only step for the held-out split: val(batch, draws=None,
    generator=None) -> the loss terms, with no gradient and no update; with
    a `mesh`, of this rank's rows, averaged over the ranks; with a
    `DpTpMesh`, of this rank's data rows with the global batch's draws
    (`rank_draws`), averaged over the data axis."""
    tp = mesh if isinstance(mesh, DpTpMesh) else None

    @torch.no_grad()
    def val(batch, draws=None, generator=None):
        if tp is None:
            draws = complete_draws(mods, cfg, batch, draws, generator)
        else:
            draws = rank_draws(mods, cfg, batch, draws, generator, tp)
        terms = compute_losses(mods, cfg, batch, draws)[1]
        if mesh is None:
            return terms
        return pmean_dict(mesh if tp is None else tp.data, terms)

    return val


def rank_draws(mods: FineTunerModules, cfg: FineTuneConfig, batch: Dict[str, torch.Tensor],
               draws: Optional[Dict[str, torch.Tensor]], generator: Optional[torch.Generator],
               mesh: DpTpMesh) -> Dict[str, torch.Tensor]:
    """This rank's data rows of the draws of the global batch (`batch` is
    this rank's rows of it, one of n_data equal parts): `draws` holds the
    global batch's rows, and what it lacks is drawn at the global batch's
    shapes from `generator`, which every rank seeds alike."""
    rows = batch["input_ids"].shape[0] * mesh.data.world_size
    if draws is None or any(k not in draws for k in ("vae_eps", "noise", "timesteps")):
        shapes = {k: torch.empty((rows, *v.shape[1:]), device="meta") for k, v in batch.items()}
        draws = complete_draws(mods, cfg, shapes, draws, generator)
    mine = rank_slice(mesh.data, rows)
    return {k: v[mine] for k, v in draws.items()}


def _tp_global_norm(student: GatedUNet, masters: MasterWeights, mesh: DpTpMesh) -> Callable:
    """norm(grads): the global gradient norm of a student sharded on the
    model axis: the split leaves' squares summed over the axis, each
    replicated leaf's counted once."""
    split = set(student.shard.split_keys)
    is_split = [name in split for name in masters.names]

    def norm(grads):
        sq = [torch.linalg.vector_norm(g.float()).square() for g in grads]
        zero = torch.zeros((), device=grads[0].device)
        split_sq = sum((s for s, t in zip(sq, is_split) if t), zero)
        replicated_sq = sum((s for s, t in zip(sq, is_split) if not t), zero)
        return torch.sqrt(psum(mesh.model, split_sq) + replicated_sq)

    return norm


def make_finetune_step_gspmd(mods: FineTunerModules, cfg: FineTuneConfig, optimizer: AdamW,
                             mesh: DpTpMesh, accum_steps: int = 1) -> Callable:
    """The 2-D data × model train step (the JAX package's GSPMD step):
    step(batch, draws=None, generator=None, mark=...) -> the metrics of
    `make_finetune_step`. `mods.student` and `mods.teacher` are sharded on
    the model axis of `mesh` (`parallel.tp.shard_unet`), `optimizer` holds
    the student's master shards, `batch` is this rank's data rows of the
    global batch and `draws` (one mapping per micro-batch) the global
    batch's; the semantics are the global batch's (module docstring)."""
    if isinstance(optimizer, Zero1AdamW):
        raise ValueError("the 2-D step runs AdamW on the master shards, without ZeRO-1")
    if getattr(mods.student, "shard", None) is None:
        raise ValueError("the 2-D step's student is a sharded U-Net (parallel.tp.shard_unet)")
    return _step(mods, cfg, optimizer, accum_steps, False, mesh.data, mesh)

