"""The port's stage 2 (expert fine-tuning) on the CPU, held against the JAX
package's `training/finetuner.py` on the same inputs: the loss terms for the
same draws (made from the JAX keys exactly as the JAX step splits them), the
student's per-leaf gradients, the parameters after AdamW steps (clipping,
bf16 first moment, accumulation), the non-finite guard, the warmup, the
validation step, `FineTuneLoop`'s checkpoints, resume and EMA, the magnitude
and random arch vectors, and the three traps of training a physically pruned
student: storage shared with the teacher, the bf16 compute copy of f32
masters, and the fused conv's packed-weight cache. The tiny U-Net with a
32-wide cross-attention, as tests/test_finetuner.py; weights from numpy,
carried with `params_from_jax`; f32 on both sides."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pruning_tpu.core.structure import build_structure as jax_build_structure
from diffusion_pruning_tpu.models.hypernet import random_arch_vector as jax_random_arch_vector
from diffusion_pruning_tpu.models.text_encoders import CLIPTextConfig as JaxCLIPConfig
from diffusion_pruning_tpu.models.text_encoders import CLIPTextEncoder as JaxCLIP
from diffusion_pruning_tpu.models.unet import pruned as jax_pruned
from diffusion_pruning_tpu.models.unet.config import UNetConfig as JaxUNetConfig
from diffusion_pruning_tpu.models.unet.magnitude import magnitude_arch_vector as jax_magnitude
from diffusion_pruning_tpu.models.unet.unet import GatedUNet as JaxGatedUNet
from diffusion_pruning_tpu.models.vae import AutoencoderKL as JaxVAE
from diffusion_pruning_tpu.models.vae import VAEConfig as JaxVAEConfig
from diffusion_pruning_tpu.schedulers import DiffusionSchedule as JaxSchedule
from diffusion_pruning_tpu.training import finetuner as jax_ft
from diffusion_pruning_tpu_torch.core.structure import build_structure
from diffusion_pruning_tpu_torch.models.convert import params_from_jax
from diffusion_pruning_tpu_torch.models.hypernet import random_arch_vector
from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.unet.magnitude import magnitude_arch_vector
from diffusion_pruning_tpu_torch.models.unet.pruned import (
    expert_cuts,
    make_expert_plan,
    slice_expert_params,
)
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from diffusion_pruning_tpu_torch.pipelines.expert_server import build_expert
from diffusion_pruning_tpu_torch.schedulers import DiffusionSchedule
from diffusion_pruning_tpu_torch.training import finetuner as ft
from diffusion_pruning_tpu_torch.training.factory import build_student
from diffusion_pruning_tpu_torch.training.loop import FineTuneLoop, LoopConfig
from diffusion_pruning_tpu_torch.training.pruner import _applied_updates
from diffusion_pruning_tpu_torch.utils.checkpoint import load_torch_artifact

from torch_port_common import numpy_params

torch.set_num_threads(1)
B = 4
UCFG = dict(cross_attention_dim=32)
# loss terms: f32 on both sides, the same draws; op order differs (readings
# in the test's docstring)
LOSS_RTOL = 1e-4
# per-leaf gradients: ||port − jax|| / ||jax|| per leaf
GRAD_REL_L2 = 1e-4
# Parameters after AdamW steps, |port − jax| as a fraction of the learning
# rate. A relative comparison is meaningless here: Adam's first step is
# lr·g/(|g| + eps), so every entry moves by about lr whatever its gradient,
# and an entry whose gradient sits near the rounding floor takes a step set by
# its rounding. The absolute error is what a fraction of lr bounds. Readings
# over the step cases: any entry ≤ 0.117·lr (entries whose gradient is near
# eps = 1e-8, where g/(|g| + eps) follows the gradient's rounding), a leaf's
# mean ≤ 8.7e-4·lr (1.9e-3·lr with the bf16 first moment, whose rounding
# flips with it), the median leaf's 1e-5·lr.
PARAM_ATOL_LR = 0.25
PARAM_MEAN_LR = 1e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _expert_arch(spec):
    """tests/test_finetuner.py's expert: the first half of the width units
    closed, each site's first unit open, every depth gate open."""
    arch = np.ones(spec.vq_dim, np.float32)
    arch[: spec.num_width // 2] = 0.0
    for sb in spec.subblocks:
        for s in sb.sites:
            arch[s.start] = 1.0
    return arch


@pytest.fixture(scope="module")
def world():
    ucfg = JaxUNetConfig.tiny(**UCFG)
    spec = jax_build_structure(ucfg)
    teacher = JaxGatedUNet(ucfg)
    dense = numpy_params(jax.eval_shape(lambda: teacher.init_params(jax.random.PRNGKey(0))),
                         seed=3)
    arch = _expert_arch(spec)
    plan = jax_pruned.make_expert_plan(spec, arch)
    res = ucfg.sample_size * 8
    vae, text = JaxVAE(JaxVAEConfig.tiny()), JaxCLIP(JaxCLIPConfig.tiny())

    def init(module, *args, seed):
        shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
        return numpy_params(shapes["params"], seed=seed)

    frozen = {"teacher": dense,
              "vae": init(vae, jnp.zeros((1, res, res, 3)), jax.random.PRNGKey(0), seed=4),
              "text": init(text, jnp.zeros((1, 77), jnp.int32), seed=5)}
    mods = jax_ft.FineTunerModules(student=JaxGatedUNet(ucfg, plan=plan), teacher=teacher,
                                   vae=vae, text_encoder=text, schedule=JaxSchedule())
    return mods, frozen, jax_pruned.slice_expert_params(dense, plan), arch


def _port(world, **unet_overrides):
    """The port's modules on the same weights: the teacher, its expert
    student (`build_student`), the VAE and the text encoder."""
    jmods, frozen, _, arch = world
    teacher = GatedUNet(UNetConfig.tiny(**UCFG, **unet_overrides))
    teacher.load_state_dict(params_from_jax(frozen["teacher"], teacher))
    student = build_student(teacher, make_expert_plan(teacher.spec, arch))
    vae, text = AutoencoderKL(VAEConfig.tiny()), CLIPTextEncoder(CLIPTextConfig.tiny())
    vae.load_state_dict(params_from_jax(frozen["vae"], vae))
    text.load_state_dict(params_from_jax(frozen["text"], text))
    return ft.FineTunerModules(student=student, teacher=teacher.eval(), vae=vae.eval(),
                               text_encoder=text.eval(), schedule=DiffusionSchedule())


def _bf16_copy_optimizer(cfg, student, global_batch):
    """The optimizer as the finetune entry point builds it for a bf16
    compute copy: f32 masters taken from the student, then the student cast."""
    masters = ft.MasterWeights(student, separate=True)
    student.to(torch.bfloat16)
    return ft.make_finetune_optimizer(cfg, masters, global_batch)


def _batch(cached=False, b=B, seed=12):
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(0, 128, (b, 77)).astype(np.int32)}
    if cached:
        batch["latent_mean"] = rng.standard_normal((b, 8, 8, 4), dtype=np.float32)
        batch["latent_logvar"] = np.full((b, 8, 8, 4), -6.0, np.float32)
    else:  # the tiny VAE downsamples by 2: 8×8 latents
        batch["pixel_values"] = 0.5 * rng.standard_normal((b, 16, 16, 3), dtype=np.float32)
    return batch


def _port_batch(batch):
    return {k: _t(v).long() if k == "input_ids" else _t(v) for k, v in batch.items()}


def _jax_draws(key, b=B):
    """The draws of `_losses(…, key)`, split as the JAX step splits them
    (finetuner.py:94-117)."""
    k_vae, k_noise, k_t, k_off, k_pert = jax.random.split(key, 5)
    lat = (b, 8, 8, 4)
    return {"vae_eps": _t(jax.random.normal(k_vae, lat)),
            "noise": _t(jax.random.normal(k_noise, lat)),
            "timesteps": _t(jax.random.randint(k_t, (b,), 0, 1000)).long(),
            "noise_offset": _t(jax.random.normal(k_off, (b, 1, 1, 4))),
            "perturbation": _t(jax.random.normal(k_pert, lat))}


def _step_draws(key, accum):
    """One step's draws: its key, or one split key per micro-batch."""
    if accum == 1:
        return _jax_draws(key)
    return [_jax_draws(k, B // accum) for k in jax.random.split(key, accum)]


def _student_state(mods):
    return {k: v.detach().clone() for k, v in mods.student.state_dict().items()}


def _jax_student_state(tree, mods):
    return params_from_jax(jax.tree.map(np.asarray, tree), mods.student)


VARIANTS = {
    "default": (dict(), False),
    "noise_offset": (dict(noise_offset=0.1), False),
    "input_perturbation": (dict(input_perturbation=0.1), False),
    "self_distill_target": (dict(self_distill_target=True), False),
    "latent_moments": (dict(), True),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_losses_and_grads_match_jax(world, variant):
    """The four loss terms and the student's per-leaf gradients of one batch
    against `jax.value_and_grad` of the JAX `_losses` with the same draws.
    Readings: loss terms within 6.1e-7 relative, per-leaf gradients within
    1.9e-6 relative L2."""
    jmods, frozen, student_params, _ = world
    overrides, cached = VARIANTS[variant]
    jcfg, cfg = jax_ft.FineTuneConfig(**overrides), ft.FineTuneConfig(**overrides)
    batch = _batch(cached)
    key = jax.random.PRNGKey(20)
    (_, want), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_ft._losses(jmods, jcfg, p, frozen, {k: jnp.asarray(v)
                                                          for k, v in batch.items()}, key),
        has_aux=True))(student_params)
    mods = _port(world)
    loss, got = ft.compute_losses(mods, cfg, _port_batch(batch), _jax_draws(key))
    loss.backward()
    got = {k: v.detach() for k, v in got.items()}
    for name in ft.LOSS_TERMS:
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=LOSS_RTOL,
                                   err_msg=name)
    want_grads = _jax_student_state(want_grads, mods)
    for name, p in mods.student.named_parameters():
        w = want_grads[name]
        err = float((p.grad - w).norm() / (w.norm() + 1e-30))
        assert err <= GRAD_REL_L2, (name, err)


STEP_CASES = {
    "plain": dict(),
    "clipped": dict(max_grad_norm=0.05),
    "adam_mu_bf16": dict(adam_mu_bf16=True),
    "accum_2": dict(accum_steps=2),
    "weight_decay": dict(weight_decay=0.1),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_finetune_steps_match_jax(world, case):
    """Two steps of each case against the JAX step (`make_finetune_step`, no
    mesh) from the same parameters with the same draws: the loss terms of each
    step and the parameters after the first and the second update, each entry
    within PARAM_ATOL_LR of lr and each leaf's mean within PARAM_MEAN_LR. The
    clipped case's bound (0.05) sits below every step's gradient norm
    (0.4-0.6), so both steps clip."""
    jmods, frozen, student_params, _ = world
    kw = dict(STEP_CASES[case])
    accum = kw.pop("accum_steps", 1)
    jcfg = jax_ft.FineTuneConfig(lr_warmup_steps=0, unet_lr=1e-4, **kw)
    cfg = ft.FineTuneConfig(lr_warmup_steps=0, unet_lr=1e-4, **kw)
    jopt = jax_ft.make_finetune_optimizer(jcfg, global_batch=B)
    jstep = jax_ft.make_finetune_step(jmods, jcfg, jopt, mesh=None, accum_steps=accum)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree.map(jnp.asarray, student_params)
    opt_state = jopt.init(params)

    mods = _port(world)
    opt = ft.make_finetune_optimizer(cfg, ft.MasterWeights(mods.student), B)
    assert opt.param_groups[0]["peak_lr"] == pytest.approx(1e-4 * B ** 0.5)
    step = ft.make_finetune_step(mods, cfg, opt, accum_steps=accum)
    lr = opt.param_groups[0]["peak_lr"]
    for i, key in enumerate((jax.random.PRNGKey(30), jax.random.PRNGKey(31))):
        params, opt_state, want = jstep(params, frozen, opt_state, jbatch, key)
        got = step(_port_batch(batch), _step_draws(key, accum))
        assert not got["skipped"]
        if case == "clipped":
            assert float(got["grad_norm"]) > cfg.max_grad_norm
        for name in ft.LOSS_TERMS:
            np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {name}")
        want_state = _jax_student_state(params, mods)
        for name, p in mods.student.named_parameters():
            diff = (p.detach() - want_state[name]).abs() / lr
            assert float(diff.max()) <= PARAM_ATOL_LR, (i, name, float(diff.max()))
            assert float(diff.mean()) <= PARAM_MEAN_LR, (i, name, float(diff.mean()))
    if case == "adam_mu_bf16":
        assert all(s["mu"].dtype == torch.bfloat16 and s["nu"].dtype == torch.float32
                   for s in opt.state.values())


def test_non_finite_step_leaves_weights_and_optimizer_state_untouched(world):
    """A NaN in the batch: the step reports `skipped`, and the weights and
    the optimizer state (its step count too) are bit for bit what they were
    after the last good step."""
    mods = _port(world)
    cfg = ft.FineTuneConfig(lr_warmup_steps=0)
    opt = ft.make_finetune_optimizer(cfg, ft.MasterWeights(mods.student), B)
    step = ft.make_finetune_step(mods, cfg, opt)
    gen = torch.Generator().manual_seed(0)
    batch = _port_batch(_batch())
    assert not step(batch, generator=gen)["skipped"]
    weights = _student_state(mods)
    state = {k: {n: v.clone() for n, v in s.items()} for k, s in enumerate(opt.state.values())}
    bad = dict(batch, pixel_values=batch["pixel_values"].clone())
    bad["pixel_values"][0, 0, 0, 0] = float("nan")
    metrics = step(bad, generator=gen)
    assert metrics["skipped"] and not torch.isfinite(metrics["loss"])
    for name, v in mods.student.state_dict().items():
        assert torch.equal(v, weights[name]), name
    for k, s in enumerate(opt.state.values()):
        for n, v in s.items():
            assert torch.equal(v, state[k][n]), (k, n)


def test_warmup_counts_applied_updates_only(world):
    """lr = peak · applied / warmup before each applied update: a skipped
    step does not advance it, as the optax schedule's count under the JAX step's
    guard. Draws missing from `draws` come from the generator, and without
    one the step raises."""
    mods = _port(world)
    cfg = ft.FineTuneConfig(lr_warmup_steps=4, unet_lr=1e-4, scale_lr=False)
    opt = ft.make_finetune_optimizer(cfg, ft.MasterWeights(mods.student), B)
    step = ft.make_finetune_step(mods, cfg, opt)
    gen = torch.Generator().manual_seed(0)
    batch = _port_batch(_batch())
    bad = dict(batch, pixel_values=batch["pixel_values"] * float("nan"))
    lrs = []
    for b in (bad, batch, bad, batch, batch):
        skipped = step(b, generator=gen)["skipped"]
        lrs.append((skipped, _applied_updates(opt, opt.param_groups[0]),
                     opt.param_groups[0]["lr"]))
    assert lrs == [(True, 0, pytest.approx(1e-4)), (False, 1, 0.0), (True, 1, 0.0),
                   (False, 2, pytest.approx(2.5e-5)), (False, 3, pytest.approx(5e-5))]
    with pytest.raises(ValueError, match="draws lack"):
        step(batch)


def test_validation_step_gives_the_step_losses_without_updating(world):
    mods = _port(world)
    cfg = ft.FineTuneConfig()
    batch = _port_batch(_batch(cached=True))
    draws = _jax_draws(jax.random.PRNGKey(40))
    before = _student_state(mods)
    val = ft.make_finetune_validation_step(mods, cfg)(batch, draws)
    for name, v in mods.student.state_dict().items():
        assert torch.equal(v, before[name])
    opt = ft.make_finetune_optimizer(cfg, ft.MasterWeights(mods.student), B)
    metrics = ft.make_finetune_step(mods, cfg, opt)(batch, draws)
    for name in ft.LOSS_TERMS:
        assert float(val[name]) == pytest.approx(float(metrics[name]), rel=1e-6)


def test_data_parallel_branches_raise(world):
    """ZeRO-1 without a mesh, or without the mesh's `Zero1AdamW`, and a
    `Zero1AdamW` outside ZeRO-1, raise; the 2-D data × model step at a 1 × 1
    mesh (a student sharded on a model axis of one) equals the one-process
    step bit for bit."""
    from diffusion_pruning_tpu_torch.parallel.mesh import data_mesh
    from diffusion_pruning_tpu_torch.parallel.tp import dp_tp_mesh, shard_unet
    mods = _port(world)
    cfg = ft.FineTuneConfig()
    opt = ft.make_finetune_optimizer(cfg, ft.MasterWeights(mods.student), B)
    with pytest.raises(ValueError, match="zero1 needs a mesh"):
        ft.make_finetune_step(mods, cfg, opt, zero1=True)
    with pytest.raises(ValueError, match="zero1 needs a mesh"):
        ft.make_finetune_step(mods, cfg, opt, zero1=True, mesh=data_mesh("cpu"))
    z1 = ft.make_finetune_optimizer(cfg, ft.MasterWeights(mods.student), B,
                                    zero1_mesh=data_mesh("cpu"))
    with pytest.raises(ValueError, match="Zero1AdamW"):
        ft.make_finetune_step(mods, cfg, z1)
    batch, draws = _port_batch(_batch()), _jax_draws(jax.random.PRNGKey(40))
    runs = {}
    for name in ("one_process", "gspmd_1x1"):
        m = _port(world)
        if name == "gspmd_1x1":
            mesh = dp_tp_mesh(1, 1, "cpu")
            m.student, m.teacher = shard_unet(m.student, mesh), shard_unet(m.teacher, mesh)
        o = ft.make_finetune_optimizer(cfg, ft.MasterWeights(m.student), B)
        step = (ft.make_finetune_step(m, cfg, o) if name == "one_process"
                else ft.make_finetune_step_gspmd(m, cfg, o, mesh))
        runs[name] = (step(batch, draws), o.masters.state_dict())
    (m1, p1), (m2, p2) = runs["one_process"], runs["gspmd_1x1"]
    assert {k: float(v) for k, v in m1.items()} == {k: float(v) for k, v in m2.items()}
    assert list(p1) == list(p2) and all(torch.equal(p1[k], p2[k]) for k in p1)


# ---------------------------------------------------------------- the loop

class _Recorder:
    """A step that records the masters after each update."""

    def __init__(self, step, opt):
        self.step, self.opt, self.after = step, opt, []

    def __call__(self, batch, generator=None):
        out = self.step(batch, generator=generator)
        self.after.append({n: m.detach().clone() for n, m in self.opt.masters.state_dict().items()})
        return out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone() if torch.is_tensor(tree) else tree


def _loop(world, tmp_path, steps, resume=None, ema=None):
    mods = _port(world)
    cfg = ft.FineTuneConfig(lr_warmup_steps=1, unet_lr=1e-3)
    opt = ft.make_finetune_optimizer(cfg, ft.MasterWeights(mods.student), 2)
    step = _Recorder(ft.make_finetune_step(mods, cfg, opt), opt)
    lc = LoopConfig(max_train_steps=steps, checkpoints_total_limit=2, log_every=1,
                    validation_steps=2, resume_from=resume)
    loop = FineTuneLoop(step, ft.make_finetune_validation_step(mods, cfg), opt, lc,
                        str(tmp_path), arch_vector=world[3], seed=7, ema_decay=ema)
    return mods, loop, step


def _batches(_epoch=0):
    for i in range(3):
        yield _batch(b=2, seed=50 + i)


def test_finetune_loop_checkpoints_resume_bit_for_bit_with_ema(world, tmp_path):
    """Two steps with EMA (decay 0.5), validation at step 2, checkpoint-2
    with `arch_vector.pt` (the expert's arch) beside it; a new loop resumed
    from `latest` restores the masters, the optimizer state and the EMA bit
    for bit, and runs on to step 3 (the epoch's end); rotation keeps 2
    checkpoints, and a loop resumed from step 2 by number restores it. The
    EMA is e ← 0.5·e + 0.5·p after each update, from the initial weights, as
    the JAX loop's."""
    _, loop, rec = _loop(world, tmp_path, 2, ema=0.5)
    start = {n: m.detach().clone() for n, m in loop.masters.state_dict().items()}
    loop.train(_batches, lambda: iter([_batch(b=2, seed=60)]))
    assert loop.global_step == 2 and loop.ckpt.list_steps() == [2]
    for name, e in loop.ema.items():
        want = (start[name] * 0.5 + rec.after[0][name] * 0.5) * 0.5 + rec.after[1][name] * 0.5
        assert torch.equal(e, want), name
    saved = torch.load(os.path.join(loop.ckpt.dir_for(2), "state", "state.pt"), weights_only=True)
    np.testing.assert_array_equal(
        load_torch_artifact(os.path.join(loop.ckpt.dir_for(2), "arch_vector.pt")).numpy(),
        world[3])
    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 3 and "val_loss" in lines[2]

    _, loop2, _ = _loop(world, tmp_path, 3, resume="latest", ema=0.5)
    restored = {}
    real = loop2.maybe_resume

    def resume():  # the state right after the restore, before any step
        real()
        restored.update(_clone(loop2.state_dict()))
    loop2.maybe_resume = resume
    loop2.train(_batches)
    assert restored["step"] == 2 and restored["skipped_steps"] == 0
    for part in ("student", "ema"):
        for name, v in saved[part].items():
            assert torch.equal(restored[part][name], v), (part, name)
    want_opt, got_opt = saved["optimizer"], restored["optimizer"]
    assert want_opt["param_groups"] == got_opt["param_groups"]
    for k, s in want_opt["state"].items():
        for n, v in s.items():
            assert torch.equal(got_opt["state"][k][n], v), (k, n)
    assert loop2.global_step == 3 and loop2.ckpt.list_steps() == [2, 3]
    _, loop3, _ = _loop(world, tmp_path, 3, resume="2")
    loop3.maybe_resume()
    assert loop3.global_step == 2
    for name, v in saved["student"].items():
        assert torch.equal(loop3.masters.state_dict()[name], v), name


def test_resume_without_ema_in_the_checkpoint_starts_the_ema_from_the_restored_weights(
        world, tmp_path):
    _, loop, _ = _loop(world, tmp_path, 1)
    loop.train(_batches)
    _, loop2, _ = _loop(world, tmp_path, 1, resume="latest", ema=0.9)
    loop2.maybe_resume()
    for name, e in loop2.ema.items():
        assert torch.equal(e, loop2.masters.state_dict()[name])


# ---------------------------------------------------------------- baselines' arch vectors

@pytest.mark.parametrize("random", [False, True], ids=["magnitude", "random"])
@pytest.mark.parametrize("ratio", [0.3, 0.6])
def test_magnitude_arch_vector_matches_jax(world, random, ratio):
    """The same arch vector as the JAX package's from the same weights (the
    port's diffusers state dict, float64, against the flax tree, f32), in
    both modes; the kept count is round(ratio · num_width) plus the sites
    that would keep none."""
    _, frozen, _, _ = world
    spec = jax_build_structure(JaxUNetConfig.tiny(**UCFG))
    teacher = GatedUNet(UNetConfig.tiny(**UCFG))
    teacher.load_state_dict(params_from_jax(frozen["teacher"], teacher))
    want = jax_magnitude(spec, frozen["teacher"], ratio, random=random, seed=3)
    got = magnitude_arch_vector(teacher.spec, teacher.state_dict(), ratio, random=random, seed=3)
    assert got.shape == (1, spec.vq_dim) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got[0, : spec.num_width] >= 0.5).sum() >= round(ratio * spec.num_width)


def test_random_arch_vector_invariants():
    """⌊ratio · width⌋ units at 0.9 a group, the rest 0, depth gates 0.9; the
    same generator seed repeats, another differs; the JAX vector has the same
    per-group counts (its bits come from a PRNG key torch cannot repeat)."""
    spec = build_structure(UNetConfig.sd21())
    jspec = jax_build_structure(JaxUNetConfig.sd21())
    a = random_arch_vector(spec, 0.6, torch.Generator().manual_seed(0))
    assert a.shape == (1, spec.vq_dim)
    want = np.asarray(jax_random_arch_vector(jax.random.PRNGKey(0), jspec, 0.6))
    start = 0
    for w in spec.width_list:
        col = a[0, start:start + w]
        assert bool(((col == 0) | torch.isclose(col, torch.tensor(0.9))).all())
        assert int((col > 0.5).sum()) == int(0.6 * w) == int((want[0, start:start + w] > 0.5).sum())
        start += w
    assert torch.allclose(a[0, spec.num_width:], torch.tensor(0.9))
    assert torch.equal(a, random_arch_vector(spec, 0.6, torch.Generator().manual_seed(0)))
    assert not torch.equal(a, random_arch_vector(spec, 0.6, torch.Generator().manual_seed(1)))


# ---------------------------------------------------------------- the three traps

def test_student_owns_its_storage_and_the_teacher_stays_unchanged(world):
    """Trap 1. `slice_expert_params` hands back the dense tensors themselves
    for the leaves it does not cut: a student assembled from it over the
    teacher's storage is refused. The student of `build_student` owns every
    tensor: after a step the teacher's state dict equals its state before,
    bit for bit, and the student's uncut leaves have moved."""
    mods = _port(world)
    plan = make_expert_plan(mods.teacher.spec, world[3])
    shared = build_expert(mods.teacher.cfg, plan,
                          slice_expert_params(mods.teacher.state_dict(), plan))
    with pytest.raises(ValueError, match="shares the teacher's storage"):
        dataclasses.replace(mods, student=shared.requires_grad_(True))
    teacher = {k: v.clone() for k, v in mods.teacher.state_dict().items()}
    student = _student_state(mods)
    cfg = ft.FineTuneConfig(lr_warmup_steps=0)
    opt = ft.make_finetune_optimizer(cfg, ft.MasterWeights(mods.student), B)
    ft.make_finetune_step(mods, cfg, opt)(_port_batch(_batch()), _jax_draws(jax.random.PRNGKey(1)))
    for k, v in mods.teacher.state_dict().items():
        assert torch.equal(v, teacher[k]), k
    cut = set(expert_cuts(plan))
    uncut = [k for k in student if k not in cut]
    assert "conv_in.weight" in uncut and "down_blocks.0.attentions.0.proj_in.weight" in uncut
    for k in uncut:
        assert not torch.equal(mods.student.state_dict()[k], student[k]), k


def test_bf16_compute_copy_follows_the_f32_masters(world):
    """Trap 2, on the CPU. With compute_dtype=bf16 the student's parameters
    are a bf16 copy and the optimizer holds f32 masters: the gradients reach
    the masters in f32, the masters take updates below a bf16 ulp, and after
    each step the copy is the masters rounded to bf16."""
    mods = _port(world)
    cfg = ft.FineTuneConfig(lr_warmup_steps=0, unet_lr=1e-6, scale_lr=False)
    opt = _bf16_copy_optimizer(cfg, mods.student, B)
    masters = opt.masters
    assert masters.separate and all(p.dtype == torch.bfloat16 for p in mods.student.parameters())
    assert all(m.dtype == torch.float32 for m in masters.masters)
    before = [m.clone() for m in masters.masters]
    step = ft.make_finetune_step(mods, cfg, opt)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        assert not step(_port_batch(_batch()), generator=gen)["skipped"]
        assert all(m.grad is not None and m.grad.dtype == torch.float32 for m in masters.masters)
        for m, p in zip(masters.masters, masters.copies):
            assert p.grad is None and torch.equal(p.detach(), m.bfloat16())
    moved = [(m - b).abs().max() for m, b in zip(masters.masters, before)]
    assert all(0 < d <= 3e-6 for d in moved)


def test_master_weights_take_the_f32_values_before_the_cast(world):
    """`MasterWeights` records the student's parameters and, when separate,
    f32 clones of their values; it casts nothing, and refuses a student that
    was cast before the masters took its f32 values."""
    mods = _port(world)
    values = [p.detach().clone() for p in mods.student.parameters()]
    masters = ft.MasterWeights(mods.student, separate=True)
    assert all(p.dtype == torch.float32 for p in mods.student.parameters())
    assert all(torch.equal(m, v) and m.data_ptr() != c.data_ptr()
               for m, v, c in zip(masters.masters, values, masters.copies))
    shared = ft.MasterWeights(mods.student)
    assert not shared.separate and shared.masters is shared.copies
    mods.student.to(torch.bfloat16)
    assert all(c.dtype == torch.bfloat16 for c in masters.copies)
    with pytest.raises(ValueError, match="take f32 values"):
        ft.MasterWeights(mods.student, separate=True)


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16], ids=["f32", "bf16_copy"])
def test_fused_conv_packed_weights_follow_every_update(world, compute_dtype):
    """Trap 3. Under `fused_norm_conv` each conv keeps a packed copy of its
    weight keyed by the weight's version counter. After two updates (in
    place on f32 weights, or the bf16 copy refreshed from its masters) the
    student's output equals, bit for bit, that of a fresh student built from
    its current weights; a refresh through `.data` would leave the first
    step's packed weights in place."""
    mods = _port(world, fused_norm_conv=True)
    cfg = ft.FineTuneConfig(lr_warmup_steps=0, unet_lr=1e-2)
    opt = (_bf16_copy_optimizer(cfg, mods.student, B) if compute_dtype == torch.bfloat16
           else ft.make_finetune_optimizer(cfg, ft.MasterWeights(mods.student), B))
    step = ft.make_finetune_step(mods, cfg, opt)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(70)
    x = _t(rng.standard_normal((2, 8, 8, 4), dtype=np.float32))
    ehs = _t(rng.standard_normal((2, 77, 32), dtype=np.float32))
    t = torch.tensor([10, 700])
    for _ in range(2):
        step(_port_batch(_batch()), generator=gen)
        with torch.no_grad():
            mods.student(x, t, ehs)  # packs the weights of this step
    with torch.device("meta"):
        fresh = GatedUNet(mods.student.cfg, plan=mods.student.plan)
    fresh.load_state_dict({k: v.clone() for k, v in mods.student.state_dict().items()},
                          assign=True)
    with torch.no_grad():
        assert torch.equal(mods.student(x, t, ehs), fresh(x, t, ehs))
