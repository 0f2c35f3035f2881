"""The port's data-parallel step on the CPU: two ranks (subprocesses with
torchrun's environment over localhost gloo, `tests/torch_port_parallel_worker.py`,
which imports torch and the port, never JAX) held against the JAX package's
mesh step, run here as its `make_local_*_step` under
`jax.vmap(axis_name=DATA_AXIS)` (tests/test_spmd_equivalence.py's emulation
of the mesh) with the same numpy weights (carried by `params_from_jax`) and
the same draws: rank r's from `fold_in(key, r)`, the shared ones from the
shared key, as the JAX step splits them (the JAX steps are compiled at XLA's
backend optimisation level 0: the same programs, in half the compile time).
Also: the launch, Sinkhorn over the
global batch, the contrastive gradient's DDP semantics, ZeRO-1 against the
replicated step, world size 1 against the one-process step, the replicas,
the skip of a NaN batch on every rank, and the three training entry points
at world size 2."""
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from diffusion_pruning_tpu.core.sinkhorn import sinkhorn as jax_sinkhorn
from diffusion_pruning_tpu.core.sinkhorn import sinkhorn_assign as jax_sinkhorn_assign
from diffusion_pruning_tpu.core.structure import build_structure as jax_build_structure
from diffusion_pruning_tpu.models.hypernet import HyperStructure as JaxHyperStructure
from diffusion_pruning_tpu.models.quantizer import StructureQuantizer as JaxQuantizer
from diffusion_pruning_tpu.models.text_encoders import CLIPTextConfig as JaxCLIPConfig
from diffusion_pruning_tpu.models.text_encoders import CLIPTextEncoder as JaxCLIP
from diffusion_pruning_tpu.models.unet import pruned as jax_pruned
from diffusion_pruning_tpu.models.unet.config import UNetConfig as JaxUNetConfig
from diffusion_pruning_tpu.models.unet.unet import GatedUNet as JaxGatedUNet
from diffusion_pruning_tpu.models.vae import AutoencoderKL as JaxVAE
from diffusion_pruning_tpu.models.vae import VAEConfig as JaxVAEConfig
from diffusion_pruning_tpu.parallel.mesh import DATA_AXIS
from diffusion_pruning_tpu.parallel.zero1 import init_opt_state
from diffusion_pruning_tpu.schedulers import DiffusionSchedule as JaxSchedule
from diffusion_pruning_tpu.training import finetuner as jax_ft
from diffusion_pruning_tpu.training import pruner as jax_pruner
from diffusion_pruning_tpu_torch.core import sinkhorn as port_sinkhorn
from diffusion_pruning_tpu_torch.losses import contrastive_loss
from diffusion_pruning_tpu_torch.training.pruner import LOSS_TERMS
from diffusion_pruning_tpu_torch.utils.checkpoint import CheckpointManager

from test_torch_port_finetune import PARAM_ATOL_LR, PARAM_MEAN_LR, _expert_arch, _port
from test_torch_port_training import (
    DEPTH_GRAD_RTOL,
    GRAD_ATOL_FRAC,
    GRAD_RTOL,
    LOSS_RTOL,
    PARAM_ATOL,
    _capture_grads,
    _jax_gumbel,
    _jax_trainables,
    _port_modules,
)
from torch_port_common import numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_parallel_worker.py")
WORLD = 2
WORKER_TIMEOUT = 420
FT_TERMS = ("loss", "diffusion_loss", "distillation_loss", "block_loss")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(job, out_dir, scenarios, world=WORLD, env=None):
    """Start `world` ranks of the worker with torchrun's environment."""
    os.makedirs(out_dir, exist_ok=True)
    job_path = os.path.join(out_dir, "job.pt")
    torch.save(job, job_path)
    port = free_port()
    procs = []
    for rank in range(world):
        e = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                 LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 OMP_NUM_THREADS="1")
        e.update(env or {})
        procs.append(subprocess.Popen([sys.executable, WORKER, job_path, out_dir, *scenarios],
                                      env=e, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs, out_dir


def finish(run, timeout=WORKER_TIMEOUT):
    """(exit codes, outputs) of a started run's ranks."""
    procs, _ = run
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"the ranks did not finish within {timeout} s")
    return [p.returncode for p in procs], outs


def results(run):
    """Each rank's results of a started run, which must have exited 0."""
    rcs, outs = finish(run)
    for rank, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {rank} exited {rc}:\n{out[-4000:]}"
    got = [torch.load(os.path.join(run[1], f"rank{r}.pt"), weights_only=False)
           for r in range(len(rcs))]
    assert not any(r["jax_imported"] for r in got), "a rank imported JAX"
    return got


def _take0(tree):
    return jax.tree.map(lambda x: x[0], tree)


def _split_rows(batch, world=WORLD):
    """Rank r's rows of a global numpy batch."""
    n = next(iter(batch.values())).shape[0] // world
    return [{k: v[r * n:(r + 1) * n] for k, v in batch.items()} for r in range(world)]


def _stack_rows(batch, world=WORLD):
    return {k: jnp.asarray(v.reshape(world, -1, *v.shape[1:])) for k, v in batch.items()}


# ---------------------------------------------------------------- the worlds

def _stage1_world():
    """test_torch_port_training's stage-1 modules and numpy weights."""
    ucfg = JaxUNetConfig.tiny(cross_attention_dim=32)
    spec = jax_build_structure(ucfg)
    model = JaxGatedUNet(ucfg)
    mods = jax_pruner.PrunerModules(
        unet=model, vae=JaxVAE(JaxVAEConfig.tiny()), text_encoder=JaxCLIP(JaxCLIPConfig.tiny()),
        hypernet=JaxHyperStructure(spec, input_dim=24),
        quantizer=JaxQuantizer(spec, n_e=4, base=3.0), schedule=JaxSchedule())
    res = ucfg.sample_size * 8

    def init(module, *args):
        shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
        return numpy_params(shapes["params"], seed=len(jax.tree_util.tree_leaves(shapes)))

    frozen = {"unet": numpy_params(jax.eval_shape(
                  lambda: model.init_params(jax.random.PRNGKey(0))), seed=3),
              "vae": init(mods.vae, jnp.zeros((1, res, res, 3)), jax.random.PRNGKey(0)),
              "text": init(mods.text_encoder, jnp.zeros((1, 77), jnp.int32))}
    trainable = {"hypernet": init(mods.hypernet, jnp.zeros((1, 24))),
                 "quantizer": jax.jit(mods.quantizer.init_params)(jax.random.PRNGKey(1))}
    world = (mods, frozen, trainable)
    port = _port_modules(world)
    weights = {name: {k: v.detach().clone() for k, v in mod.state_dict().items()}
               for name, mod in (("unet", port.unet), ("vae", port.vae),
                                 ("text", port.text_encoder), ("hypernet", port.hypernet),
                                 ("quantizer", port.quantizer))}
    return world, weights


def _stage1_batch(b, cached, seed):
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(0, 128, (b, 77)).astype(np.int32),
             "mpnet_embeddings": rng.standard_normal((b, 24), dtype=np.float32)}
    if cached:
        batch["latent_mean"] = rng.standard_normal((b, 8, 8, 4), dtype=np.float32)
        batch["latent_logvar"] = np.full((b, 8, 8, 4), -6.0, np.float32)
    else:
        batch["pixel_values"] = 0.5 * rng.standard_normal((b, 16, 16, 3), dtype=np.float32)
    return batch


def _stage1_draws(key, shared_key, b, spec, n_e):
    """`_compute_losses`' draws of one (micro-)batch from its keys
    (pruner.py:141; quantizer.py:115, 195)."""
    k_vae, k_noise, k_t, k_g, _, _ = jax.random.split(key, 6)
    k1, k2 = jax.random.split(shared_key)
    lat = (b, 8, 8, 4)
    return {"vae_eps": np.asarray(jax.random.normal(k_vae, lat)),
            "noise": np.asarray(jax.random.normal(k_noise, lat)),
            "timesteps": np.asarray(jax.random.randint(k_t, (b,), 0, 1000)),
            "gumbel": _jax_gumbel(k_g, b, spec), "codebook_gumbel": _jax_gumbel(k1, n_e, spec),
            "gates_gumbel": _jax_gumbel(k2, b, spec)}


def stage1_rank_draws(key, rank, local_b, accum, spec, n_e=4):
    """Rank `rank`'s draws of the JAX mesh step's key (pruner.py:306-313):
    its own from fold_in(key, rank), the quantizer's from the shared key.
    The JAX step draws the quantizer's gate noise from the shared key too,
    so every rank's rows get the same gate noise there; the port draws it
    per rank (`gates_gumbel`), and here it is handed the JAX values."""
    shared_key, k = jax.random.split(key)
    k = jax.random.fold_in(k, rank)
    if accum == 1:
        return _stage1_draws(k, shared_key, local_b, spec, n_e)
    return [_stage1_draws(ki, si, local_b // accum, spec, n_e)
            for ki, si in zip(jax.random.split(k, accum), jax.random.split(shared_key, accum))]


STAGE1_CASES = {
    # name: (pretrain, cached latents, accum_steps, rows per rank)
    "pretrain_cached_latents": (True, True, 1, 2),
    "codebook_pixels_accum_2": (False, False, 2, 4),
}
STAGE1_KEYS = (jax.random.PRNGKey(40), jax.random.PRNGKey(41))


def _ft_draws(key, b):
    """`_losses(…, key)`'s draws (finetuner.py:94-117)."""
    k_vae, k_noise, k_t, k_off, k_pert = jax.random.split(key, 5)
    lat = (b, 8, 8, 4)
    return {"vae_eps": np.asarray(jax.random.normal(k_vae, lat)),
            "noise": np.asarray(jax.random.normal(k_noise, lat)),
            "timesteps": np.asarray(jax.random.randint(k_t, (b,), 0, 1000)),
            "noise_offset": np.asarray(jax.random.normal(k_off, (b, 1, 1, 4))),
            "perturbation": np.asarray(jax.random.normal(k_pert, lat))}


def ft_rank_draws(key, rank, local_b, accum):
    k = jax.random.fold_in(key, rank)
    if accum == 1:
        return _ft_draws(k, local_b)
    return [_ft_draws(ki, local_b // accum) for ki in jax.random.split(k, accum)]


def _ft_world():
    """test_torch_port_finetune's world: the tiny teacher, its expert and the
    frozen VAE and CLIP, numpy weights."""
    ucfg = JaxUNetConfig.tiny(cross_attention_dim=32)
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
    world = (mods, frozen, jax_pruned.slice_expert_params(dense, plan), arch)
    port = _port(world)
    weights = {"teacher": port.teacher.state_dict(), "vae": port.vae.state_dict(),
               "text": port.text_encoder.state_dict()}
    return world, weights, port


def _ft_batch(b, seed):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 128, (b, 77)).astype(np.int32),
            "pixel_values": 0.5 * rng.standard_normal((b, 16, 16, 3), dtype=np.float32)}


FT_LOCAL_B = 2
FT_KEYS = (jax.random.PRNGKey(50), jax.random.PRNGKey(51))
FT_LR = 1e-4
# name: (config, accum_steps, the port's modes, whether the JAX reference is ZeRO-1)
FT_CASES = {
    "plain": (dict(), 1, ("mesh", "zero1"), False),
    # the bound sits below every step's gradient norm: both steps clip
    "accum_2_mu_bf16_clipped": (dict(adam_mu_bf16=True, max_grad_norm=0.05), 2,
                                ("mesh", "zero1"), True),
}
# the port alone, on a JAX case's batches and draws: name: (that case, config)
FT_PORT_CASES = {"accum_2_mu_bf16": ("accum_2_mu_bf16_clipped", dict(adam_mu_bf16=True))}
# trainables whose gradient in a step lies below this are at its f32 rounding floor
# (the gradients reach ~0.1); see the stage-1 step test
GRAD_FLOOR = 1e-6
SINKHORN_SCORES = np.random.default_rng(81).uniform(-1, 1, (WORLD * 5, 4)).astype(np.float32)


# ---------------------------------------------------------------- the references and the ranks

@pytest.fixture(scope="module")
def stage1_world():
    return _stage1_world()


@pytest.fixture(scope="module")
def ft_world():
    return _ft_world()


@pytest.fixture(scope="module")
def stage1_inputs(stage1_world):
    """Per case: each step's global batch and each rank's draws."""
    (jmods, _, _), _ = stage1_world
    spec = jmods.quantizer.spec
    out = {}
    for name, (pretrain, cached, accum, local_b) in STAGE1_CASES.items():
        out[name] = {"global_batch": WORLD * local_b, "accum": accum, "pretrain": pretrain,
                     "steps": [{"key": key, "pretrain": pretrain,
                                "batch": _stage1_batch(WORLD * local_b, cached, seed=60 + i),
                                "draws": [stage1_rank_draws(key, r, local_b, accum, spec)
                                          for r in range(WORLD)]}
                               for i, key in enumerate(STAGE1_KEYS)]}
    return out


@pytest.fixture(scope="module")
def ft_inputs():
    gb = WORLD * FT_LOCAL_B
    return {name: {"global_batch": gb, "accum": accum, "cfg": kw,
                   "steps": [{"key": key, "batch": _ft_batch(gb, seed=70 + i),
                              "draws": [ft_rank_draws(key, r, FT_LOCAL_B, accum)
                                        for r in range(WORLD)]}
                             for i, key in enumerate(FT_KEYS)]}
            for name, (kw, accum, _, _) in FT_CASES.items()}


def _stage1_reference(stage1_world, case):
    """(the JAX mesh step of a stage-1 case, vmapped over two devices, and
    its first arguments)."""
    (jmods, frozen, trainable), _ = stage1_world
    cfg = jax_pruner.PrunerConfig(lr_warmup_steps=0)
    opt = optax.chain(_capture_grads(),
                      jax_pruner.make_optimizer(cfg, global_batch=case["global_batch"]))
    p_actual = jmods.resource_model.actual_pruning_target(cfg.pruning_target)
    local = jax_pruner.make_local_pruner_step(jmods, cfg, opt, DATA_AXIS, WORLD,
                                              case["pretrain"], p_actual,
                                              accum_steps=case["accum"])
    step = jax.vmap(local, in_axes=(None, None, None, 0, None), axis_name=DATA_AXIS)
    first = case["steps"][0]
    return step, (trainable, frozen, opt.init(trainable), _stack_rows(first["batch"]),
                  first["key"])


def _stage1_run(compiled, args, case):
    tr, frozen, opt_state = args[:3]
    steps = []
    for s in case["steps"]:
        tr, opt_state, q_state, metrics, aux = compiled(tr, frozen, opt_state,
                                                        _stack_rows(s["batch"]), s["key"])
        tr, opt_state = _take0(tr), _take0(opt_state)
        steps.append({"metrics": _take0(metrics), "q_state": _take0(q_state),
                      "grads": opt_state[0],
                      "expert_indices": np.asarray(aux["expert_indices"]).reshape(-1),
                      "batch_resource_ratios":
                          np.asarray(aux["batch_resource_ratios"]).reshape(-1)})
    return {"steps": steps, "trainable": tr}


def _ft_reference(ft_world, name, case):
    (jmods, frozen, student_params, _), _, _ = ft_world
    zero1 = FT_CASES[name][3]
    jcfg = jax_ft.FineTuneConfig(lr_warmup_steps=0, unet_lr=FT_LR, **case["cfg"])
    jopt = jax_ft.make_finetune_optimizer(jcfg, global_batch=case["global_batch"],
                                          elementwise=zero1)
    local = jax_ft.make_local_finetune_step(jmods, jcfg, jopt, DATA_AXIS, zero1=zero1,
                                            axis_size=WORLD, accum_steps=case["accum"])
    step = jax.vmap(local, in_axes=(None, None, 0 if zero1 else None, 0, None),
                    axis_name=DATA_AXIS)
    params = jax.tree.map(jnp.asarray, student_params)
    if zero1:
        opt_state = jax.tree.map(lambda x: jnp.stack([x] * WORLD),
                                 init_opt_state(jopt, params, WORLD))
    else:
        opt_state = jopt.init(params)
    first = case["steps"][0]
    return step, (params, frozen, opt_state, _stack_rows(first["batch"]), first["key"])


def _ft_run(compiled, args, case, zero1):
    params, frozen, opt_state = args[:3]
    steps = []
    for s in case["steps"]:
        params, opt_state, metrics = compiled(params, frozen, opt_state,
                                              _stack_rows(s["batch"]), s["key"])
        params = _take0(params)
        if not zero1:
            opt_state = _take0(opt_state)
        steps.append({"metrics": _take0(metrics), "params": jax.tree.map(np.asarray, params)})
    return {"steps": steps, "global_batch": case["global_batch"]}


@pytest.fixture(scope="module")
def jax_refs(stage1_world, stage1_inputs, ft_world, ft_inputs):
    """The JAX mesh steps' outputs of every case. Each step is traced in this
    thread and compiled (XLA's backend optimisation level 0) in a second
    one while the next is traced."""
    plans = [("stage1", name, *_stage1_reference(stage1_world, case))
             for name, case in stage1_inputs.items()]
    plans += [("stage2", name, *_ft_reference(ft_world, name, case))
              for name, case in ft_inputs.items()]
    with ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(jax.jit(step).lower(*args).compile,
                               compiler_options={"xla_backend_optimization_level": 0})
                   for _, _, step, args in plans]
        compiled = [f.result() for f in futures]
    out = {"stage1": {}, "stage2": {}}
    for (kind, name, _, args), exe in zip(plans, compiled):
        out[kind][name] = (_stage1_run(exe, args, stage1_inputs[name]) if kind == "stage1"
                           else _ft_run(exe, args, ft_inputs[name], FT_CASES[name][3]))
    return out


@pytest.fixture(scope="module")
def stage1_jax(jax_refs):
    return jax_refs["stage1"]


@pytest.fixture(scope="module")
def ft_jax(jax_refs):
    return jax_refs["stage2"]


def _stage1_job(stage1_world, stage1_inputs, nan_case=True):
    _, weights = stage1_world
    cases = {}
    for name, case in stage1_inputs.items():
        cases[name] = {
            "global_batch": case["global_batch"], "accum": case["accum"],
            "cfg": dict(lr_warmup_steps=0),
            "steps": [{"pretrain": s["pretrain"], "batch": _split_rows(s["batch"]),
                       "draws": s["draws"]} for s in case["steps"]]}
    if nan_case:  # a good step, then NaN in rank 1's pixels
        src = cases["codebook_pixels_accum_2"]
        good, bad = src["steps"]
        rows = [dict(r) for r in bad["batch"]]
        rows[1]["pixel_values"] = rows[1]["pixel_values"].copy()
        rows[1]["pixel_values"][0, 0, 0, 0] = np.nan
        cases["nan_rank1"] = dict(src, steps=[good, dict(bad, batch=rows)])
    return {"weights": weights, "cases": cases}


def _ft_job(ft_world, ft_inputs):
    (_, _, _, arch), weights, _ = ft_world
    cases = {}
    for name, case in ft_inputs.items():
        cases[name] = {"global_batch": case["global_batch"], "accum": case["accum"],
                       "cfg": dict(lr_warmup_steps=0, unet_lr=FT_LR, **case["cfg"]),
                       "modes": FT_CASES[name][2],
                       "steps": [{"batch": _split_rows(s["batch"]), "draws": s["draws"]}
                                 for s in case["steps"]]}
    for name, (src, kw) in FT_PORT_CASES.items():
        cases[name] = dict(cases[src], cfg=dict(lr_warmup_steps=0, unet_lr=FT_LR, **kw))
    good, bad = cases["plain"]["steps"]
    rows = [dict(r) for r in bad["batch"]]
    rows[1]["pixel_values"] = rows[1]["pixel_values"].copy()
    rows[1]["pixel_values"][1, 2, 3, 0] = np.nan
    cases["nan_rank1"] = dict(cases["plain"], modes=("zero1", "mesh"),
                              steps=[good, dict(bad, batch=rows)])
    return {"weights": weights, "arch": arch, "cases": cases}


def _contrastive_job():
    rng = np.random.default_rng(80)
    return {"text": rng.standard_normal((WORLD * 3, 16), dtype=np.float32),
            "x": rng.standard_normal((WORLD * 3, 8), dtype=np.float32),
            "w": rng.standard_normal((8, 12), dtype=np.float32)}


def _world1_jobs(stage1_world, stage1_inputs, ft_world, ft_inputs):
    """Rank 0's rows and draws of the world-2 cases, each step run with
    mesh=None and on a mesh of one rank (and ZeRO-1 there for stage 2)."""
    s1 = _stage1_job(stage1_world, stage1_inputs, nan_case=False)
    for case in s1["cases"].values():
        case["modes"] = (None, "mesh")
        case["steps"] = [dict(s, batch=s["batch"][:1], draws=s["draws"][:1])
                         for s in case["steps"]]
    s2 = _ft_job(ft_world, ft_inputs)
    s2["cases"] = {k: dict(v, modes=("none", "mesh", "zero1"),
                           steps=[dict(s, batch=s["batch"][:1], draws=s["draws"][:1])
                                  for s in v["steps"]])
                   for k, v in s2["cases"].items() if k in ("plain", "accum_2_mu_bf16")}
    return {"stage1": s1, "stage2": s2}


def _yaml(src, path, **changes):
    with open(src) as f:
        cfg = yaml.safe_load(f)
    for key, value in changes.items():
        node = cfg
        *parents, last = key.split(".")
        for p in parents:
            node = node[p]
        node[last] = value
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return str(path)


def _cli_job(tmp):
    """tiny_smoke's prune and finetune YAMLs for the entry points' runs; the
    resumes' configs share their runs' names, so they share the run folders."""
    runs = tmp / "runs"
    prune_yaml = os.path.join(REPO, "configs", "pruning", "tiny_smoke.yaml")
    ft_yaml = os.path.join(REPO, "configs", "finetuning", "tiny_smoke.yaml")
    common = {"training.logging.logging_dir": str(runs),
              "training.logging.checkpoints_total_limit": 2,
              "training.hf_hub": {"push_to_hub": True}}
    stage1 = {"training.hypernet_pretraining_steps": 1, "training.validation_steps": 3}
    resume = {"training.logging.resume_from_checkpoint": "latest"}
    return {"root": str(runs),
            "prune": _yaml(prune_yaml, tmp / "p.yaml", **common, **stage1,
                           **{"training.max_train_steps": 3}),
            "prune_resume": _yaml(prune_yaml, tmp / "resume" / "p.yaml", **common, **stage1,
                                  **resume, **{"training.max_train_steps": 4}),
            "finetune": _yaml(ft_yaml, tmp / "f.yaml", **common, **{
                "training.max_train_steps": 2, "training.validation_steps": 2}),
            "finetune_resume": _yaml(ft_yaml, tmp / "resume" / "f.yaml", **common, **resume, **{
                "training.max_train_steps": 3, "training.validation_steps": 2}),
            "baseline": _yaml(ft_yaml, tmp / "b.yaml", **common, **{
                "training.max_train_steps": 2, "training.validation_steps": 2})}


@pytest.fixture(scope="module")
def started(tmp_path_factory, stage1_world, stage1_inputs, ft_world, ft_inputs):
    """Every run of the worker, started together before the JAX references
    are compiled: the two ranks over the step scenarios, one rank at world
    size 1, two ranks over the entry points, and rank 1 of 2 pointed at a
    master that never answers."""
    job = {"sinkhorn": {"scores": SINKHORN_SCORES}, "contrastive": _contrastive_job(),
           "stage1": _stage1_job(stage1_world, stage1_inputs),
           "stage2": _ft_job(ft_world, ft_inputs)}
    cli_tmp = tmp_path_factory.mktemp("cli")
    return {
        "ranks": start(job, str(tmp_path_factory.mktemp("ranks")),
                       ["launch", "sinkhorn", "contrastive", "stage1", "stage2"]),
        "world1": start(_world1_jobs(stage1_world, stage1_inputs, ft_world, ft_inputs),
                        str(tmp_path_factory.mktemp("world1")), ["stage1", "stage2"], world=1),
        "cli": start({"cli": _cli_job(cli_tmp)}, str(cli_tmp / "out"), ["cli"]),
        "unanswered": start({}, str(tmp_path_factory.mktemp("unanswered")), ["launch"],
                            world=1, env={"WORLD_SIZE": "2", "RANK": "1", "DP_TIMEOUT": "5"}),
    }


@pytest.fixture(scope="module")
def ranks(started, stage1_jax, ft_jax):
    """The two ranks' results over the step scenarios."""
    return results(started["ranks"])


# ---------------------------------------------------------------- 1. launch

def test_two_ranks_form_the_group_from_torchruns_environment(ranks):
    """An all_reduce, the all_gather's gloo route, `process_slice(10)`, each
    rank's place; the workers never imported JAX."""
    for r, res in enumerate(ranks):
        got = res["launch"]
        assert got["rank"] == r and got["world"] == WORLD and got["main"] == (r == 0)
        assert got["backend"] == "gloo" and got["all_reduce"] == 3.0
        np.testing.assert_array_equal(got["all_gather"], [0, 1, 2, 10, 11, 12])
    assert [res["launch"]["slice"] for res in ranks] == [(0, 5), (5, 10)]


def test_a_master_that_never_answers_raises_instead_of_running_alone(started):
    """Rank 1 of 2 pointed at a port nobody serves: `init_distributed` raises
    within its rendezvous timeout (5 s); the process writes no result."""
    rcs, outs = finish(started["unanswered"], timeout=120)
    assert rcs[0] != 0, outs[0][-2000:]
    assert "Error" in outs[0], outs[0][-2000:]
    assert not os.path.exists(os.path.join(started["unanswered"][1], "rank1.pt"))


# ---------------------------------------------------------------- 2. Sinkhorn

def test_sinkhorn_over_two_ranks_is_the_global_sinkhorn(ranks):
    """Each rank's rows equal JAX's `sinkhorn` over two vmapped shards and
    the port's one-process Sinkhorn over the concatenated scores; the
    assignments are equal."""
    scores = SINKHORN_SCORES
    got = np.concatenate([r["sinkhorn"]["q"] for r in ranks])
    shards = jnp.asarray(scores.reshape(WORLD, -1, 4))
    want = np.asarray(jax.vmap(lambda s: jax_sinkhorn(s, 0.05, 3, axis_name=DATA_AXIS,
                                                      axis_size=WORLD),
                               axis_name=DATA_AXIS)(shards)).reshape(-1, 4)
    one = port_sinkhorn.sinkhorn(torch.from_numpy(scores), 0.05, 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, one, rtol=1e-6, atol=1e-7)
    want_idx = np.asarray(jax.vmap(lambda s: jax_sinkhorn_assign(
        s, 0.05, 3, axis_name=DATA_AXIS, axis_size=WORLD), axis_name=DATA_AXIS)(shards))
    np.testing.assert_array_equal(np.concatenate([r["sinkhorn"]["assign"] for r in ranks]),
                                  want_idx.reshape(-1))
    np.testing.assert_array_equal(np.concatenate([r["sinkhorn"]["assign"] for r in ranks]),
                                  one.argmax(-1))


# ---------------------------------------------------------------- 3-4. stage 1

@pytest.mark.parametrize("case", sorted(STAGE1_CASES))
def test_stage1_steps_at_world_2_match_the_jax_mesh_step(ranks, stage1_jax, stage1_world,
                                                         stage1_inputs, case):
    """Two steps: the seven loss terms, the global expert indices and
    resource ratios, the snapshot, the grads of each step and the trainables
    after both, within test_torch_port_training's tolerances, on both ranks.
    A trainable whose gradient sits at the rounding floor in a step (below
    GRAD_FLOOR) is held as test_torch_port_finetune holds every parameter
    (PARAM_ATOL_LR of the learning rate): Adam's first step is
    lr·g/(|g| + 1e-8), so its step follows the rounding of g (reading: one
    hypernet entry of 3696 in the accumulation case, gradients 1.2e-8 and
    9.3e-9 between the packages, 3.2e-5 apart after two steps)."""
    (jmods, _, _), _ = stage1_world
    n_heads = len(jmods.hypernet.spec.width_list) + 1
    nw = jmods.quantizer.spec.num_width
    ref = stage1_jax[case]
    for r, res in enumerate(ranks):
        rows = res["stage1"][case]["mesh"]
        for i, (got, want) in enumerate(zip(rows, ref["steps"])):
            assert not got["skipped"]
            for name in LOSS_TERMS:
                np.testing.assert_allclose(got["metrics"][name], float(want["metrics"][name]),
                                           rtol=LOSS_RTOL, atol=1e-7,
                                           err_msg=f"rank {r} step {i} {name}")
            np.testing.assert_array_equal(got["expert_indices"], want["expert_indices"])
            np.testing.assert_allclose(got["batch_resource_ratios"],
                                       want["batch_resource_ratios"], rtol=1e-5)
            np.testing.assert_allclose(got["embedding_gs"],
                                       np.asarray(want["q_state"]["embedding_gs"]),
                                       rtol=1e-5, atol=1e-6)
            wg = _jax_trainables(want["grads"], n_heads)
            for name, g in got["grads"].items():
                w = wg[name]
                atol = GRAD_ATOL_FRAC * np.abs(w).max() + 1e-12
                if name == "codebook":
                    np.testing.assert_allclose(g[:, nw:], w[:, nw:], rtol=DEPTH_GRAD_RTOL,
                                               atol=atol, err_msg=f"rank {r} step {i} depth")
                    g, w = g[:, :nw], w[:, :nw]
                np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=atol,
                                           err_msg=f"rank {r} step {i} grad {name}")
        want_params = _jax_trainables(ref["trainable"], n_heads)
        grads = [_jax_trainables(s["grads"], n_heads) for s in ref["steps"]]
        lr = 2e-4 * stage1_inputs[case]["global_batch"] ** 0.5
        for name, p in rows[-1]["trainables"].items():
            floor = np.min([np.abs(g[name]) for g in grads], axis=0) < GRAD_FLOOR
            diff = np.abs(p - want_params[name])
            assert diff[~floor].max(initial=0) <= PARAM_ATOL, (r, name, diff[~floor].max(initial=0))
            assert diff[floor].max(initial=0) <= PARAM_ATOL_LR * lr, (r, name, diff[floor].max())


def test_contrastive_gradient_is_the_ddp_average(ranks):
    """The spliced gather's loss is the global one on each rank and its
    ranks' mean gradient the one-process gradient ÷ 2; a differentiable
    gather without the splice (the planted fault) reads the full gradient,
    2× the limit's."""
    c = _contrastive_job()
    w = torch.from_numpy(c["w"]).requires_grad_()
    loss, _ = contrastive_loss(torch.from_numpy(c["text"]),
                               torch.sigmoid(torch.from_numpy(c["x"]) @ w))
    loss.backward()
    full = w.grad.numpy()
    for res in ranks:
        got = res["contrastive"]
        np.testing.assert_allclose(got["spliced"]["loss"], float(loss.detach()), rtol=1e-6)
        np.testing.assert_allclose(got["spliced"]["grad"], full / WORLD, rtol=1e-5, atol=1e-8)
        fault = got["fault_differentiable_gather"]["grad"]
        assert not np.allclose(fault, full / WORLD, rtol=1e-2, atol=1e-8)
        np.testing.assert_allclose(fault, full, rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------- 5. stage 2

def _masters_close(got, want_params, port, lr, what):
    want = _ft_state(want_params, port)
    for name, p in got.items():
        diff = (p - want[name]).abs() / lr
        assert float(diff.max()) <= PARAM_ATOL_LR, (what, name, float(diff.max()))
        assert float(diff.mean()) <= PARAM_MEAN_LR, (what, name, float(diff.mean()))


def _ft_state(params, port):
    from diffusion_pruning_tpu_torch.models.convert import params_from_jax
    return params_from_jax(params, port.student)


@pytest.mark.parametrize("case", sorted(FT_CASES))
def test_stage2_steps_at_world_2_match_the_jax_mesh_step(ranks, ft_jax, ft_world, case):
    """Two steps, replicated and ZeRO-1: the loss terms and the masters after
    each step against the JAX mesh step (its ZeRO-1 step for the clipped
    case, whose replicated twin clips by the one-device formula), as
    test_torch_port_finetune holds them; each rank's moments hold
    shard_len(P, 2) elements under ZeRO-1."""
    _, _, port = ft_world
    ref = ft_jax[case]
    lr = FT_LR * ref["global_batch"] ** 0.5
    for r, res in enumerate(ranks):
        got = res["stage2"]
        for mode, rows in got[case].items():
            for i, (row, want) in enumerate(zip(rows, ref["steps"])):
                assert not row["skipped"]
                for name in FT_TERMS:
                    np.testing.assert_allclose(row["metrics"][name],
                                               float(want["metrics"][name]), rtol=1e-4,
                                               err_msg=f"rank {r} {mode} step {i} {name}")
                _masters_close(row["masters"], want["params"], port, lr, (r, mode, i))
                if mode == "zero1":
                    assert row["moment_numels"] == [got["shard_len"]] * 2
                    assert got["shard_len"] == -(-got["total"] // WORLD)


@pytest.mark.parametrize("case", ["plain", "accum_2_mu_bf16"])
def test_zero1_equals_the_replicated_step_bit_for_bit(ranks, case):
    """ZeRO-1 is a layout of the moments, not another algorithm: the masters
    and the metrics after each step equal the replicated step's bit for bit
    (without a clip, whose ZeRO-1 formula is the JAX package's other one)."""
    for res in ranks:
        rep, z1 = res["stage2"][case]["mesh"], res["stage2"][case]["zero1"]
        for i, (a, b) in enumerate(zip(rep, z1)):
            assert a["metrics"] == b["metrics"], i
            for name, t in a["masters"].items():
                assert torch.equal(t, b["masters"][name]), (case, i, name)


# ---------------------------------------------------------------- 7. replicas and skips

def test_replicas_stay_equal_bit_for_bit(ranks):
    """After every step of every case, rank 0's trainables (stage 1) and
    masters (stage 2) equal rank 1's, and so do the metrics."""
    a, b = ranks
    for case, modes in a["stage1"].items():
        for i, (x, y) in enumerate(zip(modes["mesh"], b["stage1"][case]["mesh"])):
            np.testing.assert_array_equal(list(x["metrics"].values()),
                                          list(y["metrics"].values()), err_msg=f"{case} {i}")
            for name in x["trainables"]:
                np.testing.assert_array_equal(x["trainables"][name], y["trainables"][name])
                np.testing.assert_array_equal(x["grads"][name], y["grads"][name])
    for case, modes in a["stage2"].items():
        if not isinstance(modes, dict):
            continue
        for mode, rows in modes.items():
            for i, (x, y) in enumerate(zip(rows, b["stage2"][case][mode])):
                np.testing.assert_array_equal(list(x["metrics"].values()),
                                              list(y["metrics"].values()),
                                              err_msg=f"{case} {mode} {i}")
                for name, t in x["masters"].items():
                    assert torch.equal(t, y["masters"][name]), (case, mode, i, name)


def test_a_nan_in_one_ranks_batch_skips_the_step_on_every_rank(ranks):
    """NaN in rank 1's pixels at step 2: both ranks skip; their trainables,
    masters, AdamW moments and warmup counts stay as step 1 left them."""
    for res in ranks:
        good, bad = res["stage1"]["nan_rank1"]["mesh"]
        assert not good["skipped"] and bad["skipped"]
        assert bad["applied"] == good["applied"] == [1, 1]
        for name in good["trainables"]:
            np.testing.assert_array_equal(bad["trainables"][name], good["trainables"][name])
        assert good["adam"]  # AdamW's moments after step 1
        for x, y in zip(good["adam"], bad["adam"]):
            np.testing.assert_array_equal(x, y)
        for mode, (good, bad) in res["stage2"]["nan_rank1"].items():
            assert not good["skipped"] and bad["skipped"], mode
            assert bad["applied"] == good["applied"] and set(good["applied"]) == {1}, mode
            for name, t in good["masters"].items():
                assert torch.equal(bad["masters"][name], t), (mode, name)
            for x, y in zip(good["moments"], bad["moments"]):
                assert torch.equal(x, y), mode


# ---------------------------------------------------------------- 6. world size 1

def test_world_1_mesh_steps_equal_the_one_process_steps_bit_for_bit(started):
    """One rank in a real gloo group: the stage-1 mesh step and the stage-2
    mesh step and ZeRO-1 step equal the mesh=None steps bit for bit on the
    same explicit draws (rank 0's rows and draws of the world-2 cases)."""
    (res,) = results(started["world1"])
    for case, modes in res["stage1"].items():
        for i, (x, y) in enumerate(zip(modes["none"], modes["mesh"])):
            assert x["metrics"] == y["metrics"], (case, i)
            np.testing.assert_array_equal(x["expert_indices"], y["expert_indices"])
            for name in x["trainables"]:
                np.testing.assert_array_equal(x["grads"][name], y["grads"][name])
                np.testing.assert_array_equal(x["trainables"][name], y["trainables"][name])
    for case, modes in res["stage2"].items():
        if not isinstance(modes, dict):
            continue
        for mode in ("mesh", "zero1"):
            for i, (x, y) in enumerate(zip(modes["none"], modes[mode])):
                assert x["metrics"] == y["metrics"], (case, mode, i)
                for name, t in x["masters"].items():
                    assert torch.equal(t, y["masters"][name]), (case, mode, i, name)
        assert modes["zero1"][0]["moment_numels"] == [res["stage2"]["total"]] * 2


# ---------------------------------------------------------------- 8. the entry points

def test_entry_points_at_world_2(started):
    """`cli.prune` for 3 steps and a resume to step 4, `cli.finetune` on its
    codebook (ZeRO-1, the default at world 2) for 2 steps and a resume to 3,
    and `cli.finetune_baseline` (magnitude, no ZeRO-1) for 2 steps, each on
    two ranks with `--device cpu`: rank 1 writes nothing under the runs'
    folder, rank 0 writes the run directories and checkpoints, the ranks'
    trainables and masters are equal bit for bit, each resume restores the
    saved state bit for bit, and the ZeRO-1 resume gives each rank its row
    of the saved moments. With `training.hf_hub.push_to_hub`, rank 0 alone
    uploads each prune and finetune run directory once its loop has ended
    (a fake `huggingface_hub`); the baseline entry point uploads nothing."""
    runs = os.path.join(os.path.dirname(started["cli"][1]), "runs")
    a, b = results(started["cli"])
    a, b = a["cli"], b["cli"]
    assert b["writes"] == [] and b["hub"] == []
    uploads = [c for c in a["hub"] if c[0] == "upload"]
    assert [c[1] for c in a["hub"] if c[0] == "create"] == ["dp", "dp", "dp-expert0",
                                                            "dp-expert0"]
    assert [c[2] for c in uploads] == [a["prune"]["run_dir"]] * 2 + [a["finetune"]["run_dir"]] * 2
    assert [max(f for f in c[3] if f.startswith("checkpoint-")) for c in uploads] == [
        "checkpoint-3", "checkpoint-4", "checkpoint-2", "checkpoint-3"]
    assert "README.md" in uploads[2][3]
    assert a["prune"]["run_dir"] == b["prune"]["run_dir"] == os.path.join(runs, "p", "dp")
    # prune
    ckpt = CheckpointManager(a["prune"]["run_dir"], create=False)
    assert ckpt.list_steps() == [3, 4] and a["prune"]["step"] == 3
    assert a["prune_resume"]["step"] == b["prune_resume"]["step"] == 4
    for run in ("prune", "prune_resume"):
        for name, t in a[run]["trainables"].items():
            np.testing.assert_array_equal(t, b[run]["trainables"][name])
    saved = ckpt.restore(3)
    for res in (a, b):
        got = res["prune_resume"]["resumed"]
        assert got["step"] == 3 and _diff(got["state"], saved) == []
    # finetune with ZeRO-1
    assert a["finetune"]["zero1"] == b["finetune"]["zero1"] == "Zero1AdamW"
    ft_ckpt = CheckpointManager(a["finetune"]["run_dir"], create=False)
    assert ft_ckpt.list_steps() == [2, 3]
    assert os.path.exists(os.path.join(a["finetune"]["run_dir"], "README.md"))
    for run in ("finetune", "finetune_resume"):
        for name, t in a[run]["masters"].items():
            assert torch.equal(t, b[run]["masters"][name]), (run, name)
    saved = ft_ckpt.restore(2)
    assert _diff(a["finetune"]["optimizer"], saved["optimizer"]) == []
    total = saved["optimizer"]["zero1_total"]
    per = -(-total // WORLD)
    for r, res in enumerate((a, b)):
        got = res["finetune_resume"]["resumed"]
        assert got["step"] == 2 and _diff(got["state"], saved) == []
        for k in ("mu", "nu"):
            row = saved["optimizer"]["state"][0][k][r * per:(r + 1) * per]
            local = got["local"][0][k]
            assert local.numel() == per
            assert torch.equal(local[:row.numel()].float(), row.float()), (r, k)
    # the baseline: data parallel, no ZeRO-1
    assert a["baseline"]["optimizer"] == b["baseline"]["optimizer"] == "AdamW"
    assert CheckpointManager(a["baseline"]["run_dir"], create=False).list_steps() == [2]
    for name, t in a["baseline"]["masters"].items():
        assert torch.equal(t, b["baseline"]["masters"][name]), name


def _diff(a, b, path=""):
    """Paths where two states (dicts, lists, tensors, numbers) differ."""
    if isinstance(a, dict):
        if sorted(a, key=str) != sorted(b, key=str):
            return [f"{path}: keys"]
        return [d for k in a for d in _diff(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{path}: length"]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in _diff(x, y, f"{path}/{i}")]
    if torch.is_tensor(a):
        return [] if torch.equal(a, b) else [path]
    return [] if a == b else [path]


# ---------------------------------------------------------------- the data layer's rank rows

@pytest.mark.parametrize("native", [False, True], ids=["pillow", "dpt_native"])
def test_loader_gives_each_rank_its_rows_of_the_global_batch(tmp_path, native):
    """`DataPipeline(rows=...)`: over two epochs each rank's batches are its
    rows of the one-process batches, bit for bit (random crops and flips,
    unreadable files replaced from the pool in either rank's rows), its
    captions alone tokenized; with Pillow only its own rows are decoded."""
    from diffusion_pruning_tpu_torch.data import datasets, loader
    from test_torch_port_data import write_coco
    if native:
        pytest.importorskip("dpt_native")
    root = write_coco(tmp_path / "coco", n_train=16, corrupt=(1, 6), missing=(11,))
    cols = datasets.load_coco_dataset(os.path.join(root, "images", "train2014"),
                                      os.path.join(root, "annotations", "captions_train2014.json"))
    tokenized = []

    def tok(caps):
        tokenized.append(len(caps))
        return np.asarray([[len(c), sum(map(ord, c)) % 997] for c in caps], np.int32)

    kw = dict(batch_size=4, resolution=24, train=True, seed=3, use_native=native,
              tokenize_clip=tok)
    whole = loader.DataPipeline(cols, **kw)
    want = [list(whole.epoch(e)) for e in (0, 1)]
    for rank in range(WORLD):
        tokenized.clear()
        pipe = loader.DataPipeline(cols, rows=slice(2 * rank, 2 * rank + 2), **kw)
        for e in (0, 1):
            got = list(pipe.epoch(e))
            assert len(got) == len(want[e]) == 4
            for g, w in zip(got, want[e]):
                for k in ("pixel_values", "input_ids", "captions"):
                    np.testing.assert_array_equal(g[k], w[k][2 * rank:2 * rank + 2], err_msg=k)
        assert set(tokenized) == {2}
        if not native:
            decoded = sum(pipe.decoded[k] for k in ("pillow", "resampled"))
            assert decoded == 2 * len(want[0]) * 2


def test_finetune_with_zero1_at_world_1_runs_on_a_mesh_of_one_process(tmp_path):
    """`optim.zero1: true` with no launch: the finetune entry point runs
    ZeRO-1 on a one-process mesh, its moments the whole flat masters."""
    from diffusion_pruning_tpu_torch.cli import finetune, prune
    from diffusion_pruning_tpu_torch.training.finetuner import Zero1AdamW
    prune_yaml = os.path.join(REPO, "configs", "pruning", "tiny_smoke.yaml")
    ft_yaml = os.path.join(REPO, "configs", "finetuning", "tiny_smoke.yaml")
    runs = {"training.logging.logging_dir": str(tmp_path / "runs")}
    p = prune.main(["--base_config_path", _yaml(prune_yaml, tmp_path / "p.yaml", **runs, **{
        "training.max_train_steps": 1}), "--device", "cpu", "--wandb_run_name", "z",
        "--pretrained_model_name_or_path", ""])
    loop = finetune.main(["--base_config_path", _yaml(ft_yaml, tmp_path / "f.yaml", **runs, **{
        "training.max_train_steps": 2, "training.optim.zero1": True}), "--device", "cpu",
        "--pretrained_model_name_or_path", "", "--pruning_ckpt_dir", p.run_dir,
        "--expert_id", "1"])
    opt = loop.optimizer
    assert isinstance(opt, Zero1AdamW) and loop.mesh.world_size == 1
    assert not loop.mesh.distributed and loop.global_step == 2
    total = sum(m.numel() for m in opt.masters.masters)
    assert [t.numel() for s in opt.state.values() for k, t in s.items() if k != "step"] == [
        total, total]
    assert loop.ckpt.restore(2)["optimizer"]["zero1_total"] == total
