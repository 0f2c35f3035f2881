"""The port's tensor parallelism on the CPU (`parallel/tp.py`), held against
the JAX package's single-device counterparts (`mesh=None`) with the same
numpy weights (carried by `params_from_jax`); `tests/test_tp.py` holds the
JAX GSPMD path against the same single-device functions.

(a) the split rules against JAX `unet_param_specs`, and (b) shard then
gather, run in this process. The rest runs in one launch of four gloo ranks
(subprocesses with torchrun's environment, `tests/torch_port_tp_worker.py`,
which imports torch and the port, never JAX) as a 2 × 2 data × model mesh,
started before the JAX references are compiled: (c) the sharded U-Net's
forward, dense with a soft arch and an expert with odd kept widths and a
site of one head (a rank with zero heads there), plain and under
`fused_norm_conv` (the plain versions of the fused ops here; JAX's unfused
U-Net, the same function, as the reference); (d) `shard_pipeline` at CFG
with DDIM-3 on given latents and routing noise; (e) `ExpertServer.
from_codebook` on it against the one-process server (which
`test_torch_port_experts.py` holds against the JAX server); (f) one
`make_finetune_step_gspmd` step on the expert student with the JAX draws
against JAX `make_finetune_step(mesh=None)`; (g) `cli.finetune` with
`optim.tensor_parallel: 2` on the four ranks for 2 steps and a resume, its
checkpoint against a one-process run's at the same global batch; (h) a
tensor_parallel that does not divide the world raises."""
import multiprocessing
import os
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from diffusion_pruning_tpu.core.estimators import FIXED_KEY, sample_gumbel as jax_sample_gumbel
from diffusion_pruning_tpu.core.structure import build_structure as jax_build_structure
from diffusion_pruning_tpu.models import text_encoders as jax_te
from diffusion_pruning_tpu.models.hypernet import HyperStructure as JaxHyperStructure
from diffusion_pruning_tpu.models.quantizer import StructureQuantizer as JaxQuantizer
from diffusion_pruning_tpu.models.unet import pruned as jax_pruned
from diffusion_pruning_tpu.models.unet.config import UNetConfig as JaxUNetConfig
from diffusion_pruning_tpu.models.unet.unet import GatedUNet as JaxGatedUNet
from diffusion_pruning_tpu.models.vae import AutoencoderKL as JaxVAE
from diffusion_pruning_tpu.models.vae import VAEConfig as JaxVAEConfig
from diffusion_pruning_tpu.parallel.tp import MODEL_AXIS, unet_param_specs
from diffusion_pruning_tpu.pipelines import PruningPipeline as JaxPipeline
from diffusion_pruning_tpu.training import finetuner as jax_ft
from diffusion_pruning_tpu_torch.cli import finetune as finetune_cli
from diffusion_pruning_tpu_torch.models import text_encoders as te
from diffusion_pruning_tpu_torch.models.convert import params_from_jax
from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.unet.pruned import make_expert_plan, slice_expert_params
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from diffusion_pruning_tpu_torch.parallel.tp import (
    gather_params,
    local_index,
    shard_params,
    split_keys,
    tp_plan,
    unit_range,
)
from diffusion_pruning_tpu_torch.pipelines.expert_server import build_expert
from diffusion_pruning_tpu_torch.utils.checkpoint import CheckpointManager, save_torch_artifact

from test_torch_port_finetune import LOSS_RTOL, PARAM_ATOL_LR, PARAM_MEAN_LR
from test_torch_port_parallel import (
    FT_LR,
    FT_TERMS,
    _ft_batch,
    _ft_draws,
    _ft_world,
    _masters_close,
    _yaml,
    finish,
    free_port,
)
from torch_port_common import numpy_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_tp_worker.py")
WORLD, N_MODEL = 4, 2
B = 4                 # the global batch: 2 rows a data rank
UCFG = dict(cross_attention_dim=32)
RTOL = ATOL = 1e-4    # tests/test_tp.py's
STEPS = 3
# AdamW moments after 3 steps of the entry point, 2 × 2 against one process:
# the gradients differ by the order of f32 sums
MOMENT_RTOL = 1e-3
FINETUNE_YAML = os.path.join(REPO, "configs", "finetuning", "tiny_smoke.yaml")
CLI_EXPERT = 2


# ---------------------------------------------------------------- the weights

def _jax_unet():
    ucfg = JaxUNetConfig.tiny(**UCFG)
    model = JaxGatedUNet(ucfg)
    params = numpy_params(jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0))),
                          seed=3)
    return ucfg, model, params


def _expert_arch(spec):
    """Odd kept counts: 3 of 8 norm2 groups, 3 of 4 GEGLU groups and of 4
    heads; fewer units than model ranks (one) at every attn1, at level 0's
    attn2 and at the first resnet and feed-forward; the first depth-gated
    subblock dropped."""
    arch = np.zeros(spec.vq_dim, np.float32)
    arch[spec.num_width:] = 1.0
    arch[spec.num_width] = 0.0
    first = set()
    for sb in spec.subblocks:
        for s in sb.sites:
            one = s.kind == "attn1" or s.width == 2 or s.kind not in first
            first.add(s.kind)
            keep = 1 if one else 3
            arch[s.start + np.arange(s.width)[-keep:]] = 1.0
    return arch


@pytest.fixture(scope="module")
def world():
    ucfg, model, params = _jax_unet()
    spec = jax_build_structure(ucfg)
    port = GatedUNet(UNetConfig.tiny(**UCFG))
    port.load_state_dict(params_from_jax(params, port))
    rng = np.random.default_rng(21)
    inputs = {"sample": rng.standard_normal((B, 8, 8, 4), dtype=np.float32),
              "timesteps": np.asarray([0, 10, 500, 999]),
              "ehs": rng.standard_normal((B, 77, 32), dtype=np.float32),
              "arch": rng.uniform(0.0, 1.0, (B, spec.vq_dim)).astype(np.float32)}
    return {"model": model, "params": params, "spec": spec, "port": port.eval(),
            "expert_arch": _expert_arch(spec), "inputs": inputs}


# ---------------------------------------------------------------- (a), (b)

def _markers(params, specs):
    """Each leaf JAX splits as arange along its split axis (broadcast), every
    replicated leaf as zeros."""
    def leaf(x, spec):
        x = np.asarray(x)
        axes = [i for i, a in enumerate(tuple(spec)) if a == MODEL_AXIS]
        if not axes:
            return np.zeros_like(x)
        shape = [1] * x.ndim
        shape[axes[0]] = x.shape[axes[0]]
        return np.broadcast_to(np.arange(x.shape[axes[0]], dtype=np.float32).reshape(shape),
                               x.shape).copy()
    return jax.tree.map(leaf, params, specs, is_leaf=lambda s: isinstance(s, P))


def _varying_dims(t):
    return [d for d in range(t.dim()) if t.shape[d] > 1 and not bool(
        (t == t.select(d, 0).unsqueeze(d)).all())]


def test_split_rules_follow_the_jax_specs(world):
    """Every leaf JAX puts on MODEL_AXIS is split here on the matching
    dimension (kernels are (in, out) against the weight's (out, in), conv
    kernels HWIO against OIHW); what JAX replicates stays replicated, except
    three rows: norm2 (its statistics are per group, and the port splits its
    groups whole where XLA would gather the channels), the column-parallel
    biases of conv1, time_emb_proj and the GEGLU projection (JAX gives a spec
    to kernels only and lets XLA slice a replicated bias; here a bias goes
    with its output channels), and the GEGLU projection's unit: both halves'
    matching slices, where JAX's contiguous block would give model rank 0
    the whole linear half at tp = 2."""
    port = world["port"]
    markers = params_from_jax(_markers(world["params"], unet_param_specs(world["params"])),
                              port)
    keys = split_keys(tp_plan(port))
    jax_split = {k: _varying_dims(v) for k, v in markers.items() if _varying_dims(v)}
    assert jax_split and set(jax_split) <= set(keys)
    for k, dims in jax_split.items():
        assert dims == [keys[k][1]], (k, dims, keys[k])
    extra = sorted(set(keys) - set(jax_split))
    suffixes = {"norm2.weight", "norm2.bias", "conv1.bias", "time_emb_proj.bias",
                "ff.net.0.proj.bias"}
    assert extra and all(any(k.endswith(s) for s in suffixes) for k in extra), extra
    assert {s for s in suffixes if any(k.endswith(s) for k in extra)} == suffixes
    for k, v in port.state_dict().items():  # replicated rows: every other leaf, the norms too
        if k not in keys:
            assert not _varying_dims(markers[k]), k
    site, dim, halves = keys["down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj.weight"]
    assert halves and dim == 0
    inner = site.units * site.unit
    mine = local_index(site, 0, N_MODEL, halves).tolist()
    assert mine == list(range(inner // 2)) + list(range(inner, inner + inner // 2))
    assert mine != list(range(inner))  # JAX's contiguous block: the linear half alone


def _expert(world):
    port = world["port"]
    plan = make_expert_plan(port.spec, world["expert_arch"])
    return build_expert(port.cfg, plan, slice_expert_params(port.state_dict(), plan))


@pytest.mark.parametrize("which", ["dense", "expert"])
def test_shard_then_gather_gives_back_the_state_dict(world, which):
    """shard_params for each model rank, then gather_params: the state dict
    bit for bit; the expert's shards are uneven (3 of 8 groups split 2 + 1)
    and some hold no unit of a site (one head at tp = 2: 1 + 0), their
    tensors zero-width."""
    unet = world["port"] if which == "dense" else _expert(world)
    plan = tp_plan(unet)
    sd = unet.state_dict()
    shards = [shard_params(sd, r, N_MODEL, plan) for r in range(N_MODEL)]
    back = gather_params(shards, plan)
    assert list(back) == list(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k]), k
    widths = {(s.name, s.kind): [unit_range(s.units, r, N_MODEL) for r in range(N_MODEL)]
              for s in plan}
    if which == "expert":
        assert any(r[1][0] == r[1][1] for r in widths.values())          # a zero-width shard
        assert any((r[0][1] - r[0][0]) != (r[1][1] - r[1][0]) for r in widths.values())
        empty = [k for k, v in shards[1].items() if v.numel() == 0]
        for part in (".conv1.weight", ".attn1.to_q.weight", ".ff.net.2.weight"):
            assert any(k.endswith(part) for k in empty), part
    else:
        assert all(r[0][1] - r[0][0] == r[1][1] - r[1][0] for r in widths.values())


# ---------------------------------------------------------------- the four ranks

def _pipeline_world():
    """test_torch_port_pipeline's tiny routed pipeline in both packages."""
    ucfg = JaxUNetConfig.tiny(**UCFG)
    spec = jax_build_structure(ucfg)
    unet, text = JaxGatedUNet(ucfg), jax_te.CLIPTextEncoder(jax_te.CLIPTextConfig.tiny())
    vae, hypernet = JaxVAE(JaxVAEConfig.tiny()), JaxHyperStructure(spec, input_dim=32)
    quantizer = JaxQuantizer(spec, n_e=4, base=0.0)

    def init(module, *args):
        shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
        return numpy_params(shapes["params"], seed=len(jax.tree_util.tree_leaves(shapes)))

    unet_p = numpy_params(jax.eval_shape(lambda: unet.init_params(jax.random.PRNGKey(0))))
    text_p = init(text, jnp.zeros((1, 77), jnp.int32))
    vae_p = init(vae, jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(0))
    hn_p = init(hypernet, jnp.zeros((1, 32)))
    q_p = jax.jit(quantizer.init_params)(jax.random.PRNGKey(1))
    q_s = jax.jit(quantizer.init_state)(q_p)
    jp = JaxPipeline(unet=unet, unet_params=unet_p, vae=vae, vae_params=vae_p,
                     text_encoder=text, text_params=text_p, hypernet=hypernet,
                     hypernet_params=hn_p, quantizer=quantizer, quantizer_params=q_p,
                     quantizer_state=q_s)
    pu = GatedUNet(UNetConfig.tiny(**UCFG))
    mods = {"unet": pu, "vae": AutoencoderKL(VAEConfig.tiny()),
            "text": te.CLIPTextEncoder(te.CLIPTextConfig.tiny()),
            "hypernet": HyperStructure(pu.spec, input_dim=32),
            "quantizer": StructureQuantizer(pu.spec, n_e=4, base=0.0)}
    trees = {"unet": unet_p, "vae": vae_p, "text": text_p, "hypernet": hn_p,
             "quantizer": {"embedding": np.asarray(q_p["embedding"]),
                           "embedding_gs": np.asarray(q_s["embedding_gs"])}}
    weights = {}
    for name, mod in mods.items():
        mod.load_state_dict(params_from_jax(trees[name], mod))
        weights[name] = mod.state_dict()
    return jp, weights, spec


def _route_noise(spec, n):
    kw, kd = jax.random.split(FIXED_KEY)
    return np.concatenate([np.asarray(jax_sample_gumbel(kw, (n, spec.num_width))),
                           np.asarray(jax_sample_gumbel(kd, (n, spec.num_depth)))], axis=1)


def _requests(seed, n, spec):
    rng = np.random.default_rng(seed)
    return {"ids": rng.integers(0, 128, (n, 77)).astype(np.int32),
            "neg": rng.integers(0, 128, (n, 77)).astype(np.int32),
            "latents": rng.standard_normal((n, 8, 8, 4), dtype=np.float32),
            "noise": _route_noise(spec, n), "steps": STEPS}


def _cli_configs(tmp):
    """tiny_smoke's finetune YAML at tensor_parallel 2 (2 steps, then a
    resume to 3 sharing the run's name), one at 3 (no divisor of 4), and the
    one-process twins of the first two at the same global batch (2 rows × 2
    data ranks)."""
    common = {"training.logging.checkpoints_total_limit": 3,
              "training.validation_steps": 2, "training.logging.logging_dir": str(tmp / "runs")}
    tp2 = {"training.optim.tensor_parallel": 2}
    return {"run": _yaml(FINETUNE_YAML, tmp / "f.yaml", **common, **tp2,
                         **{"training.max_train_steps": 2}),
            "resume": _yaml(FINETUNE_YAML, tmp / "resume" / "f.yaml", **common, **tp2, **{
                "training.max_train_steps": 3,
                "training.logging.resume_from_checkpoint": "latest"}),
            "tp3": _yaml(FINETUNE_YAML, tmp / "t3.yaml", **common,
                         **{"training.optim.tensor_parallel": 3}),
            **{name: _yaml(FINETUNE_YAML, tmp / name / "f.yaml", **{
                **common, **more, "training.logging.logging_dir": str(tmp / "one_runs"),
                "data.dataloader.train_batch_size": 4})
               for name, more in (("one_process", {"training.max_train_steps": 2}),
                                  ("one_process_resume", {
                                      "training.max_train_steps": 3,
                                      "training.logging.resume_from_checkpoint": "latest"}))}}


def _jax_ft_step():
    """The JAX single-device step (`make_local_finetune_step` with no axis,
    compiled at XLA's backend optimisation level 0) on the global batch of
    `_ft_world`: the parameters after it and its metrics, as numpy."""
    (jmods, frozen, student_params, _), _, _ = _ft_world()
    jcfg = jax_ft.FineTuneConfig(lr_warmup_steps=0, unet_lr=FT_LR)
    jopt = jax_ft.make_finetune_optimizer(jcfg, global_batch=B)
    sparams = jax.tree.map(jnp.asarray, student_params)
    fbatch = {k: jnp.asarray(v) for k, v in _ft_batch(B, seed=90).items()}
    args = (sparams, frozen, jopt.init(sparams), fbatch, jax.random.PRNGKey(91))
    step = _compile(jax_ft.make_local_finetune_step(jmods, jcfg, jopt, None), *args)
    params_after, _, metrics = step(*args)
    return {"params": jax.tree.map(np.asarray, params_after),
            "metrics": {k: float(v) for k, v in metrics.items()}}


@pytest.fixture(scope="module")
def ft_reference():
    """The stage-2 world and the JAX step's result (a future): its compile
    is the file's longest, so it runs in a process of its own (no shared
    GIL), started before the rest of the setup."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    future = pool.submit(_jax_ft_step)
    yield _ft_world(), future
    pool.shutdown()


@pytest.fixture(scope="module")
def setup(tmp_path_factory, world, ft_reference):
    """The job (weights, inputs, the entry points' configs and a stage-1
    folder whose codebook row CLI_EXPERT is `_expert_arch`'s expert), and
    the four ranks started on it."""
    tmp = tmp_path_factory.mktemp("tp")
    stage1 = tmp / "stage1"  # the finetune entry point reads its quantizer_embeddings.pt
    os.makedirs(stage1)
    codes = np.ones((4, world["spec"].vq_dim), np.float32)
    codes[CLI_EXPERT] = world["expert_arch"]
    save_torch_artifact(codes, str(stage1 / "quantizer_embeddings.pt"))
    stage1 = str(stage1)
    jp, pipe_weights, spec = _pipeline_world()
    (ft_world, ft_weights, ft_port), _ = ft_reference
    arch = ft_world[3]
    batch, draws = _ft_batch(B, seed=90), _ft_draws(jax.random.PRNGKey(91), B)
    cli = dict(_cli_configs(tmp), stage1=stage1, expert=CLI_EXPERT)
    job = {"unet": world["port"].state_dict(), "expert_arch": world["expert_arch"],
           "forward": world["inputs"],
           "pipeline": {"weights": pipe_weights, **_requests(31, B, spec),
                        "server": _requests(32, 6, spec)},
           "finetune": {**ft_weights, "arch": arch, "cfg": dict(lr_warmup_steps=0, unet_lr=FT_LR),
                        "global_batch": B, "batch": batch, "draws": draws},
           "cli": cli}
    out_dir = tmp / "ranks"
    os.makedirs(out_dir)
    job_path = str(out_dir / "job.pt")
    torch.save(job, job_path)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, job_path, str(out_dir)],
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 OMP_NUM_THREADS="1"),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    return {"procs": (procs, str(out_dir)), "job": job, "jax_pipe": jp, "ft_port": ft_port}


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture(scope="module")
def jax_refs(setup, world, ft_reference):
    """The JAX single-device references, the U-Net forwards compiled at XLA's
    backend optimisation level 0, in threads while the ranks run."""
    model, params, inp = world["model"], world["params"], world["inputs"]
    spec = world["spec"]
    jplan = jax_pruned.make_expert_plan(spec, world["expert_arch"])
    expert = JaxGatedUNet(model.cfg, plan=jplan)
    x, t, e, a = (jnp.asarray(inp[k]) for k in ("sample", "timesteps", "ehs", "arch"))
    plans = {
        "dense": (lambda p, x, t, e, a: model.apply({"params": p}, x, t, e, arch=a),
                  (params, x, t, e, a)),
        "expert": (lambda p, x, t, e: expert.apply({"params": p}, x, t, e),
                   (jax_pruned.slice_expert_params(params, jplan), x, t, e))}
    with ThreadPoolExecutor(2) as pool:
        pipeline = pool.submit(_jax_pipeline_images, setup["jax_pipe"], setup["job"]["pipeline"])
        futures = {k: pool.submit(_compile, fn, *args) for k, (fn, args) in plans.items()}
        out = {k: np.asarray(f.result()(*plans[k][1])) for k, f in futures.items()}
        out["pipeline"] = pipeline.result()
    out["finetune"] = ft_reference[1].result()
    return out


def _jax_pipeline_images(jp, p):
    """The JAX pipeline's routed CFG images on the job's ids and latents."""
    pe, ne = jp.encode_prompt(jnp.asarray(p["ids"])), jp.encode_prompt(jnp.asarray(p["neg"]))
    arch, idx = jp.route(pe)
    latents = jp._denoise_fn(STEPS, 7.5, True)(jp.unet_params, jnp.concatenate([ne, pe]), arch,
                                               jnp.asarray(p["latents"]))
    return {"images": np.asarray(jp.decode(latents)), "indices": np.asarray(idx)}


@pytest.fixture(scope="module")
def ranks(setup, jax_refs):
    """Each rank's results (the ranks must exit 0 and import no JAX)."""
    run = setup["procs"]
    rcs, outs = finish(run)
    for rank, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {rank} exited {rc}:\n{out[-4000:]}"
    got = [torch.load(os.path.join(run[1], f"rank{r}.pt"), weights_only=False)
           for r in range(WORLD)]
    assert not any(r["jax_imported"] for r in got), "a rank imported JAX"
    assert [r["coords"] for r in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    return got


# ---------------------------------------------------------------- (c) - (h)

@pytest.mark.parametrize("flag", ["plain", "fused_norm_conv"])
@pytest.mark.parametrize("which", ["dense", "expert"])
def test_tp_forward_matches_jax_single_device(ranks, jax_refs, world, flag, which):
    """At 2 × 2 every rank returns the whole batch within tests/test_tp.py's
    rtol and atol of the JAX single-device U-Net; the collective gather of
    every shard is the unsharded state dict bit for bit; one reduction a
    row-parallel output (3 a transformer, 1 a resnet); the expert has a site
    where model rank 1 holds no head."""
    want = jax_refs[which]
    subs = list(tp_plan(world["port"] if which == "dense" else _expert(world)))
    n_reductions = (sum(1 for s in subs if s.kind == "resnet")
                    + sum(1 for s in subs if s.kind == "ff") * 3)
    for r, res in enumerate(ranks):
        got = res["forward"][(flag, which)]
        np.testing.assert_allclose(got["out"].numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"rank {r}")
        assert got["gather_differs_at"] == []
        assert got["reductions"] == n_reductions
        if which == "expert" and res["coords"][1] == 1:
            assert any(n == 0 for (_, kind), n in got["units"].items() if kind == "attn1")


def test_sharded_pipeline_matches_jax_single_device(ranks, jax_refs):
    """`shard_pipeline` at CFG 7.5, DDIM-3, on given latents and routing
    noise: every rank returns the whole batch, routed to the JAX pipeline's
    experts, its images within RTOL/ATOL of the JAX images and of rank 0's;
    the pipeline carries the mesh."""
    want = jax_refs["pipeline"]
    first = ranks[0]["pipeline"]["images"]
    for r, res in enumerate(ranks):
        got = res["pipeline"]
        assert got["mesh_kept"] and got["unet_sharded"]
        np.testing.assert_array_equal(got["indices"].numpy(), want["indices"])
        np.testing.assert_allclose(got["images"].numpy(), want["images"], rtol=RTOL, atol=ATOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got["images"].numpy(), first.numpy(), rtol=RTOL, atol=ATOL)


def test_sharded_expert_server_matches_the_one_process_server(ranks):
    """`ExpertServer.from_codebook` on the sharded pipeline: every expert
    sharded, expert pipes carrying the mesh; 6 prompts in tiers up to 2 (a
    tier of 1 runs whole on both data ranks) routed and served as the
    one-process server serves them, within RTOL/ATOL."""
    for r, res in enumerate(ranks):
        s = res["pipeline"]["server"]
        one, sharded = s["one_process"], s["sharded"]
        assert all(sharded["sharded_experts"]) and not any(one["sharded_experts"])
        assert all(sharded["pipes_keep_mesh"])
        np.testing.assert_array_equal(sharded["experts"].numpy(), one["experts"].numpy())
        np.testing.assert_allclose(sharded["images"].numpy(), one["images"].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=f"rank {r}")


def test_2d_finetune_step_matches_the_jax_single_device_step(ranks, jax_refs, setup):
    """One step of the expert student (a site of one unit: model rank 1 holds
    none there) at the global batch of 4 with the JAX draws: the loss terms
    within test_torch_port_finetune's LOSS_RTOL on every rank, and the
    masters gathered whole within its PARAM_ATOL_LR / PARAM_MEAN_LR of the
    learning rate of the JAX step's parameters."""
    want = jax_refs["finetune"]
    lr = FT_LR * B ** 0.5
    for r, res in enumerate(ranks):
        got = res["finetune"]
        assert not got["skipped"]
        for k in FT_TERMS:
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=LOSS_RTOL,
                                       err_msg=f"rank {r} {k}")
        _masters_close(got["masters"], want["params"], setup["ft_port"], lr, f"rank {r}")


def test_replicated_leaves_equal_bit_for_bit_across_each_model_group(ranks):
    """After the 2-D step every replicated master and its gradient are the
    same bits on both ranks of a model group (and, the data axis having
    averaged them, on all four)."""
    for group in ((0, 1), (2, 3), (0, 2)):
        a, b = (ranks[r]["finetune"] for r in group)
        for key in ("replicated", "replicated_grads"):
            assert list(a[key]) == list(b[key]) and a[key]
            for n in a[key]:
                assert torch.equal(a[key][n], b[key][n]), (group, key, n)


def test_finetune_cli_at_tensor_parallel_2_writes_a_one_process_checkpoint(ranks, setup):
    """`cli.finetune` with `optim.tensor_parallel: 2` on the four ranks: a 2 ×
    2 mesh, AdamW on shards, 2 steps, a resume to 3, in f32 (each rank's bf16
    partials round before the sum, so a bf16 run reads further from one
    process; the card's phase 18 holds it); the checkpoint has the
    keys and shapes of a one-process run at the same global batch and loads
    into a one-process student, whose masters, moments and step equal that
    run's: each master within test_torch_port_finetune's PARAM_ATOL_LR and
    PARAM_MEAN_LR of the learning rate, each moment within MOMENT_RTOL
    (relative to its leaf's largest entry for the absolute part)."""
    r0 = ranks[0]["cli"]
    for res in ranks:
        c = res["cli"]
        assert c["run"]["step"] == 2 and c["resume"]["step"] == 3
        assert c["resume"]["mesh"] == {"data": 2, "model": 2}
        assert c["resume"]["optimizer"] == "AdamW"
        assert c["resume"]["run_dir"] == r0["resume"]["run_dir"]
    saved = CheckpointManager(r0["resume"]["run_dir"], create=False)
    assert saved.list_steps() == [2, 3]
    state = saved.restore(3)
    c = setup["job"]["cli"]
    for name in ("one_process", "one_process_resume"):
        one = finetune_cli.main([
            "--base_config_path", c[name], "--device", "cpu", "--pretrained_model_name_or_path",
            "", "--seed", "0", "--compute_dtype", "float32", "--pruning_ckpt_dir", c["stage1"],
            "--expert_id",
            str(CLI_EXPERT), "--wandb_run_name", "tp"])
    want = one.state_dict()
    assert set(state) == set(want) and state["step"] == want["step"] == 3
    assert list(state["student"]) == list(want["student"])
    lr = 1e-5 * B ** 0.5  # tiny_smoke's unet_learning_rate × √(global batch)
    for k, v in want["student"].items():
        assert state["student"][k].shape == v.shape and state["student"][k].dtype == v.dtype, k
        diff = (state["student"][k] - v).abs() / lr
        assert float(diff.max()) <= PARAM_ATOL_LR and float(diff.mean()) <= PARAM_MEAN_LR, k
    for i, s in want["optimizer"]["state"].items():
        for k in ("mu", "nu"):
            got = state["optimizer"]["state"][i][k]
            assert got.shape == s[k].shape and got.dtype == s[k].dtype
            np.testing.assert_allclose(got.numpy(), s[k].numpy(), rtol=MOMENT_RTOL,
                                       atol=MOMENT_RTOL * float(s[k].abs().max()) + 1e-30)
    shards_differ = [n for n, shape in r0["resume"]["local_shapes"].items()
                     if shape != tuple(want["student"][n].shape)]
    assert shards_differ  # rank 0 trained shards, and its checkpoint holds full tensors
    one.masters.load_state_dict(state["student"])  # loads in one process


def test_tensor_parallel_that_does_not_divide_the_world_raises(ranks):
    """At world 4, `optim.tensor_parallel: 3` raises naming both numbers, and
    a 3 × 1 mesh raises: there is no 1-D fallback."""
    for res in ranks:
        errors = res["cli"]["errors"]
        assert errors["tp3"] and "3" in errors["tp3"] and "world size 4" in errors["tp3"]
        assert errors["mesh_3x1"] and "3 × 1" in errors["mesh_3x1"]
