"""One rank of the port's tensor-parallel CPU tests (not a test module).

Run by `tests/test_torch_port_tp.py` as torchrun runs a rank: RANK,
WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT in the
environment (four ranks, a 2 × 2 data × model mesh), and

    python tests/torch_port_tp_worker.py JOB.pt OUT_DIR

It forms the group with `utils/launch.init_distributed(device="cpu")` (gloo),
runs every scenario on the job's inputs, and writes what it read to
OUT_DIR/rank{r}.pt. It imports torch and the port, never JAX.
"""
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig  # noqa: E402
from diffusion_pruning_tpu_torch.models.unet.pruned import (  # noqa: E402
    make_expert_plan,
    slice_expert_params,
)
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet  # noqa: E402
from diffusion_pruning_tpu_torch.parallel import mesh as pm  # noqa: E402
from diffusion_pruning_tpu_torch.parallel import tp  # noqa: E402
from diffusion_pruning_tpu_torch.pipelines.expert_server import build_expert  # noqa: E402
from diffusion_pruning_tpu_torch.utils.launch import init_distributed  # noqa: E402

N_DATA, N_MODEL = 2, 2
UCFG = dict(cross_attention_dim=32)


def _t(a):
    t = torch.from_numpy(np.array(a))
    return t.long() if t.dtype == torch.int32 else t


def _unets(job, **flags):
    """The dense tiny U-Net and the job's expert of it, f32, eval."""
    cfg = UNetConfig.tiny(**UCFG, **flags)
    dense = GatedUNet(cfg)
    dense.load_state_dict(job["unet"])
    plan = make_expert_plan(dense.spec, job["expert_arch"])
    expert = build_expert(cfg, plan, slice_expert_params(dense.state_dict(), plan))
    return dense.eval().requires_grad_(False), expert


def forward(mesh, job):
    """(c): each U-Net through `tp_forward` under each flag; (b) the
    collective gather of each shard; the units this rank holds a site."""
    f = job["forward"]
    x, t, ehs, arch = (_t(f[k]) for k in ("sample", "timesteps", "ehs", "arch"))
    out = {}
    for flag in ("plain", "fused_norm_conv"):
        dense, expert = _unets(job, **({} if flag == "plain" else {flag: True}))
        for name, unet, a in (("dense", dense, arch), ("expert", expert, None)):
            sharded = tp.shard_unet(unet, mesh)
            tp.reset_tp_stats()
            with torch.no_grad():
                got = tp.tp_forward(sharded, mesh)(x, t, ehs, a)
            full = tp.gather_state(mesh.model, sharded.state_dict(), sharded.shard.plan)
            ref = unet.state_dict()
            out[(flag, name)] = {
                "out": got, "reductions": tp.tp_stats["reductions"],
                "gather_differs_at": [k for k in ref if not torch.equal(full[k], ref[k])],
                "units": {(s.name, s.kind): sharded.shard.local_units(s.name, s.kind)
                          for s in sharded.shard.plan}}
    return out


def _pipeline(job):
    from diffusion_pruning_tpu_torch.models import text_encoders as te
    from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
    from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
    from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from diffusion_pruning_tpu_torch.pipelines import PruningPipeline
    w = job["pipeline"]["weights"]
    unet = GatedUNet(UNetConfig.tiny(**UCFG))
    vae, text = AutoencoderKL(VAEConfig.tiny()), te.CLIPTextEncoder(te.CLIPTextConfig.tiny())
    hypernet = HyperStructure(unet.spec, input_dim=32)
    quantizer = StructureQuantizer(unet.spec, n_e=4, base=0.0)
    for name, mod in (("unet", unet), ("vae", vae), ("text", text), ("hypernet", hypernet),
                      ("quantizer", quantizer)):
        mod.load_state_dict(w[name])
    return PruningPipeline(unet, vae, text, hypernet, quantizer, device="cpu")


def pipeline(mesh, job):
    """(d) the sharded pipeline's routed CFG call on given latents and
    routing noise; (e) `ExpertServer.from_codebook` on it and on the
    one-process pipeline, each serving the same prompts."""
    from diffusion_pruning_tpu_torch.pipelines.expert_server import ExpertServer
    p = job["pipeline"]
    pipe = _pipeline(job)
    sharded = tp.shard_pipeline(pipe, mesh)
    ids, neg, latents, noise = (_t(p[k]) for k in ("ids", "neg", "latents", "noise"))
    images, idx, ratios = sharded(ids, neg, latents=latents, num_inference_steps=p["steps"],
                                  route_noise=noise)
    out = {"images": images, "indices": idx, "ratios": ratios,
           "mesh_kept": sharded.mesh is mesh, "unet_sharded": sharded.unet.shard is not None}
    s = p["server"]
    served = {}
    for name, base in (("one_process", pipe), ("sharded", sharded)):
        server = ExpertServer.from_codebook(base, pipe.unet.spec, pipe.unet.cfg, batch_size=2)
        imgs, experts = server.generate(_t(s["ids"]), _t(s["neg"]), latents=_t(s["latents"]),
                                        num_inference_steps=s["steps"],
                                        route_noise=_t(s["noise"]))
        served[name] = {"images": imgs, "experts": experts,
                        "sharded_experts": [m.shard is not None for m in server.expert_models],
                        "pipes_keep_mesh": [server.expert_pipe(e).mesh is base.mesh
                                            for e in range(len(server.expert_models))]}
    out["server"] = served
    return out


def _ft_modules(job):
    from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
    from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from diffusion_pruning_tpu_torch.schedulers import DiffusionSchedule
    from diffusion_pruning_tpu_torch.training import finetuner as ft
    from diffusion_pruning_tpu_torch.training.factory import build_student
    j = job["finetune"]
    teacher = GatedUNet(UNetConfig.tiny(**UCFG))
    teacher.load_state_dict(j["teacher"])
    student = build_student(teacher, make_expert_plan(teacher.spec, j["arch"]))
    vae, text = AutoencoderKL(VAEConfig.tiny()), CLIPTextEncoder(CLIPTextConfig.tiny())
    vae.load_state_dict(j["vae"])
    text.load_state_dict(j["text"])
    return ft.FineTunerModules(student=student, teacher=teacher.eval(), vae=vae.eval(),
                               text_encoder=text.eval(), schedule=DiffusionSchedule())


def finetune(mesh, job):
    """(f) one 2-D step on the expert student (sharded, as the teacher) with
    the global batch's draws: the metrics, the masters gathered whole, and
    this rank's replicated masters and gradients (the bits a model group
    must share)."""
    from diffusion_pruning_tpu_torch.training import finetuner as ft
    j = job["finetune"]
    mods = _ft_modules(job)
    mods.student = tp.shard_unet(mods.student, mesh)
    mods.teacher = tp.shard_unet(mods.teacher, mesh)
    masters = ft.MasterWeights(mods.student)
    cfg = ft.FineTuneConfig(**j["cfg"])
    opt = ft.make_finetune_optimizer(cfg, masters, j["global_batch"])
    step = ft.make_finetune_step_gspmd(mods, cfg, opt, mesh)
    rows = pm.rank_slice(mesh.data, j["global_batch"])
    batch = {k: _t(v)[rows] for k, v in j["batch"].items()}
    metrics = step(batch, {k: _t(v) for k, v in j["draws"].items()})
    split = mods.student.shard.split_keys
    named = dict(zip(masters.names, masters.masters))
    return {"metrics": {k: float(metrics[k]) for k in (*ft.LOSS_TERMS, "grad_norm")},
            "skipped": bool(metrics["skipped"]),
            "masters": tp.gather_state(mesh.model, masters.state_dict(), mods.student.shard.plan),
            "replicated": {n: p.detach().clone() for n, p in named.items() if n not in split},
            "replicated_grads": {n: p.grad.clone() for n, p in named.items() if n not in split}}


def cli(mesh, job):
    """(g) `cli.finetune` with `optim.tensor_parallel: 2` on the four ranks
    (2 × 2), in f32, for 2 steps, then a resume to 3; (h) a tensor_parallel that does
    not divide the world, and a mesh of another size, raise."""
    from diffusion_pruning_tpu_torch.cli import finetune as finetune_cli
    from diffusion_pruning_tpu_torch.utils.arg_utils import parse_args
    from diffusion_pruning_tpu_torch.utils.config import load_config
    c = job["cli"]
    argv = ["--device", "cpu", "--pretrained_model_name_or_path", "", "--seed", "0",
            "--compute_dtype", "float32",
            "--pruning_ckpt_dir", c["stage1"], "--expert_id", str(c["expert"]),
            "--wandb_run_name", "tp"]
    out = {}
    for name in ("run", "resume"):
        loop = finetune_cli.main(["--base_config_path", c[name], *argv])
        out[name] = {"step": loop.global_step, "run_dir": loop.run_dir,
                     "mesh": (loop.mesh.shape if isinstance(loop.mesh, tp.DpTpMesh) else None),
                     "optimizer": type(loop.optimizer).__name__,
                     "local_shapes": {n: tuple(m.shape) for n, m in
                                      zip(loop.masters.names, loop.masters.masters)}}
    errors = {}
    args = parse_args(["--base_config_path", c["tp3"], *argv])
    cfg = load_config(c["tp3"])
    cfg.update_flat(vars(args))
    for name, fn in (("tp3", lambda: finetune_cli.data_parallel(args, cfg)),
                     ("mesh_3x1", lambda: tp.dp_tp_mesh(3, 1, "cpu"))):
        try:
            fn()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    return out


SCENARIOS = {"forward": forward, "pipeline": pipeline, "finetune": finetune, "cli": cli}


def main():
    job_path, out_dir = sys.argv[1:3]
    device = init_distributed(device="cpu", timeout_s=float(os.environ.get("TP_TIMEOUT", 300)))
    mesh = tp.dp_tp_mesh(N_DATA, N_MODEL, device)
    job = torch.load(job_path, weights_only=False)
    result = {"coords": (mesh.data.rank, mesh.model.rank)}
    result.update({name: fn(mesh, job) for name, fn in SCENARIOS.items()})
    result["jax_imported"] = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    torch.save(result, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    pm.barrier(mesh)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
