"""One rank of the port's data-parallel CPU tests (not a test module).

Run by `tests/test_torch_port_parallel.py` as torchrun runs a rank: RANK,
WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT in the
environment, and

    python tests/torch_port_parallel_worker.py JOB.pt OUT_DIR SCENARIO [SCENARIO ...]

It forms the group with `utils/launch.init_distributed(device="cpu")` (gloo),
runs each scenario on the job's numpy inputs, and writes what it read to
OUT_DIR/rank{r}.pt. It imports torch and the port, never JAX.
"""
import os
import sys
import types

import numpy as np
import torch

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from diffusion_pruning_tpu_torch.parallel import mesh as pm  # noqa: E402
from diffusion_pruning_tpu_torch.parallel.zero1 import shard_len  # noqa: E402
from diffusion_pruning_tpu_torch.utils.launch import (  # noqa: E402
    init_distributed,
    is_main_process,
    process_slice,
)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tensors(tree):
    """numpy leaves → tensors (int32 ids → int64)."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    if isinstance(tree, np.ndarray):
        t = _t(tree)
        return t.long() if t.dtype == torch.int32 else t
    return tree


def launch(mesh, job):
    x = torch.tensor([float(mesh.rank + 1)])
    s = process_slice(10)
    gathered = pm.all_gather(mesh, torch.arange(3.0) + 10 * mesh.rank)
    return {"all_reduce": float(pm.psum(mesh, x)), "slice": (s.start, s.stop),
            "rank": mesh.rank, "world": mesh.world_size, "main": is_main_process(),
            "all_gather": gathered.numpy(), "backend": mesh.backend}


def sinkhorn(mesh, job):
    from diffusion_pruning_tpu_torch.core.sinkhorn import sinkhorn as sk, sinkhorn_assign
    scores = pm.shard_batch(mesh, {"s": _t(job["sinkhorn"]["scores"])})["s"]
    return {"q": sk(scores, 0.05, 3, mesh=mesh).numpy(),
            "assign": sinkhorn_assign(scores, 0.05, 3, mesh=mesh).numpy()}


def contrastive(mesh, job):
    """d contrastive(global batch) / dW through the spliced gather, averaged
    over the ranks; and the planted fault, a differentiable gather without
    the splice (every rank's loss then reaches every rank's rows)."""
    import torch.distributed.nn.functional as dnn
    from diffusion_pruning_tpu_torch.losses import contrastive_loss
    from diffusion_pruning_tpu_torch.training.pruner import gather_spliced
    c = job["contrastive"]
    local = pm.shard_batch(mesh, {"text": _t(c["text"]), "x": _t(c["x"])})
    text_all = pm.all_gather(mesh, local["text"])
    out = {}
    for name, gather in (("spliced", lambda g: gather_spliced(mesh, g)),
                         ("fault_differentiable_gather",
                          lambda g: torch.cat(dnn.all_gather(g)))):
        w = _t(c["w"]).requires_grad_()
        gates = torch.sigmoid(local["x"] @ w)
        loss, _ = contrastive_loss(text_all, gather(gates))
        loss.backward()
        grad = w.grad.clone()
        pm.pmean_(mesh, [grad])
        out[name] = {"loss": float(loss), "grad": grad.numpy()}
    return out


# ---------------------------------------------------------------- stage 1

def _stage1_modules(weights):
    from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
    from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
    from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from diffusion_pruning_tpu_torch.schedulers import DiffusionSchedule
    from diffusion_pruning_tpu_torch.training import PrunerModules
    unet = GatedUNet(UNetConfig.tiny(cross_attention_dim=32))
    vae, text = AutoencoderKL(VAEConfig.tiny()), CLIPTextEncoder(CLIPTextConfig.tiny())
    hypernet = HyperStructure(unet.spec, input_dim=24)
    quantizer = StructureQuantizer(unet.spec, n_e=4, base=3.0)
    for name, mod in (("unet", unet), ("vae", vae), ("text", text), ("hypernet", hypernet),
                      ("quantizer", quantizer)):
        mod.load_state_dict(weights[name])
    return PrunerModules(unet.eval(), vae.eval(), text.eval(), hypernet, quantizer,
                         DiffusionSchedule())


def stage1_trainables(mods):
    """{hypernet: (kernel (in, vq), bias), codebook} as arrays, flax layout."""
    fcs = mods.hypernet.mh_fc
    return {"kernel": torch.cat([fc.weight for fc in fcs]).T.detach().numpy(),
            "bias": torch.cat([fc.bias for fc in fcs]).detach().numpy(),
            "codebook": mods.quantizer.embedding.weight.detach().numpy().copy()}


def _stage1_grads(mods):
    fcs = mods.hypernet.mh_fc
    return {"kernel": torch.cat([fc.weight.grad for fc in fcs]).T.numpy(),
            "bias": torch.cat([fc.bias.grad for fc in fcs]).numpy(),
            "codebook": mods.quantizer.embedding.weight.grad.numpy().copy()}


def stage1(mesh, job):
    """Each case's steps with the mesh (and, where asked, the same steps with
    mesh=None on the same explicit draws): per step the loss terms, the
    per-sample outputs, the snapshot and the grads, and the trainables."""
    from diffusion_pruning_tpu_torch.training import PrunerConfig, make_optimizer
    from diffusion_pruning_tpu_torch.training.pruner import (
        LOSS_TERMS,
        _applied_updates,
        make_pruner_step,
    )
    j = job["stage1"]
    out = {}
    for name, case in j["cases"].items():
        on = {None: None, "mesh": mesh}
        out[name] = {}
        for mode in case.get("modes", ("mesh",)):
            mods = _stage1_modules(j["weights"])
            cfg = PrunerConfig(**case.get("cfg", {}))
            opt = make_optimizer(cfg, mods, case["global_batch"])
            steps = {p: make_pruner_step(mods, cfg, opt, pretrain=p,
                                         accum_steps=case.get("accum", 1), mesh=on[mode])
                     for p in (True, False)}
            rows = []
            for s in case["steps"]:
                batch = _tensors(s["batch"][mesh.rank if mode == "mesh" else 0])
                draws = _tensors(s["draws"][mesh.rank if mode == "mesh" else 0])
                metrics, aux = steps[s["pretrain"]](batch, draws)
                rows.append({
                    "metrics": {k: float(metrics[k]) for k in (*LOSS_TERMS, "grad_norm")},
                    "skipped": bool(metrics["skipped"]),
                    "expert_indices": aux["expert_indices"].numpy(),
                    "batch_resource_ratios": aux["batch_resource_ratios"].numpy(),
                    "embedding_gs": mods.quantizer.embedding_gs.numpy().copy(),
                    "grads": _stage1_grads(mods), "trainables": stage1_trainables(mods),
                    "applied": [_applied_updates(opt, g) for g in opt.param_groups],
                    "adam": [v.numpy().copy() for st in opt.state.values()
                             for k, v in sorted(st.items()) if k != "step"]})
            out[name][mode or "none"] = rows
    return out


# ---------------------------------------------------------------- stage 2

def _stage2_modules(j):
    from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    from diffusion_pruning_tpu_torch.models.unet.pruned import make_expert_plan
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from diffusion_pruning_tpu_torch.schedulers import DiffusionSchedule
    from diffusion_pruning_tpu_torch.training import finetuner as ft
    from diffusion_pruning_tpu_torch.training.factory import build_student
    weights = j["weights"]
    teacher = GatedUNet(UNetConfig.tiny(cross_attention_dim=32))
    teacher.load_state_dict(weights["teacher"])
    student = build_student(teacher, make_expert_plan(teacher.spec, j["arch"]))
    vae, text = AutoencoderKL(VAEConfig.tiny()), CLIPTextEncoder(CLIPTextConfig.tiny())
    vae.load_state_dict(weights["vae"])
    text.load_state_dict(weights["text"])
    return ft.FineTunerModules(student=student, teacher=teacher.eval(), vae=vae.eval(),
                               text_encoder=text.eval(), schedule=DiffusionSchedule())


def stage2(mesh, job):
    """Each case's steps in each of its modes (`none`: mesh=None; `mesh`;
    `zero1`): per step the metrics and the masters, and the moments each
    rank holds."""
    from diffusion_pruning_tpu_torch.training import finetuner as ft
    j = job["stage2"]
    out = {}
    for name, case in j["cases"].items():
        out[name] = {}
        for mode in case["modes"]:
            mods = _stage2_modules(j)
            cfg = ft.FineTuneConfig(**case["cfg"])
            masters = ft.MasterWeights(mods.student)
            on_mesh = None if mode == "none" else mesh
            opt = ft.make_finetune_optimizer(cfg, masters, case["global_batch"],
                                             zero1_mesh=mesh if mode == "zero1" else None)
            step = ft.make_finetune_step(mods, cfg, opt, accum_steps=case.get("accum", 1),
                                         zero1=mode == "zero1", mesh=on_mesh)
            rows = []
            for s in case["steps"]:
                r = 0 if mode == "none" else mesh.rank
                metrics = step(_tensors(s["batch"][r]), _tensors(s["draws"][r]))
                state = [v for st in opt.state.values() for k, v in st.items()
                         if k in ("mu", "nu")]
                rows.append({
                    "metrics": {k: float(metrics[k]) for k in (*ft.LOSS_TERMS, "grad_norm")},
                    "skipped": bool(metrics["skipped"]),
                    "masters": {k: v.clone() for k, v in masters.state_dict().items()},
                    "moment_numels": [t.numel() for t in state],
                    "moments": [t.clone() for t in state],
                    "applied": [int(st["step"]) for st in opt.state.values()]})
            out[name][mode] = rows
    out["total"] = sum(p.numel() for p in _stage2_modules(j).student.parameters())
    out["shard_len"] = shard_len(out["total"], mesh.world_size)
    return out


# ---------------------------------------------------------------- the entry points

def _watch_writes(root, log):
    """Record every file this process opens for writing, and every directory
    it makes or file it moves or removes, under `root`."""
    root = os.path.realpath(root)

    def under(path):
        try:
            return os.path.realpath(os.fsdecode(path)).startswith(root)
        except (TypeError, ValueError):
            return False

    def hook(event, args):
        if event == "open" and args and isinstance(args[0], (str, bytes, os.PathLike)):
            mode = args[1] if len(args) > 1 and isinstance(args[1], str) else "r"
            flags = args[2] if len(args) > 2 and isinstance(args[2], int) else 0
            writes = any(c in mode for c in "wax+") or flags & (os.O_WRONLY | os.O_RDWR)
            if writes and under(args[0]):
                log.append(("open", os.fsdecode(args[0])))
        elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove", "os.rmdir",
                       "shutil.rmtree") and args and under(args[0]):
            log.append((event, os.fsdecode(args[0])))
    sys.addaudithook(hook)


def cli(mesh, job):
    """prune for 3 steps, then a resume to 4; finetune (ZeRO-1, the world
    size's default) on its codebook for 2 steps, then a resume to 3; the
    magnitude baseline for 2 steps. Per run: this rank's trainables (or
    masters and gathered moments) and the state each resume restored."""
    from diffusion_pruning_tpu_torch.cli import finetune, finetune_baseline, prune
    from diffusion_pruning_tpu_torch.training import loop as loop_module
    c = job["cli"]
    writes = []
    if mesh.rank != 0:
        _watch_writes(c["root"], writes)
    resumed = []
    for cls in (loop_module.PrunerLoop, loop_module.FineTuneLoop):
        real = cls.maybe_resume

        def resume(self, real=real):
            real(self)
            if self.loop_cfg.resume_from is not None:
                resumed.append({"step": self.global_step, "state": _host(self.state_dict()),
                                "local": [_host(st) for st in self.optimizer.state.values()]})
        cls.maybe_resume = resume
    hub = []  # a fake huggingface_hub's calls: (create, repo id), (upload, id, folder, files)
    fake = types.ModuleType("huggingface_hub")
    fake.create_repo = lambda repo_id, exist_ok=False, token=None: (
        hub.append(("create", repo_id)) or types.SimpleNamespace(repo_id=repo_id))
    fake.upload_folder = lambda repo_id, folder_path, commit_message=None, \
        ignore_patterns=None, token=None: hub.append(
            ("upload", repo_id, folder_path, sorted(os.listdir(folder_path))))
    sys.modules["huggingface_hub"] = fake
    out = {"hub": hub}
    base = ["--device", "cpu", "--pretrained_model_name_or_path", "", "--seed", "0"]
    p1 = prune.main(["--base_config_path", c["prune"], "--wandb_run_name", "dp", *base])
    out["prune"] = {"step": p1.global_step, "trainables": stage1_trainables(p1.mods),
                    "run_dir": p1.run_dir}
    p2 = prune.main(["--base_config_path", c["prune_resume"], "--wandb_run_name", "dp", *base])
    out["prune_resume"] = {"step": p2.global_step, "trainables": stage1_trainables(p2.mods),
                           "resumed": resumed.pop()}
    ft_argv = ["--pruning_ckpt_dir", p1.run_dir, "--expert_id", "0", "--wandb_run_name", "dp"]
    f1 = finetune.main(["--base_config_path", c["finetune"], *ft_argv, *base])
    out["finetune"] = {"step": f1.global_step, "zero1": type(f1.optimizer).__name__,
                       "masters": _host(f1.masters.state_dict()),
                       "optimizer": _host(f1.optimizer.state_dict()),
                       "run_dir": f1.run_dir}
    f2 = finetune.main(["--base_config_path", c["finetune_resume"], *ft_argv, *base])
    out["finetune_resume"] = {"step": f2.global_step, "resumed": resumed.pop(),
                              "masters": _host(f2.masters.state_dict()),
                              "shard": [_host(s) for s in f2.optimizer.state.values()]}
    b = finetune_baseline.main(["--base_config_path", c["baseline"], "--pruning_type",
                                "magnitude", *base])
    out["baseline"] = {"step": b.global_step, "optimizer": type(b.optimizer).__name__,
                       "masters": _host(b.masters.state_dict()), "run_dir": b.run_dir}
    out["writes"] = writes
    return out


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree.detach().clone() if torch.is_tensor(tree) else tree


SCENARIOS = {"launch": launch, "sinkhorn": sinkhorn, "contrastive": contrastive,
             "stage1": stage1, "stage2": stage2, "cli": cli}


def main():
    job_path, out_dir, *scenarios = sys.argv[1:]
    device = init_distributed(device="cpu", timeout_s=float(os.environ.get("DP_TIMEOUT", 300)))
    mesh = pm.data_mesh(device)
    job = torch.load(job_path, weights_only=False)
    result = {name: SCENARIOS[name](mesh, job) for name in scenarios}
    result["jax_imported"] = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    torch.save(result, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    pm.barrier(mesh)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
