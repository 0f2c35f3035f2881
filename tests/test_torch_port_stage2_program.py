"""Stage 2 as a program in the port, on the CPU: the finetune entry point and
the baseline entry point (every `--pruning_type`) on
`configs/finetuning/tiny_smoke.yaml` with `--device cpu`, reading the
stage-1 checkpoint that the port's own prune entry point has just written
(`configs/pruning/tiny_smoke.yaml`); the run directory's files, resume, EMA,
and the options and devices the entry points refuse."""
import functools
import json
import math
import os

import numpy as np
import pytest
import torch
import yaml

from diffusion_pruning_tpu_torch.cli import finetune, finetune_baseline, prune
from diffusion_pruning_tpu_torch.core.structure import build_structure
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.unet.pruned import expert_macs_ratio, make_expert_plan
from diffusion_pruning_tpu_torch.training import loop as loop_module
from diffusion_pruning_tpu_torch.training.loop import LoopConfig
from diffusion_pruning_tpu_torch.utils.checkpoint import load_torch_artifact, save_torch_artifact

from test_torch_port_data import write_coco

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRUNE_YAML = os.path.join(REPO, "configs", "pruning", "tiny_smoke.yaml")
FINETUNE_YAML = os.path.join(REPO, "configs", "finetuning", "tiny_smoke.yaml")
EXPERT = 2


def _yaml(src, tmp_path, name, **changes):
    with open(src) as f:
        cfg = yaml.safe_load(f)
    cfg["training"]["logging"]["logging_dir"] = str(tmp_path / "runs")
    for path, value in changes.items():
        node = cfg
        *parents, last = path.split(".")
        for p in parents:
            node = node[p]
        node[last] = value
    out = tmp_path / name
    out.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(out)


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """A stage-1 run of the port's prune entry point (6 tiny steps)."""
    tmp = tmp_path_factory.mktemp("stage1")
    loop = prune.main(["--base_config_path", _yaml(PRUNE_YAML, tmp, "p.yaml"), "--device",
                       "cpu", "--wandb_run_name", "p", "--pretrained_model_name_or_path", "",
                       "--seed", "0"])
    return loop.run_dir


def _argv(config, *extra):
    return ["--base_config_path", config, "--device", "cpu",
            "--pretrained_model_name_or_path", "", *extra]


def _lines(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_finetune_cli_fine_tunes_a_codebook_expert_and_resumes(stage1, tmp_path, monkeypatch):
    """Row EXPERT of the checkpoint's `quantizer_embeddings.pt` becomes the
    run's `arch_vector.pt` (in the run directory and beside the checkpoint);
    3 steps with a bf16 compute copy (the default `--compute_dtype`) log
    finite losses, validation runs at step 3, the model card names the expert
    and its MACs ratio. A second run resumes from `latest` to step 5 with
    `--use_ema` and 2 micro-batches a step: it restores the saved masters bit
    for bit and starts its EMA from them."""
    monkeypatch.setattr(loop_module, "LoopConfig", functools.partial(LoopConfig, log_every=1))
    config = _yaml(FINETUNE_YAML, tmp_path, "f.yaml")
    loop = finetune.main(_argv(config, "--pruning_ckpt_dir", stage1, "--expert_id", str(EXPERT),
                               "--wandb_run_name", "ft"))
    run = tmp_path / "runs" / "f" / f"ft-expert{EXPERT}"
    assert loop.run_dir == str(run) and loop.global_step == 3 and loop.ckpt.list_steps() == [3]
    row = load_torch_artifact(os.path.join(stage1, "checkpoint-6", "quantizer_embeddings.pt"))
    for path in (run / "arch_vector.pt", run / "checkpoint-3" / "arch_vector.pt"):
        np.testing.assert_array_equal(load_torch_artifact(str(path)).numpy(), row[EXPERT].numpy())
    assert loop.masters.separate and loop.optimizer.masters.copies[0].dtype == torch.bfloat16
    lines = _lines(run)
    assert [m["step"] for m in lines if "loss" in m] == [1, 2, 3]
    assert [m["step"] for m in lines if "val_loss" in m] == [3]
    assert all(math.isfinite(m["loss"]) and not m["skipped"] for m in lines if "loss" in m)
    spec = build_structure(UNetConfig.tiny())
    ratio = expert_macs_ratio(spec, make_expert_plan(spec, row[EXPERT]))
    card = (run / "README.md").read_text()
    assert f"# APTP expert {EXPERT}" in card and f"**{ratio:.3f}**" in card
    saved = torch.load(str(run / "checkpoint-3" / "state" / "state.pt"), weights_only=True)

    os.makedirs(tmp_path / "resume")
    config2 = _yaml(FINETUNE_YAML, tmp_path, "resume/f.yaml", **{
        "training.max_train_steps": 5, "training.gradient_accumulation_steps": 2,
        "training.logging.resume_from_checkpoint": "latest"})
    restored = {}
    real = loop_module.FineTuneLoop.maybe_resume

    def resume(self):
        real(self)
        restored.update(student={k: v.clone() for k, v in self.masters.state_dict().items()},
                        ema={k: v.clone() for k, v in self.ema.items()}, step=self.global_step)
    monkeypatch.setattr(loop_module.FineTuneLoop, "maybe_resume", resume)
    loop2 = finetune.main(_argv(config2, "--pruning_ckpt_dir", stage1, "--expert_id",
                                str(EXPERT), "--wandb_run_name", "ft", "--use_ema"))
    assert restored["step"] == 3 and loop2.global_step == 5
    for name, v in saved["student"].items():
        assert torch.equal(restored["student"][name], v), name
        assert torch.equal(restored["ema"][name], v), name
    assert loop2.ckpt.list_steps() == [5]
    assert "ema" in torch.load(str(run / "checkpoint-5" / "state" / "state.pt"), weights_only=True)


@pytest.mark.parametrize("pruning_type", finetune_baseline.PRUNING_TYPES)
def test_finetune_baseline_cli_runs_every_pruning_type(stage1, tmp_path, pruning_type, capsys):
    """Each baseline trains 3 steps through the same student, teacher and
    loop, in `baseline-<type>`, and prints its MACs ratio: the dense student
    1.000; magnitude and random below 1 at the yaml's pruning target 0.6;
    structural the arch vector of a fine-tuning run (here planted); single-arch
    the `arch_vector.pt` of the pruning run directory (a uni-architecture run
    would hold it; here row 0 of the stage-1 codebook is written there)."""
    config = _yaml(FINETUNE_YAML, tmp_path, "b.yaml")
    extra = ["--pruning_type", pruning_type, "--seed", "3"]
    want = None
    if pruning_type == "structural":
        want = np.zeros((1, build_structure(UNetConfig.tiny()).vq_dim), np.float32) + 0.9
        want[0, :3] = 0.0
        os.makedirs(tmp_path / "ft")
        save_torch_artifact(want, str(tmp_path / "ft" / "arch_vector.pt"))
        extra += ["--finetuning_ckpt_dir", str(tmp_path / "ft")]
    if pruning_type == "single-arch":
        pruning = tmp_path / "pruning"
        os.makedirs(pruning)
        want = load_torch_artifact(os.path.join(stage1, "checkpoint-6",
                                                "quantizer_embeddings.pt"))[0].numpy()
        save_torch_artifact(want, str(pruning / "arch_vector.pt"))
        extra += ["--pruning_ckpt_dir", str(pruning)]
    loop = finetune_baseline.main(_argv(config, *extra))
    run = tmp_path / "runs" / "b" / f"baseline-{pruning_type}"
    assert loop.run_dir == str(run) and loop.global_step == 3
    ratio = float(capsys.readouterr().err.split(f"{pruning_type}: MACs ratio ")[1].split()[0])
    if pruning_type == "no-pruning":
        assert ratio == 1.0 and loop.arch_vector is None
        assert sorted(os.listdir(run / "checkpoint-3")) == ["state"]
        return
    arch = load_torch_artifact(str(run / "checkpoint-3" / "arch_vector.pt")).numpy()
    if want is not None:
        np.testing.assert_array_equal(arch, want)
    if pruning_type in ("magnitude", "random"):
        assert arch.shape == (1, build_structure(UNetConfig.tiny()).vq_dim) and ratio < 1.0


def test_finetune_entry_points_refuse_what_is_not_ported(stage1, tmp_path, monkeypatch):
    """No card without `--device cpu`; `optim.tensor_parallel` 2 at world
    size 1 (the finetune entry point's mesh needs a world it divides; the
    baseline one runs data parallel only); a `--mesh_shape` other than the
    launch's world size (1 here); `optim.zero1` in the
    baseline entry point, which runs without ZeRO-1; a missing `--expert_id`.
    Each raises before the run directory is made. An existing data_dir is
    trained on by both entry points."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ft = ["--pruning_ckpt_dir", stage1, "--expert_id", "0"]
    base = _yaml(FINETUNE_YAML, tmp_path, "f.yaml")
    for main, extra in ((finetune.main, ft), (finetune_baseline.main, [])):
        argv = ["--base_config_path", base, "--pretrained_model_name_or_path", "", *extra]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
        cases = (
            (ValueError, "--mesh_shape 2 differs from the world size 1", base,
             ["--mesh_shape", "2"]),
            (ValueError, ("optim.tensor_parallel 2 does not divide the world size 1"
                          if main is finetune.main else "runs data parallel only"),
             _yaml(FINETUNE_YAML, tmp_path, "t.yaml", **{"training.optim.tensor_parallel": 2}),
             []),
        )
        if main is finetune_baseline.main:
            cases += ((ValueError, "without ZeRO-1", _yaml(FINETUNE_YAML, tmp_path, "z.yaml",
                                                           **{"training.optim.zero1": True}),
                       []),)
        for error, match, config, more in cases:
            with pytest.raises(error, match=match):
                main(["--base_config_path", config, "--device", "cpu",
                      "--pretrained_model_name_or_path", "", *extra, *more])
    with pytest.raises(ValueError, match="--expert_id"):
        finetune.main(_argv(base, "--pruning_ckpt_dir", stage1))
    assert not (tmp_path / "runs").exists()
    data = _yaml(FINETUNE_YAML, tmp_path, "d.yaml", **{
        "data.data_dir": write_coco(tmp_path / "coco", n_train=6, n_val=4),
        "data.dataset_name": "coco", "training.max_train_steps": 2})
    for main, extra in ((finetune.main, ft), (finetune_baseline.main, [])):
        loop = main(["--base_config_path", data, "--device", "cpu",
                     "--pretrained_model_name_or_path", "", *extra])
        assert loop.global_step == 2 and loop.ckpt.list_steps() == [2]
