"""The Hub upload contract of the port (`utils/hub.py`), driven with a fake
`huggingface_hub` module: the five cases of tests/test_hub.py, each also run
through the JAX module on the same calls, and the prune and finetune entry
points calling the hook once their tiny run has ended (rank 0 alone at
world size 2: tests/test_torch_port_parallel.py::test_entry_points_at_world_2).
No upload is made."""
import os
import sys
import types

import pytest
import yaml

from diffusion_pruning_tpu.utils import hub as jax_hub
from diffusion_pruning_tpu.utils.config import load_config_dict as jax_load_config_dict
from diffusion_pruning_tpu_torch.cli import finetune, prune
from diffusion_pruning_tpu_torch.utils import hub
from diffusion_pruning_tpu_torch.utils.config import load_config_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_hub(calls):
    fake = types.ModuleType("huggingface_hub")

    class _Repo:
        repo_id = "user/run-x"

    def create_repo(repo_id, exist_ok=False, token=None):
        calls["create"].append((repo_id, exist_ok, token))
        return _Repo()

    def upload_folder(repo_id, folder_path, commit_message=None, ignore_patterns=None,
                      token=None):
        files = sorted(os.listdir(folder_path)) if os.path.isdir(folder_path) else []
        calls["upload"].append((repo_id, folder_path, commit_message,
                                tuple(ignore_patterns or ()), token, files))

    fake.create_repo = create_repo
    fake.upload_folder = upload_folder
    return fake


@pytest.fixture
def calls(monkeypatch):
    calls = {"create": [], "upload": []}
    monkeypatch.setitem(sys.modules, "huggingface_hub", _fake_hub(calls))
    return calls


def _both(calls, fn):
    """fn(module, load_config) through the port and then the JAX module:
    (the port's result, the JAX one's), the fake's calls of each equal."""
    got = fn(hub, load_config_dict)
    mine = {k: list(v) for k, v in calls.items()}
    for v in calls.values():
        v.clear()
    want = fn(jax_hub, jax_load_config_dict)
    assert mine == calls
    for k, v in mine.items():
        calls[k][:] = v
    return got, want


def test_create_repo_defaults_to_run_dir_name(calls):
    got, want = _both(calls, lambda h, _: h.create_training_repo("/tmp/runs/my-run/"))
    assert calls["create"] == [("my-run", True, None)]
    assert got == want == "user/run-x"  # the id the hub answers with


def test_push_run_uploads_folder(calls):
    _both(calls, lambda h, _: h.push_run_to_hub("/tmp/runs/my-run", "user/run-x", token="tok"))
    (repo_id, folder, msg, ignore, token, _), = calls["upload"]
    assert (repo_id, folder, token) == ("user/run-x", "/tmp/runs/my-run", "tok")
    assert msg == "End of training"
    assert ignore == hub.DEFAULT_IGNORE == jax_hub.DEFAULT_IGNORE
    assert "checkpoint-*/state/*" in ignore


def test_maybe_push_disabled_and_enabled(calls, tmp_path):
    off = {"training": {"hf_hub": {"push_to_hub": False}}}
    got, want = _both(calls, lambda h, load: h.maybe_push_to_hub(load(off), str(tmp_path)))
    assert got is want is None
    assert not calls["create"] and not calls["upload"]

    on = {"training": {"hf_hub": {"push_to_hub": True, "hub_model_id": "org/experts",
                                  "hub_token": "t"}}}
    got, want = _both(calls, lambda h, load: h.maybe_push_to_hub(load(on), str(tmp_path)))
    assert got == want == "user/run-x"
    assert calls["create"] == [("org/experts", True, "t")]
    assert calls["upload"][0][0] == "user/run-x"


def test_maybe_push_without_section_is_noop(calls, tmp_path):
    got, want = _both(calls, lambda h, load: h.maybe_push_to_hub(load({"training": {}}),
                                                                  str(tmp_path)))
    assert got is want is None and not calls["create"]


def test_missing_package_raises_only_when_opted_in(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # an ImportError on import
    for h, load in ((hub, load_config_dict), (jax_hub, jax_load_config_dict)):
        with pytest.raises(RuntimeError, match="huggingface_hub"):
            h.maybe_push_to_hub(load({"training": {"hf_hub": {"push_to_hub": True}}}),
                                str(tmp_path))
        assert h.maybe_push_to_hub(load({"training": {"hf_hub": {"push_to_hub": False}}}),
                                   str(tmp_path)) is None


def _yaml(src, folder, name, **changes):
    with open(src) as f:
        cfg = yaml.safe_load(f)
    cfg["training"]["logging"]["logging_dir"] = str(folder / "runs")
    cfg["training"]["hf_hub"] = {"push_to_hub": True, "hub_model_id": None, "hub_token": None}
    for path, value in changes.items():
        node = cfg
        *parents, last = path.split(".")
        for p in parents:
            node = node[p]
        node[last] = value
    out = folder / name
    out.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(out)


def test_entry_points_push_the_run_once_it_has_ended(calls, tmp_path):
    """With `training.hf_hub.push_to_hub`, `cli.prune` and `cli.finetune` each
    create the run's repo (named after the run directory) and upload the run
    directory once, after the final checkpoint (and the model card) are
    written."""
    base = ["--device", "cpu", "--pretrained_model_name_or_path", "", "--seed", "0"]
    p = prune.main(["--base_config_path", _yaml(
        os.path.join(REPO, "configs", "pruning", "tiny_smoke.yaml"), tmp_path, "p.yaml",
        **{"training.max_train_steps": 2, "training.hypernet_pretraining_steps": 1,
           "training.validation_steps": 2}), "--wandb_run_name", "hub", *base])
    f = finetune.main(["--base_config_path", _yaml(
        os.path.join(REPO, "configs", "finetuning", "tiny_smoke.yaml"), tmp_path, "f.yaml",
        **{"training.max_train_steps": 1, "training.validation_steps": 1}),
        "--pruning_ckpt_dir", p.run_dir, "--expert_id", "0", "--wandb_run_name", "hub", *base])
    assert calls["create"] == [("hub", True, None), ("hub-expert0", True, None)]
    assert [c[1] for c in calls["upload"]] == [p.run_dir, f.run_dir]
    (_, _, _, _, _, p_files), (_, _, _, _, _, f_files) = calls["upload"]
    assert "checkpoint-2" in p_files and "config.yaml" in p_files
    assert {"checkpoint-1", "README.md", "arch_vector.pt"} <= set(f_files)
