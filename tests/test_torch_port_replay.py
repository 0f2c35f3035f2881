"""The port's replay chain (`cli/replay_chain.py`) on the CPU: its fixture
writers against the JAX script's (loaded as a module, unchanged), the tiny
CLIP folder read back by `metrics/towers.py`, the Inception stand-in's
contract, the YAMLs' U-Net layout, the default workspace, the results
table, and (marked slow, as tests/test_replay_chain.py is) the whole chain
at --experts 2 --device cpu, every link a subprocess of the port's entry
points."""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from diffusion_pruning_tpu_torch.cli import replay_chain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "scripts", "other", "replay_chain.py")


@pytest.fixture(scope="module")
def jax_chain():
    spec = importlib.util.spec_from_file_location("jax_replay_chain", JAX_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tree(root):
    out = {}
    for folder, _, files in os.walk(root):
        for name in files:
            path = os.path.join(folder, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_tiny_coco_equals_the_jax_chains(jax_chain, tmp_path):
    """The same JPEG bytes and caption files, in COCO-2014's layout."""
    replay_chain.make_tiny_coco(str(tmp_path / "port"), n_train_imgs=6, n_val_imgs=3)
    jax_chain.make_tiny_coco(str(tmp_path / "jax"), n_train_imgs=6, n_val_imgs=3)
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got == want
    assert "images/train2014/COCO_train2014_000000000005.jpg" in got
    caps = json.loads(got["annotations/captions_val2014.json"])["annotations"]
    assert len(caps) == 12 and caps[0]["caption"].startswith("a photo of a red car")


def test_tiny_clip_folder_reads_back_through_the_towers(tmp_path):
    """config.json, model.safetensors in HF names and the BPE files: both
    towers load by name (nothing missing), captions tokenize through the
    letters-only vocabulary, and the embeddings have the projection's width."""
    from diffusion_pruning_tpu_torch.cli.cmmd import folder_vision_config
    from diffusion_pruning_tpu_torch.metrics.towers import load_clip_towers, read_clip_config
    folder = str(tmp_path / "clip")
    replay_chain.make_tiny_clip(folder)
    tcfg, vcfg = read_clip_config(folder)
    assert (tcfg.hidden_size, tcfg.num_layers, tcfg.vocab_size) == (32, 2, 54)
    assert (vcfg.image_size, vcfg.patch_size, vcfg.projection_dim) == (32, 8, 16)
    assert folder_vision_config(folder) == vcfg
    towers = load_clip_towers(folder, torch.device("cpu"))
    text = towers.embed_texts(["a photo of a red car number 12", "blue bird"])
    rng = np.random.default_rng(0)
    images = towers.embed_images([rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
                                  for _ in range(3)], unit=True)
    assert text.shape == (2, 16) and images.shape == (3, 16)
    assert np.isfinite(text).all() and np.allclose(np.linalg.norm(images, axis=1), 1.0,
                                                   rtol=1e-5)
    assert towers.logit_scale == pytest.approx(1 / 0.07, rel=1e-5)


def test_stub_inception_keeps_the_contract(jax_chain, tmp_path):
    """NCHW float → (N, 2C): each channel's mean and maximum, as the JAX
    chain's stand-in gives them."""
    replay_chain.make_stub_inception(str(tmp_path / "port.pt"))
    jax_chain.make_stub_inception(str(tmp_path / "jax.pt"))
    x = torch.rand(4, 3, 20, 24, generator=torch.Generator().manual_seed(0)) * 255
    got = torch.jit.load(str(tmp_path / "port.pt"))(x)
    assert got.shape == (4, 6)
    assert torch.equal(got, torch.jit.load(str(tmp_path / "jax.pt"))(x))
    assert torch.equal(got[:, :3], x.mean(dim=(2, 3)))


def test_yamls_take_the_sd21_layout_where_the_weights_are_full_width(jax_chain, tmp_path):
    """Without SD weights the YAMLs are the JAX chain's; with a folder holding
    unet/ they take SD-2.1's blocks, gate width and depth order, and a
    codebook that starts at quantizer_base 0."""
    args = replay_chain.parse_args(["--experts", "3", "--steps", "6", "--ft_steps", "2"])
    ws = tmp_path / "tiny"
    ws.mkdir()
    prune_cfg, ft_cfg = replay_chain.write_yamls(str(ws), args, "/data", "/runs")
    want = jax_chain.PRUNE_YAML.format(experts=3, data_dir="/data", runs="/runs", steps=6,
                                       pretrain=2, batch=2, router_lr="2e-4", infer_steps=3)
    assert yaml.safe_load(open(prune_cfg)) == yaml.safe_load(want)
    want = jax_chain.FINETUNE_YAML.format(experts=3, data_dir="/data", runs="/runs", steps=2,
                                          batch=2, infer_steps=3)
    assert yaml.safe_load(open(ft_cfg)) == yaml.safe_load(want)
    (tmp_path / "sd" / "unet").mkdir(parents=True)
    args = replay_chain.parse_args(["--pretrained_model_name_or_path", str(tmp_path / "sd")])
    ws = tmp_path / "full"
    ws.mkdir()
    for path in replay_chain.write_yamls(str(ws), args, "/data", "/runs"):
        unet = yaml.safe_load(open(path))["model"]["unet"]
        assert unet["unet_down_blocks"] == ["CrossAttnDownBlock2DHalfGated"] * 3 + [
            "DownBlock2DHalfGated"]
        assert unet["ff_gate_width"] == 32
        quantizer = yaml.safe_load(open(path))["model"]["quantizer"]
        assert len(quantizer["depth_order"]) == 14 and quantizer["quantizer_base"] == 0


def test_workspace_defaults_inside_the_checkout():
    """Without `--workspace` the chain works under build/replay of its own
    checkout, which git ignores, so two checkouts never resume from each
    other's links (`leg_done`)."""
    args = replay_chain.parse_args([])
    assert args.workspace == os.path.join(REPO, "build", "replay")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "build/" in f.read().split()


def test_results_table():
    results = {"experts": 2, "per_expert": {
        0: {"train_prompts": 9, "val_prompts": 3, "finetune_run": "r", "images": 3,
            "fid_stub": 12.345, "clip_score_tiny": 1.5, "cmmd_tiny": 0.1234},
        1: {"train_prompts": 1, "val_prompts": 0}}}
    lines = replay_chain.results_table(results).splitlines()
    assert lines[1].startswith("| expert | train | val | finetuned | imgs | FID(stub)")
    assert lines[3] == "| 0 | 9 | 3 | yes | 3 | 12.35 | 1.50 | 0.123 |"
    assert lines[4] == "| 1 | 1 | 0 | no | — | — | — | — |"


@pytest.mark.slow
def test_replay_chain_cpu(tmp_path):
    ws = tmp_path / "replay"
    proc = subprocess.run(
        [sys.executable, "-m", "diffusion_pruning_tpu_torch.cli.replay_chain",
         "--workspace", str(ws), "--experts", "2", "--steps", "4", "--ft_steps", "2",
         "--infer_steps", "2", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=3600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    results = json.load(open(ws / "REPLAY_RESULTS.json"))
    assert results["experts"] == 2
    assert sum(results["train_counts"]) == 64 * 4
    assert sum(results["val_counts"]) == 16 * 4
    full = [r for r in results["per_expert"].values() if "cmmd_tiny" in r]
    assert full, results
    for r in full:
        assert r["images"] > 0
        for k in ("fid_stub", "clip_score_tiny", "cmmd_tiny"):
            assert r[k] == r[k], (k, r)
    assert not os.path.exists(os.path.join(REPO, "runs", "replay_prune"))
