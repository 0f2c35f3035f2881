"""Stage 1 as a program in the port, held against the JAX package on the CPU:
the step's gradient accumulation (`accum_steps`), the YAML config and its
reader, the flags, the checkpoint and its artifacts, the diffusers-style
export and the state-dict loader, the factory, the loop (`PrunerLoop`) and
its heatmap images, and the prune entry point end to end on
`configs/pruning/tiny_smoke.yaml` with `--device cpu`.

Weights come from numpy (carried by `params_from_jax`), draws from the JAX
keys exactly as the JAX step splits them. Tolerances are stated at each
comparison."""
import dataclasses
import functools
import glob
import json
import logging
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from safetensors.torch import load_file, save_file

from diffusion_pruning_tpu.core.structure import build_structure as jax_build_structure
from diffusion_pruning_tpu.models.hypernet import HyperStructure as JaxHyperStructure
from diffusion_pruning_tpu.models.quantizer import StructureQuantizer as JaxQuantizer
from diffusion_pruning_tpu.models.unet.config import UNetConfig as JaxUNetConfig
from diffusion_pruning_tpu.models.unet.unet import GatedUNet as JaxGatedUNet
from diffusion_pruning_tpu.training import factory as jax_factory
from diffusion_pruning_tpu.training import pruner as jax_pruner
from diffusion_pruning_tpu.utils import arg_utils as jax_arg_utils
from diffusion_pruning_tpu.utils import checkpoint as jax_checkpoint
from diffusion_pruning_tpu.utils import config as jax_config
from diffusion_pruning_tpu.utils import export as jax_export
from diffusion_pruning_tpu.utils import logging_utils as jax_logging
from diffusion_pruning_tpu_torch.cli import prune
from diffusion_pruning_tpu_torch.models.convert import params_from_jax
from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
from diffusion_pruning_tpu_torch.models.text_encoders import (
    CLIPTextConfig,
    CLIPTextEncoder,
    MPNetConfig,
    MPNetEncoder,
)
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from diffusion_pruning_tpu_torch.training import (
    PrunerConfig,
    make_optimizer,
    make_pruner_step,
    make_validation_step,
)
from diffusion_pruning_tpu_torch.training import factory
from diffusion_pruning_tpu_torch.training import loop as loop_module
from diffusion_pruning_tpu_torch.training.loop import LoopConfig, PrunerLoop
from diffusion_pruning_tpu_torch.training.pruner import LOSS_TERMS
from diffusion_pruning_tpu_torch.utils import arg_utils, config, export, logging_utils
from diffusion_pruning_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    latest_checkpoint_dir,
    load_torch_artifact,
    save_torch_artifact,
)

import test_torch_port_training as tt
from test_torch_port_data import write_coco
from test_torch_port_training import unet_params, world  # noqa: F401 (fixtures)
from torch_port_common import numpy_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))
TINY_YAML = os.path.join(REPO, "configs", "pruning", "tiny_smoke.yaml")


def _t(a):
    return torch.from_numpy(np.array(a))


def _typed(v):
    """A tree with every leaf paired with its type, so equality checks types."""
    if isinstance(v, dict):
        return {k: _typed(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_typed(x) for x in v]
    return (type(v).__name__, "nan" if isinstance(v, float) and math.isnan(v) else v)


# ---------------------------------------------------------------- accum_steps

def _jax_micro_draws(key, spec, n_e, accum, b):
    """The draws of each micro-batch, split from `key` as the JAX step splits
    it under accumulation (training/pruner.py: keys and shared keys split
    into `accum` each, then per micro-batch as `_jax_draws` does)."""
    shared_key, key = jax.random.split(key)
    keys, shared = jax.random.split(key, accum), jax.random.split(shared_key, accum)
    out = []
    for k, sk in zip(keys, shared):
        k_vae, k_noise, k_t, k_g, _, _ = jax.random.split(k, 6)
        k1, k2 = jax.random.split(sk)
        lat = (b, 8, 8, 4)
        out.append({"vae_eps": _t(jax.random.normal(k_vae, lat)),
                    "noise": _t(jax.random.normal(k_noise, lat)),
                    "timesteps": _t(jax.random.randint(k_t, (b,), 0, 1000)).long(),
                    "gumbel": _t(tt._jax_gumbel(k_g, b, spec)),
                    "codebook_gumbel": _t(tt._jax_gumbel(k1, n_e, spec)),
                    "gates_gumbel": _t(tt._jax_gumbel(k2, b, spec))})
    return out


@pytest.mark.parametrize("pretrain", [True, False], ids=["pretrain", "codebook"])
def test_accumulated_step_matches_jax_two_steps(world, pretrain):
    """Two steps of 2 micro-batches of 2 against `make_pruner_step(accum_steps
    =2)`: the loss terms (mean over micro-batches, rtol 1e-4), the indices
    and ratios of the whole batch, the last micro-batch's snapshot, the mean
    gradients and the parameters after both steps, at the whole-step
    tolerances of tests/test_torch_port_training.py."""
    jmods, frozen, trainable = world
    cfg = jax_pruner.PrunerConfig(lr_warmup_steps=0)
    opt = optax.chain(tt._capture_grads(), jax_pruner.make_optimizer(cfg, global_batch=tt.B))
    step = jax_pruner.make_pruner_step(jmods, cfg, opt, mesh=None, pretrain=pretrain,
                                       accum_steps=2)
    batch = tt._batch(cached=not pretrain, seed=40)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    n_heads = len(jmods.hypernet.spec.width_list) + 1
    nw = jmods.quantizer.spec.num_width

    mods = tt._port_modules(world)
    pcfg = PrunerConfig(lr_warmup_steps=0)
    port_step = make_pruner_step(mods, pcfg, make_optimizer(pcfg, mods, tt.B),
                                 pretrain=pretrain, accum_steps=2)
    tr, opt_state = trainable, opt.init(trainable)
    at_floor = {}  # entries whose rounding-level gradients differ in sign in some step
    for i, key in enumerate((jax.random.PRNGKey(41), jax.random.PRNGKey(42))):
        tr, opt_state, q_state, metrics, aux = step(tr, frozen, opt_state, jbatch, key)
        got, got_aux = port_step(tt._port_batch(batch),
                                 _jax_micro_draws(key, jmods.quantizer.spec, 4, 2, tt.B // 2))
        assert not got["skipped"]
        for name in LOSS_TERMS:
            np.testing.assert_allclose(float(got[name]), float(metrics[name]),
                                       rtol=tt.LOSS_RTOL, atol=1e-7, err_msg=f"{i} {name}")
        np.testing.assert_array_equal(got_aux["expert_indices"].numpy(),
                                      np.asarray(aux["expert_indices"]))
        np.testing.assert_allclose(got_aux["batch_resource_ratios"].numpy(),
                                   np.asarray(aux["batch_resource_ratios"]), rtol=1e-5)
        np.testing.assert_allclose(mods.quantizer.embedding_gs.numpy(),
                                   np.asarray(q_state["embedding_gs"]), rtol=1e-5, atol=1e-6)
        want_grads = tt._jax_trainables(opt_state[0], n_heads)
        for name, g in tt._port_grads(mods).items():
            w = want_grads[name]
            atol = tt.GRAD_ATOL_FRAC * np.abs(w).max() + 1e-12
            at_floor[name] = at_floor.get(name, False) | (
                (np.abs(w) < atol) & (np.sign(g) != np.sign(w)))
            if name == "codebook":
                np.testing.assert_allclose(g[:, nw:], w[:, nw:], rtol=tt.DEPTH_GRAD_RTOL,
                                           atol=atol)
                g, w = g[:, :nw], w[:, :nw]
            np.testing.assert_allclose(g, w, rtol=tt.GRAD_RTOL, atol=atol, err_msg=f"{i} {name}")
    # Adam scales each gradient by its own RMS, so an entry whose gradient is
    # rounding noise (|g| below the grad atol) of the other sign in some step
    # moves by a whole step (the peak LR, 4e-4) the other way: it read 4.2e-4
    # at one codebook entry of 616 (gradients 8.8e-8 against -1.6e-8, the
    # largest 1.8e-2). Every other entry is held at PARAM_ATOL.
    want_params = tt._jax_trainables(tr, n_heads)
    lr = 2e-4 * tt.B ** 0.5
    for name, p in tt._port_trainables(mods).items():
        floor = at_floor[name]
        assert floor.mean() < 0.02, name
        np.testing.assert_allclose(p[~floor], want_params[name][~floor], rtol=0,
                                   atol=tt.PARAM_ATOL, err_msg=name)
        np.testing.assert_allclose(p[floor], want_params[name][floor], rtol=0, atol=2 * lr,
                                   err_msg=name)


def test_accumulated_step_needs_a_draw_per_micro_batch(world):
    mods = tt._port_modules(world)
    cfg = PrunerConfig()
    step = make_pruner_step(mods, cfg, make_optimizer(cfg, mods, tt.B), accum_steps=3)
    with pytest.raises(ValueError, match="does not split"):
        step(tt._port_batch(tt._batch(cached=True)), generator=torch.Generator())
    step = make_pruner_step(mods, cfg, make_optimizer(cfg, mods, tt.B), accum_steps=2)
    with pytest.raises(ValueError, match="one draws mapping per micro-batch"):
        step(tt._port_batch(tt._batch(cached=True)), draws=[{}])


# ---------------------------------------------------------------- config, flags

@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_load_config_matches_jax_on_every_shipped_yaml(path, tmp_path):
    """Values and types (`2e-4` and `1e-08` stay strings), and the port's dump
    read back by both packages."""
    want = _typed(jax_config.load_config(path).to_dict())
    cfg = config.load_config(path)
    assert _typed(cfg.to_dict()) == want
    dumped = str(tmp_path / "dump.yaml")
    cfg.dump(dumped)
    assert _typed(jax_config.load_config(dumped).to_dict()) == want
    assert _typed(config.load_config(dumped).to_dict()) == want


def test_config_paths_merge_and_clone():
    """As tests/test_config_ckpt.py: dotted get/set, a None never
    overwrites, clone is deep."""
    cfg = config.load_config_dict({"a": {"b": 1}})
    cfg.update_flat({"a.b": None, "seed": 43, "x.y.z": 2.0})
    assert (cfg.a.b, cfg.seed, cfg.get_path("x.y.z"), cfg.get_path("x.q", 5)) == (1, 43, 2.0, 5)
    cfg.update_flat({"a.b": 7})
    clone = cfg.clone()
    clone.a.b = 8
    assert cfg.a.b == 7 and isinstance(clone.a, config.Config)


@pytest.mark.parametrize("argv", [
    ["--base_config_path", "c.yaml"],
    ["--base_config_path", "c.yaml", "--seed", "7", "--mesh_shape", "1", "--use_ema",
     "--compute_dtype", "float32", "--pruning_type", "magnitude", "--expert_id", "3",
     "--jax_cache_dir", "/tmp/x", "--pretrained_model_name_or_path", "/m"],
])
def test_parse_args_gives_the_jax_namespace(argv):
    ours = vars(arg_utils.parse_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == vars(jax_arg_utils.parse_args(argv))
    assert arg_utils.parse_args(argv + ["--device", "cpu"]).device == "cpu"


# ---------------------------------------------------------------- checkpoint

def test_checkpoint_round_trip_rotation_and_latest_by_number(tmp_path):
    mgr = CheckpointManager(str(tmp_path), total_limit=2)
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for step in (10, 999, 1000):
        mgr.save(step, {"w": w * step, "step": step, "opt": {"lr": [0.1], "name": "hypernet"}},
                 artifacts={"quantizer_embeddings.pt": torch.full((4, 8), 0.25),
                            "arch_vector.pt": np.linspace(0, 1, 10)})
    assert mgr.list_steps() == [999, 1000]                       # rotated
    assert latest_checkpoint_dir(str(tmp_path)).endswith("checkpoint-1000")  # not 999
    restored = mgr.restore()
    assert restored["step"] == 1000 and restored["opt"]["name"] == "hypernet"
    assert torch.equal(restored["w"], w * 1000)
    assert torch.equal(mgr.restore(999)["w"], w * 999)
    d = mgr.dir_for(1000)
    # the reference-format artifacts: plain tensors, read by the JAX package too
    emb = jax_checkpoint.load_torch_artifact(os.path.join(d, "quantizer_embeddings.pt"))
    np.testing.assert_array_equal(emb, np.full((4, 8), 0.25, np.float32))
    np.testing.assert_allclose(jax_checkpoint.load_torch_artifact(
        os.path.join(d, "arch_vector.pt")), np.linspace(0, 1, 10))
    p = str(tmp_path / "jax.pt")
    jax_checkpoint.save_torch_artifact(np.arange(3.0), p)
    assert torch.equal(load_torch_artifact(p), torch.arange(3.0, dtype=torch.float64))
    save_torch_artifact(torch.ones(2, requires_grad=True)[:1], p)
    assert torch.equal(load_torch_artifact(p), torch.ones(1))
    os.makedirs(tmp_path / "x")
    assert latest_checkpoint_dir(str(tmp_path / "x")) is None
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "x")).restore()


# ---------------------------------------------------------------- state dicts, images

def test_safetensors_files_match_the_library(tmp_path):
    """`load_torch_state_dict` reads the library's `.safetensors` and torch's
    `.bin` with their stored dtypes, from a file or from a folder by the
    usual names in order; the export writes every tensor as contiguous f32."""
    g = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 5, generator=g), "bf16": torch.randn(7, generator=g).bfloat16(),
               "f16": torch.randn(2, 2, generator=g).half(), "i64": torch.arange(5),
               "bool": torch.tensor([True, False, True]), "scalar": torch.tensor(2.5),
               "empty": torch.zeros(0, 4)}
    folder = tmp_path / "model"
    folder.mkdir()
    save_file(tensors, str(folder / "model.safetensors"))
    torch.save({"bin": torch.ones(2)}, str(folder / "pytorch_model.bin"))
    for got in (export.load_torch_state_dict(str(folder)),
                export.load_torch_state_dict(str(folder / "model.safetensors"))):
        assert sorted(got) == sorted(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert export.load_torch_state_dict(str(folder / "pytorch_model.bin"))["bin"].sum() == 2
    with pytest.raises(FileNotFoundError):
        export.load_torch_state_dict(str(tmp_path))
    written = {"strided": torch.randn(6, 4, generator=g).t(), "bf16": tensors["bf16"]}
    export._save(str(tmp_path / "out"), "X", {"n": 1}, written)
    back = load_file(str(tmp_path / "out" / export._WEIGHTS_NAME))
    for k, v in written.items():
        assert back[k].dtype == torch.float32 and torch.equal(back[k], v.float()), k


def test_png_writer_heatmap_and_grid_match_pillow_and_jax(tmp_path):
    """The heatmap and grid pixels are the JAX package's; the loop's heatmap
    PNGs read back through Pillow as those pixels."""
    from types import SimpleNamespace

    from PIL import Image
    rng = np.random.default_rng(0)
    m = rng.standard_normal((4, 3))
    np.testing.assert_array_equal(logging_utils.heatmap_image(m, scale=3),
                                  np.asarray(jax_logging.heatmap_image(m, scale=3)))
    images = rng.random((5, 4, 6, 3))
    np.testing.assert_array_equal(logging_utils.image_grid(images, cols=2),
                                  np.asarray(jax_logging.image_grid(images, cols=2)))
    logged = []
    gs = torch.from_numpy(rng.random((4, 10)).astype(np.float32))
    stub = SimpleNamespace(
        run_dir=str(tmp_path), global_step=7,
        mods=SimpleNamespace(quantizer=SimpleNamespace(embedding_gs=gs)),
        tracker=SimpleNamespace(log_images=lambda images, step: logged.append((images, step))))
    ratios = torch.tensor([0.25, 0.5, 0.75])
    PrunerLoop.log_heatmaps(stub, {"batch_resource_ratios": ratios})
    codes = (gs.numpy() >= 0.5).astype(np.float32)
    codes = codes / (np.linalg.norm(codes, axis=1, keepdims=True) + 1e-9)
    want = {"codebook_sim_7.png": np.asarray(jax_logging.heatmap_image(codes @ codes.T)),
            "batch_resource_ratios_7.png": np.asarray(jax_logging.heatmap_image(
                ratios.numpy().reshape(-1, 1)))}
    for name, pixels in want.items():
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "heatmaps" / name)),
                                      pixels, err_msg=name)
    assert logged[0][1] == 7 and sorted(logged[0][0]) == ["batch_resource_ratios",
                                                         "codebook_similarity"]


def test_tracker_writes_jsonl_and_warns_without_wandb(tmp_path, caplog, monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "wandb", None)  # not importable
    with caplog.at_level(logging.WARNING):
        tracker = logging_utils.Tracker(str(tmp_path), use_wandb=True)
    assert "JSONL tracking only" in caplog.text
    tracker.log({"loss": torch.tensor(1.5), "n": 3, "vec": np.zeros(2)}, step=4)
    tracker.log_images({"x": np.zeros((2, 2, 3), np.uint8)}, step=4)
    tracker.close()
    with open(tmp_path / "metrics.jsonl") as f:
        assert json.loads(f.read()) == {"step": 4, "loss": 1.5, "n": 3.0}
    run = logging_utils.make_run_dir(str(tmp_path / "runs"), "cfg/tiny.yaml", "r1")
    assert run == str(tmp_path / "runs" / "tiny" / "r1") and os.path.isdir(run)


# ---------------------------------------------------------------- export

def _files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(f"{root}/**/*", recursive=True)
                  if os.path.isfile(p))


def _same_export(ours, theirs):
    """Same file names, the same config.json, equal f32 tensors by name."""
    assert _files(ours) == _files(theirs)
    for sub in {os.path.dirname(f) for f in _files(ours)}:
        with open(os.path.join(ours, sub, "config.json")) as f:
            a = json.load(f)
        with open(os.path.join(theirs, sub, "config.json")) as f:
            assert a == json.load(f), sub
        a = load_file(os.path.join(ours, sub, export._WEIGHTS_NAME))
        b = load_file(os.path.join(theirs, sub, export._WEIGHTS_NAME))
        assert sorted(a) == sorted(b), sub
        for k in a:
            assert a[k].dtype == b[k].dtype == torch.float32
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{sub} {k}")


@pytest.mark.parametrize("use_linear_projection", [True, False], ids=["linear", "conv"])
def test_unet_export_matches_jax(tmp_path, use_linear_projection):
    jcfg = JaxUNetConfig.tiny(cross_attention_dim=32,
                              use_linear_projection=use_linear_projection)
    params = numpy_params(jax.eval_shape(
        lambda: JaxGatedUNet(jcfg).init_params(jax.random.PRNGKey(0))), seed=2)
    unet = GatedUNet(UNetConfig.tiny(cross_attention_dim=32,
                                     use_linear_projection=use_linear_projection))
    unet.load_state_dict(params_from_jax(params, unet))
    jax_export.export_unet(str(tmp_path / "jax" / "unet"), jcfg, params)
    export.export_unet(str(tmp_path / "port" / "unet"), unet)
    _same_export(str(tmp_path / "port"), str(tmp_path / "jax"))
    # the export loads back into the port and into the JAX package alike
    sd = export.load_torch_state_dict(str(tmp_path / "port" / "unet"))
    again = GatedUNet(unet.cfg)
    again.load_state_dict(sd)
    assert all(torch.equal(again.state_dict()[k], v) for k, v in unet.state_dict().items())


@pytest.mark.parametrize("hn_options,q_options", [
    ({}, {}),
    (dict(weight_norm=True, linear_bias=False), dict(optimal_transport=False)),
    (dict(single_arch_param=True), dict(resource_aware_normalization=True)),
], ids=["default", "weight_norm_no_ot", "single_arch_resource_aware"])
def test_pruning_checkpoint_export_matches_jax(tmp_path, hn_options, q_options):
    spec = jax_build_structure(JaxUNetConfig.tiny())
    jhn = JaxHyperStructure(spec, input_dim=24, **hn_options)
    hn_params = numpy_params(jax.eval_shape(
        lambda: jhn.init(jax.random.PRNGKey(0), jnp.zeros((1, 24))))["params"], seed=5)
    jq = JaxQuantizer(spec, n_e=4, base=3, depth_order=(-1, -2, 0, 1, -3, 2), **q_options)
    q_params = {"embedding": np.random.default_rng(1).standard_normal(
        (4, spec.vq_dim)).astype(np.float32)}
    q_state = {"embedding_gs": np.random.default_rng(2).random((4, spec.vq_dim),
                                                               dtype=np.float32)}
    pspec = GatedUNet(UNetConfig.tiny()).spec
    hn = HyperStructure(pspec, input_dim=24, **hn_options)
    hn.load_state_dict(params_from_jax(hn_params, hn))
    q = StructureQuantizer(pspec, n_e=4, base=3, depth_order=(-1, -2, 0, 1, -3, 2), **q_options)
    q.load_state_dict(params_from_jax({**q_params, **q_state}, q))
    jax_export.export_pruning_checkpoint(str(tmp_path / "jax"), jhn, hn_params, jq, q_params,
                                         q_state)
    export.export_pruning_checkpoint(str(tmp_path / "port"), hn, q)
    _same_export(str(tmp_path / "port"), str(tmp_path / "jax"))


# ---------------------------------------------------------------- factory

@pytest.mark.parametrize("path", [p for p in CONFIGS if "/pruning/" in p],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_factory_unet_config_matches_jax(path):
    cfg = config.load_config(path)
    jcfg = jax_config.load_config(path)
    for tiny in (False, True):
        assert (dataclasses.asdict(factory.unet_config_from_yaml(cfg, tiny=tiny))
                == dataclasses.asdict(jax_factory.unet_config_from_yaml(jcfg, tiny=tiny)))
    cfg.set_path("training.gradient_checkpointing", True)
    cfg.set_path("model.unet.fused_norm_conv", True)
    assert factory.unet_config_from_yaml(cfg).remat
    assert factory.unet_config_from_yaml(cfg, tiny=True).fused_norm_conv


def _checkpoint_dirs(root):
    """Tiny diffusers/HF folders written from seeded port modules: unet/ and
    vae/ in bf16 (diffusers names), text_encoder/ in f32 without the
    `text_model.` prefix and with HF's position_ids and a longer position
    table, an MPNet dir with the `mpnet.` prefix and a pooler."""
    gen = torch.Generator().manual_seed(3)
    mods = {"unet": GatedUNet(UNetConfig.tiny()), "vae": AutoencoderKL(VAEConfig.tiny()),
            "text_encoder": CLIPTextEncoder(CLIPTextConfig.tiny()),
            "mpnet": MPNetEncoder(MPNetConfig.tiny())}
    for m in mods.values():
        for p in m.parameters():
            p.data.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    for name in ("unet", "vae"):
        os.makedirs(root / name)
        save_file({k: v.bfloat16() for k, v in mods[name].state_dict().items()},
                  str(root / name / "diffusion_pytorch_model.safetensors"))
    text = {k[len("text_model."):]: v for k, v in mods["text_encoder"].state_dict().items()}
    pos = text["embeddings.position_embedding.weight"]
    text["embeddings.position_embedding.weight"] = torch.cat([pos, pos[:3] + 1])
    text["embeddings.position_ids"] = torch.arange(80)[None]
    os.makedirs(root / "text_encoder")
    save_file(text, str(root / "text_encoder" / "model.safetensors"))
    mp = {f"mpnet.{k}": v for k, v in mods["mpnet"].state_dict().items()}
    mp["pooler.dense.weight"] = torch.zeros(2, 2)
    os.makedirs(root / "mpnet")
    torch.save(mp, str(root / "mpnet" / "pytorch_model.bin"))
    return mods


def test_factory_loads_checkpoint_folders_as_the_jax_factory_does(tmp_path, caplog):
    """Each module loaded by state-dict name equals its source (bf16 frozen
    modules bit for bit); the JAX factory's converters read the same folders
    to the same weights (carried back by `params_from_jax`, exact); a
    missing folder gives a seeded random init and a warning."""
    src = _checkpoint_dirs(tmp_path)
    ucfg = UNetConfig.tiny()
    unet = factory.build_unet(ucfg, str(tmp_path), "cpu", torch.bfloat16)
    vae = factory.build_vae(str(tmp_path), tiny=True, device="cpu", dtype=torch.bfloat16)
    text = factory.build_text_encoder(str(tmp_path), tiny=True, device="cpu")
    mpnet = factory.build_mpnet(str(tmp_path / "mpnet"), tiny=True, device="cpu")
    for name, got, dtype in (("unet", unet, torch.bfloat16), ("vae", vae, torch.bfloat16),
                             ("text_encoder", text, torch.float32), ("mpnet", mpnet, torch.float32)):
        assert not any(p.requires_grad for p in got.parameters())
        for k, v in src[name].state_dict().items():
            assert torch.equal(got.state_dict()[k], v.to(dtype)), (name, k)
    jax_loaded = {
        "unet": (jax_factory.build_unet(JaxUNetConfig.tiny(), str(tmp_path))[1], unet),
        "vae": (jax_factory.build_vae(str(tmp_path), tiny=True)[1], vae),
        "text_encoder": (jax_factory.build_text_encoder(str(tmp_path), tiny=True)[1], text),
        "mpnet": (jax_factory.build_mpnet(str(tmp_path / "mpnet"), tiny=True)[1], mpnet)}
    for name, (params, module) in jax_loaded.items():
        carried = params_from_jax(jax.tree.map(np.asarray, params), module)
        for k, v in module.state_dict().items():
            assert torch.equal(carried[k], v.float()), (name, k)
    with caplog.at_level(logging.WARNING):
        fresh = factory.build_unet(ucfg, str(tmp_path / "none"), "cpu")
        again = factory.build_unet(ucfg, str(tmp_path / "none"), "cpu")
    assert "missing — random init" in caplog.text
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                 again.state_dict().values()))


def test_factory_trainables_follow_the_yaml():
    cfg = config.load_config(TINY_YAML)
    spec = GatedUNet(UNetConfig.tiny()).spec
    hn = factory.build_hypernet(spec, cfg, input_dim=32, device="cpu")
    w = hn.mh_fc[0].weight
    torch.testing.assert_close(w @ w.T, torch.eye(w.shape[0]), atol=1e-5, rtol=0)
    cfg.set_path("model.hypernet.weight_norm", True)
    cfg.set_path("model.quantizer.optimal_transport", False)
    cfg.set_path("model.quantizer.resource_aware_normalization", True)
    assert factory.build_hypernet(spec, cfg, 32, "cpu").mh_fc[0].g is not None
    q = factory.build_quantizer(spec, cfg, device="cpu")
    assert (q.n_e, q.base, q.optimal_transport, q.resource_aware_normalization) == (4, 3, False,
                                                                                   True)
    assert q.depth_order == (-1, -2, 0, 1, -3, 2)
    assert torch.equal(q.embedding_gs, q.gumbel_sigmoid_trick(q.embedding.weight).detach())


# ---------------------------------------------------------------- the loop

def _loop_batches(b=tt.B, n=8, nan_at=None):
    def gen(_epoch=0):
        rng = np.random.RandomState(0)
        for i in range(n):
            batch = {"pixel_values": rng.randn(b, 16, 16, 3).astype(np.float32) * 0.5,
                     "input_ids": rng.randint(0, 128, (b, 77)).astype(np.int32),
                     "mpnet_embeddings": rng.randn(b, 24).astype(np.float32),
                     "ignored": np.zeros(1)}
            if i == nan_at:
                batch["mpnet_embeddings"][0, 0] = np.nan
            yield batch
    return gen


def _state_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _state_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _state_equal(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a.cpu(), b.cpu()), path
    else:
        assert a == b, path


def test_pruner_loop_phases_skips_checkpoints_resume_and_ema(world, tmp_path):
    """A tiny world for 4 steps (one pretrain), step 3's batch NaN: the
    phase switch, the skip count, metrics every step with the expert-usage
    histogram, heatmaps, the checkpoint layout (the step's soft snapshot as
    quantizer_embeddings.pt, hypernet/ and quantizer/), the EMA's recursion,
    and a resume that restores every tensor bit for bit."""
    mods = tt._port_modules(world)
    cfg = PrunerConfig(lr_warmup_steps=0, scale_lr=False)
    opt = make_optimizer(cfg, mods, tt.B)
    phases, params_after = [], []

    def make_step(m, c, o, pretrain):
        step = make_pruner_step(m, c, o, pretrain=pretrain)

        def recorded(batch, **kw):
            phases.append(pretrain)
            out = step(batch, **kw)
            params_after.append({n: p.detach().clone() for n, p in loop.trainables()})
            return out
        return recorded

    lc = LoopConfig(max_train_steps=4, hypernet_pretraining_steps=1, validation_steps=2,
                    image_logging_steps=2, log_every=1)
    loop = PrunerLoop(mods, cfg, lc, opt, make_step, make_validation_step, str(tmp_path),
                      ema_decay=0.5)
    ema = {n: p.detach().clone() for n, p in loop.trainables()}
    loop.train(_loop_batches(nan_at=2), lambda: _loop_batches(n=1)())
    assert phases == [True, False, False, False] and loop.global_step == 4
    assert loop.skipped_steps == 1
    for after in params_after:
        ema = {n: e * 0.5 + after[n] * 0.5 for n, e in ema.items()}
    for n, e in ema.items():
        assert torch.equal(loop.ema[n], e), n
    with open(tmp_path / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    train_lines = [m for m in lines if "loss" in m]
    assert [m["step"] for m in train_lines] == [1, 2, 3, 4]
    assert [m["skipped"] for m in train_lines] == [0.0, 0.0, 1.0, 0.0]
    assert train_lines[-1]["skipped_steps"] == 1.0
    for m in train_lines:
        assert sum(m[f"expert_usage/{e}"] for e in range(4)) == tt.B and m["steps_per_sec"] > 0
    assert sum("val_loss" in m for m in lines) == 2
    assert sorted(os.listdir(tmp_path / "heatmaps")) == [
        "batch_resource_ratios_2.png", "batch_resource_ratios_4.png",
        "codebook_sim_2.png", "codebook_sim_4.png"]
    assert loop.ckpt.list_steps() == [4]                   # per epoch + final, rotated to 1
    d = loop.ckpt.dir_for(4)
    assert sorted(os.listdir(d)) == ["hypernet", "quantizer", "quantizer_embeddings.pt", "state"]
    emb = load_torch_artifact(os.path.join(d, "quantizer_embeddings.pt"))
    assert torch.equal(emb, mods.quantizer.embedding_gs)
    assert ((emb > 0) & (emb < 1)).any(), "the snapshot must be soft, not binarised"
    exported = load_file(os.path.join(d, "quantizer", export._WEIGHTS_NAME))
    assert torch.equal(exported["embedding_gs"], emb)

    # resume into freshly initialised modules
    mods2 = tt._port_modules(world)
    opt2 = make_optimizer(cfg, mods2, tt.B)
    lc2 = dataclasses.replace(lc, resume_from="latest")
    loop2 = PrunerLoop(mods2, cfg, lc2, opt2, make_pruner_step, make_validation_step,
                       str(tmp_path), ema_decay=0.5)
    assert not torch.equal(mods2.hypernet.mh_fc[0].weight, mods.hypernet.mh_fc[0].weight)
    loop2.maybe_resume()
    assert loop2.global_step == 4 and loop2.skipped_steps == 1
    _state_equal(loop2.state_dict(), loop.state_dict())
    loop3 = PrunerLoop(mods2, cfg, dataclasses.replace(lc2, resume_from="4"), opt2,
                       make_pruner_step, make_validation_step, str(tmp_path))
    loop3.maybe_resume()
    assert loop3.global_step == 4


# ---------------------------------------------------------------- the entry point

def _yaml(tmp_path, name="tiny.yaml", **changes):
    with open(TINY_YAML) as f:
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


def test_prune_cli_runs_tiny_smoke_on_the_cpu_and_resumes(tmp_path, monkeypatch):
    """tiny_smoke.yaml end to end with --device cpu: 6 steps (2 pretrain),
    validation, the final checkpoint with unet/ exported (the default); then
    a resume to step 8 with gradient accumulation over 2 micro-batches of 1,
    which rotates checkpoint-6 away, its loop logging every step."""
    argv = ["--base_config_path", _yaml(tmp_path), "--device", "cpu",
            "--wandb_run_name", "r", "--pretrained_model_name_or_path", ""]
    loop = prune.main(argv)
    run = tmp_path / "runs" / "tiny" / "r"
    assert loop.global_step == 6 and loop.run_dir == str(run)
    d = run / "checkpoint-6"
    assert sorted(os.listdir(d)) == ["hypernet", "quantizer", "quantizer_embeddings.pt",
                                     "state", "unet"]
    sd = load_file(str(d / "unet" / export._WEIGHTS_NAME))
    assert all(torch.equal(sd[k], v.float()) for k, v in loop.mods.unet.state_dict().items())
    assert config.load_config(str(run / "config.yaml")).device == "cpu"

    os.makedirs(tmp_path / "resume")
    argv2 = ["--base_config_path", _yaml(
        tmp_path, "resume/tiny.yaml", **{"training.max_train_steps": 8,
                                    "training.gradient_accumulation_steps": 2,
                                    "training.logging.resume_from_checkpoint": "latest"}),
             "--device", "cpu", "--wandb_run_name", "r", "--pretrained_model_name_or_path", ""]
    saved = torch.load(str(d / "state" / "state.pt"), weights_only=True)
    monkeypatch.setattr(loop_module, "LoopConfig", functools.partial(LoopConfig, log_every=1))
    loop2 = prune.main(argv2)
    assert loop2.global_step == 8 and os.listdir(run).count("checkpoint-8") == 1
    assert not (run / "checkpoint-6").exists()
    assert saved["step"] == 6
    with open(run / "metrics.jsonl") as f:
        steps = [json.loads(line) for line in f if '"loss"' in line]
    assert [m["step"] for m in steps] == [7, 8]
    assert all(math.isfinite(m["loss"]) for m in steps)
    assert all(sum(m[f"expert_usage/{e}"] for e in range(4)) == 2 for m in steps)


def test_prune_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """No card without `--device cpu` and a `--mesh_shape` other than the
    launch's world size (1 here) raise before the run directory is made; a
    `data_dir` that exists is trained on. (The Hub upload runs at the end:
    tests/test_torch_port_hub.py.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = ["--pretrained_model_name_or_path", "", "--wandb_run_name", "r"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prune.main(["--base_config_path", _yaml(tmp_path)] + base)
    assert not (tmp_path / "runs").exists()
    with pytest.raises(ValueError, match="--mesh_shape 2 differs from the world size 1"):
        prune.main(["--base_config_path", _yaml(tmp_path), "--device", "cpu",
                    "--mesh_shape", "2"] + base)
    assert not (tmp_path / "runs").exists()
    data_dir = write_coco(tmp_path / "coco", n_train=6, n_val=4)
    loop = prune.main(["--base_config_path", _yaml(tmp_path, "d.yaml", **{
        "data.data_dir": data_dir, "data.dataset_name": "coco",
        "training.max_train_steps": 2, "training.validation_steps": 2}),
        "--device", "cpu"] + base)
    assert loop.global_step == 2 and loop.ckpt.list_steps() == [2]