"""Evaluation and serving entry points of the port, held against the JAX
package on the CPU: the metric functions, CLIP's pooled text features, the
CLIP-score, CMMD and FID entry points against the JAX scripts on the same
files, the per-expert and baseline image generation, the pruning-ratio
report, the depth ablation, and the serve entry point in its three modes
after a tiny stage-1 run of the port's prune entry point.

Weights and inputs come from numpy seeds; tolerances are stated at each
comparison. The JAX scripts are loaded with `importlib`, as
`tests/test_metrics.py` loads `fid.py`; their accelerator path
(`--backend jax`) runs the CLIP vision tower in bf16, so on the CPU the
test builds it in f32, the port's CPU dtype."""
import dataclasses
import importlib.util
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
import yaml
from PIL import Image
from safetensors.torch import save_file

from diffusion_pruning_tpu import metrics as jax_metrics
from diffusion_pruning_tpu.core.structure import build_structure as jax_build_structure
from diffusion_pruning_tpu.models import clip_vision as jax_clip_vision
from diffusion_pruning_tpu.models import text_encoders as jax_te
from diffusion_pruning_tpu.models.convert import (
    convert_clip_text_state_dict,
    convert_clip_vision_state_dict,
)
from diffusion_pruning_tpu.models.safety import clip_preprocess as jax_clip_preprocess
from diffusion_pruning_tpu.models.unet import pruned as jax_pruned
from diffusion_pruning_tpu.models.unet.config import UNetConfig as JaxUNetConfig
from diffusion_pruning_tpu.models.unet.unet import GatedUNet as JaxGatedUNet
from diffusion_pruning_tpu_torch import metrics
from diffusion_pruning_tpu_torch.cli import (
    calculate_pruning_ratio,
    clip_features,
    clip_score,
    cmmd,
    depth_analysis,
    fid,
    filter_dataset,
    finetune,
    finetune_baseline,
    generate_fid_images,
    generate_images,
    prune,
    resize_and_save_images,
    sample_coco_30k,
    save_captions,
    serve,
)
from diffusion_pruning_tpu_torch.metrics.towers import load_clip_towers
from diffusion_pruning_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder
from diffusion_pruning_tpu_torch.models.convert import params_from_jax
from diffusion_pruning_tpu_torch.models.text_encoders import (
    CLIPTextConfig,
    CLIPTextEncoder,
    clip_pooled_text_features,
)
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.unet.pruned import make_expert_plan
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    latest_checkpoint_dir,
    load_torch_artifact,
)
from diffusion_pruning_tpu_torch.utils.config import load_config

from test_torch_port_data import write_clip_tokenizer, write_coco
from torch_port_common import numpy_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRUNE_YAML = os.path.join(REPO, "configs", "pruning", "tiny_smoke.yaml")
FINETUNE_YAML = os.path.join(REPO, "configs", "finetuning", "tiny_smoke.yaml")
METRIC_RTOL = 1e-12
TINY_TEXT = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
TINY_VISION = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                   image_size=32, patch_size=8, projection_dim=16)
PROJ = 16


def _script(*parts):
    path = os.path.join(REPO, "scripts", *parts)
    spec = importlib.util.spec_from_file_location("jax_" + parts[-1][:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(mod, monkeypatch, capsys, *argv):
    """A JAX script's main() with `argv`; returns what it printed."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["script", *argv])
    mod.main()
    return capsys.readouterr().out


def _yaml(src, folder, name, **changes):
    with open(src) as f:
        cfg = yaml.safe_load(f)
    cfg["training"]["logging"]["logging_dir"] = str(folder / "runs")
    for path, value in changes.items():
        node = cfg
        *parents, last = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = value
    out = folder / name
    out.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(out)


# ---------------------------------------------------------------- metrics

def _features(case, rng):
    if case == "full_rank":
        return rng.standard_normal((40, 6)), rng.standard_normal((30, 6)) * 1.3 + 0.4
    if case == "rank_deficient":   # N < D: both covariances singular
        return rng.standard_normal((5, 12)), rng.standard_normal((7, 12)) + 0.2
    return rng.standard_normal((16, 4)), rng.standard_normal((16, 4))


@pytest.mark.parametrize("case", ["full_rank", "rank_deficient", "non_finite_sqrtm"])
def test_metric_functions_match_jax(case, monkeypatch):
    """gaussian_stats, frechet_distance (the `eps` branch forced by a sqrtm
    that returns NaN on its first call, in both packages), clip_score,
    mmd_rbf and cmmd against the JAX package's at rtol 1e-12."""
    a, b = _features(case, np.random.default_rng(len(case)))
    if case == "non_finite_sqrtm":
        real, calls = scipy.linalg.sqrtm, []

        def sqrtm(m, **kw):  # NaN on each package's first call
            calls.append(sorted(kw))
            out = np.full_like(m, np.nan) if len(calls) % 2 else real(m)
            return (out, 0.0) if kw.get("disp") is False else out
        monkeypatch.setattr(scipy.linalg, "sqrtm", sqrtm)
    got_a, got_b = metrics.gaussian_stats(a), metrics.gaussian_stats(b)
    want_a, want_b = jax_metrics.gaussian_stats(a), jax_metrics.gaussian_stats(b)
    for got, want in zip(got_a + got_b, want_a + want_b):
        np.testing.assert_allclose(got, want, rtol=METRIC_RTOL)
    got = metrics.frechet_distance(*got_a, *got_b)
    want = jax_metrics.frechet_distance(*want_a, *want_b)
    assert math.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=METRIC_RTOL)
    if case == "non_finite_sqrtm":
        # each package took the eps branch; the port never passes `disp`
        assert calls == [[], [], ["disp"], []]
        return
    c = a[: len(b)] if len(a) >= len(b) else a
    d = b[: len(c)] * 0.5 + c[:, :b.shape[1]]
    np.testing.assert_allclose(metrics.clip_score(c, d, 80.0),
                               jax_metrics.clip_score(c, d, 80.0), rtol=METRIC_RTOL)
    np.testing.assert_allclose(metrics.mmd_rbf(a, b, 3.0), jax_metrics.mmd_rbf(a, b, 3.0),
                               rtol=METRIC_RTOL)
    np.testing.assert_allclose(metrics.cmmd(a.astype(np.float32), b.astype(np.float32)),
                               jax_metrics.cmmd(a.astype(np.float32), b.astype(np.float32)),
                               rtol=METRIC_RTOL)


def test_frechet_distance_runs_on_a_scipy_without_disp(monkeypatch):
    """SciPy 1.18 (the H100 installation's) removed `sqrtm`'s `disp` argument,
    which the JAX package passes: the port's FID calls it without and keeps
    the JAX value (taken before the stand-in goes in)."""
    a, b = _features("full_rank", np.random.default_rng(4))
    want = jax_metrics.frechet_distance(*jax_metrics.gaussian_stats(a),
                                        *jax_metrics.gaussian_stats(b))
    real = scipy.linalg.sqrtm

    def sqrtm(m):
        return real(m)
    monkeypatch.setattr(scipy.linalg, "sqrtm", sqrtm)
    got = metrics.frechet_distance(*metrics.gaussian_stats(a), *metrics.gaussian_stats(b))
    np.testing.assert_allclose(got, want, rtol=METRIC_RTOL)


def test_gaussian_stats_refuses_a_single_sample():
    for mod in (metrics, jax_metrics):
        with pytest.raises(ValueError, match="single sample"):
            mod.gaussian_stats(np.ones((1, 4)))


# ---------------------------------------------------------------- CLIP towers

def _random_state(module, rng):
    sd = {}
    for k, v in module.state_dict().items():
        if k.endswith(("layer_norm1.weight", "layer_norm2.weight", "norm.weight",
                       "layrnorm.weight", "layernorm.weight")):
            sd[k] = torch.from_numpy(1 + 0.1 * rng.standard_normal(v.shape, dtype=np.float32))
        elif v.ndim <= 1:
            sd[k] = torch.from_numpy(0.1 * rng.standard_normal(v.shape, dtype=np.float32))
        else:
            fan_in = float(np.prod(v.shape[1:])) if "embedding" not in k else 1.0
            sd[k] = torch.from_numpy(rng.standard_normal(v.shape, dtype=np.float32)
                                     / np.sqrt(fan_in))
    return sd


def write_clip_folder(folder, seed=0, text_act="gelu", vision_act="quick_gelu", text=True):
    """A local HF CLIP folder at the tiny widths: config.json, the tokenizer
    files (byte-level BPE), model.safetensors in HF names with a random
    projection and logit scale. Returns (text cfg, vision cfg)."""
    os.makedirs(folder, exist_ok=True)
    vocab = write_clip_tokenizer(str(folder))
    tcfg = CLIPTextConfig(vocab_size=vocab, hidden_act=text_act, **TINY_TEXT)
    vcfg = CLIPVisionConfig(hidden_act=vision_act, **TINY_VISION)
    rng = np.random.default_rng(seed)
    sd = _random_state(CLIPVisionEncoder(vcfg), rng)
    conf = {"model_type": "clip", "architectures": ["CLIPModel"], "projection_dim": PROJ,
            "vision_config": {"hidden_size": 32, "num_hidden_layers": 2,
                              "num_attention_heads": 2, "intermediate_size": 64,
                              "image_size": 32, "patch_size": 8, "hidden_act": vision_act}}
    if text:
        sd.update(_random_state(CLIPTextEncoder(tcfg), rng))
        sd["text_projection.weight"] = torch.from_numpy(
            rng.standard_normal((PROJ, 32), dtype=np.float32) / np.sqrt(32))
        sd["logit_scale"] = torch.tensor(math.log(1 / 0.07))
        sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]  # HF's buffer
        conf["text_config"] = {"vocab_size": vocab, "hidden_size": 32, "num_hidden_layers": 2,
                               "num_attention_heads": 2, "intermediate_size": 64,
                               "max_position_embeddings": 77, "hidden_act": text_act,
                               "eos_token_id": 2, "bos_token_id": 0, "pad_token_id": 1}
    save_file({k: v.contiguous() for k, v in sd.items()}, os.path.join(folder, "model.safetensors"))
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(conf, f)
    return tcfg, vcfg


@pytest.fixture(scope="module")
def clip_folder(tmp_path_factory):
    folder = tmp_path_factory.mktemp("clip") / "clip"
    return folder, write_clip_folder(folder)


def _jax_text_cfg(tcfg):
    return jax_te.CLIPTextConfig(vocab_size=tcfg.vocab_size, hidden_size=tcfg.hidden_size,
                                 num_layers=tcfg.num_layers, num_heads=tcfg.num_heads,
                                 intermediate_size=tcfg.intermediate_size,
                                 max_positions=tcfg.max_positions)


def _jax_vision_cfg(vcfg):
    return jax_clip_vision.CLIPVisionConfig(**dataclasses.asdict(vcfg))


@pytest.mark.parametrize("eos", [None, "eos"])
def test_clip_pooled_text_features_match_jax(clip_folder, eos):
    """Pooling at the EOS position (argmax of the ids, or the first
    `eos_token_id`) and the projection, on the same hidden states, f32,
    rtol 1e-5; the whole text tower + pooling against the JAX tower on the
    folder's weights, rtol 1e-5."""
    from diffusion_pruning_tpu_torch.utils.export import load_torch_state_dict
    folder, (tcfg, _) = clip_folder
    towers = load_clip_towers(str(folder), torch.device("cpu"))
    rng = np.random.default_rng(3)
    eos_id = tcfg.vocab_size - 1
    ids = rng.integers(3, eos_id, (3, 77))
    for r, n in enumerate((77, 9, 5)):
        ids[r, n - 1] = eos_id
        ids[r, n:] = 0
    kw = {"eos_token_id": eos_id if eos else None}
    hidden = rng.standard_normal((3, 77, 32), dtype=np.float32)
    proj = towers.text_projection.numpy()
    got = clip_pooled_text_features(torch.from_numpy(hidden), torch.from_numpy(ids),
                                    torch.from_numpy(proj), **kw)
    want = jax_te.clip_pooled_text_features(jnp.asarray(hidden), jnp.asarray(ids),
                                            projection=jnp.asarray(proj), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)

    sd = load_torch_state_dict(str(folder))
    params = convert_clip_text_state_dict({k[len("text_model."):]: v for k, v in sd.items()
                                           if k.startswith("text_model.")},
                                          _jax_text_cfg(tcfg))
    jax_hidden = jax.jit(jax_te.CLIPTextEncoder(_jax_text_cfg(tcfg)).apply)(
        {"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        port_hidden = towers.text(torch.from_numpy(ids))
    got = clip_pooled_text_features(port_hidden, torch.from_numpy(ids), towers.text_projection,
                                    **kw)
    want = jax_te.clip_pooled_text_features(jax_hidden, jnp.asarray(ids),
                                            projection=jnp.asarray(proj), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_clip_reader_honours_quick_gelu_as_transformers_does(tmp_path):
    """A folder whose text tower names quick_gelu (OpenAI's CLIP): the port's
    reader and towers against `transformers.CLIPModel` loaded from the same
    folder, image and text embeddings on the same pixels and ids (rtol 1e-4).
    The JAX package's text tower has exact GELU only; the port follows the
    config (ROADMAP, deliberate differences)."""
    import transformers
    from diffusion_pruning_tpu_torch.models.safety import clip_preprocess
    folder = tmp_path / "clip_qg"
    write_clip_folder(folder, seed=5, text_act="quick_gelu")
    towers = load_clip_towers(str(folder), torch.device("cpu"))
    assert towers.text.cfg.hidden_act == "quick_gelu"
    model = transformers.CLIPModel.from_pretrained(str(folder)).eval()
    caps = ["a red cat", "two dogs on a beach at night"]
    ids = torch.as_tensor(towers.tokenizer(caps, max_length=77, padding="max_length",
                                           truncation=True, return_tensors="np").input_ids)
    images = np.random.default_rng(6).integers(0, 256, (2, 40, 40, 3), dtype=np.uint8)
    px = clip_preprocess(torch.from_numpy(images / 255.0).float(), 32)
    with torch.no_grad():
        want_t = model.text_projection(model.text_model(input_ids=ids).pooler_output)
        want_i = model.visual_projection(
            model.vision_model(pixel_values=px.permute(0, 3, 1, 2)).pooler_output)
    np.testing.assert_allclose(towers.embed_texts(caps), want_t.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(towers.embed_images(list(images)), want_i.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert towers.logit_scale == pytest.approx(float(model.logit_scale.exp()), rel=1e-6)


def _f32_vision_tower(monkeypatch):
    """The JAX scripts build the vision tower in bf16 (the accelerator
    path); on the CPU the test builds it in f32, as the port runs there."""
    real = jax_clip_vision.CLIPVisionEncoder
    monkeypatch.setattr(jax_clip_vision, "CLIPVisionEncoder",
                        lambda cfg, dtype=None: real(cfg, dtype=jnp.float32))


def _images(folder, n, rng, size=40, suffix=".npy"):
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        if suffix == ".npy":
            np.save(os.path.join(folder, f"{i:06d}.npy"), img)
        else:
            Image.fromarray(img).save(os.path.join(folder, f"{i:06d}{suffix}"))
    return str(folder)


def test_clip_score_cli_matches_the_jax_script(clip_folder, tmp_path, monkeypatch, capsys):
    """`cli.clip_score` on a written tiny CLIP folder against JAX
    `scripts/metrics/clip_score.py --backend jax` on the same folder and
    files: the score within 1e-4 relative (the JAX script's value read from
    its `clip_score` call); `cli.clip_features` writes one feature a
    caption, equal to the score's text features (rtol 1e-6)."""
    folder, _ = clip_folder
    gen = _images(tmp_path / "gen", 5, np.random.default_rng(7))
    caps = ["a cat on a mat", "the red bus", "two dogs", "an old tree in the park", "sky"]
    cap_file = tmp_path / "caps.json"
    cap_file.write_text(json.dumps(caps))
    got = clip_score.main([gen, "--captions", str(cap_file), "--clip_model", str(folder),
                           "--batch_size", "2", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"CLIP-score: {got['score']:.4f}" in printed

    _f32_vision_tower(monkeypatch)
    seen = {}
    real = jax_metrics.clip_score

    def spy(img, txt, logit_scale):
        seen.update(score=real(img, txt, logit_scale=logit_scale), img=img, txt=txt)
        return seen["score"]
    monkeypatch.setattr(jax_metrics, "clip_score", spy)
    out = _run_script(_script("metrics", "clip_score.py"), monkeypatch, capsys, gen,
                      "--captions", str(cap_file), "--clip_model", str(folder),
                      "--batch_size", "2", "--backend", "jax")
    assert out.startswith("CLIP-score:")
    assert got["score"] == pytest.approx(seen["score"], rel=1e-4)
    np.testing.assert_allclose(got["text_features"], seen["txt"], rtol=1e-4, atol=1e-5)

    n = clip_features.main(["--captions", str(cap_file), "--out_dir", str(tmp_path / "tf"),
                            "--clip_model", str(folder), "--batch_size", "3",
                            "--device", "cpu"])
    files = sorted(os.listdir(tmp_path / "tf"))
    assert n == 5 and files == [f"{i:06d}.npy" for i in range(5)]
    np.testing.assert_allclose(np.stack([np.load(tmp_path / "tf" / f) for f in files]),
                               got["text_features"], rtol=1e-6, atol=1e-7)
    with pytest.raises(NotImplementedError, match="transformers"):
        clip_score.main([gen, "--captions", str(cap_file), "--clip_model", str(folder),
                         "--backend", "torch", "--device", "cpu"])


def test_cmmd_cli_embeddings_match_the_jax_tower(tmp_path, capsys):
    """`cli.cmmd` at a tiny vision config on a vision-only folder: each
    row's embedding of both directories (`.npy` and `.png`) against the JAX
    tower on the same weights and preprocessing, unit length, cosine >=
    0.9999; the printed CMMD equal to JAX `cmmd()` on the port's embeddings;
    a `.npy` reference is read as embeddings and `--save_ref_embeddings`
    writes them."""
    from diffusion_pruning_tpu_torch.utils.export import load_torch_state_dict
    folder = tmp_path / "vision"
    _, vcfg = write_clip_folder(folder, seed=9, text=False)
    rng = np.random.default_rng(10)
    gen = _images(tmp_path / "gen", 5, rng)
    ref = _images(tmp_path / "ref", 4, rng, size=48, suffix=".png")
    saved = tmp_path / "emb" / "ref.npy"
    got = cmmd.main([gen, ref, "--clip_model", str(folder), "--device", "cpu",
                     "--save_ref_embeddings", str(saved)], vision_cfg=vcfg)
    printed = capsys.readouterr().out
    assert printed.strip() == f"CMMD: {jax_metrics.cmmd(got['ref'], got['gen']):.4f}"
    assert got["cmmd"] == pytest.approx(jax_metrics.cmmd(got["ref"], got["gen"]),
                                        rel=METRIC_RTOL)

    jcfg = _jax_vision_cfg(vcfg)
    params = convert_clip_vision_state_dict(load_torch_state_dict(str(folder)), jcfg)
    enc = jax_clip_vision.CLIPVisionEncoder(jcfg, dtype=jnp.float32)
    embed = jax.jit(lambda px: enc.apply({"params": params}, px)[1])
    for path, emb in ((gen, got["gen"]), (ref, got["ref"])):
        from diffusion_pruning_tpu_torch.metrics.towers import image_files, load_images
        imgs = np.stack([im.astype(np.float32) / 255.0
                         for im in load_images(path, image_files(path))])
        want = np.asarray(embed(jax_clip_preprocess(jnp.asarray(imgs), 32)))
        want = want / np.linalg.norm(want, axis=-1, keepdims=True)
        np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, rtol=1e-6)
        assert (emb * want).sum(-1).min() >= 0.9999
    np.testing.assert_array_equal(np.load(saved), got["ref"])
    again = cmmd.main([gen, str(saved), "--clip_model", str(folder), "--device", "cpu"],
                      vision_cfg=vcfg)
    assert again["cmmd"] == got["cmmd"]


class _StubExtractor(torch.nn.Module):
    """The stub InceptionV3 of tests/test_metrics.py: per-channel mean and max."""

    def forward(self, x):
        return torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], dim=1)


@pytest.mark.parametrize("ref_kind", ["npz", "dir"])
def test_fid_cli_matches_the_jax_script(tmp_path, monkeypatch, capsys, ref_kind):
    """`cli.fid` with the stub TorchScript extractor: `inception_features`
    equal to the JAX script's on the same folder, and the printed FID equal
    to the JAX script's, against a `.npz` and against a directory."""
    stub = str(tmp_path / "stub.pt")
    torch.jit.script(_StubExtractor()).save(stub)
    rng = np.random.default_rng(11)
    gen = _images(tmp_path / "gen", 9, rng, size=16)
    ref = _images(tmp_path / "ref", 7, rng, size=16)
    jax_fid = _script("metrics", "fid.py")
    feats = fid.inception_features(gen, stub, torch.device("cpu"), batch_size=4)
    np.testing.assert_array_equal(feats, jax_fid.inception_features(gen, stub, batch_size=3))
    if ref_kind == "npz":
        mu, sigma = metrics.gaussian_stats(fid.inception_features(ref, stub, "cpu"))
        np.savez(tmp_path / "ref.npz", mu=mu, sigma=sigma)
        ref = str(tmp_path / "ref.npz")
    capsys.readouterr()
    got = fid.main([gen, "--ref_stats", ref, "--inception", stub, "--device", "cpu"])
    printed = capsys.readouterr().out
    want = _run_script(jax_fid, monkeypatch, capsys, gen, "--ref_stats", ref,
                       "--inception", stub)
    assert printed == want and math.isfinite(got["fid"])
    with pytest.raises(ValueError, match="--inception"):
        fid.main([gen, "--ref_stats", ref, "--device", "cpu"])


def test_resize_and_sample_coco_match_the_jax_scripts(tmp_path, monkeypatch, capsys):
    """The two data-prep copies against the JAX scripts on the same COCO
    folder (an unreadable file, a second caption of an image): the same
    files with the same uint8 arrays, and COCO-30k's same sample and
    annotations."""
    data = tmp_path / "coco"
    write_coco(str(data), n_train=2, n_val=6)
    val = data / "images" / "val2014"
    (val / "broken.jpg").write_bytes(b"not a jpeg")
    ann_path = data / "annotations" / "captions_val2014.json"
    ann = json.loads(ann_path.read_text())
    ann["annotations"].insert(1, {"image_id": 0, "caption": "a second caption"})
    ann_path.write_text(json.dumps(ann))
    runs = {
        "resize": (resize_and_save_images, _script("metrics", "resize_and_save_images.py"),
                   lambda out: [str(val), out, "--resolution", "24"]),
        "coco30k": (sample_coco_30k, _script("metrics", "sample_coco_30k.py"),
                    lambda out: ["--data_dir", str(data), "--out_dir", out, "--n", "4",
                                 "--resolution", "16"]),
    }
    for name, (port, jax_mod, argv) in runs.items():
        ours, theirs = str(tmp_path / f"{name}_port"), str(tmp_path / f"{name}_jax")
        port.main(argv(ours))
        _run_script(jax_mod, monkeypatch, capsys, *argv(theirs))
        files = sorted(os.listdir(ours))
        assert files == sorted(os.listdir(theirs))
        assert len([f for f in files if f.endswith(".npy")]) == (6 if name == "resize" else 4)
        for f in files:
            if f.endswith(".npy"):
                a = np.load(os.path.join(ours, f))
                assert a.dtype == np.uint8
                np.testing.assert_array_equal(a, np.load(os.path.join(theirs, f)))
            else:
                assert (json.loads(open(os.path.join(ours, f)).read())
                        == json.loads(open(os.path.join(theirs, f)).read()))


# ---------------------------------------------------------------- stage-1 run

@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """A stage-1 run of the port's prune entry point (6 tiny steps, from a
    codebook biased toward pruning, `quantizer_base` 0), the router's
    assignment of the synthetic captions (`cli.filter_dataset`), and a
    1-step stage-2 run of the codebook row with most validation captions."""
    tmp = tmp_path_factory.mktemp("stage1")
    p_yaml = _yaml(PRUNE_YAML, tmp, "p.yaml", **{"model.quantizer.quantizer_base": 0})
    common = ["--device", "cpu", "--pretrained_model_name_or_path", "", "--seed", "0"]
    run = prune.main(["--base_config_path", p_yaml, "--wandb_run_name", "p", *common]).run_dir
    routed = filter_dataset.main(["--base_config_path", p_yaml, "--pruning_ckpt_dir", run,
                                  *common])
    expert = int(np.bincount(routed["validation"]).argmax())
    f_yaml = _yaml(FINETUNE_YAML, tmp, "f.yaml", **{"training.max_train_steps": 1,
                                                    "training.validation_steps": 100})
    ft = finetune.main(["--base_config_path", f_yaml, "--pruning_ckpt_dir", run, "--expert_id",
                        str(expert), "--wandb_run_name", "ft", *common]).run_dir
    return {"run": run, "yaml": p_yaml, "tmp": tmp, "expert": expert, "ft": ft,
            "routed": routed}


def _codebook(run):
    emb = load_torch_artifact(os.path.join(latest_checkpoint_dir(run),
                                           "quantizer_embeddings.pt"))
    return emb.float().numpy()


def test_calculate_pruning_ratio_prints_the_jax_lines(stage1, monkeypatch, capsys):
    """Line for line what JAX `scripts/other/calculate_pruning_ratio.py`
    prints on the same `quantizer_embeddings.pt`."""
    argv = ["--base_config_path", stage1["yaml"], "--pruning_ckpt_dir", stage1["run"],
            "--pretrained_model_name_or_path", ""]
    capsys.readouterr()
    lines = calculate_pruning_ratio.main(argv)
    printed = capsys.readouterr().out
    want = _run_script(_script("other", "calculate_pruning_ratio.py"), monkeypatch, capsys,
                       *argv)
    assert printed == want == "\n".join(lines) + "\n"
    assert len(lines) == 1 + len(_codebook(stage1["run"]))
    assert any("MACs ratio 1.000" not in line for line in lines[1:])  # the codebook prunes


def _jax_captions(cfg, pruning_ckpt_dir, expert_id):
    """The JAX `generate_fid_images.py` rule (lines 75-93) on a missing
    dataset folder."""
    caps = None
    idx_path = os.path.join(pruning_ckpt_dir,
                            f"{cfg.data.dataset_name}_validation_mapped_indices.pt")
    if os.path.exists(idx_path):
        assigned = np.asarray(load_torch_artifact(idx_path))
        if caps is None:
            caps = [f"validation prompt {i}" for i in range(len(assigned))]
        caps = [caps[i] for i in np.nonzero(assigned == expert_id)[0]]
    elif caps is None:
        caps = [f"validation prompt {i}" for i in range(8)]
    max_n = cfg.data.get("max_generated_samples")
    if max_n:
        caps = caps[:max_n]
    return caps


def _gen_argv(stage1, yaml_path, *extra):
    return ["--base_config_path", yaml_path, "--device", "cpu", "--compute_dtype", "float32",
            "--pretrained_model_name_or_path", "", "--seed", "3", *extra]


def test_generate_fid_images_writes_the_experts_images(stage1, capsys):
    """The expert's captions are the ones the JAX rule picks from the
    written assignment (capped at `max_generated_samples` 3), its plan from
    `quantizer_embeddings.pt` row e equals JAX `make_expert_plan` on that
    row, the files are `{i:06d}.npy` uint8 H×W×3 with the last batch of 2
    padded, and the first batch equals the port's pipeline called directly
    with the same generator. `cli.save_captions` writes the same captions.
    With `--finetuning_ckpt_dir` the expert holds the stage-2 masters."""
    tmp, e = stage1["tmp"], stage1["expert"]
    g_yaml = _yaml(PRUNE_YAML, tmp, "g.yaml", **{"data.max_generated_samples": 3})
    cfg = load_config(g_yaml)
    caps = generate_fid_images.expert_captions(cfg, stage1["run"], e)
    assert caps == _jax_captions(cfg, stage1["run"], e) and len(caps) == 3
    arch = _codebook(stage1["run"])[e]
    spec = GatedUNet(UNetConfig.tiny()).spec
    jplan = jax_pruned.make_expert_plan(jax_build_structure(JaxUNetConfig.tiny()), arch)
    assert dataclasses.asdict(make_expert_plan(spec, arch)) == dataclasses.asdict(jplan)

    argv = _gen_argv(stage1, g_yaml, "--pruning_ckpt_dir", stage1["run"], "--expert_id", str(e))
    out_dir = generate_fid_images.main(argv)
    assert out_dir == os.path.join(str(tmp / "runs"), f"fid_images_expert_{e}")
    files = sorted(os.listdir(out_dir))
    assert files == ["000000.npy", "000001.npy", "000002.npy"]
    imgs = [np.load(os.path.join(out_dir, f)) for f in files]
    assert all(a.dtype == np.uint8 and a.shape == (16, 16, 3) for a in imgs)  # tiny VAE: 8 → 16

    from diffusion_pruning_tpu_torch.utils.arg_utils import parse_args
    pargs = parse_args(argv)
    cfg.update_flat(vars(pargs))
    pipe, tok = generate_fid_images.generation_pipeline(pargs, cfg, torch.device("cpu"),
                                                        arch=arch)
    assert dataclasses.asdict(pipe.unet.plan) == dataclasses.asdict(jplan)

    def ids(c):
        return torch.as_tensor(tok(c, max_length=77, padding="max_length", truncation=True,
                                   return_tensors="np").input_ids)
    first = pipe.generate_samples(ids(caps[:2]), ids(["", ""]), torch.Generator().manual_seed(3),
                                  num_inference_steps=2)
    np.testing.assert_array_equal((first.numpy() * 255).astype(np.uint8), np.stack(imgs[:2]))

    saved = save_captions.main(["--base_config_path", g_yaml, "--pruning_ckpt_dir",
                                stage1["run"], "--expert_id", str(e),
                                "--out", str(tmp / "caps.json")])
    assert saved == caps == json.loads((tmp / "caps.json").read_text())

    ft = stage1["ft"]
    pargs = parse_args(_gen_argv(stage1, g_yaml, "--pruning_ckpt_dir", stage1["run"],
                                 "--expert_id", str(e), "--finetuning_ckpt_dir", ft))
    np.testing.assert_array_equal(generate_fid_images.expert_arch(pargs),
                                  load_torch_artifact(os.path.join(ft, "arch_vector.pt")))
    pipe, _ = generate_fid_images.generation_pipeline(
        pargs, cfg, torch.device("cpu"), arch=generate_fid_images.expert_arch(pargs),
        weights_dir=ft)
    masters = CheckpointManager(ft, create=False).restore()["student"]
    got = pipe.unet.state_dict()
    assert set(got) == set(masters)
    for k, v in masters.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("pruning_type", generate_images.PRUNING_TYPES)
def test_generate_images_cli_every_pruning_type(stage1, pruning_type, monkeypatch):
    """Each baseline's arch equals the port's baseline function on the f32
    dense U-Net (`cli.finetune_baseline.pick_arch`), and its images are
    written to `fid_images_baseline_<type>/`."""
    picked = []
    real = finetune_baseline.pick_arch

    def spy(args, cfg, kind):
        fn = real(args, cfg, kind)

        def pick(dense):
            assert next(dense.parameters()).dtype == torch.float32
            picked.append((fn(dense), real(args, cfg, kind)(dense)))
            return picked[-1][0]
        return pick
    monkeypatch.setattr(finetune_baseline, "pick_arch", spy)
    extra = ["--pruning_type", pruning_type]
    if pruning_type == "structural":
        extra += ["--finetuning_ckpt_dir", stage1["ft"]]
    out = generate_images.main(_gen_argv(stage1, stage1["yaml"], *extra))
    got, want = picked[0]
    if pruning_type == "no-pruning":
        assert got is None and want is None
    else:
        np.testing.assert_array_equal(got, want)
    if pruning_type == "structural":
        np.testing.assert_array_equal(got, load_torch_artifact(
            os.path.join(stage1["ft"], "arch_vector.pt")).numpy())
    assert out.endswith(f"fid_images_baseline_{pruning_type}")
    files = sorted(os.listdir(out))
    assert files == [f"{i:06d}.npy" for i in range(generate_fid_images.SYNTHETIC_PROMPTS)]
    assert np.load(os.path.join(out, files[-1])).dtype == np.uint8


def test_depth_ablation_matches_jax_on_handed_over_inputs():
    """`depth_ablation`'s MSE per depth gate against the JAX script's
    computation (the jitted tiny U-Net at an all-ones arch and each gate
    closed) on the same weights and inputs, rtol 1e-4."""
    model = JaxGatedUNet(JaxUNetConfig.tiny())
    tree = numpy_params(jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0))))
    port = GatedUNet(UNetConfig.tiny()).eval()
    port.load_state_dict(params_from_jax(tree, port))
    cfg, spec = port.cfg, port.spec
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, cfg.sample_size, cfg.sample_size, cfg.in_channels),
                            dtype=np.float32)
    t = np.asarray([100, 600])
    ehs = rng.standard_normal((2, cfg.max_text_len, cfg.cross_attention_dim), dtype=np.float32)
    rows = depth_analysis.depth_ablation(port, torch.from_numpy(x), torch.from_numpy(t),
                                         torch.from_numpy(ehs))
    fwd = jax.jit(lambda a: model.apply({"params": tree}, x, t, ehs, arch=a))
    dense = fwd(jnp.ones((2, spec.vq_dim)))
    names = [sb.name for sb in spec.subblocks if sb.depth_index >= 0]
    assert [n for n, _ in rows] == names and len(rows) == spec.num_depth
    for d, (_, mse) in enumerate(rows):
        arch = jnp.ones((2, spec.vq_dim)).at[:, spec.num_width + d].set(0.0)
        want = float(jnp.mean((fwd(arch) - dense) ** 2))
        assert mse == pytest.approx(want, rel=1e-4), d


# ---------------------------------------------------------------- serve

def _serve_argv(stage1, mode, out, *extra):
    return ["--base_config_path", stage1["yaml"], "--device", "cpu", "--pruning_ckpt_dir",
            stage1["run"], "--pretrained_model_name_or_path", "", "--n_synthetic", "6",
            "--batch_size", "2", "--arrival_batch", "4", "--num_inference_steps", "2",
            "--mode", mode, "--out_dir", str(out), *extra]


@pytest.mark.parametrize("mode", ["experts", "hybrid", "routed"])
def test_serve_cli_after_a_prune_run(stage1, mode, tmp_path):
    """`cli.serve` in each mode: one uint8 image a prompt, each prompt's
    expert equal to `ExpertServer.encode_route` on the same waves of prompts
    and routing noise (the quantizer's eval noise), and the materialised
    experts' MACs ratios equal to JAX `expert_macs_ratio` on the same
    codebook; in experts mode slot e of `--finetuning_ckpt_dirs` serves the
    stage-2 masters."""
    extra = []
    if mode == "experts":
        extra = ["--finetuning_ckpt_dirs", "," * stage1["expert"] + stage1["ft"]]
    got = serve.main(_serve_argv(stage1, mode, tmp_path / "out", *extra))
    files = sorted(os.listdir(tmp_path / "out"))
    assert got["images"] == 6 and files == [f"img_{i:05d}.npy" for i in range(6)]
    for f in files:
        a = np.load(tmp_path / "out" / f)
        assert a.dtype == np.uint8 and a.shape == (16, 16, 3)

    args = serve.parse_args(_serve_argv(stage1, mode, tmp_path / "out", *extra))
    server, mpnet = serve.build_server(args, torch.device("cpu"))
    from diffusion_pruning_tpu_torch.data.tokenizers import (
        build_clip_tokenizer,
        build_mpnet_tokenizer,
    )
    prompts = serve.read_prompts(args)
    tok = build_clip_tokenizer("", vocab_size=server.base_pipeline.text_encoder.cfg.vocab_size)
    ids = torch.as_tensor(tok(prompts, max_length=77, padding="max_length", truncation=True,
                              return_tensors="np").input_ids)
    neg = torch.as_tensor(tok([""], max_length=77, padding="max_length", truncation=True,
                              return_tensors="np").input_ids)
    embed = filter_dataset.caption_embedder(
        mpnet, build_mpnet_tokenizer(args.prompt_encoder_model_name_or_path,
                                     vocab_size=mpnet.cfg.vocab_size))
    want = []  # each wave routed as the entry point routes it (the eval noise is per row)
    for lo in range(0, len(prompts), args.arrival_batch):
        wave = prompts[lo:lo + args.arrival_batch]
        want += server.encode_route(ids[lo:lo + len(wave)], neg,
                                    hyper_net_input=embed(wave))[2].tolist()
    assert [got["experts"][i] for i in range(6)] == want
    if mode == "routed":
        assert got["macs_ratios"] == [] and server.expert_models == []
        return
    codes = (server.base_pipeline.quantizer.embedding_gs.float() >= 0.5).float().numpy()
    jspec = jax_build_structure(JaxUNetConfig.tiny())
    want_ratios = [jax_pruned.expert_macs_ratio(jspec, jax_pruned.make_expert_plan(jspec, c))
                   for c in codes]
    np.testing.assert_allclose(got["macs_ratios"], want_ratios, rtol=1e-6)
    assert min(want_ratios) < 1.0
    if mode == "experts":
        masters = CheckpointManager(stage1["ft"], create=False).restore()["student"]
        # rebuild with the stage-2 slot to read the served expert's weights
        args = serve.parse_args(_serve_argv(stage1, mode, tmp_path / "o2", *extra))
        served, _ = serve.build_server(args, torch.device("cpu"))
        sd = served.expert_models[stage1["expert"]].state_dict()
        for k, v in masters.items():
            assert torch.equal(sd[k], v.to(sd[k].dtype)), k


@pytest.mark.parametrize("flag", [("--aot_dir", "aot", "cannot be saved to disk"),
                                  ("--warmup_parallel", "2", "under the GIL")])
def test_serve_cli_refuses_what_waits_for_a1b(stage1, tmp_path, flag):
    """Persisted programs and parallel warm-up raise, each with its reason."""
    with pytest.raises(NotImplementedError, match=flag[2]):
        serve.main(_serve_argv(stage1, "experts", tmp_path / "out", *flag[:2]))


@pytest.mark.parametrize("name", ["clip_features", "clip_score", "cmmd", "fid",
                                  "generate_fid_images", "generate_images", "depth_analysis",
                                  "serve"])
def test_new_entry_points_need_a_card_unless_told_cpu(name, monkeypatch, tmp_path):
    """Without `--device cpu` each entry point asks for the CUDA card and
    raises where there is none, before it reads a checkpoint."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing")
    argv = {
        "clip_features": ["--captions", missing, "--out_dir", missing, "--clip_model", missing],
        "clip_score": [missing, "--captions", missing, "--clip_model", missing],
        "cmmd": [missing, missing, "--clip_model", missing],
        "fid": [missing, "--ref_stats", missing, "--inception", missing],
        "generate_fid_images": ["--base_config_path", PRUNE_YAML, "--pruning_ckpt_dir",
                                missing, "--expert_id", "0"],
        "generate_images": ["--base_config_path", PRUNE_YAML],
        "depth_analysis": ["--base_config_path", PRUNE_YAML],
        "serve": ["--base_config_path", PRUNE_YAML],
    }[name]
    module = importlib.import_module(f"diffusion_pruning_tpu_torch.cli.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
