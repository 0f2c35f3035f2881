"""The rest of the port's pipeline, held against the JAX package on the CPU
with the same weights (carried by `params_from_jax`) and the same inputs,
latents and noise made with numpy or from the JAX keys:

  * `UNetConfig(use_linear_projection=False)`: 1×1-conv proj_in/proj_out,
    plain and under each fused flag (the norm stays unfused there);
  * the hypernet's `weight_norm`, `linear_bias` and `single_arch_param`;
  * the quantizer's `optimal_transport=False` and
    `resource_aware_normalization`;
  * `PruningPipeline.sample_progressive` and `depth_analysis_arch`;
  * `clip_preprocess`, `CLIPVisionEncoder`, `SafetyChecker` (also
    `from_diffusers` on a written folder) and the pipeline's 4-tuple.

Tolerances are stated at each comparison: f32 on both sides, op order
differs."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from diffusion_pruning_tpu.core.estimators import FIXED_KEY
from diffusion_pruning_tpu.core.structure import build_structure as jax_build_structure
from diffusion_pruning_tpu.models.clip_vision import CLIPVisionConfig as JaxCLIPVisionConfig
from diffusion_pruning_tpu.models.clip_vision import CLIPVisionEncoder as JaxCLIPVision
from diffusion_pruning_tpu.models.hypernet import HyperStructure as JaxHyperStructure
from diffusion_pruning_tpu.models.quantizer import StructureQuantizer as JaxQuantizer
from diffusion_pruning_tpu.models.safety import SafetyChecker as JaxSafetyChecker
from diffusion_pruning_tpu.models.safety import clip_preprocess as jax_clip_preprocess
from diffusion_pruning_tpu.models.unet.config import UNetConfig as JaxUNetConfig
from diffusion_pruning_tpu.models.unet.unet import GatedUNet as JaxGatedUNet
from diffusion_pruning_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder
from diffusion_pruning_tpu_torch.models.convert import params_from_jax
from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
from diffusion_pruning_tpu_torch.models.safety import SafetyChecker, clip_preprocess
from diffusion_pruning_tpu_torch.models.unet import blocks
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.ops import group_norm as gn
from diffusion_pruning_tpu_torch.ops import norm_conv as nc

from test_torch_port_pipeline import _inputs, pipelines  # noqa: F401 (a fixture)
from test_torch_port_training import _jax_gumbel
from torch_port_common import numpy_params

torch.set_num_threads(1)
UNET_RTOL, UNET_ATOL = 1e-4, 5e-4  # as tests/test_torch_port_unet.py
FLAGS = ({}, {"fused_norms": True}, {"fused_norm_conv": True})


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- conv projections

@pytest.fixture(scope="module")
def conv_proj_params():
    model = JaxGatedUNet(JaxUNetConfig.tiny(use_linear_projection=False))
    return numpy_params(jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0))),
                       seed=4)


@pytest.mark.parametrize("flags", FLAGS, ids=["plain", "fused_norms", "fused_norm_conv"])
def test_conv_projection_unet_matches_jax(conv_proj_params, flags, monkeypatch):
    """A tiny U-Net with 1×1-conv proj_in/proj_out against the JAX one with
    the same flags (the JAX fused ops in Pallas interpret mode), soft arch,
    CFG-tiled batch. Under `fused_norm_conv` the transformer norms stay
    unfused: `group_norm_linear` never runs, and the resnets still take the
    fused conv (25 sites)."""
    calls = {"group_norm_linear": 0, "norm_conv3x3": 0}
    for module, name in ((blocks, "group_norm_linear"), (nc, "norm_conv3x3")):
        real = getattr(module, name)

        def counted(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(module, name, counted)
    model = GatedUNet(UNetConfig.tiny(use_linear_projection=False, **flags)).eval()
    assert model.state_dict()["mid_block.attentions.0.proj_in.weight"].shape == (64, 64, 1, 1)
    model.load_state_dict(params_from_jax(conv_proj_params, model))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 8, 8, 4), dtype=np.float32)
    t = np.array([3, 747, 100, 999])
    ehs = rng.standard_normal((4, 77, 32), dtype=np.float32)
    arch = rng.random((2, model.spec.vq_dim), dtype=np.float32)
    jmodel = JaxGatedUNet(JaxUNetConfig.tiny(use_linear_projection=False, **flags))
    want = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a[:3], arch=a[3]))(
        conv_proj_params, *map(jnp.asarray, (x, t, ehs, arch)))
    with torch.no_grad():
        got = model(_t(x), _t(t), _t(ehs), arch=_t(arch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=UNET_RTOL, atol=UNET_ATOL)
    assert calls["group_norm_linear"] == 0
    assert calls["norm_conv3x3"] == (25 if flags.get("fused_norm_conv") else 0)


def test_conv_projection_keeps_the_norm_of_fused_norms(monkeypatch):
    """Under `fused_norms` alone a conv-projection transformer's norm runs the
    one-pass GroupNorm (30 sites, as with linear projections); under both
    flags the transformers' 6 norms fall back to it instead of the linear."""
    counts = {}
    real = gn.group_norm_silu_forward

    def counted(*args):
        counts["gn"] = counts.get("gn", 0) + 1
        return real(*args)

    monkeypatch.setattr(gn, "group_norm_silu_forward", counted)
    x, t, ehs = torch.zeros(1, 8, 8, 4), torch.zeros(1), torch.zeros(1, 77, 32)
    for flags, want in (({"fused_norms": True}, 30),
                        ({"fused_norms": True, "fused_norm_conv": True}, 6)):
        counts.clear()
        with torch.no_grad():
            GatedUNet(UNetConfig.tiny(use_linear_projection=False, **flags))(x, t, ehs)
        assert counts.get("gn", 0) == want, flags


# ---------------------------------------------------------------- hypernet options

HYPERNET_OPTIONS = [dict(weight_norm=True), dict(linear_bias=False),
                    dict(weight_norm=True, linear_bias=False), dict(single_arch_param=True)]


@pytest.mark.parametrize("options", HYPERNET_OPTIONS,
                         ids=["weight_norm", "no_bias", "weight_norm_no_bias", "single_arch"])
def test_hypernet_options_match_jax(options):
    """Forward (rtol 1e-5) and the gradient of a weighted sum (rtol 1e-4)
    per parameter, weight-norm gains away from 1."""
    spec = jax_build_structure(JaxUNetConfig.tiny())
    jhn = JaxHyperStructure(spec, input_dim=24, **options)
    params = numpy_params(jax.eval_shape(
        lambda: jhn.init(jax.random.PRNGKey(0), jnp.zeros((1, 24))))["params"], seed=9)
    hn = HyperStructure(GatedUNet(UNetConfig.tiny()).spec, input_dim=24, **options)
    hn.load_state_dict(params_from_jax(params, hn))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 24), dtype=np.float32)
    w = rng.standard_normal((1 if options.get("single_arch_param") else 3, spec.vq_dim),
                            dtype=np.float32)

    def jax_loss(p):
        out = jhn.apply({"params": p}, jnp.asarray(x))
        return (out * w).sum(), out

    grads, want = jax.grad(jax_loss, has_aux=True)(params)
    got = hn(_t(x))
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    want_grads = params_from_jax(jax.tree.map(np.asarray, grads), hn)
    for name, p in hn.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


# ---------------------------------------------------------------- quantizer options

QUANTIZER_OPTIONS = [dict(optimal_transport=False), dict(resource_aware_normalization=True),
                     dict(optimal_transport=False, resource_aware_normalization=True),
                     dict(non_zero_width=False)]


@pytest.mark.parametrize("options", QUANTIZER_OPTIONS,
                         ids=["no_ot", "resource_aware", "both", "no_non_zero_width"])
def test_quantizer_options_match_jax(options):
    """width_depth_normalize (rtol 1e-5), forward_train's indices (equal),
    z_q and snapshot (rtol 1e-5) and codebook grad (rtol 1e-4, as the default
    quantizer's test), and eval routing (equal), with the JAX noise."""
    jspec = jax_build_structure(JaxUNetConfig.tiny())
    order = tuple(range(jspec.num_depth))[::-1]
    jq = JaxQuantizer(jspec, n_e=4, base=3.0, depth_order=order, **options)
    params = jax.jit(jq.init_params)(jax.random.PRNGKey(5))
    gs = jq.init_state(params)["embedding_gs"]
    q = StructureQuantizer(GatedUNet(UNetConfig.tiny()).spec, n_e=4, base=3.0,
                           depth_order=order, **options)
    q.load_state_dict(params_from_jax({"embedding": np.asarray(params["embedding"]),
                                       "embedding_gs": np.asarray(gs)}, q))
    rng = np.random.default_rng(6)
    z = (np.asarray(params["embedding"])[rng.integers(0, 4, 6)]
         + 0.5 * rng.standard_normal((6, jspec.vq_dim))).astype(np.float32)
    gates = rng.random((6, jspec.vq_dim), dtype=np.float32)
    np.testing.assert_allclose(q.width_depth_normalize(_t(gates)).numpy(),
                               np.asarray(jq.width_depth_normalize(jnp.asarray(gates))),
                               rtol=1e-5, atol=1e-7)
    w = rng.standard_normal((6, jspec.vq_dim)).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def jax_fn(emb):
        z_q, idx, state = jq.forward_train({"embedding": emb}, jnp.asarray(z), key)
        return (z_q * w).sum(), (z_q, idx, state["embedding_gs"])

    want_grad, (want_zq, want_idx, want_gs) = jax.grad(jax_fn, has_aux=True)(params["embedding"])
    k1, k2 = jax.random.split(key)
    z_q, idx, new_gs = q.forward_train(_t(z), _t(_jax_gumbel(k1, 4, jspec)),
                                       _t(_jax_gumbel(k2, 6, jspec)))
    (z_q * _t(w)).sum().backward()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(z_q.detach().numpy(), np.asarray(want_zq), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(new_gs.numpy(), np.asarray(want_gs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(q.embedding.weight.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-4, atol=1e-6)
    want_arch, want_eval = jq.forward_eval({"embedding_gs": gs}, jnp.asarray(z))
    got_arch, got_eval = q.forward_eval(_t(z), _t(_jax_gumbel(FIXED_KEY, 6, jspec)))
    np.testing.assert_array_equal(got_eval.numpy(), np.asarray(want_eval))
    np.testing.assert_array_equal(got_arch.numpy(), np.asarray(want_arch))


def test_no_optimal_transport_takes_the_cosine_argmax():
    """Without Sinkhorn every prompt goes to its nearest code, even when all
    prompts share one (Sinkhorn would spread them)."""
    spec = GatedUNet(UNetConfig.tiny()).spec
    results = {}
    for ot in (True, False):
        q = StructureQuantizer(spec, n_e=4, base=3.0, optimal_transport=ot)
        q.init_params(torch.Generator().manual_seed(1))
        z = q.embedding.weight.detach()[[2] * 8]  # eight prompts at code 2
        noise_c = torch.zeros(4, spec.vq_dim)
        noise_g = torch.zeros(8, spec.vq_dim)
        results[ot] = q.forward_train(z, noise_c, noise_g)[1]
    assert results[False].tolist() == [2] * 8
    assert len(set(results[True].tolist())) > 1


# ---------------------------------------------------------------- progressive sampling

def test_sample_progressive_matches_jax_and_lands_on_the_call(pipelines):
    """Six DDIM steps in snapshots of two: each snapshot against the JAX
    package's (atol 1e-3, as the pipeline test's images), the indices equal,
    and the last snapshot equal, bit for bit, to `__call__` under DDIM with
    the same latents and routing noise (the same U-Net calls)."""
    jp, pp = pipelines
    ids, neg, _, noise = _inputs(pp.unet.spec)
    key = jax.random.PRNGKey(3)
    latents = np.asarray(jax.random.normal(key, (2, 8, 8, 4)))
    snaps, idx = jp.sample_progressive(jnp.asarray(ids), jnp.asarray(neg), key,
                                       num_inference_steps=6, snapshot_every=2)
    t = lambda a: torch.from_numpy(a).long()  # noqa: E731
    got, got_idx = pp.sample_progressive(t(ids), t(neg), latents=_t(latents),
                                         route_noise=noise, num_inference_steps=6,
                                         snapshot_every=2)
    assert len(got) == len(snaps) == 3
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    for i, (g, w) in enumerate(zip(got, snaps)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, err_msg=f"snapshot {i}")
    images, call_idx, _ = pp(t(ids), t(neg), latents=_t(latents), route_noise=noise,
                             num_inference_steps=6)
    assert torch.equal(got[-1], images) and torch.equal(call_idx, got_idx)


def test_depth_analysis_arch_matches_jax(pipelines):
    jp, pp = pipelines
    for depth, batch in (([], 1), ([0, 3], 2), ([pp.unet.spec.num_depth - 1], 3)):
        np.testing.assert_array_equal(pp.depth_analysis_arch(depth, batch).numpy(),
                                      np.asarray(jp.depth_analysis_arch(depth, batch)))


# ---------------------------------------------------------------- CLIP vision + safety

@pytest.mark.parametrize("size,shape", [(224, (256, 256)), (32, (24, 24)), (32, (64, 48))],
                         ids=["down_256_224", "up_24_32", "down_64x48_32"])
def test_clip_preprocess_matches_jax(size, shape):
    """`jax.image.resize(..., "bilinear")` antialiases when it shrinks: the
    port's antialiased `F.interpolate` reads within 2e-6 (normalised
    units); without antialiasing the shrink would read far above it."""
    x = np.random.default_rng(size).random((2, *shape, 3), dtype=np.float32)
    want = np.asarray(jax_clip_preprocess(jnp.asarray(x), size))
    got = clip_preprocess(_t(x), size)
    assert got.shape == (2, size, size, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    if shape[0] > size:
        plain = torch.nn.functional.interpolate(_t(x).permute(0, 3, 1, 2), size=(size, size),
                                                mode="bilinear", align_corners=False)
        mean, std = (torch.tensor(c)[:, None, None] for c in
                     ((0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)))
        assert np.abs(((plain - mean) / std).permute(0, 2, 3, 1).numpy() - want).max() > 1e-2


@pytest.fixture(scope="module")
def vision_params():
    enc = JaxCLIPVision(JaxCLIPVisionConfig.tiny())
    return numpy_params(jax.eval_shape(lambda: enc.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))["params"], seed=6)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_vision_encoder_matches_jax(vision_params, act):
    import dataclasses
    jcfg = dataclasses.replace(JaxCLIPVisionConfig.tiny(), hidden_act=act)
    enc = CLIPVisionEncoder(dataclasses.replace(CLIPVisionConfig.tiny(), hidden_act=act)).eval()
    enc.load_state_dict(params_from_jax(vision_params, enc))
    px = np.random.default_rng(1).standard_normal((3, 32, 32, 3), dtype=np.float32)
    want = JaxCLIPVision(jcfg).apply({"params": vision_params}, jnp.asarray(px))
    with torch.no_grad():
        got = enc(_t(px))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def _write_safety_dir(root, vision_params, concept, thresholds, special, special_t):
    """A diffusers `safety_checker/` folder: HF names nested under
    `vision_model.` (diffusers' double nesting), written by safetensors."""
    cfg = CLIPVisionConfig.tiny()
    enc = CLIPVisionEncoder(cfg)
    sd = {}
    for k, v in params_from_jax(vision_params, enc).items():
        sd[f"vision_model.{k}" if k.startswith("vision_model.") else k] = v
    sd.update(concept_embeds=_t(concept), concept_embeds_weights=_t(thresholds),
              special_care_embeds=_t(special), special_care_embeds_weights=_t(special_t))
    d = root / "safety_checker"
    d.mkdir()
    save_file(sd, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps({
        "projection_dim": cfg.projection_dim,
        "vision_config": {"hidden_size": cfg.hidden_size,
                          "intermediate_size": cfg.intermediate_size,
                          "num_hidden_layers": cfg.num_layers,
                          "num_attention_heads": cfg.num_heads, "image_size": cfg.image_size,
                          "patch_size": cfg.patch_size, "hidden_act": cfg.hidden_act}}))
    return str(d)


def test_safety_checker_from_diffusers_matches_jax(tmp_path, vision_params):
    """A concept planted at image 1's embedding (threshold 0.99) flags image 1
    alone; a concept whose threshold sits 0.005 above image 2's cosine flags
    image 2 only through the special-care adjustment (0.01), which a special
    concept at image 2's embedding triggers. Flags equal to the JAX
    package's, flagged images black, the rest unchanged."""
    images = np.random.default_rng(2).random((4, 24, 24, 3), dtype=np.float32)
    enc = JaxCLIPVision(JaxCLIPVisionConfig.tiny())
    emb = np.asarray(enc.apply({"params": vision_params},
                               jax_clip_preprocess(jnp.asarray(images), 32))[1])
    unit = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    other = np.random.default_rng(3).standard_normal((1, emb.shape[1])).astype(np.float32)
    concept = np.stack([emb[1], emb[2], other[0]])
    cos2 = float(unit[2] @ (emb[2] / np.linalg.norm(emb[2])))
    cos_images_to_c1 = unit @ (emb[2] / np.linalg.norm(emb[2]))
    # concept 1's threshold just above image 2's cosine with it (≈ 1): only
    # the special-care adjustment can flag image 2
    thresholds = np.array([0.99, cos2 + 0.005, 0.99], np.float32)
    special = emb[2:3].copy()
    special_t = np.array([0.99], np.float32)
    assert (cos_images_to_c1[[0, 1, 3]] < thresholds[1] - 0.01).all()
    d = _write_safety_dir(tmp_path, vision_params, concept, thresholds, special, special_t)

    jchecker = JaxSafetyChecker.from_diffusers(d)
    want_imgs, want_flags = jchecker(jnp.asarray(images))
    checker = SafetyChecker.from_diffusers(d)
    got_imgs, flags = checker(_t(images))
    np.testing.assert_array_equal(flags.numpy(), np.asarray(want_flags))
    assert flags.tolist() == [False, True, True, False]
    np.testing.assert_array_equal(got_imgs.numpy(), np.asarray(want_imgs))
    no_special = SafetyChecker(checker.embed_fn, _t(concept), _t(thresholds), 32)
    assert no_special.flags(_t(images)).tolist() == [False, True, False, False]


def test_pipeline_with_a_safety_checker_returns_four(pipelines, vision_params):
    """`__call__` with a checker: (images, indices, ratios, nsfw), flagged
    images black, the others as without a checker."""
    _, pp = pipelines
    ids, neg, latents, noise = _inputs(pp.unet.spec)
    t = lambda a: torch.from_numpy(a).long()  # noqa: E731
    kw = dict(latents=_t(latents), route_noise=noise, num_inference_steps=2)
    images, idx, ratios = pp(t(ids), t(neg), **kw)
    enc = CLIPVisionEncoder(CLIPVisionConfig.tiny()).eval()
    enc.load_state_dict(params_from_jax(vision_params, enc))
    with torch.no_grad():
        emb = enc(clip_preprocess(images, 32))[1]
    pp.safety_checker = SafetyChecker(lambda px: enc(px)[1], emb[:1], torch.tensor([0.99]), 32)
    try:
        out = pp(t(ids), t(neg), **kw)
    finally:
        pp.safety_checker = None
    assert len(out) == 4
    got, got_idx, got_ratios, nsfw = out
    assert nsfw.tolist() == [True, False]
    assert torch.equal(got[0], torch.zeros_like(got[0])) and torch.equal(got[1], images[1])
    assert torch.equal(got_idx, idx) and torch.equal(got_ratios, ratios)
