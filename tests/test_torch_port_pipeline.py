"""One tiny routed generation through the port's `PruningPipeline`, held
stage by stage against the JAX package's pipeline with the same weights,
token ids, initial latents and routing noise, on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pruning_tpu.core.estimators import FIXED_KEY, sample_gumbel as jax_sample_gumbel
from diffusion_pruning_tpu.core.resource import ResourceModel as JaxResourceModel
from diffusion_pruning_tpu.core.structure import build_structure as jax_build_structure
from diffusion_pruning_tpu.models import text_encoders as jax_te
from diffusion_pruning_tpu.models.hypernet import HyperStructure as JaxHyperStructure
from diffusion_pruning_tpu.models.quantizer import StructureQuantizer as JaxQuantizer
from diffusion_pruning_tpu.models.unet.config import UNetConfig as JaxUNetConfig
from diffusion_pruning_tpu.models.unet.unet import GatedUNet as JaxGatedUNet
from diffusion_pruning_tpu.models.vae import AutoencoderKL as JaxVAE
from diffusion_pruning_tpu.models.vae import VAEConfig as JaxVAEConfig
from diffusion_pruning_tpu.pipelines import PruningPipeline as JaxPipeline
from diffusion_pruning_tpu_torch.models import text_encoders as te
from diffusion_pruning_tpu_torch.models.convert import params_from_jax
from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from diffusion_pruning_tpu_torch.pipelines import PruningPipeline

from torch_port_common import numpy_params

torch.set_num_threads(1)
STEPS = 3


def _params(module, *args):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    return numpy_params(shapes["params"], seed=len(jax.tree_util.tree_leaves(shapes)))


@pytest.fixture(scope="module")
def pipelines():
    ucfg = JaxUNetConfig.tiny(cross_attention_dim=32)
    spec = jax_build_structure(ucfg)
    unet = JaxGatedUNet(ucfg)
    text = jax_te.CLIPTextEncoder(jax_te.CLIPTextConfig.tiny())
    vae = JaxVAE(JaxVAEConfig.tiny())
    hypernet = JaxHyperStructure(spec, input_dim=32)
    quantizer = JaxQuantizer(spec, n_e=4, base=0.0)
    ids = jnp.zeros((1, 77), jnp.int32)
    unet_p = numpy_params(jax.eval_shape(lambda: unet.init_params(jax.random.PRNGKey(0))))
    text_p = _params(text, ids)
    vae_p = _params(vae, jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(0))
    hn_p = _params(hypernet, jnp.zeros((1, 32)))
    q_p = jax.jit(quantizer.init_params)(jax.random.PRNGKey(1))
    q_s = jax.jit(quantizer.init_state)(q_p)
    jax_pipe = JaxPipeline(unet=unet, unet_params=unet_p, vae=vae, vae_params=vae_p,
                           text_encoder=text, text_params=text_p, hypernet=hypernet,
                           hypernet_params=hn_p, quantizer=quantizer, quantizer_params=q_p,
                           quantizer_state=q_s)

    modules = (GatedUNet(UNetConfig.tiny(cross_attention_dim=32)),
               AutoencoderKL(VAEConfig.tiny()), te.CLIPTextEncoder(te.CLIPTextConfig.tiny()))
    pu, pv, pt = modules
    ph = HyperStructure(pu.spec, input_dim=32)
    pq = StructureQuantizer(pu.spec, n_e=4, base=0.0)
    for mod, tree in ((pu, unet_p), (pv, vae_p), (pt, text_p), (ph, hn_p),
                      (pq, {"embedding": np.asarray(q_p["embedding"]),
                            "embedding_gs": np.asarray(q_s["embedding_gs"])})):
        mod.load_state_dict(params_from_jax(tree, mod))
    port_pipe = PruningPipeline(pu, pv, pt, ph, pq, device="cpu")
    return jax_pipe, port_pipe


def _inputs(spec):
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 128, (2, 77)).astype(np.int32)
    neg = rng.integers(0, 128, (2, 77)).astype(np.int32)
    latents = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    kw, kd = jax.random.split(FIXED_KEY)
    noise = np.concatenate([np.asarray(jax_sample_gumbel(kw, (2, spec.num_width))),
                            np.asarray(jax_sample_gumbel(kd, (2, spec.num_depth)))], axis=1)
    return ids, neg, latents, torch.from_numpy(noise)


def test_routed_generation_matches_jax_stage_by_stage(pipelines):
    jp, pp = pipelines
    ids, neg, latents, noise = _inputs(pp.unet.spec)
    t = lambda a: torch.from_numpy(a).long()  # noqa: E731

    pe, ne = jp.encode_prompt(jnp.asarray(ids)), jp.encode_prompt(jnp.asarray(neg))
    pe_t, ne_t = pp.encode_prompt(t(ids)), pp.encode_prompt(t(neg))
    np.testing.assert_allclose(pe_t.numpy(), np.asarray(pe), rtol=1e-4, atol=1e-4)

    arch, idx = jp.route(pe)
    arch_t, idx_t = pp.route(pe_t, noise=noise)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(arch_t.numpy(), np.asarray(arch))

    ehs = jnp.concatenate([ne, pe])
    out = jp._denoise_fn(STEPS, 7.5, True)(jp.unet_params, ehs, arch, jnp.asarray(latents))
    out_t = pp.denoise(None, pe_t, ne_t, arch_t, STEPS, 7.5, latents=torch.from_numpy(latents))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out), rtol=1e-3, atol=1e-3)

    images = np.asarray(jp.decode(out))
    images_t = pp.decode(out_t)
    np.testing.assert_allclose(images_t.numpy(), images, atol=1e-3)

    # the whole call, with the same latents and routing noise
    got, got_idx, ratios = pp(t(ids), t(neg), latents=torch.from_numpy(latents),
                              num_inference_steps=STEPS, route_noise=noise)
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), images, atol=1e-3)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    want_ratios = JaxResourceModel(jp.unet.spec).resource_ratio(arch)
    np.testing.assert_allclose(ratios.numpy(), np.asarray(want_ratios), rtol=1e-5)


def test_generate_samples_and_quantizer_samples(pipelines):
    _, pp = pipelines
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 128, (2, 77), generator=g)
    neg = torch.randint(0, 128, (2, 77), generator=g)
    dense = pp.generate_samples(ids, neg, g, arch=None, num_inference_steps=2)
    experts = pp.quantizer_samples(ids, neg, g, expert_ids=[0, 3], num_inference_steps=2)
    for images in (dense, experts):
        assert images.shape == (2, 16, 16, 3)
        assert torch.isfinite(images).all() and images.min() >= 0 and images.max() <= 1
