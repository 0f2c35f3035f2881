"""The port's sampler, text encoders, router (hypernet + quantizer eval
forward), VAE decoder and random init, held against the JAX package on the
CPU with the same weights (carried by `params_from_jax`) and inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pruning_tpu.core.estimators import FIXED_KEY, sample_gumbel as jax_sample_gumbel
from diffusion_pruning_tpu.core.structure import build_structure as jax_build_structure
from diffusion_pruning_tpu.models import text_encoders as jax_te
from diffusion_pruning_tpu.models.hypernet import HyperStructure as JaxHyperStructure
from diffusion_pruning_tpu.models.quantizer import StructureQuantizer as JaxQuantizer
from diffusion_pruning_tpu.models.unet.config import UNetConfig as JaxUNetConfig
from diffusion_pruning_tpu.models.vae import AutoencoderKL as JaxVAE
from diffusion_pruning_tpu.models.vae import VAEConfig as JaxVAEConfig
from diffusion_pruning_tpu.schedulers import DDIMSampler as JaxDDIM
from diffusion_pruning_tpu.schedulers import DiffusionSchedule as JaxSchedule
from diffusion_pruning_tpu_torch.core.structure import build_structure
from diffusion_pruning_tpu_torch.models import text_encoders as te
from diffusion_pruning_tpu_torch.models.convert import params_from_jax
from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from diffusion_pruning_tpu_torch.schedulers import DDIMSampler, DiffusionSchedule
from diffusion_pruning_tpu_torch.utils.init_utils import random_init_

from torch_mini_diffusers import MiniVAE
from torch_port_common import numpy_params

torch.set_num_threads(1)
# f32 on both sides; the slack covers op-order differences between XLA:CPU
# and PyTorch's CPU kernels
RTOL, ATOL = 1e-4, 1e-4


def _carry(jax_module, port_module, *init_args, seed=0):
    """Random numpy weights for the JAX module, the same weights in the port."""
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), *init_args))
    params = numpy_params(shapes["params"], seed)
    port_module.load_state_dict(params_from_jax(params, port_module))
    return params


@pytest.mark.parametrize("prediction_type", ["v_prediction", "epsilon"])
@pytest.mark.parametrize("steps", [10, 25])
def test_ddim_trajectory_matches_jax(prediction_type, steps):
    latents = np.random.default_rng(steps).standard_normal((2, 4, 4, 4), dtype=np.float32)

    def jax_fn(x, t):
        return 0.3 * jnp.tanh(x) * (t[:, None, None, None] / 1000.0) - 0.05 * x

    def port_fn(x, t):
        return 0.3 * torch.tanh(x) * (t[:, None, None, None] / 1000.0) - 0.05 * x

    jax_sampler = JaxDDIM(JaxSchedule(prediction_type=prediction_type))
    sampler = DDIMSampler(DiffusionSchedule(prediction_type=prediction_type))
    np.testing.assert_array_equal(sampler.timesteps(steps), jax_sampler.timesteps(steps))
    want = jax_sampler.sample(jax_fn, jnp.asarray(latents), steps)
    got = sampler.sample(port_fn, torch.from_numpy(latents), steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_clip_text_encoder_matches_jax():
    cfg = te.CLIPTextConfig.tiny()
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 77)).astype(np.int32)
    jax_enc = jax_te.CLIPTextEncoder(jax_te.CLIPTextConfig.tiny())
    enc = te.CLIPTextEncoder(cfg).eval()
    params = _carry(jax_enc, enc, jnp.asarray(ids))
    want = jax.jit(lambda p, i: jax_enc.apply({"params": p}, i))(params, jnp.asarray(ids))
    with torch.no_grad():
        got = enc(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_mpnet_encoder_and_mean_pool_match_jax():
    cfg = te.MPNetConfig.tiny()
    rng = np.random.default_rng(1)
    ids = rng.integers(2, cfg.vocab_size, (3, 12)).astype(np.int32)
    mask = (np.arange(12)[None, :] < np.array([[12], [7], [3]])).astype(np.int32)
    ids = np.where(mask == 1, ids, cfg.pad_token_id).astype(np.int32)
    jax_enc = jax_te.MPNetEncoder(jax_te.MPNetConfig.tiny())
    enc = te.MPNetEncoder(cfg).eval()
    params = _carry(jax_enc, enc, jnp.asarray(ids), jnp.asarray(mask))
    want = jax.jit(lambda p, i, m: jax_te.mean_pool(jax_enc.apply({"params": p}, i, m), m))(
        params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        t_ids, t_mask = torch.from_numpy(ids).long(), torch.from_numpy(mask).long()
        tokens = enc(t_ids, t_mask)
        got = te.mean_pool(tokens, t_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    tokens_want = jax_enc.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(tokens.numpy(), np.asarray(tokens_want), rtol=RTOL, atol=ATOL)


def test_hypernet_matches_jax():
    spec = jax_build_structure(JaxUNetConfig.tiny())
    jax_hn = JaxHyperStructure(spec, input_dim=32)
    hn = HyperStructure(build_structure(UNetConfig.tiny()), input_dim=32)
    x = np.random.default_rng(2).standard_normal((3, 32), dtype=np.float32)
    params = _carry(jax_hn, hn, jnp.zeros((1, 32)))
    want = jax_hn.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = hn(torch.from_numpy(x))
    assert got.shape == (3, spec.vq_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)


def _jax_eval_noise(batch, spec):
    """The gumbel noise the JAX quantizer draws at eval (from FIXED_KEY)."""
    kw, kd = jax.random.split(FIXED_KEY)
    gw = jax_sample_gumbel(kw, (batch, spec.num_width))
    gd = jax_sample_gumbel(kd, (batch, spec.num_depth))
    return torch.from_numpy(np.concatenate([np.asarray(gw), np.asarray(gd)], axis=1))


@pytest.mark.parametrize("name", ["tiny", "sd21"])
def test_quantizer_forward_eval_matches_jax(name):
    jspec = jax_build_structure(getattr(JaxUNetConfig, name)())
    # a permuted depth order with negative entries, as the shipped configs use
    nd = jspec.num_depth
    order = tuple(v - nd if j % 2 else v for j, v in enumerate(reversed(range(nd))))
    jq = JaxQuantizer(jspec, n_e=4, base=3.0, depth_order=order)
    jparams = jax.jit(jq.init_params)(jax.random.PRNGKey(3))
    jstate = jax.jit(jq.init_state)(jparams)
    q = StructureQuantizer(build_structure(getattr(UNetConfig, name)()), n_e=4, base=3.0,
                           depth_order=order)
    q.load_state_dict(params_from_jax(
        {"embedding": np.asarray(jparams["embedding"]),
         "embedding_gs": np.asarray(jstate["embedding_gs"])}, q))
    # hypernet-like logits near the codebook rows, so routing is not trivial
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 4, 6)
    z = (np.asarray(jparams["embedding"])[rows]
         + 0.5 * rng.standard_normal((6, jspec.vq_dim))).astype(np.float32)
    noise = _jax_eval_noise(6, jspec)

    np.testing.assert_allclose(q.gumbel_sigmoid_trick(torch.from_numpy(z), noise).numpy(),
                               np.asarray(jax.jit(jq.gumbel_sigmoid_trick)(jnp.asarray(z))),
                               rtol=1e-5, atol=1e-6)
    want_arch, want_idx = jax.jit(jq.forward_eval)(jstate, jnp.asarray(z))
    arch, idx = q.forward_eval(torch.from_numpy(z), noise)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(arch.numpy(), np.asarray(want_arch))
    # the port's default noise is fixed: the same routing on every call
    a1, i1 = q.forward_eval(torch.from_numpy(z))
    a2, i2 = q.forward_eval(torch.from_numpy(z))
    assert torch.equal(i1, i2) and torch.equal(a1, a2)
    assert bool(((i1 >= 0) & (i1 < 4)).all())


def test_vae_decode_matches_jax():
    jvae = JaxVAE(JaxVAEConfig.tiny())
    vae = AutoencoderKL(VAEConfig.tiny()).eval()
    img = jnp.zeros((1, 16, 16, 3))
    params = _carry(jvae, vae, img, jax.random.PRNGKey(0))
    z = np.random.default_rng(5).standard_normal((2, 8, 8, 4), dtype=np.float32)
    want = jax.jit(lambda p, z: jvae.apply({"params": p}, z, method=JaxVAE.decode))(
        params, jnp.asarray(z))
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(z))
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_vae_decoder_loads_diffusers_state_dict():
    """The whole diffusers VAE state dict loads by name; the decoder and the
    encoder's moments agree with the diffusers-layout ground truth."""
    torch.manual_seed(0)
    mini = MiniVAE(VAEConfig.tiny()).eval()
    vae = AutoencoderKL(VAEConfig.tiny()).eval()
    vae.load_state_dict(mini.state_dict(), strict=True)
    g = torch.Generator().manual_seed(1)
    z = torch.randn(1, 4, 8, 8, generator=g)
    x = torch.randn(1, 3, 16, 16, generator=g)
    with torch.no_grad():
        want = mini.decode(z / VAEConfig.tiny().scaling_factor)
        got = vae.decode(z.permute(0, 2, 3, 1))
        want_moments = mini.encode_moments(x)
        got_moments = vae.encode_moments(x.permute(0, 2, 3, 1))
    torch.testing.assert_close(got.permute(0, 3, 1, 2), want, rtol=RTOL, atol=ATOL)
    for g_, w_ in zip(got_moments, want_moments):
        torch.testing.assert_close(g_.permute(0, 3, 1, 2), w_, rtol=RTOL, atol=ATOL)


def test_random_init_scales_like_the_jax_convention():
    model = te.CLIPTextEncoder(te.CLIPTextConfig.tiny())
    random_init_(model, torch.Generator().manual_seed(0))
    layer = model.text_model.encoder.layers[0]
    assert torch.all(layer.layer_norm1.weight == 1) and torch.all(layer.layer_norm1.bias == 0)
    assert torch.all(layer.mlp.fc1.bias == 0)
    w = layer.mlp.fc2.weight  # (32, 64): fan-in 64
    assert abs(w.std().item() * 8.0 - 1.0) < 0.1
    assert all(torch.isfinite(p).all() for p in model.parameters())
