"""The port's gated U-Net against the JAX package's (same weights carried
across with `params_from_jax`) and against the torch diffusers ground truth
in `tests/torch_mini_diffusers.py`, on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pruning_tpu.models.unet.config import UNetConfig as JaxUNetConfig
from diffusion_pruning_tpu.models.unet.unet import GatedUNet as JaxGatedUNet
from diffusion_pruning_tpu_torch.models.convert import params_from_jax
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet, timestep_embedding

from torch_mini_diffusers import MiniUNet
from torch_port_common import numpy_params

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 5e-4  # as tests/test_torch_parity_models.py


@pytest.fixture(scope="module")
def jax_params():
    model = JaxGatedUNet(JaxUNetConfig.tiny())
    return numpy_params(jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0))))


def _arch(kind, spec, rng):
    if kind == "none":
        return None
    if kind == "soft":
        return rng.random((2, spec.vq_dim), dtype=np.float32)
    arch = (rng.random((2, spec.vq_dim)) < 0.7).astype(np.float32)
    arch[:, spec.num_width:] = 1.0
    arch[0, spec.num_width::2] = 0.0  # close every other depth gate of row 0
    arch[1, spec.num_width + 1::2] = 0.0
    return arch


@pytest.mark.parametrize("arch_kind", ["none", "soft", "hard_depth"])
@pytest.mark.parametrize("flash", [False, True])
def test_gated_unet_matches_jax(jax_params, flash, arch_kind):
    jcfg = JaxUNetConfig.tiny(use_flash_attention=flash)
    model = GatedUNet(UNetConfig.tiny(use_flash_attention=flash)).eval()
    model.load_state_dict(params_from_jax(jax_params, model))
    rng = np.random.default_rng(7)
    # batch 4 against an arch of batch 2: the CFG tiling of arch rows
    x = rng.standard_normal((4, 8, 8, 4), dtype=np.float32)
    t = np.array([3, 747, 100, 999])
    ehs = rng.standard_normal((4, 77, 32), dtype=np.float32)
    arch = _arch(arch_kind, model.spec, rng)
    if arch_kind == "hard_depth":
        assert model.spec.num_depth > 1 and (arch[:, model.spec.num_width:] == 0).any()

    jax_model = JaxGatedUNet(jcfg)
    want = jax.jit(lambda p, *a, **k: jax_model.apply({"params": p}, *a, **k))(
        jax_params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs),
        arch=None if arch is None else jnp.asarray(arch))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ehs),
                    arch=None if arch is None else torch.from_numpy(arch))
    assert got.shape == (4, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_gated_unet_loads_diffusers_state_dict_directly():
    cfg = UNetConfig.tiny()
    torch.manual_seed(0)
    mini = MiniUNet(dataclasses.replace(cfg)).eval()
    model = GatedUNet(cfg).eval()
    model.load_state_dict(mini.state_dict(), strict=True)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 4, 8, 8, generator=g)
    t = torch.tensor([3, 747])
    ehs = torch.randn(2, 77, 32, generator=g)
    with torch.no_grad():
        want = mini(x, t, ehs)
        got = model(x.permute(0, 2, 3, 1), t, ehs)
        ones = model(x.permute(0, 2, 3, 1), t, ehs, arch=torch.ones(1, model.spec.vq_dim))
    torch.testing.assert_close(got.permute(0, 3, 1, 2), want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(ones, got, rtol=RTOL, atol=ATOL)


def test_timestep_embedding_is_cos_then_sin():
    emb = timestep_embedding(torch.tensor([0.0]), 8)
    assert emb[0, :4].tolist() == [1.0, 1.0, 1.0, 1.0]
    assert emb[0, 4:].tolist() == [0.0, 0.0, 0.0, 0.0]


def test_arch_width_mismatch_raises():
    model = GatedUNet(UNetConfig.tiny())
    with pytest.raises(ValueError, match="arch vector"):
        model(torch.zeros(1, 8, 8, 4), torch.zeros(1), torch.zeros(1, 77, 32),
              arch=torch.ones(1, model.spec.vq_dim + 1))
