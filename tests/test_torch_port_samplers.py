"""The port's PNDM and DPM-Solver++(2M) samplers and the pipeline's sampler
choice, held against the JAX package's samplers (the same model function, the
same initial latents) and PNDM also against the hand-ported diffusers stepper
of `tests/torch_mini_schedulers.py`, on the CPU."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pruning_tpu.schedulers import DDIMSampler as JaxDDIM
from diffusion_pruning_tpu.schedulers import DiffusionSchedule as JaxSchedule
from diffusion_pruning_tpu.schedulers import DPMSolverPPSampler as JaxDPM
from diffusion_pruning_tpu.schedulers import PNDMSampler as JaxPNDM
from diffusion_pruning_tpu_torch.pipelines import PruningPipeline
from diffusion_pruning_tpu_torch.schedulers import (
    DDIMSampler,
    DiffusionSchedule,
    DPMSolverPPSampler,
    PNDMSampler,
)

from torch_mini_schedulers import RefPNDMScheduler

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5  # as tests/test_sampler_parity.py
SHAPE = (2, 4, 4, 4)
PAIRS = {"pndm": (PNDMSampler, JaxPNDM), "dpm++": (DPMSolverPPSampler, JaxDPM)}


def _model_jax(x, t_b):
    # a deterministic stand-in denoiser, the same function as `_model_torch`
    tt = t_b.astype(jnp.float32).reshape((-1,) + (1,) * (x.ndim - 1))
    return 0.1 * jnp.sin(3.0 * x) + 0.05 * jnp.cos(tt / 50.0)


def _model_torch(x, t_b):
    tt = t_b.float().reshape((-1,) + (1,) * (x.dim() - 1))
    return 0.1 * torch.sin(3.0 * x) + 0.05 * torch.cos(tt / 50.0)


def _latents(seed=0):
    return np.random.default_rng(seed).standard_normal(SHAPE, dtype=np.float32)


@pytest.mark.parametrize("name", sorted(PAIRS))
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("steps", [2, 3, 10, 25, 50])
def test_sampler_trajectory_matches_jax(name, prediction_type, steps):
    ours, theirs = PAIRS[name]
    sampler = ours(DiffusionSchedule(prediction_type=prediction_type))
    ref = theirs(JaxSchedule(prediction_type=prediction_type))
    np.testing.assert_array_equal(sampler.timesteps(steps), ref.timesteps(steps))
    x0 = _latents(steps)
    want = jax.jit(lambda z: ref.sample(_model_jax, z, steps))(jnp.asarray(x0))
    got = sampler.sample(_model_torch, torch.from_numpy(x0), steps)
    assert got.dtype == torch.float32 and got.shape == SHAPE
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("steps", [25, 50])
def test_pndm_trajectory_matches_diffusers(prediction_type, steps):
    """As tests/test_sampler_parity.py holds the JAX PNDM sampler."""
    sampler = PNDMSampler(DiffusionSchedule(prediction_type=prediction_type))
    ref = RefPNDMScheduler(prediction_type=prediction_type)
    ref.set_timesteps(steps)
    np.testing.assert_array_equal(sampler.timesteps(steps), ref.timesteps)
    x0 = _latents(1)
    x_t = torch.from_numpy(x0.copy())
    for t in ref.timesteps:
        out = 0.1 * torch.sin(3.0 * x_t) + 0.05 * math.cos(int(t) / 50.0)
        x_t = ref.step(out, int(t), x_t)
    got = sampler.sample(_model_torch, torch.from_numpy(x0), steps)
    np.testing.assert_allclose(got.numpy(), x_t.numpy(), rtol=RTOL, atol=ATOL)


def test_dpm_timesteps_are_ddims_and_constant_x0_is_exact():
    """DPM++ uses DDIM's plan; with a model whose x0 prediction is constant
    both its orders integrate the ODE exactly, as DDIM's transfer does."""
    sched = DiffusionSchedule(prediction_type="epsilon")
    dpm, ddim = DPMSolverPPSampler(sched), DDIMSampler(sched)
    np.testing.assert_array_equal(dpm.timesteps(5), [801, 601, 401, 201, 1])
    np.testing.assert_array_equal(dpm.timesteps(7), ddim.timesteps(7))
    target = torch.full(SHAPE, -0.3)
    ac = torch.as_tensor(sched.alphas_cumprod, dtype=torch.float64)

    def perfect(x, t_b):  # ε of the constant x0 = target
        a = ac[t_b].reshape(-1, 1, 1, 1)
        return ((x.double() - a.sqrt() * target.double()) / (1 - a).sqrt()).float()

    x = torch.from_numpy(_latents(2))
    np.testing.assert_allclose(dpm.sample(perfect, x, 10).numpy(),
                               ddim.sample(perfect, x, 10).numpy(), atol=1e-4)


def test_jax_ddim_and_port_ddim_share_the_plan():
    np.testing.assert_array_equal(DDIMSampler(DiffusionSchedule()).timesteps(25),
                                  JaxDDIM(JaxSchedule()).timesteps(25))


@pytest.fixture(scope="module")
def pipelines():
    from test_torch_port_pipeline import pipelines as fixture
    return fixture.__wrapped__()


@pytest.mark.parametrize("sampler", ["ddim", "pndm", "dpm++"])
def test_pipeline_sampler_choice_matches_jax(pipelines, sampler):
    """The routed pipeline's `sampler` choice: the port's CFG trajectory under
    each sampler against the JAX pipeline's with the same choice, weights,
    text states, arch and initial latents."""
    import dataclasses
    jp, pp = pipelines
    jp = dataclasses.replace(jp, sampler=sampler)
    port = PruningPipeline(pp.unet, pp.vae, pp.text_encoder, pp.hypernet, pp.quantizer,
                           device="cpu", sampler=sampler)
    assert port.sampler == sampler
    assert type(port._sampler()) is {"ddim": DDIMSampler, "pndm": PNDMSampler,
                                      "dpm++": DPMSolverPPSampler}[sampler]
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 128, (2, 77)).astype(np.int32)
    neg = rng.integers(0, 128, (2, 77)).astype(np.int32)
    latents = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    arch = (rng.random((2, pp.unet.spec.vq_dim)) < 0.7).astype(np.float32)
    pe, ne = jp.encode_prompt(jnp.asarray(ids)), jp.encode_prompt(jnp.asarray(neg))
    want = jp._denoise_fn(3, 7.5, True)(jp.unet_params, jnp.concatenate([ne, pe]),
                                        jnp.asarray(arch), jnp.asarray(latents))
    pe_t = port.encode_prompt(torch.from_numpy(ids).long())
    ne_t = port.encode_prompt(torch.from_numpy(neg).long())
    got = port.denoise(None, pe_t, ne_t, torch.from_numpy(arch), 3, 7.5,
                       latents=torch.from_numpy(latents))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)


def test_pipeline_refuses_an_unknown_sampler():
    with pytest.raises(ValueError, match="sampler must be one of"):
        PruningPipeline(None, None, None, device="cpu", sampler="euler")
