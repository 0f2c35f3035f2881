"""The port's prepared serving programs (`pipelines/aot.py`, `ExpertServer.
warmup`, `PruningPipeline.prepare_denoise`), on the CPU.

The signature and dispatch semantics are held against the JAX module's on
the same call sequence (tests/test_aot.py). On the CPU `warmup` installs the
eager trajectory in each expert pipe's dispatch table instead of a CUDA
graph, so a warmed server must serve the unwarmed server's images bit for
bit; a tier it did not prepare falls back to the eager loop. Capture itself
needs the card (`test_torch_port_cuda.py`, `chip_smoke.py` phase 19); here
it must refuse CPU tensors. A CUDA graph cannot be saved and capture has no
wait to overlap, so `aot_dir` and `parallel > 1` raise with those reasons."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pruning_tpu.pipelines import aot as jax_aot
from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from diffusion_pruning_tpu_torch.ops import flash_attention, group_norm, norm_conv
from diffusion_pruning_tpu_torch.pipelines import PruningPipeline, aot
from diffusion_pruning_tpu_torch.pipelines.expert_server import (
    AOT_DIR_REFUSED,
    PARALLEL_REFUSED,
    ExpertServer,
)
from diffusion_pruning_tpu_torch.utils.init_utils import random_init_

torch.set_num_threads(1)
K = 3
STEPS = 2


def _pipeline():
    """A tiny routed pipeline, random from a seed, whose codebook snapshot
    holds K distinct codes (units kept with p = 0.6; code 1 closes every
    other depth gate)."""
    gen = torch.Generator().manual_seed(0)
    unet = GatedUNet(UNetConfig.tiny(cross_attention_dim=32))
    spec = unet.spec
    vae, text = AutoencoderKL(VAEConfig.tiny()), CLIPTextEncoder(CLIPTextConfig.tiny())
    hypernet = HyperStructure(spec, input_dim=32)
    quantizer = StructureQuantizer(spec, n_e=K, base=0.0)
    for module in (unet, vae, text, hypernet):
        random_init_(module, gen)
    quantizer.init_params(gen)
    quantizer.init_state()
    rng = np.random.default_rng(21)
    codes = (rng.random((K, spec.vq_dim)) < 0.6).astype(np.float32)
    codes[:, spec.num_width:] = 1.0
    codes[1, spec.num_width::2] = 0.0
    with torch.no_grad():
        quantizer.embedding_gs.copy_(torch.from_numpy(np.where(codes >= 0.5, 0.8, 0.2)))
    return PruningPipeline(unet, vae, text, hypernet, quantizer, device="cpu")


def _server(pipe, batch_size=2):
    return ExpertServer.from_codebook(pipe, pipe.unet.spec, pipe.unet.cfg,
                                      batch_size=batch_size)


@pytest.fixture(scope="module")
def pipe():
    return _pipeline()


def _request(pipe, seed, n):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, 128, (n, 77)))
    noise = torch.from_numpy(rng.gumbel(size=(n, pipe.unet.spec.vq_dim)).astype(np.float32))
    latents = torch.from_numpy(rng.standard_normal((n, 8, 8, 4), dtype=np.float32))
    return ids, noise, latents


# ---------------------------------------------------------------- signature and dispatch

def test_signature_and_dispatch_follow_the_jax_module():
    """The same call sequence through both packages' `ShapeDispatch`: a
    matching operand signature runs the prepared program, an unseen one the
    fallback; the leading model never enters the key. A signature hashes
    shapes, dtypes and strides; other leaves by repr."""
    def counting(calls, name):
        def fn(p, x):
            calls[name] += 1
            return x + 1
        return fn

    got = {"fallback": 0, "program": 0}
    want = {"fallback": 0, "program": 0}
    d = aot.ShapeDispatch(counting(got, "fallback"))
    jd = jax_aot.ShapeDispatch(counting(want, "fallback"))
    d.add((torch.nn.Linear(5, 5), torch.zeros(2, 3)), counting(got, "program"))
    jd.add(({"w": jnp.zeros((5,))}, jnp.zeros((2, 3))), counting(want, "program"))
    for shape, model in (((2, 3), None), ((4, 3), None), ((2, 3), "another model")):
        d(model, torch.zeros(shape))
        jd(model, jnp.zeros(shape))
    assert got == want == {"fallback": 1, "program": 2}
    assert len(d.programs) == 1

    x = torch.zeros(2, 3)
    assert aot.signature((x, None)) == aot.signature((torch.ones(2, 3), None))
    for other in (torch.zeros(3, 2), x.double(), torch.zeros(3, 2).t(), torch.zeros(2, 3, 1)):
        assert aot.signature((other, None)) != aot.signature((x, None))
    assert aot.signature((x, None)) != aot.signature((x, 1.0))
    assert aot.signature((x, 1.0)) == aot.signature((torch.zeros(2, 3), 1.0))


def test_capture_refuses_cpu_tensors(pipe):
    run = pipe._denoise_fn(STEPS, 7.5, False)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        aot.capture(run, (pipe.unet, torch.zeros(2, 77, 32), None, torch.zeros(1, 8, 8, 4)))
    with pytest.raises(ValueError, match="tensor operand"):
        aot.capture(run, (pipe.unet, None))


def test_launch_counts_cover_every_kernel_wrapper():
    """A replay adds the launches its capture recorded to every counter the
    port keeps: each wrapper with a `.launches` of the ops modules, and each
    forward kernel's."""
    wrappers = {name for module in (flash_attention, group_norm, norm_conv)
                for name, fn in inspect.getmembers(module, inspect.isfunction)
                if hasattr(fn, "launches")}
    assert wrappers == {fn.__name__ for fn in aot.COUNTED_WRAPPERS}
    counts = aot.launch_counts()
    assert set(counts) == wrappers | set(flash_attention.forward_launches)
    before = dict(counts)
    delta = {k: i + 1 for i, k in enumerate(counts)}
    aot._add_launches(delta)
    assert aot.launch_counts() == {k: before[k] + delta[k] for k in counts}
    aot._add_launches(delta, -1)
    assert aot.launch_counts() == before


# ---------------------------------------------------------------- warm-up

@pytest.mark.parametrize("hybrid", [False, True])
def test_warmed_server_serves_the_unwarmed_images_bit_for_bit(pipe, hybrid):
    """`warmup` prepares one program per (expert, tier), and under hybrid one
    per tier of the gated U-Net, each in a dispatch table of its pipe's own
    cache; the images and expert indices it then serves equal an unwarmed
    server's bit for bit (on the CPU a program is the eager trajectory)."""
    warm, plain = _server(pipe), _server(pipe)
    tiers = warm.batch_shapes
    stats = warm.warmup(STEPS, 7.5, hybrid=hybrid)
    assert stats == {"loaded": 0, "built": (K + hybrid) * len(tiers)}
    key = (STEPS, 7.5, False, "ddim")
    caches = [warm.expert_pipe(e)._denoise_cache for e in range(K)]
    assert len({id(c) for c in caches}) == K
    for cache in caches:
        assert isinstance(cache[key], aot.ShapeDispatch) and len(cache[key].programs) == len(tiers)
    gated = pipe._denoise_cache.get((STEPS, 7.5, True, "ddim"))
    assert isinstance(gated, aot.ShapeDispatch) == hybrid
    assert not any(isinstance(c.get(key), aot.ShapeDispatch)
                   for c in [plain.expert_pipe(e)._denoise_cache for e in range(K)])

    ids, noise, latents = _request(pipe, 3, 5)
    neg = torch.zeros(1, 77, dtype=torch.long)
    got, got_idx = warm.generate(ids, neg, num_inference_steps=STEPS, hybrid=hybrid,
                                 route_noise=noise, latents=latents)
    if hybrid:  # the unwarmed pipeline's gated path runs the eager loop
        pipe._denoise_cache.clear()
    want, want_idx = plain.generate(ids, neg, num_inference_steps=STEPS, hybrid=hybrid,
                                    route_noise=noise, latents=latents)
    assert len(set(got_idx.tolist())) > 1
    assert torch.equal(got_idx, want_idx)
    assert torch.equal(got, want) and torch.isfinite(got).all()


def test_an_unprepared_tier_falls_back_to_the_eager_loop(pipe):
    """A request whose batch no tier prepared (3 here) runs the pipe's eager
    trajectory and counts a miss; a prepared one runs its program and counts
    a hit."""
    pipe = pipe.with_unet(pipe.unet)
    assert pipe.prepare_denoise(STEPS, 7.5, (1, 2)) == 2
    disp = pipe._denoise_fn(STEPS, 7.5, False)
    calls = []
    eager = disp.fallback
    disp.fallback = lambda *a: calls.append(a[-1].shape[0]) or eager(*a)
    disp._by_sig = {k: (lambda *a, fn=fn: calls.append(("program", a[-1].shape[0])) or fn(*a))
                    for k, fn in disp._by_sig.items()}
    ids, _, latents = _request(pipe, 4, 3)
    pe = pipe.encode_prompt(ids)
    ne = pipe.encode_prompt(torch.zeros_like(ids))
    for n in (3, 2):
        pipe.denoise(None, pe[:n], ne[:n], None, STEPS, 7.5, latents=latents[:n])
        assert (disp.hits, disp.misses) == ((0, 1) if n == 3 else (1, 1))
    assert calls == [3, ("program", 2)]


def test_warmup_refuses_what_a_graph_cannot_do(pipe):
    """`aot_dir` and `parallel > 1` raise with the recorded reasons."""
    server = _server(pipe)
    with pytest.raises(NotImplementedError, match="cannot be saved") as e:
        server.warmup(STEPS, aot_dir="programs")
    assert AOT_DIR_REFUSED in str(e.value) and "build/torch_kernels" in str(e.value)
    with pytest.raises(NotImplementedError, match="GIL") as e:
        server.warmup(STEPS, parallel=2)
    assert PARALLEL_REFUSED in str(e.value)
