"""The port's gated attention (plain version of the CUDA kernel) against the
JAX package's Pallas flash attention (interpret mode) and its masked-SDPA
reference, on the CPU. The CUDA kernel itself is checked against the plain
version in test_torch_port_cuda.py (needs a card)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusion_pruning_tpu.ops.flash_attention as jax_fa
from diffusion_pruning_tpu_torch.ops.flash_attention import (
    gated_attention_reference,
    gated_flash_attention,
)

torch.set_num_threads(1)
ATOL, RTOL = 2e-5, 1e-4  # f32, as the JAX package's own flash tests


def _inputs(b, s_q, s_kv, h, gate_kind, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s_q, h, 64), dtype=np.float32)
    k = rng.standard_normal((b, s_kv, h, 64), dtype=np.float32)
    v = rng.standard_normal((b, s_kv, h, 64), dtype=np.float32)
    gate = {"none": None,
            "soft": rng.random((b, h), dtype=np.float32),
            "hard": (rng.random((b, h)) < 0.5).astype(np.float32)}[gate_kind]
    return q, k, v, gate


def _port(q, k, v, gate):
    t = torch.from_numpy
    return gated_flash_attention(t(q), t(k), t(v), None if gate is None else t(gate)).numpy()


def _jax(q, k, v, gate):
    g = None if gate is None else jnp.asarray(gate)
    flash = jax_fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), g,
                                   512, True)
    sdpa = jax_fa._masked_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), g)
    return np.asarray(flash), np.asarray(sdpa)


@pytest.mark.parametrize("gate_kind", ["none", "soft", "hard"])
@pytest.mark.parametrize("s_kv", [64, 77])
@pytest.mark.parametrize("h", [4, 5])
def test_plain_version_matches_jax_flash_and_masked_sdpa(h, s_kv, gate_kind):
    q, k, v, gate = _inputs(2, 64, s_kv, h, gate_kind, seed=h * 100 + s_kv)
    got = _port(q, k, v, gate)
    flash, sdpa = _jax(q, k, v, gate)
    np.testing.assert_allclose(got, flash, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, sdpa, atol=ATOL, rtol=RTOL)
    if gate_kind == "hard":  # closed heads give exactly zero
        closed = gate == 0
        assert np.all(got.transpose(0, 2, 1, 3)[closed] == 0)


@pytest.mark.parametrize("h", [4, 5])
def test_plain_version_matches_jax_kv_blocked_kernels(h, monkeypatch):
    """The JAX package switches to kv-blocked online-softmax kernels at long
    kv extents; shrink the switch-over so they run at a test size."""
    monkeypatch.setattr(jax_fa, "_KV_SPLIT", 64)
    monkeypatch.setattr(jax_fa, "_KV_BLK", 32)
    monkeypatch.setattr(jax_fa, "_KV_QBLK", 32)
    q, k, v, gate = _inputs(1, 128, 128, h, "soft", seed=h)
    flash, sdpa = _jax(q, k, v, gate)
    got = _port(q, k, v, gate)
    np.testing.assert_allclose(got, flash, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, sdpa, atol=ATOL, rtol=RTOL)


def test_gated_attention_module_flash_flag_is_the_same_function_on_cpu():
    from diffusion_pruning_tpu_torch.models.unet.attention import GatedAttention

    torch.manual_seed(0)
    attn = GatedAttention(128, 2, context_dim=32, use_flash=True)
    x = torch.randn(4, 16, 128)
    ctx = torch.randn(4, 77, 32)
    gate = torch.rand(2, 2)
    flash = attn(x, ctx, gate)
    attn.use_flash = False
    torch.testing.assert_close(flash, attn(x, ctx, gate), rtol=0, atol=0)
