"""Gradients of the port's gated attention on the CPU: the plain version of
the backward kernels (`gated_flash_backward_reference`), the lse of the
training forward, and the autograd Function that joins them, held against
`jax.grad` of the JAX package's Pallas flash attention (interpret mode) and
against torch autograd through the plain forward. Shapes and tolerances are
those of tests/test_flash_attention.py:111-235. The CUDA kernels themselves
are held against these plain versions in test_torch_port_cuda.py (needs a
card)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusion_pruning_tpu.ops.flash_attention as jax_fa
from diffusion_pruning_tpu_torch.ops.flash_attention import (
    gated_attention_reference,
    gated_attention_reference_lse,
    gated_flash_attention,
    gated_flash_backward_reference,
)

torch.set_num_threads(1)

# name: (B, S_q, S_kv, H, block_q of the JAX kernels, atol, rtol, closed head)
CASES = {
    "single_block": (1, 16, 16, 2, 512, 1e-4, 1e-3, None),
    "multi_q_block": (1, 256, 256, 2, 64, 5e-4, 1e-3, None),
    "cross_attention_77": (1, 64, 77, 2, 512, 5e-4, 1e-3, None),
    "odd_heads_hard_zero_gate": (1, 64, 64, 5, 512, 5e-4, 1e-3, 2),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """Inputs from a seed and the JAX package's grads of Σ flash(q, k, v, g)²."""
    b, s_q, s_kv, h, block_q, _, _, closed = CASES[name]
    rng = np.random.default_rng(len(name))
    q = rng.standard_normal((b, s_q, h, 64), dtype=np.float32)
    k = rng.standard_normal((b, s_kv, h, 64), dtype=np.float32)
    v = rng.standard_normal((b, s_kv, h, 64), dtype=np.float32)
    gate = (rng.random((b, h), dtype=np.float32) * 0.8 + 0.1).astype(np.float32)
    if closed is not None:
        gate[0, closed] = 0.0

    def loss(q, k, v, g):
        return (jax_fa.flash_attention(q, k, v, g, block_q, True) ** 2).sum()

    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, gate)))
    return (q, k, v, gate), tuple(np.asarray(g) for g in grads)


def _tol(name):
    return dict(atol=CASES[name][5], rtol=CASES[name][6])


def _reference_grads(q, k, v, gate):
    """The plain backward on the cotangent of Σ o² (do = 2·o)."""
    t = [torch.from_numpy(a) for a in (q, k, v, gate)]
    o, lse = gated_attention_reference_lse(*t)
    return gated_flash_backward_reference(*t, o, lse, 2.0 * o)


def _autograd_grads(fn, q, k, v, gate):
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, gate)]
    (fn(*t) ** 2).sum().backward()
    return tuple(x.grad for x in t)


def _assert_close(got, want, err_msg="", **tol):
    for g, w, name in zip(got, want, "qkvg"):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), err_msg=err_msg + name, **tol)


@pytest.mark.parametrize("name", list(CASES))
def test_backward_reference_matches_jax_flash_grad(name):
    inputs, want = _case(name)
    _assert_close(_reference_grads(*inputs), want, **_tol(name))


@pytest.mark.parametrize("name", list(CASES))
def test_backward_reference_matches_torch_autograd(name):
    inputs, _ = _case(name)
    want = _autograd_grads(gated_attention_reference, *inputs)
    _assert_close(_reference_grads(*inputs), want, **_tol(name))


@pytest.mark.parametrize("name", list(CASES))
def test_autograd_function_on_cpu_matches_jax_and_autograd(name):
    inputs, want_jax = _case(name)
    got = _autograd_grads(gated_flash_attention, *inputs)
    _assert_close(got, want_jax, "vs jax: ", **_tol(name))
    _assert_close(got, _autograd_grads(gated_attention_reference, *inputs), "vs autograd: ",
                  **_tol(name))


@pytest.mark.parametrize("name", ["multi_q_block", "cross_attention_77"])
def test_lse_matches_jax_training_forward(name):
    (q, k, v, gate), _ = _case(name)
    b, s_q, _, h, block_q = CASES[name][:5]
    _, want = jax_fa._flash_forward(*map(jnp.asarray, (q, k, v, gate)), block_q, True,
                                    with_lse=True)
    _, got = gated_attention_reference_lse(*map(torch.from_numpy, (q, k, v, gate)))
    assert got.shape == (b * h, s_q) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(b * h, s_q),
                               atol=1e-5, rtol=1e-5)


def test_closed_head_has_zero_input_grads_and_a_live_gate_grad():
    """A hard 0 gate: q, k, v get no gradient through that head, but its gate
    does (Σ dv'∘v with uniform probabilities), which is what trains the
    router. The output gradient is random here: under Σ o² a closed head's
    output gradient would itself be 0."""
    (q, k, v, gate), _ = _case("odd_heads_hard_zero_gate")
    do = torch.from_numpy(np.random.default_rng(3).standard_normal(q.shape, dtype=np.float32))
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, gate)]
    (gated_attention_reference(*t) * do).sum().backward()
    o, lse = gated_attention_reference_lse(*(x.detach() for x in t))
    got = gated_flash_backward_reference(*(x.detach() for x in t), o, lse, do)
    for g in got[:3]:
        assert torch.all(g[:, :, 2] == 0)
    assert abs(float(got[3][0, 2])) > 1e-2
    _assert_close(got, [x.grad for x in t], **_tol("odd_heads_hard_zero_gate"))


def test_function_without_a_gate_or_gate_grad_returns_none_for_it():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 16, 2, 64, generator=g, requires_grad=True) for _ in range(3))
    gate = torch.rand(1, 2, generator=g)  # no grad
    gated_flash_attention(q, k, v, gate).sum().backward()
    assert gate.grad is None and q.grad is not None
    q.grad = None
    gated_flash_attention(q, k, v, None).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
