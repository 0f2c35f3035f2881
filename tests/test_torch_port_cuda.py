"""The gated flash attention CUDA kernel against its plain version, on a CUDA
card. Imports only torch and the port, so that it runs on a machine without
JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Without a card every test here skips."""
import pytest
import torch

from diffusion_pruning_tpu_torch.ops.flash_attention import (
    gated_attention_reference,
    gated_flash_attention,
)

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")]


# per (batch, head) ||kernel - reference|| / ||reference||: the kernel
# rounds P and O to bf16 (about 2e-3 relative each); a dropped 64-row kv tile
# or a gate applied once instead of squared reads 1e-1 or more
REL_L2 = 1e-2


def _inputs(b, s_q, s_kv, h, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, 64, device="cuda", generator=g).bfloat16()
               for s in (s_q, s_kv, s_kv))
    gate = torch.rand(b, h, device="cuda", generator=g)
    gate[0, 0] = 0.0  # one closed head
    return q, k, v, gate


def per_head_rel_l2(out, ref):
    err = (out.float() - ref).square().sum(dim=(1, 3)).sqrt()
    return err / ref.square().sum(dim=(1, 3)).sqrt().clamp_min(1e-30)


@pytest.mark.parametrize("s_q,s_kv,h", [(1024, 1024, 5), (256, 77, 10), (16, 16, 20),
                                        (100, 77, 3), (4096, 4096, 1)])
def test_cuda_kernel_matches_plain_version(s_q, s_kv, h):
    """The bf16 kernel against the plain version in f32 (TF32 off) on the
    same bf16 inputs."""
    q, k, v, gate = _inputs(2, s_q, s_kv, h, seed=s_q + h)
    before = gated_flash_attention.launches
    out = gated_flash_attention(q, k, v, gate)
    torch.cuda.synchronize()
    assert gated_flash_attention.launches == before + 1
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = gated_attention_reference(q.float(), k.float(), v.float(), gate)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert per_head_rel_l2(out, ref).max().item() <= REL_L2
    assert torch.all(out[0, :, 0] == 0)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, gate = _inputs(1, 32, 32, 2, seed=0)
    with pytest.raises(ValueError, match="head dim"):
        gated_flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                              v[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        gated_flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    with pytest.raises(TypeError):
        gated_flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="bfloat16"):
        gated_flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="gate"):
        gated_flash_attention(q, k, v, gate.bfloat16())
    with pytest.raises(NotImplementedError, match="no backward"):
        gated_flash_attention(q.requires_grad_(), k, v, gate)
