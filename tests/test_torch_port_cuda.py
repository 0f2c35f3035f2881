"""The gated flash attention CUDA kernels (the forward, with and without lse,
and the dq and dk/dv backward kernels) against their plain versions, on a
CUDA card. Imports only torch and the port, so that it runs on a machine without
JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Without a card every test here skips."""
import pytest
import torch

from diffusion_pruning_tpu_torch.ops.flash_attention import (
    gated_attention_reference,
    gated_attention_reference_lse,
    gated_flash_attention,
    gated_flash_backward,
    gated_flash_backward_reference,
    gated_flash_bwd_dkv,
    gated_flash_bwd_dq,
    gated_flash_forward_lse,
)

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")]


# per (batch, head) ||kernel - reference|| / ||reference||: the kernel
# rounds P and O to bf16 (about 2e-3 relative each); a dropped 64-row kv tile
# or a gate applied once instead of squared reads 1e-1 or more
REL_L2 = 1e-2
# lse: f32 on both sides from the same bf16 inputs (reads ~1e-6)
LSE_ATOL = 1e-3
# dgate per (batch, head) relative to the head's RMS dgate over the batch
DGATE_REL = 5e-2


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


def _f32_reference(fn, *args):
    """fn on the given tensors upcast to f32, with TF32 off."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn(*(t.float() if t is not None and t.dtype == torch.bfloat16 else t
                    for t in args))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


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
    with pytest.raises(TypeError, match="bfloat16"):  # the training path takes bf16 too
        gated_flash_attention(q.float().requires_grad_(), k.float(), v.float(), gate)


# the 8 attention shapes of the SD-2.1 U-Net at 256px, and a ragged odd-head one
@pytest.mark.parametrize("s_q,s_kv,h", [(1024, 1024, 5), (1024, 77, 5), (256, 256, 10),
                                        (256, 77, 10), (64, 64, 20), (64, 77, 20),
                                        (16, 16, 20), (16, 77, 20), (100, 77, 3)])
def test_cuda_training_kernels_match_plain_versions(s_q, s_kv, h):
    """The training forward's o and lse, and dq, dk, dv and dgate of the
    backward kernels (on the forward's own o and lse), against the plain
    versions in f32 on the same bf16 inputs; a closed head gets exactly 0
    dq, dk, dv and a nonzero dgate."""
    b = 4
    q, k, v, gate = _inputs(b, s_q, s_kv, h, seed=s_q * h)
    do = torch.randn_like(q)
    counts = [f.launches for f in (gated_flash_forward_lse, gated_flash_bwd_dq,
                                   gated_flash_bwd_dkv)]
    o, lse = gated_flash_forward_lse(q, k, v, gate)
    dq, dk, dv, dgate = gated_flash_backward(q, k, v, gate, o, lse, do)
    torch.cuda.synchronize()
    assert [f.launches for f in (gated_flash_forward_lse, gated_flash_bwd_dq,
                                 gated_flash_bwd_dkv)] == [c + 1 for c in counts]
    o_r, lse_r = _f32_reference(gated_attention_reference_lse, q, k, v, gate)
    dq_r, dk_r, dv_r, dg_r = _f32_reference(gated_flash_backward_reference, q, k, v, gate,
                                            o, lse, do)
    assert lse.shape == (b * h, s_q) and (lse - lse_r).abs().max().item() <= LSE_ATOL
    for got, ref in ((o, o_r), (dq, dq_r), (dk, dk_r), (dv, dv_r)):
        assert per_head_rel_l2(got, ref).max().item() <= REL_L2
    rms = dg_r.square().mean(dim=0).sqrt()
    assert ((dgate - dg_r).abs() / rms).max().item() <= DGATE_REL
    for t in (dq, dk, dv):
        assert torch.all(t[0, :, 0] == 0)
    assert dgate[0, 0].abs().item() > 0


def test_cuda_autograd_function_runs_the_training_kernels():
    """Under autograd the wrapper runs the lse forward and both backward
    kernels; under no_grad the lse-free forward."""
    q, k, v, gate = _inputs(2, 64, 77, 5, seed=1)
    q.requires_grad_()
    gate.requires_grad_()
    kinds = (gated_flash_attention, gated_flash_forward_lse, gated_flash_bwd_dq,
             gated_flash_bwd_dkv)
    before = [f.launches for f in kinds]
    gated_flash_attention(q, k, v, gate).float().square().sum().backward()
    with torch.no_grad():
        gated_flash_attention(q, k, v, gate)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(kinds, before)] == [1, 1, 1, 1]
    assert q.grad is not None and gate.grad is not None and k.grad is None
    assert torch.isfinite(gate.grad).all()
