"""The port's CUDA kernels against their plain versions, on a CUDA card: gated
flash attention (the forward, with and without lse, and the backward
kernels of both routes) and the fused-norm kernels (one-pass GroupNorm(+SiLU),
GroupNorm→SiLU→conv3x3, GroupNorm→linear). Imports only torch and the port, so that it runs on a machine without
JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Without a card every test here skips."""
import functools

import pytest
import torch

from diffusion_pruning_tpu_torch.ops.flash_attention import (
    backward_plan,
    forward_kernel,
    forward_launches,
    gated_attention_reference,
    gated_attention_reference_lse,
    gated_flash_attention,
    gated_flash_backward,
    gated_flash_backward_reference,
    gated_flash_bwd_dkv,
    gated_flash_bwd_dq,
    gated_flash_bwd_fused,
    gated_flash_bwd_reduce,
    gated_flash_forward_lse,
)

from diffusion_pruning_tpu_torch.ops import group_norm as gn
from diffusion_pruning_tpu_torch.ops import norm_conv as nc

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


# S_q > 64 runs the wgmma kernel, S_q <= 64 the mma.sync one; S_kv = 77 (no
# tile's multiple) at B = 3, so that a TMA box past S_kv must stay inside its
# batch element
@pytest.mark.parametrize("s_q,s_kv,h", [(1024, 1024, 5), (256, 77, 10), (16, 16, 20),
                                        (100, 77, 3), (4096, 4096, 1), (1024, 77, 5),
                                        (64, 77, 20), (4096, 77, 5)])
def test_cuda_kernel_matches_plain_version(s_q, s_kv, h):
    """The bf16 kernel against the plain version in f32 (TF32 off) on the
    same bf16 inputs."""
    q, k, v, gate = _inputs(3 if s_kv == 77 else 2, s_q, s_kv, h, seed=s_q + h)
    before = gated_flash_attention.launches
    kernel = forward_kernel(s_q)
    before_kernel = forward_launches[kernel]
    out = gated_flash_attention(q, k, v, gate)
    torch.cuda.synchronize()
    assert gated_flash_attention.launches == before + 1
    assert forward_launches[kernel] == before_kernel + 1
    assert kernel == ("gated_flash_fwd_wgmma" if s_q > 64 else "gated_flash_fwd")
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
    # TMA reads from 16-byte aligned bases: a view one element in is refused
    q2, k2, v2, _ = _inputs(1, 200, 200, 2, seed=1)
    shifted = [t.flatten()[1:1 + t.numel() - 128].view(1, 199, 2, 64) for t in (q2, k2, v2)]
    with pytest.raises(ValueError, match="16-byte aligned"):
        gated_flash_attention(*shifted)
    with pytest.raises(ValueError, match="16-byte aligned"):
        gated_flash_forward_lse(*shifted)


BACKWARD_KERNELS = {"gated_flash_bwd_fused": gated_flash_bwd_fused,
                    "gated_flash_bwd_reduce": gated_flash_bwd_reduce,
                    "gated_flash_bwd_dq": gated_flash_bwd_dq,
                    "gated_flash_bwd_dkv": gated_flash_bwd_dkv}


def _backward_launches():
    return {name: f.launches for name, f in BACKWARD_KERNELS.items()}


# the 8 attention shapes of the SD-2.1 U-Net at 256px, a ragged odd-head one
# of each route (one pass at S_kv <= 80, else dq then dk/dv), and S_kv at the
# edges of the one-pass kv tile (80) and of the dk/dv kernel's 128-row tile,
# and a ragged one of the one pass's S_q <= 64 instance; 1024/77 at B = 4
# and h = 5 splits the one pass's query range in four
@pytest.mark.parametrize("s_q,s_kv,h", [(1024, 1024, 5), (1024, 77, 5), (256, 256, 10),
                                        (256, 77, 10), (64, 64, 20), (64, 77, 20),
                                        (16, 16, 20), (16, 77, 20), (100, 77, 3),
                                        (200, 200, 3), (100, 80, 3), (100, 81, 3),
                                        (100, 128, 3), (100, 129, 3), (40, 50, 3)])
def test_cuda_training_kernels_match_plain_versions(s_q, s_kv, h):
    """The training forward's o and lse, and dq, dk, dv and dgate of the
    backward kernels (on the forward's own o and lse), against the plain
    versions in f32 on the same bf16 inputs; a closed head gets exactly 0
    dq, dk, dv and a nonzero dgate; the kernels of the plan's route ran."""
    b = 4
    q, k, v, gate = _inputs(b, s_q, s_kv, h, seed=s_q * h + s_kv)
    do = torch.randn_like(q)
    plan = backward_plan(b, h, s_q, s_kv)
    before_fwd = gated_flash_forward_lse.launches
    before = _backward_launches()
    o, lse = gated_flash_forward_lse(q, k, v, gate)
    dq, dk, dv, dgate = gated_flash_backward(q, k, v, gate, o, lse, do)
    torch.cuda.synchronize()
    assert gated_flash_forward_lse.launches == before_fwd + 1
    ran = {name: n - before[name] for name, n in _backward_launches().items()}
    assert ran == {name: plan.launches.get(name, 0) for name in BACKWARD_KERNELS}
    assert plan.route == ("one_pass" if s_kv <= 80 else "two_kernel")
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


@pytest.mark.parametrize("s_q,s_kv,h", [(1024, 77, 5), (200, 200, 3)])
def test_cuda_backward_repeats_bit_for_bit(s_q, s_kv, h):
    """No atomics anywhere: two backwards on the same inputs give the same
    bits in dq, dk, dv and dgate (the split one pass and the two kernels)."""
    q, k, v, gate = _inputs(4, s_q, s_kv, h, seed=7)
    do = torch.randn_like(q)
    o, lse = gated_flash_forward_lse(q, k, v, gate)
    first = gated_flash_backward(q, k, v, gate, o, lse, do)
    second = gated_flash_backward(q, k, v, gate, o, lse, do)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("s_q,s_kv,route", [(64, 77, "one_pass"), (256, 256, "two_kernel")])
def test_cuda_autograd_function_runs_the_training_kernels(s_q, s_kv, route):
    """Under autograd the wrapper runs the lse forward and the backward
    kernels of the plan's route; under no_grad the lse-free forward."""
    q, k, v, gate = _inputs(2, s_q, s_kv, 5, seed=1)
    q.requires_grad_()
    gate.requires_grad_()
    assert backward_plan(2, 5, s_q, s_kv).route == route
    kinds = (gated_flash_attention, gated_flash_forward_lse, *BACKWARD_KERNELS.values())
    before = [f.launches for f in kinds]
    gated_flash_attention(q, k, v, gate).float().square().sum().backward()
    with torch.no_grad():
        gated_flash_attention(q, k, v, gate)
    torch.cuda.synchronize()
    want = [1, 1, 1, 0, 0, 0] if route == "one_pass" else [1, 1, 0, 0, 1, 1]
    assert [f.launches - n for f, n in zip(kinds, before)] == want
    assert q.grad is not None and gate.grad is not None and k.grad is None
    assert torch.isfinite(gate.grad).all()


# ---------------------------------------------------------------- fused norms

# per batch element ||kernel - reference|| / ||reference|| against the plain
# version in f32 on the same bf16 inputs: the kernels round y and the output
# to bf16 (about 2e-3 relative each); x-space padding, ungated statistics or a
# dropped tap read 3e-2 or more
NORM_REL_L2 = 1e-2


def per_sample_rel_l2(out, ref):
    dims = tuple(range(1, out.dim()))
    err = (out.float() - ref.float()).square().sum(dim=dims).sqrt()
    return err / ref.float().square().sum(dim=dims).sqrt().clamp_min(1e-30)


class _no_tf32:
    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def _norm_inputs(b, c, h, w, seed, groups=32):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(b, c, h, w, device="cuda", generator=g) * 1.5 + 0.5).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last)
    scale = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=g)
    bias = 0.1 * torch.randn(c, device="cuda", generator=g)
    gate = torch.rand(b, groups, device="cuda", generator=g)
    gate[0, 0] = 0.0  # one closed group
    gate_c = gate.repeat_interleave(c // groups, dim=1)
    return x, scale, bias, gate_c, g


# C/G = 10, 40 and 80 (vector widths 2, 8, 8); the last slab exceeds shared memory
@pytest.mark.parametrize("b,c,h,w", [(16, 320, 32, 32), (16, 1280, 16, 16), (16, 2560, 8, 8),
                                     (2, 960, 64, 64)])
@pytest.mark.parametrize("silu,eps", [(True, 1e-5), (False, 1e-6)])
def test_cuda_group_norm_kernel_matches_plain_version(b, c, h, w, silu, eps):
    x, scale, bias, gate_c, _ = _norm_inputs(b, c, h, w, seed=c + h)
    x = x * gate_c[:, :, None, None].bfloat16()  # a zero group: variance 0
    before = gn.group_norm_silu_forward.launches
    out = gn.group_norm_silu(x, scale, bias, 32, eps, silu)
    torch.cuda.synchronize()
    assert gn.group_norm_silu_forward.launches == before + 1
    assert out.shape == x.shape and out.is_contiguous(memory_format=torch.channels_last)
    ref = gn.group_norm_silu_plain(x.float(), scale, bias, 32, eps, silu)
    assert torch.isfinite(out).all()
    assert per_sample_rel_l2(out, ref).max().item() <= NORM_REL_L2
    want = bias[:10].bfloat16().float()
    want = (want * torch.sigmoid(want) if silu else want).bfloat16()
    torch.testing.assert_close(out[0, :10, 0, 0], want, rtol=2e-2, atol=1e-3)


# one shape per plan (`conv_plan`): the 32×32 maps unsplit, the 8×8 and 4×4
# maps split over K, the output head (C_out = 4, BN = 8, split), a ragged one;
# B = 64 is the stage-1 train step's batch: 65,536 pixels of 960 channels at the
# 32×32 map, eight images a block at the 4×4 map
@pytest.mark.parametrize("b,cin,cout,h,w", [(16, 320, 320, 32, 32), (16, 2560, 1280, 4, 4),
                                            (3, 320, 4, 32, 32), (2, 72, 24, 5, 7),
                                            (64, 960, 320, 32, 32), (64, 2560, 1280, 4, 4),
                                            (16, 1280, 1280, 8, 8), (16, 1280, 1280, 4, 4),
                                            (16, 320, 4, 32, 32)])
@pytest.mark.parametrize("gated", [False, True])
def test_cuda_norm_conv_kernel_matches_plain_version(b, cin, cout, h, w, gated):
    groups = 32 if cin % 32 == 0 else 8
    x, scale, bias, gate_c, g = _norm_inputs(b, cin, h, w, seed=cin + cout, groups=groups)
    weight = (torch.randn(cout, cin, 3, 3, device="cuda", generator=g) * (9 * cin) ** -0.5
              ).bfloat16()
    cbias = 0.1 * torch.randn(cout, device="cuda", generator=g)
    gate_c = gate_c if gated else None
    before = nc.norm_conv3x3.launches
    out = nc.group_norm_silu_conv3x3(x, scale, bias, weight, cbias, gate_c, groups, 1e-5, True,
                                     packed=nc.PackedWeight())
    torch.cuda.synchronize()
    assert nc.norm_conv3x3.launches == before + 1
    assert out.shape == (b, cout, h, w)
    assert out.is_contiguous(memory_format=torch.channels_last)
    with _no_tf32():
        a, bb = nc.affine_coeffs(x, scale, bias, groups, 1e-5, gate_c)
        ref = nc.norm_conv3x3_plain(x.float(), a, bb, nc.pack_conv_weight(weight, torch.float32),
                                    cbias, True)
        unfused = nc.norm_conv_unfused(x.float(), scale, bias, weight.float(), cbias, gate_c,
                                       groups, 1e-5, True)
    assert per_sample_rel_l2(out, ref).max().item() <= NORM_REL_L2
    assert per_sample_rel_l2(out, unfused).max().item() <= NORM_REL_L2
    if cin == cout:
        _identity_tap_case(x, gate_c, g)


def _ulp_reading(out, ref):
    """max |out − ref| / (2^-7·|ref| + 1e-6): <= 1 within one bf16 ulp."""
    return ((out.float() - ref.float()).abs() / (ref.float().abs() * 2.0 ** -7 + 1e-6)).max()


def _identity_tap_case(x, gate_c, g):
    """The activation alone: the centre tap the identity, the other taps and
    the bias 0, so out = bf16(act(a·x + b)); a and b put y over [−8, 8]
    (the gate, where there is one, folded into a). Within one bf16 ulp of the
    plain version per element, for SiLU and the identity; SiLU's tanh.approx
    form (tanh(y/2) rounded to 11 significant bits, about its documented
    error) reads above."""
    b, c = x.shape[:2]
    u = (torch.rand(x.shape, device="cuda", generator=g) * 2 - 1).bfloat16()
    u = u.contiguous(memory_format=torch.channels_last)
    packed = torch.zeros(c, 3, 3, c, device="cuda", dtype=torch.bfloat16)
    packed[:, 1, 1] = torch.eye(c, device="cuda", dtype=torch.bfloat16)
    zero = torch.zeros(c, device="cuda")
    a = torch.full((b, c), 8.0, device="cuda") if gate_c is None else 8.0 * gate_c
    shift = (torch.zeros(b, c, device="cuda") if gate_c is None
             else torch.rand(b, c, device="cuda", generator=g) * 2 - 1)
    for silu in (True, False):
        out = nc.norm_conv3x3(u, a, shift, packed, zero, silu)
        # the plain version's operand bf16(act(y)) is its output here, exactly
        assert _ulp_reading(out, nc.affine_act(u, a, shift, silu)).item() <= 1.0
    y = (a[:, :, None, None] * u.float() + shift[:, :, None, None]).bfloat16().float()
    fault = (y * (0.5 + 0.5 * torch.tanh(y / 2).half().float())).bfloat16()
    assert _ulp_reading(fault, nc.affine_act(u, a, shift, True)).item() > 1.0


@pytest.mark.parametrize("b,s,c", [(16, 1024, 320), (16, 16, 1280), (3, 100, 72),
                                   (64, 1024, 320), (64, 16, 1280)])
def test_cuda_norm_linear_kernel_matches_plain_version(b, s, c):
    groups = 32 if c % 32 == 0 else 8
    x, scale, bias, gate_c, g = _norm_inputs(b, c, s, 1, seed=s + c, groups=groups)
    x = x[:, :, :, 0].transpose(1, 2).contiguous()           # (B, S, C)
    weight = (torch.randn(c, c, device="cuda", generator=g) * c ** -0.5).bfloat16()
    lbias = 0.1 * torch.randn(c, device="cuda", generator=g)
    before = nc.norm_linear.launches
    out = nc.group_norm_linear(x, scale, bias, weight, lbias, gate_c, groups, 1e-6)
    torch.cuda.synchronize()
    assert nc.norm_linear.launches == before + 1 and out.shape == (b, s, c)
    with _no_tf32():
        a, bb = nc.affine_coeffs(x.transpose(1, 2), scale, bias, groups, 1e-6, gate_c)
        ref = nc.norm_linear_plain(x.float(), a, bb, weight.float(), lbias)
        unfused = nc.norm_linear_unfused(x.float(), scale, bias, weight.float(), lbias, gate_c,
                                         groups, 1e-6)
    assert per_sample_rel_l2(out, ref).max().item() <= NORM_REL_L2
    assert per_sample_rel_l2(out, unfused).max().item() <= NORM_REL_L2


def test_cuda_fused_norm_wrappers_reject_what_the_kernels_do_not_take():
    x, scale, bias, _, g = _norm_inputs(2, 64, 8, 8, seed=0)
    a = torch.ones(2, 64, device="cuda")
    packed = torch.zeros(16, 3, 3, 64, device="cuda", dtype=torch.bfloat16)
    cbias = torch.zeros(16, device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        gn.group_norm_silu_forward(x.float(), scale, bias, 32, 1e-5, True)
    with pytest.raises(ValueError, match="channels_last"):
        gn.group_norm_silu_forward(x.contiguous(), scale, bias, 32, 1e-5, True)
    with pytest.raises(ValueError, match="scale"):
        gn.group_norm_silu_forward(x, scale.bfloat16(), bias, 32, 1e-5, True)
    with pytest.raises(ValueError, match="scale"):
        gn.group_norm_silu_forward(x, scale.cpu(), bias, 32, 1e-5, True)
    with pytest.raises(TypeError, match="bfloat16"):
        nc.norm_conv3x3(x.float(), a, a, packed, cbias, True)
    with pytest.raises(ValueError, match="channels_last"):
        nc.norm_conv3x3(x.contiguous(), a, a, packed, cbias, True)
    with pytest.raises(TypeError, match="bfloat16"):
        nc.norm_conv3x3(x, a, a, packed.float(), cbias, True)
    with pytest.raises(ValueError, match="weight must be"):
        nc.norm_conv3x3(x, a, a, packed[:, :, :, :32].contiguous(), cbias, True)
    with pytest.raises(ValueError, match="float32"):
        nc.norm_conv3x3(x, a.bfloat16(), a, packed, cbias, True)
    # the TMA weight descriptor needs a 16-byte aligned base
    w_shifted = torch.zeros(packed.numel() + 1, device="cuda", dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        nc.norm_conv3x3(x, a, a, w_shifted.view(packed.shape), cbias, True)
    out = torch.empty(2, 16, 8, 8, device="cuda", dtype=torch.bfloat16,
                      memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="float32"):
        nc.conv_split_reduce(torch.zeros(2, 128, 16, device="cuda", dtype=torch.float64),
                             cbias, out)
    with pytest.raises(ValueError, match="does not hold"):
        nc.conv_split_reduce(torch.zeros(2, 100, 16, device="cuda"), cbias, out)
    x12 = x[:, :12].contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="C_in % 8"):
        nc.norm_conv3x3(x12, a[:, :12].contiguous(), a[:, :12].contiguous(),
                        packed[..., :12].contiguous(), cbias, True)
    tokens = x.flatten(2).transpose(1, 2)[:, ::2]            # (B, S, C), rows strided
    weight = torch.zeros(64, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        nc.norm_linear(tokens, a, a, weight, torch.zeros(64, device="cuda"))
    with pytest.raises(ValueError, match="on cpu"):
        nc.norm_linear(tokens.contiguous(), a, a, weight.cpu(), torch.zeros(64, device="cuda"))


def test_cuda_fused_norm_functions_backpropagate_through_the_unfused_composition():
    """Forward through the kernels, gradients for x and the gate from the
    recompute, equal to autograd of the unfused composition on the same
    inputs."""
    x, scale, bias, gate_c, g = _norm_inputs(2, 64, 8, 8, seed=3)
    weight = (torch.randn(32, 64, 3, 3, device="cuda", generator=g) / 24).bfloat16()
    cbias = torch.zeros(32, device="cuda")
    grads = []
    fused = functools.partial(nc.group_norm_silu_conv3x3, packed=nc.PackedWeight())
    for fn in (fused, nc.norm_conv_unfused):
        xr, gr = x.clone().requires_grad_(), gate_c.clone().requires_grad_()
        out = fn(xr, scale, bias, weight, cbias, gr, 32, 1e-5, True)
        out.float().square().sum().backward()
        grads.append((xr.grad, gr.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got.float(), want.float(), rtol=5e-2, atol=5e-2)
