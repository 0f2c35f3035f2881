"""The port's CUDA kernels against their plain versions, on a CUDA card: gated
flash attention (the forward, with and without lse, and the backward
kernels of both routes) and the fused-norm kernels (one-pass GroupNorm(+SiLU),
GroupNorm→SiLU→conv3x3, GroupNorm→linear), and every backward route and split
workspace run on memory poisoned with NaN. Imports only torch and the port,
so that it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Without a card every test here skips."""
import collections
import functools

import pytest
import torch

from diffusion_pruning_tpu_torch.ops.flash_attention import (
    backward_plan,
    forward_kernel,
    forward_launches,
    forward_plan,
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
# dgate per (batch, head) relative to the head's RMS f32 dgate over the
# batch, against the plain backward that rounds P and dS to bf16 before their
# products as the kernels do. Against the f32 plain backward a sound bf16
# backward itself crosses 5e-2 for about one output gradient in a hundred
# at some shapes, so that comparison cannot hold a fixed limit; against the
# rounded one the kernels read medians of 1e-6-1.8e-4 and at most 4.6e-3
# over 300 output gradients at each of this test's shapes on an H100
# (scripts/torch_port/dgate_spread_probe.py)
DGATE_BF16_REL = 1e-2


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


# `forward_plan`: S_q <= 64 with S_kv <= 80 runs gated_flash_fwd_small (kv
# tiles of 16, 64 and 80 rows), every other shape the 128-row wgmma kernel;
# S_kv = 77 (no tile's multiple) at B = 3, so that a TMA box past S_kv must
# stay inside its batch element; ragged S_q <= 64 at each tile's edge and
# past 80
@pytest.mark.parametrize("s_q,s_kv,h", [(1024, 1024, 5), (256, 77, 10), (16, 16, 20),
                                        (100, 77, 3), (4096, 4096, 1), (1024, 77, 5),
                                        (64, 77, 20), (4096, 77, 5), (64, 64, 20), (16, 77, 20),
                                        (1, 1, 3), (40, 16, 20), (63, 77, 3), (64, 80, 3),
                                        (40, 50, 20), (1, 77, 20), (64, 81, 3), (40, 200, 20)])
def test_cuda_kernel_matches_plain_version(s_q, s_kv, h):
    """The bf16 kernel against the plain version in f32 (TF32 off) on the
    same bf16 inputs."""
    b = 3 if s_kv == 77 else 2
    q, k, v, gate = _inputs(b, s_q, s_kv, h, seed=s_q + h)
    before = gated_flash_attention.launches
    kernel = forward_kernel(s_q, s_kv)
    before_kernel = forward_launches[kernel]
    out = gated_flash_attention(q, k, v, gate)
    torch.cuda.synchronize()
    assert gated_flash_attention.launches == before + 1
    assert forward_launches[kernel] == before_kernel + 1
    assert kernel == forward_plan(b, h, s_q, s_kv).kernel == (
        "gated_flash_fwd_small" if s_q <= 64 and s_kv <= 80 else "gated_flash_fwd_wgmma")
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
    versions in f32 on the same bf16 inputs (dgate against the one with the
    kernels' bf16 roundings, DGATE_BF16_REL); a closed head gets exactly 0
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
    dg_b = _f32_reference(functools.partial(gated_flash_backward_reference, bf16_products=True),
                          q, k, v, gate, o, lse, do)[3]
    rms = dg_r.square().mean(dim=0).sqrt()
    assert ((dgate - dg_b).abs() / rms).max().item() <= DGATE_BF16_REL
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


# C/G = 10, 40 and 80 (windows of 40, 40 and 80 channels, one block a slab or
# two); 960 at 64×64 is the 512px slab (245 KB) split over a cluster of
# eight, B = 64 the train step's batch; 960 at 128×128 is a slab no cluster
# holds (read three times), C/G = 300 one that no window of at most 256
# channels holds (read three times, 8-byte loads)
@pytest.mark.parametrize("b,c,h,w", [(16, 320, 32, 32), (16, 1280, 16, 16), (16, 2560, 8, 8),
                                     (2, 960, 64, 64), (4, 960, 64, 64), (64, 320, 32, 32),
                                     (1, 960, 128, 128), (2, 9600, 8, 8)])
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


# (64, 1280) and (16, 1280) at B = 16 split K (`linear_plan`); at S = 4 and
# B = 40 a block's rows span more batch elements than are staged, so the
# kernel reads a and b from global memory
@pytest.mark.parametrize("b,s,c", [(16, 1024, 320), (16, 16, 1280), (3, 100, 72),
                                   (64, 1024, 320), (64, 16, 1280), (16, 64, 1280),
                                   (4, 256, 1280), (40, 4, 64)])
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
    assert (nc.linear_plan(b, s, c, c).ab_rows == 0) == (b == 40)
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
    # C_in = 12 is zero-padded to 16 (the TMA row stride), the result unchanged
    x12 = x[:, :12].contiguous(memory_format=torch.channels_last)
    a12, p12 = a[:, :12].contiguous(), (0.1 * torch.randn(16, 3, 3, 12, device="cuda",
                                                          generator=g)).bfloat16()
    out12 = nc.norm_conv3x3(x12, a12, a12, p12, cbias, True)
    with _no_tf32():
        ref12 = nc.norm_conv3x3_plain(x12.float(), a12, a12, p12.float(), cbias, True)
    assert out12.shape == (2, 16, 8, 8)
    assert per_sample_rel_l2(out12, ref12).max().item() <= NORM_REL_L2
    tokens = x.flatten(2).transpose(1, 2)[:, ::2]            # (B, S, C), rows strided
    weight = torch.zeros(64, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        nc.norm_linear(tokens, a, a, weight, torch.zeros(64, device="cuda"))
    with pytest.raises(ValueError, match="on cpu"):
        nc.norm_linear(tokens.contiguous(), a, a, weight.cpu(), torch.zeros(64, device="cuda"))


# an expert's channel widths (C_in, groups): kept groups of C/32 ∈ {10, 20, 40}
# channels; 90, 310 and 620 are padded to a multiple of 8 on the card, 1240 is not
@pytest.mark.parametrize("c,groups", [(90, 9), (310, 31), (620, 31), (1240, 31)])
@pytest.mark.parametrize("side", [16, 8])
def test_cuda_fused_norm_ops_at_expert_channel_widths(c, groups, side):
    """The fused conv and linear ops at an expert's channel widths (C_out =
    C_in), B_eff 16, against their plain versions in f32 on the same bf16
    inputs, per batch element; one launch of each kernel (and the
    reduction where its plan splits K)."""
    x, scale, bias, gate_c, g = _norm_inputs(16, c, side, side, seed=c + side, groups=groups)
    weight = (torch.randn(c, c, 3, 3, device="cuda", generator=g) * (9 * c) ** -0.5).bfloat16()
    cbias = 0.1 * torch.randn(c, device="cuda", generator=g)
    lweight = (torch.randn(c, c, device="cuda", generator=g) * c ** -0.5).bfloat16()
    lbias = 0.1 * torch.randn(c, device="cuda", generator=g)
    tokens = x.flatten(2).transpose(1, 2).contiguous()
    before = (nc.norm_conv3x3.launches, nc.norm_linear.launches)
    conv = nc.group_norm_silu_conv3x3(x, scale, bias, weight, cbias, gate_c, groups, 1e-5, True,
                                      packed=nc.PackedWeight())
    linear = nc.group_norm_linear(tokens, scale, bias, lweight, lbias, gate_c, groups, 1e-6)
    torch.cuda.synchronize()
    assert (nc.norm_conv3x3.launches, nc.norm_linear.launches) == (before[0] + 1, before[1] + 1)
    with _no_tf32():
        a, bb = nc.affine_coeffs(x, scale, bias, groups, 1e-5, gate_c)
        conv_ref = nc.norm_conv3x3_plain(x.float(), a, bb, weight.float().permute(0, 2, 3, 1),
                                         cbias, True)
        a, bb = nc.affine_coeffs(tokens.transpose(1, 2), scale, bias, groups, 1e-6, gate_c)
        linear_ref = nc.norm_linear_plain(tokens.float(), a, bb, lweight.float(), lbias)
    assert conv.shape == conv_ref.shape and linear.shape == linear_ref.shape
    assert per_sample_rel_l2(conv, conv_ref).max().item() <= NORM_REL_L2
    assert per_sample_rel_l2(linear, linear_ref).max().item() <= NORM_REL_L2


# the GroupNorm of an expert's resnet norm2 (kept groups of C/32 ∈ {10, 20, 40}
# channels, an odd count): no window of whole groups makes a multiple of 8
# channels at C/G = 10 or 20, so one group a block, read with 4- or 8-byte loads
# from rows of 2·C bytes that are no multiple of 16 (`group_norm_plan`); 1240
# keeps 40-channel windows
@pytest.mark.parametrize("c,groups,side", [(90, 9, 32), (170, 17, 32), (310, 31, 32),
                                           (620, 31, 16), (1240, 31, 8)])
@pytest.mark.parametrize("b", [8, 16])
@pytest.mark.parametrize("silu,eps", [(True, 1e-5), (False, 1e-6)])
def test_cuda_group_norm_at_expert_channel_widths(c, groups, side, b, silu, eps):
    x, scale, bias, gate_c, _ = _norm_inputs(b, c, side, side, seed=c + b, groups=groups)
    x = x * gate_c[:, :, None, None].bfloat16()  # a zero group: variance 0
    before = gn.group_norm_silu_forward.launches
    out = gn.group_norm_silu(x, scale, bias, groups, eps, silu)
    torch.cuda.synchronize()
    assert gn.group_norm_silu_forward.launches == before + 1
    assert out.shape == x.shape and torch.isfinite(out).all()
    ref = gn.group_norm_silu_plain(x.float(), scale, bias, groups, eps, silu)
    assert per_sample_rel_l2(out, ref).max().item() <= NORM_REL_L2


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


# ---------------------------------------------------------------- uninitialised memory

def _poison_allocator():
    """Leave NaN in the caching allocator's free blocks: the cache is emptied,
    then tensors of every size from 512 B to 256 MB are filled with NaN and
    freed, so that the blocks the next allocations get hold NaN."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = [torch.full((n // 4,), float("nan"), device="cuda")
            for n in (2 ** k for k in range(9, 29)) for _ in range(2)]
    del held


def _nan_filled(alloc):
    """`alloc` (torch.empty or torch.empty_like) whose floating tensors come
    back filled with NaN: what an uninitialised buffer may hold."""
    def empty(*args, **kwargs):
        t = alloc(*args, **kwargs)
        return t.fill_(float("nan")) if t.is_floating_point() else t
    return empty


def _bwd_route(s_q, s_kv, h):
    q, k, v, gate = _inputs(4, s_q, s_kv, h, seed=11)
    do = torch.randn_like(q)
    o, lse = gated_flash_forward_lse(q, k, v, gate)
    return lambda: gated_flash_backward(q, k, v, gate, o, lse, do)


def _fwd_route(s_q, s_kv, h):
    q, k, v, gate = _inputs(16, s_q, s_kv, h, seed=12)
    assert forward_plan(16, h, s_q, s_kv).kernel == "gated_flash_fwd_small"
    return lambda: gated_flash_forward_lse(q, k, v, gate)


def _conv_route(b, cin, cout, side):
    x, scale, bias, gate_c, g = _norm_inputs(b, cin, side, side, seed=5)
    weight = (torch.randn(cout, cin, 3, 3, device="cuda", generator=g) * (9 * cin) ** -0.5
              ).bfloat16()
    cbias = 0.1 * torch.randn(cout, device="cuda", generator=g)
    packed = nc.pack_conv_weight(weight, torch.bfloat16)
    a, bb = nc.affine_coeffs(x, scale, bias, 32, 1e-5, gate_c)
    assert nc.conv_plan(b, side, side, cin, cout).split > 1
    return lambda: (nc.norm_conv3x3(x, a, bb, packed, cbias, True),)


def _linear_route(b, s, c):
    x, scale, bias, gate_c, g = _norm_inputs(b, c, s, 1, seed=6)
    x = x[:, :, :, 0].transpose(1, 2).contiguous()
    weight = (torch.randn(c, c, device="cuda", generator=g) * c ** -0.5).bfloat16()
    lbias = 0.1 * torch.randn(c, device="cuda", generator=g)
    a, bb = nc.affine_coeffs(x.transpose(1, 2), scale, bias, 32, 1e-6, gate_c)
    assert nc.linear_plan(b, s, c, c).split > 1
    return lambda: (nc.norm_linear(x, a, bb, weight, lbias),)


# the S_q <= 64 forward with lse (kv tiles of 80, 16 and 64 rows), every
# route of `backward_plan` (one pass at S_q > 64 unsplit and split, at
# S_q <= 64; dq then dk/dv, with padded row stats at S_q = 200) and the split
# workspaces of the conv and the linear
POISON_ROUTES = {
    "fwd_small_q_lse_64_77": (_fwd_route, (64, 77, 20)),
    "fwd_small_q_lse_16_16": (_fwd_route, (16, 16, 20)),
    "fwd_small_q_lse_40_50": (_fwd_route, (40, 50, 3)),
    "bwd_one_pass": (_bwd_route, (256, 77, 20)),
    "bwd_one_pass_split": (_bwd_route, (1024, 77, 5)),
    "bwd_one_pass_small_q": (_bwd_route, (64, 77, 20)),
    "bwd_one_pass_16": (_bwd_route, (16, 16, 20)),
    "bwd_two_kernel": (_bwd_route, (256, 256, 10)),
    "bwd_two_kernel_padded_stats": (_bwd_route, (200, 200, 3)),
    "conv_split_workspace": (_conv_route, (16, 1280, 1280, 4)),
    "linear_split_workspace_64": (_linear_route, (16, 64, 1280)),
    "linear_split_workspace_16": (_linear_route, (16, 16, 1280)),
}


@pytest.mark.parametrize("route", sorted(POISON_ROUTES))
def test_cuda_kernels_write_every_element_they_read_back(monkeypatch, route):
    """With NaN left in the allocator's free blocks and in every buffer the
    wrappers allocate, each route gives finite outputs, and a second run (on
    fresh poison) the same bits: no output, partial, row-stats or workspace
    element is read before it is written."""
    make, args = POISON_ROUTES[route]
    if make is _bwd_route:
        s_q, s_kv, h = args
        plan = backward_plan(4, h, s_q, s_kv)
        assert plan.route == ("one_pass" if "one_pass" in route else "two_kernel")
        assert (plan.chunks > 1) == route.endswith("split")
        if route.endswith("padded_stats"):
            assert plan.s_q_pad > s_q
    run = make(*args)
    monkeypatch.setattr(torch, "empty", _nan_filled(torch.empty))
    monkeypatch.setattr(torch, "empty_like", _nan_filled(torch.empty_like))
    results = []
    for _ in range(2):
        _poison_allocator()
        results.append([t.clone() for t in run() if t is not None])
        torch.cuda.synchronize()
    for first, second in zip(*results):
        assert torch.isfinite(first).all()
        assert torch.equal(first, second)


# ---------------------------------------------------------------- stage 1 as a program

def _attention_sites_of_wide_tiny():
    """(s_q, s_kv, heads) of every attention site of the tiny U-Net widened to
    64-wide heads, at the prune entry point's 32×32 latents (64px through
    the tiny VAE's 2× downsampling): five transformers at 32×32 with one
    head, the mid block's at 16×16 with two."""
    return [(1024, 1024, 1)] * 5 + [(1024, 77, 1)] * 5 + [(256, 256, 2), (256, 77, 2)]


def test_cuda_prune_cli_runs_two_steps_through_the_attention_kernels(tmp_path, monkeypatch):
    """The prune entry point on the card, configs/pruning/tiny_smoke.yaml cut
    to 2 steps (one pretraining), B = 2, synthetic data. The tiny U-Net's
    heads are 16 wide and the kernels take 64, so the factory's U-Net config
    is widened to (64, 128) channels with 1 and 2 heads. Every step runs the
    kernels: 12 forwards with lse (the student), 12 without (the teacher) and
    the backward kernels `backward_plan` picks at each site; finite losses
    and a checkpoint."""
    import functools
    import json
    import math
    import os

    from diffusion_pruning_tpu_torch.cli import prune
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    from diffusion_pruning_tpu_torch.training import factory
    from diffusion_pruning_tpu_torch.training import loop as loop_module
    from diffusion_pruning_tpu_torch.training.loop import LoopConfig
    from diffusion_pruning_tpu_torch.utils.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs", "pruning", "tiny_smoke.yaml"))
    for key, value in (("training.max_train_steps", 2), ("training.hypernet_pretraining_steps", 1),
                       ("training.logging.logging_dir", str(tmp_path / "runs")),
                       ("training.logging.export_unet", False)):
        cfg.set_path(key, value)
    cfg.dump(str(tmp_path / "tiny.yaml"))
    wide = UNetConfig.tiny(block_out_channels=(64, 128), attention_head_dim=(1, 2),
                           use_flash_attention=True)
    monkeypatch.setattr(factory, "unet_config_from_yaml", lambda c, tiny=False: wide)
    monkeypatch.setattr(loop_module, "LoopConfig", functools.partial(LoopConfig, log_every=1))
    wrappers = (gated_flash_attention, gated_flash_forward_lse, gated_flash_bwd_fused,
                gated_flash_bwd_reduce, gated_flash_bwd_dq, gated_flash_bwd_dkv)
    for w in wrappers:
        w.launches = 0
    loop = prune.main(["--base_config_path", str(tmp_path / "tiny.yaml"),
                       "--pretrained_model_name_or_path", "", "--wandb_run_name", "r"])
    want = {"gated_flash_attention": 12, "gated_flash_forward_lse": 12}
    for s_q, s_kv, h in _attention_sites_of_wide_tiny():
        for name, n in backward_plan(2, h, s_q, s_kv).launches.items():
            want[name] = want.get(name, 0) + n
    got = {w.__name__: w.launches for w in wrappers}
    assert got == {name: 2 * want.get(name, 0) for name in got}
    assert loop.global_step == 2 and loop.ckpt.list_steps() == [2]
    with open(os.path.join(loop.run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [m["step"] for m in lines] == [1, 2]
    assert all(math.isfinite(m["loss"]) and not m["skipped"] for m in lines)


def test_cuda_safetensors_round_trip(tmp_path):
    """CUDA tensors (bf16, strided) written by the export come back from
    `load_torch_state_dict` equal, in f32, on the host."""
    from diffusion_pruning_tpu_torch.utils import export
    g = torch.Generator(device="cuda").manual_seed(0)
    tensors = {"f32": torch.randn(5, 3, device="cuda", generator=g),
               "bf16": torch.randn(4, 64, device="cuda", generator=g).bfloat16(),
               "strided": torch.randn(6, 4, device="cuda", generator=g).t()}
    export._save(str(tmp_path), "X", {}, tensors)
    back = export.load_torch_state_dict(str(tmp_path))
    for k, v in tensors.items():
        assert back[k].device.type == "cpu" and back[k].dtype == torch.float32
        assert torch.equal(back[k], v.float().cpu()), k


# ---------------------------------------------------------------- stage 2

def _finetune_modules(fused_norm_conv=False, seed=0):
    """A fine-tuning world on the card: the tiny U-Net widened to 64-wide
    heads (channels (64, 128), 1 and 2 heads) with seeded random weights, its
    expert (the first half of the width units closed, each site's first unit
    open) as a student that owns its tensors, the teacher, VAE and text
    encoder in bf16."""
    from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    from diffusion_pruning_tpu_torch.models.unet.pruned import make_expert_plan
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from diffusion_pruning_tpu_torch.schedulers import DiffusionSchedule
    from diffusion_pruning_tpu_torch.training.factory import build_student
    from diffusion_pruning_tpu_torch.training.finetuner import FineTunerModules
    from diffusion_pruning_tpu_torch.utils.init_utils import random_init_

    cfg = UNetConfig.tiny(block_out_channels=(64, 128), attention_head_dim=(1, 2),
                          use_flash_attention=True, fused_norm_conv=fused_norm_conv)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.device("cuda"):
        dense, vae, text = GatedUNet(cfg), AutoencoderKL(VAEConfig.tiny()), CLIPTextEncoder(
            CLIPTextConfig.tiny())
    for module in (dense, vae, text):
        random_init_(module, gen)
    spec = dense.spec
    arch = torch.ones(spec.vq_dim)
    arch[: spec.num_width // 2] = 0.0
    for sb in spec.subblocks:
        for site in sb.sites:
            arch[site.start] = 1.0
    student = build_student(dense, make_expert_plan(spec, arch))
    return FineTunerModules(student=student, teacher=dense.to(torch.bfloat16).eval(),
                            vae=vae.to(torch.bfloat16).eval(),
                            text_encoder=text.to(torch.bfloat16).eval(),
                            schedule=DiffusionSchedule())


def _bf16_copy_optimizer(cfg, student, global_batch=2):
    """f32 masters taken from the student, then the student cast to its bf16
    compute copy, as the finetune entry point does."""
    from diffusion_pruning_tpu_torch.training import finetuner as ft
    masters = ft.MasterWeights(student, separate=True)
    student.to(torch.bfloat16)
    return ft.make_finetune_optimizer(cfg, masters, global_batch)


def _finetune_batch(b=2, seed=1):
    """64px pixels: 32×32 latents through the tiny VAE, so the student's
    attention runs at 1024 and 256 tokens (both backward routes)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {"pixel_values": torch.rand(b, 64, 64, 3, device="cuda", generator=g) * 2 - 1,
            "input_ids": torch.randint(0, 128, (b, 77), device="cuda", generator=g)}


def _student_grads(mods, cfg, batch, draws):
    from diffusion_pruning_tpu_torch.training.finetuner import compute_losses
    for p in mods.student.parameters():
        p.grad = None
    compute_losses(mods, cfg, batch, draws)[0].backward()
    grads = {n: p.grad.float().clone() for n, p in mods.student.named_parameters()}
    for p in mods.student.parameters():
        p.grad = None
    return grads


def test_cuda_finetune_step_through_the_kernels(monkeypatch):
    """One fine-tune step of the narrow expert on the card, bf16 compute copy
    of f32 masters: the student's gradients through the training kernels (the
    lse forward and `backward_plan`'s kernels, no gate) against plain
    attention under autograd, cosine per leaf > 0.999 (as chip_smoke's
    GRAD_COS); then a step: the teacher's weights unchanged bit for bit, the
    copy the masters rounded to bf16."""
    from diffusion_pruning_tpu_torch.models.unet import attention
    from diffusion_pruning_tpu_torch.training import finetuner as ft

    mods = _finetune_modules()
    cfg = ft.FineTuneConfig(lr_warmup_steps=0)
    opt = _bf16_copy_optimizer(cfg, mods.student)
    batch = _finetune_batch()
    draws = ft.complete_draws(mods, cfg, batch, None,
                              torch.Generator(device="cuda").manual_seed(2))
    wrappers = (gated_flash_forward_lse, gated_flash_bwd_fused, gated_flash_bwd_reduce,
                gated_flash_bwd_dq, gated_flash_bwd_dkv)
    for w in wrappers:
        w.launches = 0
    kernel = _student_grads(mods, cfg, batch, draws)
    got = {w.__name__: w.launches for w in wrappers}
    assert got["gated_flash_forward_lse"] > 0 and got["gated_flash_bwd_dq"] > 0
    assert got["gated_flash_bwd_fused"] > 0
    monkeypatch.setattr(attention, "gated_flash_attention", gated_attention_reference)
    plain = _student_grads(mods, cfg, batch, draws)
    monkeypatch.undo()
    for name, w in plain.items():
        if w.norm() > 0:
            cos = float(torch.dot(kernel[name].flatten(), w.flatten())
                        / (kernel[name].norm() * w.norm()))
            assert cos > 0.999, (name, cos)
    teacher = {k: v.clone() for k, v in mods.teacher.state_dict().items()}
    metrics = ft.make_finetune_step(mods, cfg, opt)(batch, draws)
    assert not metrics["skipped"] and torch.isfinite(metrics["loss"])
    for k, v in mods.teacher.state_dict().items():
        assert torch.equal(v, teacher[k]), k
    masters = opt.masters
    assert all(m.dtype == torch.float32 and c.dtype == torch.bfloat16
               and torch.equal(c.detach(), m.bfloat16())
               for m, c in zip(masters.masters, masters.copies))


def test_cuda_fused_norm_conv_student_follows_its_updates():
    """Two steps of the narrow expert under `fused_norm_conv` and unfused,
    from the same weights with the same draws: the fused student's output
    then equals, bit for bit, that of a fresh fused student built from its
    current weights (its packed conv weights followed both refreshes of the
    bf16 copy), and lies within 2e-2 relative L2 of the unfused student's (as
    chip_smoke's FUSED_UNET_REL_L2)."""
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    from diffusion_pruning_tpu_torch.ops import norm_conv as nc
    from diffusion_pruning_tpu_torch.training import finetuner as ft

    cfg = ft.FineTuneConfig(lr_warmup_steps=0, unet_lr=1e-3)
    batch = _finetune_batch()
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(2, 32, 32, 4, device="cuda", generator=g)
    ehs = torch.randn(2, 77, 32, device="cuda", generator=g)
    t = torch.tensor([10, 700], device="cuda")
    outs = {}
    for fused in (False, True):
        mods = _finetune_modules(fused_norm_conv=fused)
        opt = _bf16_copy_optimizer(cfg, mods.student)
        step = ft.make_finetune_step(mods, cfg, opt)
        gen = torch.Generator(device="cuda").manual_seed(4)
        nc.norm_conv3x3.launches = 0
        for _ in range(2):
            assert not step(batch, generator=gen)["skipped"]
            with torch.no_grad():
                out = mods.student(x, t, ehs).float()
        assert (nc.norm_conv3x3.launches > 0) == fused
        outs[fused] = out
        if fused:
            with torch.device("meta"):
                fresh = GatedUNet(mods.student.cfg, plan=mods.student.plan)
            fresh.load_state_dict({k: v.clone() for k, v in mods.student.state_dict().items()},
                                  assign=True)
            with torch.no_grad():
                assert torch.equal(out, fresh(x, t, ehs).float())
    rel = float((outs[True] - outs[False]).norm() / outs[False].norm())
    assert rel <= 2e-2, rel


def test_cuda_captured_serving_equals_eager_bit_for_bit():
    """`ExpertServer.warmup` captures one CUDA graph per (expert, tier) and
    per gated tier of a narrow U-Net with heads of 64; the images, routes and
    kernel launches served through the graphs equal the eager server's, each
    program replays as often as the tier plans run it (so no tier falls back
    to the eager loop), and a CPU tensor is refused by `aot.capture`."""
    import numpy as np

    from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
    from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
    from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from diffusion_pruning_tpu_torch.pipelines import PruningPipeline, aot
    from diffusion_pruning_tpu_torch.pipelines.expert_server import ExpertServer
    from diffusion_pruning_tpu_torch.utils.init_utils import random_init_

    cfg = UNetConfig.tiny(block_out_channels=(64, 128), attention_head_dim=(1, 2),
                          use_flash_attention=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.device("cuda"):
        unet, vae = GatedUNet(cfg), AutoencoderKL(VAEConfig.tiny())
        text = CLIPTextEncoder(CLIPTextConfig.tiny())
        hypernet = HyperStructure(unet.spec, input_dim=32)
        quantizer = StructureQuantizer(unet.spec, n_e=3, base=0.0)
    for module in (unet, vae, text, hypernet):
        random_init_(module, gen)
    quantizer.init_params(gen)
    quantizer.init_state()
    spec = unet.spec
    rng = np.random.default_rng(21)
    codes = (rng.random((3, spec.vq_dim)) < 0.6).astype(np.float32)
    codes[:, spec.num_width:] = 1.0
    with torch.no_grad():
        quantizer.embedding_gs.copy_(torch.from_numpy(np.where(codes >= 0.5, 0.8, 0.2)))
    pipe = PruningPipeline(unet.to(torch.bfloat16), vae, text, hypernet, quantizer)
    eager = ExpertServer.from_codebook(pipe, spec, cfg, batch_size=2, param_dtype=torch.bfloat16)
    graph = ExpertServer.from_codebook(pipe, spec, cfg, batch_size=2, param_dtype=torch.bfloat16)
    ids = torch.randint(0, 128, (5, 77), device="cuda", generator=gen)
    noise = torch.randn(5, spec.vq_dim, device="cuda", generator=gen) * 3
    latents = torch.randn(5, 8, 8, 4, device="cuda", generator=gen)
    neg = torch.zeros(1, 77, dtype=torch.long, device="cuda")

    def served(server, hybrid):
        before = aot.launch_counts()
        images, idx = server.generate(ids, neg, num_inference_steps=3, hybrid=hybrid,
                                      route_noise=noise, latents=latents)
        return images, idx, {k: v - before[k] for k, v in aot.launch_counts().items()}

    def tier_replays(indices, hybrid):
        """{(owner, tier): replays} that serving `indices` runs: each expert's
        tier plan (under hybrid its full largest tiers) and under hybrid the
        pooled remainders' plan through the gated U-Net."""
        counts = np.bincount(indices.numpy(), minlength=3)
        size, plan = graph.batch_size, graph.plan_batches
        full = [n // size * size if hybrid else n for n in counts]
        want = collections.Counter((str(e), t) for e, n in enumerate(full)
                                   for t, _ in plan(n, graph.batch_shapes))
        if hybrid:
            want.update(("pooled", t) for t, _ in plan(int(sum(counts % size)),
                                                        graph.batch_shapes))
        return dict(want)

    want = {h: served(eager, h) for h in (False, True)}
    assert graph.warmup(3, 7.5, hybrid=True) == {"loaded": 0, "built": 4 * 2}
    caches = {**{str(e): c for e, c in graph._expert_caches.items()},
              "pooled": pipe._denoise_cache}
    programs = {(owner, t): p for owner, c in caches.items() for d in c.values()
                if isinstance(d, aot.ShapeDispatch) for t, p in zip(graph.batch_shapes, d.programs)}
    assert all(isinstance(p, aot.CapturedProgram) for p in programs.values())
    assert len(programs) == 8
    for hybrid in (False, True):
        played = {k: p.replays for k, p in programs.items()}
        got = served(graph, hybrid)
        assert torch.equal(got[1], want[hybrid][1])
        assert torch.equal(got[0], want[hybrid][0]), float((got[0] - want[hybrid][0]).abs().max())
        assert got[2] == want[hybrid][2]
        ran = {k: p.replays - played[k] for k, p in programs.items() if p.replays != played[k]}
        assert ran == tier_replays(got[1], hybrid)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        aot.capture(lambda x: x + 1, (torch.zeros(2),))


# ---------------------------------------------------------------- spans and host syncs

def _wide_tiny_modules(seed=0):
    """The tiny models with the U-Net widened to heads of 64 (the kernels'
    head size) in bf16, on the card, and a codebook snapshot of 3 codes."""
    import numpy as np

    from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
    from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
    from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from diffusion_pruning_tpu_torch.utils.init_utils import random_init_

    cfg = UNetConfig.tiny(block_out_channels=(64, 128), attention_head_dim=(1, 2),
                          use_flash_attention=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.device("cuda"):
        unet, vae = GatedUNet(cfg), AutoencoderKL(VAEConfig.tiny())
        text = CLIPTextEncoder(CLIPTextConfig.tiny())
        hypernet = HyperStructure(unet.spec, input_dim=32)
        quantizer = StructureQuantizer(unet.spec, n_e=3, base=0.0)
    for module in (unet, vae, text, hypernet):
        random_init_(module, gen)
    quantizer.init_params(gen)
    quantizer.init_state()
    codes = (np.random.default_rng(21).random((3, unet.spec.vq_dim)) < 0.6).astype(np.float32)
    codes[:, unet.spec.num_width:] = 1.0
    with torch.no_grad():
        quantizer.embedding_gs.copy_(torch.from_numpy(np.where(codes >= 0.5, 0.8, 0.2)))
    return cfg, unet.to(torch.bfloat16), vae, text, hypernet, quantizer, gen


def test_cuda_stage1_step_synchronises_exactly_host_syncs_times():
    """Under `torch.cuda.set_sync_debug_mode("warn")` one stage-1 step
    through the kernels (with `max_grad_norm`, so the clip tests run) warns
    of exactly as many synchronising operations as `step.host_syncs` counts:
    every host sync of the step is a counted `host_sync`."""
    import warnings

    from diffusion_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule
    from diffusion_pruning_tpu_torch.training.pruner import (
        PrunerConfig, PrunerModules, complete_draws, make_optimizer, make_pruner_step)

    _, unet, vae, text, hypernet, quantizer, gen = _wide_tiny_modules()
    mods = PrunerModules(unet, vae, text, hypernet, quantizer, DiffusionSchedule())
    cfg = PrunerConfig(max_grad_norm=1e-3)
    step = make_pruner_step(mods, cfg, make_optimizer(cfg, mods, 2))
    batch = {"input_ids": torch.randint(0, 128, (2, 77), device="cuda", generator=gen),
             "mpnet_embeddings": torch.randn(2, 32, device="cuda", generator=gen),
             "pixel_values": torch.rand(2, 16, 16, 3, device="cuda", generator=gen) * 2 - 1}
    step(batch, generator=gen)   # builds the kernels and the optimizer's state
    draws = complete_draws(mods, cfg, batch, None, gen)
    torch.cuda.synchronize()
    before = step.host_syncs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            metrics, _ = step(batch, draws)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    assert not metrics["skipped"]
    assert len(syncs) == step.host_syncs - before == 3 + 1 + 2, [str(w.message) for w in syncs]


def test_cuda_served_flush_records_device_time_and_every_dispatch_hits():
    """A warmed server's flush records device milliseconds for each tier's
    `denoise` and `decode` (CUDA events read when the recording stops), and
    every tier ran its prepared program: the dispatch tables count one hit a
    tier and no miss."""
    from diffusion_pruning_tpu_torch.pipelines import PruningPipeline, aot
    from diffusion_pruning_tpu_torch.pipelines.expert_server import ExpertServer, ServingQueue
    from diffusion_pruning_tpu_torch.utils import profiling

    cfg, unet, vae, text, hypernet, quantizer, gen = _wide_tiny_modules(seed=1)
    pipe = PruningPipeline(unet, vae, text, hypernet, quantizer)
    server = ExpertServer.from_codebook(pipe, unet.spec, cfg, batch_size=2,
                                        param_dtype=torch.bfloat16)
    server.warmup(3, 7.5)
    tables = [d for c in server._expert_caches.values() for d in c.values()
              if isinstance(d, aot.ShapeDispatch)]
    queue = ServingQueue(server, num_inference_steps=3)
    neg = torch.zeros(1, 77, dtype=torch.long, device="cuda")
    for _ in range(5):
        queue.submit(torch.randint(0, 128, (1, 77), device="cuda", generator=gen), neg,
                     route_noise=torch.randn(1, unet.spec.vq_dim, device="cuda",
                                             generator=gen) * 3,
                     latents=torch.randn(1, 8, 8, 4, device="cuda", generator=gen))
    hits, misses = sum(d.hits for d in tables), sum(d.misses for d in tables)
    profiling.start()
    try:
        images = queue.flush()
    finally:
        spans = profiling.stop()
    assert len(images) == 5
    tiers = [s for s in spans if s.name == "tier"]
    timed = [s for s in spans if s.name in ("denoise", "decode")]
    assert tiers and len(timed) == 2 * len(tiers)
    assert all(s.device_ms is not None and s.device_ms > 0 for s in timed), timed
    assert sum(d.hits for d in tables) - hits == len(tiers)
    assert sum(d.misses for d in tables) == misses == 0
