"""The conv kernel's plan (`conv_plan` in the port's ops/norm_conv.py), held on
the CPU: which patch shape, output-channel tile and split over K the
Hopper kernel `norm_conv3x3` runs each shape of the SD-2.1 U-Net with, and
that a split plan computes the same function as the unsplit conv.

Pure torch on the CPU; no card, no JAX."""
import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusion_pruning_tpu_torch.ops import norm_conv as nc

# (map side at 256px, C_in, C_out) of every conv3x3 site of the SD-2.1 U-Net's
# resnets and output head; at 512px every map side doubles
SD21_CONVS_256 = (
    (32, 320, 320), (32, 640, 320), (32, 960, 320), (32, 320, 4),
    (16, 320, 640), (16, 640, 640), (16, 960, 640), (16, 1280, 640), (16, 1920, 640),
    (8, 640, 1280), (8, 1280, 1280), (8, 1920, 1280), (8, 2560, 1280),
    (4, 1280, 1280), (4, 2560, 1280),
)
# the tiny U-Net of the parity tests (channels 32/64, 8 groups, 8×8 latents)
TINY_CONVS = ((8, 32, 32), (8, 64, 32), (8, 96, 32), (8, 32, 4), (4, 32, 64), (4, 64, 64),
              (4, 128, 64), (4, 96, 64))
CASES = [(res, b) for res in (256, 512) for b in (4, 16, 64)]


def _shapes(res):
    scale = res // 256
    return [(side * scale, cin, cout) for side, cin, cout in SD21_CONVS_256]


@pytest.mark.parametrize("res,b", CASES)
def test_conv_plan_slices_cover_every_channel_chunk_once(res, b):
    for side, cin, cout in _shapes(res):
        plan = nc.conv_plan(b, side, side, cin, cout)
        assert 1 <= plan.split <= plan.chunks == math.ceil(cin / nc.CONV_CHUNK)
        chunks = []
        for lo, hi in plan.slices:
            assert lo < hi and lo % nc.CONV_CHUNK == 0
            chunks += list(range(lo // nc.CONV_CHUNK, math.ceil(hi / nc.CONV_CHUNK)))
        assert chunks == list(range(plan.chunks)), (side, cin, cout, plan)
        assert plan.slices[-1][1] == cin


@pytest.mark.parametrize("res,b", CASES)
def test_conv_plan_fills_the_card_at_the_small_maps(res, b):
    """At the 8×8 and 4×4 maps the grid keeps at least 3/4 of the 132 SMs
    busy; a split grid fits in one wave (one block a SM), and a grid that
    half-fills the card alone is not split."""
    for side, cin, cout in _shapes(res):
        plan = nc.conv_plan(b, side, side, cin, cout)
        base = plan.m_tiles * plan.n_tiles
        assert plan.blocks == base * plan.split
        assert plan.m_tiles * nc.CONV_BLOCK_PIXELS >= b * side * side
        assert plan.n_tiles * plan.bn >= cout
        if side <= 8:
            assert plan.blocks >= 0.75 * nc.SM_COUNT, (side, cin, cout, plan)
        if plan.split > 1:
            assert plan.blocks <= nc.SM_COUNT
        if 2 * base > nc.SM_COUNT:
            assert plan.split == 1
        assert plan.bn == (8 if cout <= 8 else 160)


@pytest.mark.parametrize("res,b", CASES)
def test_conv_workspace_is_what_the_plan_states(res, b):
    for side, cin, cout in _shapes(res):
        plan = nc.conv_plan(b, side, side, cin, cout)
        ws = nc.conv_workspace(plan, torch.device("meta"))
        if plan.split == 1:
            assert ws is None and plan.workspace_bytes == 0
        else:
            assert ws.dtype == torch.float32
            assert tuple(ws.shape) == (plan.split, b * side * side, cout)
            assert ws.numel() * 4 == plan.workspace_bytes


def test_conv_workspace_at_the_train_steps_largest_site():
    """B = 64, 4×4, 2560→1280: S × 1024 × 1280 × 4 bytes."""
    plan = nc.conv_plan(64, 4, 4, 2560, 1280)
    assert plan.split > 1
    assert plan.workspace_bytes == plan.split * 1024 * 1280 * 4


def _operands(b, cin, cout, side, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, cin, side, side), dtype=np.float32))
    a = torch.from_numpy(1.0 + 0.2 * rng.standard_normal((b, cin), dtype=np.float32))
    sh = torch.from_numpy(0.3 * rng.standard_normal((b, cin), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((cout, 3, 3, cin), dtype=np.float32)
                         * (9 * cin) ** -0.5)
    bias = torch.from_numpy(0.1 * rng.standard_normal(cout, dtype=np.float32))
    return x, a, sh, w, bias


@pytest.mark.parametrize("b,cin,cout,side", [(2, 2560, 1280, 4)] + [(3,) + (c, o, s)
                                                                    for s, c, o in TINY_CONVS])
def test_sum_of_the_plans_slices_is_the_conv(b, cin, cout, side):
    """Plain f32 convs over the plan's channel slices, added in slice order
    with the bias by the reduction's plain version, equal the unsplit plain
    conv within 1e-5."""
    x, a, sh, w, bias = _operands(b, cin, cout, side, seed=cin + cout + side)
    plan = nc.conv_plan(b, side, side, cin, cout)
    if plan.split == 1:  # the tiny shapes run unsplit at this batch: cut every chunk apart
        plan = dataclasses.replace(plan, split=plan.chunks)
    y = nc.affine_act(x, a, sh, True)
    parts = [F.conv2d(y[:, lo:hi], w[..., lo:hi].permute(0, 3, 1, 2), padding=1)
             for lo, hi in plan.slices]
    ws = torch.stack([p.permute(0, 2, 3, 1).reshape(-1, cout) for p in parts])
    out = torch.empty(b, cout, side, side).contiguous(memory_format=torch.channels_last)
    nc.conv_split_reduce(ws, bias, out)
    want = F.conv2d(y, w.permute(0, 3, 1, 2), bias, padding=1)
    assert len(parts) == plan.split
    scale = want.abs().max().item()
    assert (out - want).abs().max().item() <= 1e-5 * scale
    packed_ref = nc.norm_conv3x3_plain(x, a, sh, w, bias, True)
    assert (out - packed_ref).abs().max().item() <= 1e-5 * scale
