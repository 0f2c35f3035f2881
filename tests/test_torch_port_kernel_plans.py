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


# ---------------------------------------------------------------- the attention backward's plan

from diffusion_pruning_tpu_torch.ops import flash_attention as fa  # noqa: E402

# (S_q, S_kv, heads) of every attention site of the SD-2.1 U-Net at 256px
# (5 sites each but the 16-token block's 1), at 512px, and ragged ones at
# the edges of the one-pass kv tile (80) and the dk/dv kernel's 128 rows
SITES_256 = ((1024, 1024, 5), (1024, 77, 5), (256, 256, 10), (256, 77, 10), (64, 64, 20),
             (64, 77, 20), (16, 16, 20), (16, 77, 20))
SITES_512 = ((4096, 4096, 5), (4096, 77, 5), (1024, 1024, 10), (1024, 77, 10), (256, 256, 20),
             (256, 77, 20), (64, 64, 20), (64, 77, 20))
RAGGED = ((200, 200, 3), (100, 77, 3), (100, 80, 3), (100, 81, 3), (100, 128, 3),
          (100, 129, 3), (1, 1, 1), (129, 77, 7))
BACKWARD_CASES = ([(64, *s) for s in SITES_256] + [(b, *s) for b in (4, 16) for s in SITES_512]
                  + [(b, *s) for b in (1, 4, 64) for s in RAGGED])


def _walk(blocks, items):
    """(block, item) of a persistent grid: block blk walks blk, blk + blocks, …"""
    for blk in range(blocks):
        for w in range(blk, items, blocks):
            yield blk, w


def _dq_writes(plan):
    """(kernel, block, b·h, first row, end row) of every run of dq rows a
    block writes, by the kernels' index arithmetic (gated_flash_bwd.cu)."""
    if plan.route == "one_pass":
        for blk, w in _walk(plan.blocks, plan.items):
            bh, ch = divmod(w, plan.chunks)
            t0, t1 = plan.slice_tiles(ch)
            yield ("gated_flash_bwd_fused", blk, bh, t0 * fa.BWD_Q_ROWS,
                   min(t1 * fa.BWD_Q_ROWS, plan.s_q))
        return
    for blk, w in _walk(plan.dq_blocks, plan.b * plan.h * plan.q_tiles):
        bh, t = divmod(w, plan.q_tiles)
        yield ("gated_flash_bwd_dq", blk, bh, t * fa.BWD_Q_ROWS,
               min((t + 1) * fa.BWD_Q_ROWS, plan.s_q))


def _dkv_writes(plan):
    """The same for dk/dv rows (the reduction's where the one pass is split)."""
    if plan.route == "one_pass":
        if plan.chunks > 1:
            for bh in range(plan.b * plan.h):
                yield ("gated_flash_bwd_reduce", None, bh, 0, plan.s_kv)
            return
        for blk, bh in _walk(plan.blocks, plan.items):
            yield ("gated_flash_bwd_fused", blk, bh, 0, plan.s_kv)
        return
    for blk, w in _walk(plan.dkv_blocks, plan.b * plan.h * plan.kv_tiles):
        bh, t = divmod(w, plan.kv_tiles)
        yield ("gated_flash_bwd_dkv", blk, bh, t * fa.BWD_DKV_ROWS,
               min((t + 1) * fa.BWD_DKV_ROWS, plan.s_kv))


def _workspace_writes(plan):
    """(block, b·h, slice) of every f32 dk/dv partial of a split one pass."""
    if plan.workspace_shape is None:
        return
    for blk, w in _walk(plan.blocks, plan.items):
        yield (blk, *divmod(w, plan.chunks))


def _runs_partition(runs, n_rows, n_bh):
    """Each b·h's runs [lo, hi) tile [0, n_rows) exactly once."""
    by_bh = {}
    for bh, lo, hi in runs:
        assert lo < hi
        by_bh.setdefault(bh, []).append((lo, hi))
    assert sorted(by_bh) == list(range(n_bh))
    for bh, spans in by_bh.items():
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == n_rows, (bh, spans)
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:])), (bh, spans)


@pytest.mark.parametrize("b,s_q,s_kv,h", BACKWARD_CASES)
def test_backward_plan_writes_every_row_once(b, s_q, s_kv, h):
    """Each query row's dq and each kv row's dk/dv is written by exactly one
    block of one kernel of the plan's route (a split one pass: each slice's
    f32 partial by one block, dk/dv by the reduction)."""
    plan = fa.backward_plan(b, h, s_q, s_kv)
    dq = list(_dq_writes(plan))
    dkv = list(_dkv_writes(plan))
    kernels = set(plan.launches)
    assert {k for k, *_ in dq} | {k for k, *_ in dkv} <= kernels
    _runs_partition([(bh, lo, hi) for _, _, bh, lo, hi in dq], s_q, b * h)
    _runs_partition([(bh, lo, hi) for _, _, bh, lo, hi in dkv], s_kv, b * h)
    blocks = {}
    for kernel, blk, bh, lo, hi in dq:
        blocks.setdefault((bh, lo), set()).add((kernel, blk))
    assert all(len(v) == 1 for v in blocks.values())
    ws = list(_workspace_writes(plan))
    if plan.workspace_shape is None:
        assert ws == []
    else:
        assert sorted((bh, ch) for _, bh, ch in ws) == [
            (bh, ch) for bh in range(b * h) for ch in range(plan.chunks)]


@pytest.mark.parametrize("b,s_q,s_kv,h", BACKWARD_CASES)
def test_backward_plan_takes_one_pass_only_where_the_kv_side_is_one_tile(b, s_q, s_kv, h):
    plan = fa.backward_plan(b, h, s_q, s_kv)
    assert plan.route == ("one_pass" if s_kv <= fa.BWD_ONE_PASS_KV else "two_kernel")
    assert plan.q_tiles == math.ceil(s_q / fa.BWD_Q_ROWS)
    if plan.route == "one_pass":
        assert plan.launches == {"gated_flash_bwd_fused": 1,
                                 "gated_flash_bwd_reduce": int(plan.chunks > 1)}
        assert plan.kv_tiles == 1 and plan.stats_shape is None
        assert 1 <= plan.blocks <= min(plan.items, fa.SM_COUNT)
    else:
        assert plan.launches == {"gated_flash_bwd_dq": 1, "gated_flash_bwd_dkv": 1}
        assert plan.dq_blocks == min(b * h * plan.q_tiles, fa.SM_COUNT)
        assert plan.dkv_blocks == min(b * h * plan.kv_tiles, fa.SM_COUNT)
        assert plan.kv_tiles == math.ceil(s_kv / fa.BWD_DKV_ROWS) and plan.chunks == 1
        assert plan.s_q_pad % fa.BWD_DKV_Q == 0 and 0 <= plan.s_q_pad - s_q < fa.BWD_DKV_Q
        assert plan.s_q_pad <= plan.q_tiles * fa.BWD_Q_ROWS  # the dq grid writes every stats row


@pytest.mark.parametrize("b,s_q,s_kv,h", BACKWARD_CASES)
def test_backward_q_split_fills_half_of_the_last_round(b, s_q, s_kv, h):
    """The one pass splits the query range only where B·H items leave the
    last round of the 132 SMs less than half full, into the fewest slices
    that fill half of it (or, where none does, one query tile a slice)."""
    plan = fa.backward_plan(b, h, s_q, s_kv)
    if plan.route != "one_pass":
        return
    fill = fa._last_round_fill(plan.items)
    assert 1 <= plan.chunks <= plan.q_tiles
    assert fill >= 0.5 or plan.chunks == plan.q_tiles or all(
        fa._last_round_fill(b * h * c) <= fill for c in range(1, plan.q_tiles + 1))
    for c in range(1, plan.chunks):
        assert fa._last_round_fill(b * h * c) < 0.5
    assert all(plan.slice_tiles(ch)[0] < plan.slice_tiles(ch)[1] for ch in range(plan.chunks))


def test_backward_plan_at_the_train_steps_sites():
    """B = 64: the 22 sites with S_kv <= 80 run one pass, only 1024/77 split
    (320 items fill 42 % of the last round, two slices 85 %); 1024² and 256²
    run the two kernels."""
    routes = {s: fa.backward_plan(64, s[2], s[0], s[1]) for s in SITES_256}
    assert [s for s, p in routes.items() if p.route == "two_kernel"] == [
        (1024, 1024, 5), (256, 256, 10)]
    assert {s: p.chunks for s, p in routes.items() if p.chunks > 1} == {(1024, 77, 5): 2}


@pytest.mark.parametrize("b,s_q,s_kv,h", [(64, 1024, 77, 5), (64, 16, 77, 20), (4, 1024, 1024, 5),
                                          (1, 200, 200, 3), (2, 100, 81, 3)])
@pytest.mark.parametrize("gated", [False, True])
def test_backward_wrappers_allocate_what_the_plan_states(monkeypatch, b, s_q, s_kv, h, gated):
    """The wrappers' partials, workspace and row stats have the plan's
    shapes, and the entry points get the plan's chunks, blocks and padding
    (shapes only: meta tensors, the launches recorded, not run)."""
    calls = []

    def launch(name, device, *args):
        calls.append((name, args))

    monkeypatch.setattr(fa, "_device", lambda t: None)
    monkeypatch.setattr(fa.build, "launch", launch)
    q, o, do = (torch.empty(b, s_q, h, 64, device="meta", dtype=torch.bfloat16) for _ in range(3))
    k, v = (torch.empty(b, s_kv, h, 64, device="meta", dtype=torch.bfloat16) for _ in range(2))
    lse = torch.empty(b * h, s_q, device="meta")
    gate = torch.empty(b, h, device="meta") if gated else None
    plan = fa.backward_plan(b, h, s_q, s_kv)
    out = fa.gated_flash_backward(q, k, v, gate, o, lse, do)
    assert [name for name, _ in calls] == [n for n, c in plan.launches.items() if c]
    assert all(len(args) == len(fa.build.SIGNATURES[name][1]) - 1 for name, args in calls)
    assert out[3] is None if not gated else tuple(out[3].shape) == (b, h)
    if plan.route == "one_pass":
        dq, dk, dv, part = fa.gated_flash_bwd_fused(q, k, v, gate, o, lse, do)
        args = calls[-2 if plan.chunks > 1 else -1][1]
        assert args[-3:-1] == (plan.chunks, plan.blocks)
        assert (part is None) == (not gated)
        if gated:
            assert (tuple(part.shape),) == plan.dgate_parts
    else:
        dq, stats, part_q = fa.gated_flash_bwd_dq(q, k, v, gate, o, lse, do)
        assert tuple(stats.shape) == plan.stats_shape
        assert calls[-1][1][-3:-1] == (plan.s_q_pad, plan.dq_blocks)
        dk, dv, part_kv = fa.gated_flash_bwd_dkv(q, k, v, gate, stats, do)
        assert calls[-1][1][-3:-1] == (plan.s_q_pad, plan.dkv_blocks)
        if gated:
            assert (tuple(part_q.shape), tuple(part_kv.shape)) == plan.dgate_parts
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
