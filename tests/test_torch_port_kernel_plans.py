"""The conv kernel's plan (`conv_plan` in the port's ops/norm_conv.py), held on
the CPU: which patch shape, output-channel tile and split over K the
Hopper kernel `norm_conv3x3` runs each shape of the SD-2.1 U-Net with, and
that a split plan computes the same function as the unsplit conv. Below it,
the same for the attention backward's plan (`backward_plan`), the forward's
(`forward_plan`: kernel, kv tile, whole items per warpgroup, persistent
grid), the linear's and the GroupNorm's.

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


# ---------------------------------------------------------------- the forward's plan

RAGGED_FORWARD = [(2, s_q, s_kv, h) for s_q in (1, 40, 63, 64, 65) for s_kv in (1, 16, 77, 80, 81, 200)
                  for h in (3, 20)]
FORWARD_CASES = ([(b, *s) for b in (16, 64) for s in SITES_256] + [(4, *s) for s in SITES_512]
                 + RAGGED_FORWARD)


def _forward_writes(plan):
    """(block, warpgroup, b·h, first row, end row) of every run of query rows
    a consumer warpgroup stores, by the kernels' index arithmetic
    (gated_flash_fwd.cu): gated_flash_fwd_small's warpgroup wg takes its
    block's items wg, wg + 2, … (w = blk + i·grid, one b·h each, rows
    [0, S_q)); gated_flash_fwd_wgmma's work tile w = blk + i·grid is
    (b·h = w / q_tiles, rows 128·(w % q_tiles) + 64·wg + [0, 64))."""
    bh_items = plan.b * plan.h
    if plan.kernel == "gated_flash_fwd_small":
        for blk in range(plan.grid):
            for wg in (0, 1):
                for w in range(blk + wg * plan.grid, bh_items, 2 * plan.grid):
                    yield blk, wg, w, 0, plan.s_q
        return
    q_tiles = -(-plan.s_q // fa.FWD_Q_ROWS)
    for blk, w in _walk(plan.grid, bh_items * q_tiles):
        bh, t = divmod(w, q_tiles)
        for wg in (0, 1):
            lo = t * fa.FWD_Q_ROWS + 64 * wg
            if lo < plan.s_q:
                yield blk, wg, bh, lo, min(lo + 64, plan.s_q)


@pytest.mark.parametrize("b,s_q,s_kv,h", FORWARD_CASES)
def test_forward_plan_writes_every_query_row_once(b, s_q, s_kv, h):
    """Each (b·h, query row) is stored by exactly one warpgroup's item."""
    plan = fa.forward_plan(b, h, s_q, s_kv)
    writes = list(_forward_writes(plan))
    _runs_partition([(bh, lo, hi) for _, _, bh, lo, hi in writes], s_q, b * h)
    owners = {}
    for blk, wg, bh, lo, _ in writes:
        owners.setdefault((bh, lo), set()).add((blk, wg))
    assert all(len(v) == 1 for v in owners.values())
    if plan.kernel == "gated_flash_fwd_small":  # whole items: one warpgroup a b·h
        assert len(writes) == b * h
        per_wg = {}
        for blk, wg, *_ in writes:
            per_wg[blk, wg] = per_wg.get((blk, wg), 0) + 1
        assert max(per_wg.values()) == plan.items_per_warpgroup


@pytest.mark.parametrize("b,s_q,s_kv,h", FORWARD_CASES)
def test_forward_plan_takes_one_kv_tile_exactly_where_s_kv_fits_80(b, s_q, s_kv, h):
    """The one-tile route (a kv tile of at most 80 rows that holds S_kv: no
    online rescale) exactly where S_kv <= 80, 128-row tiles and the online
    softmax above; the S_q <= 64 kernel there with the least of its tiles
    that holds S_kv and 64-row items, the 128-row kernel elsewhere."""
    plan = fa.forward_plan(b, h, s_q, s_kv)
    assert (plan.kv_tile <= fa.FWD_ONE_TILE_KV) == (s_kv <= fa.FWD_ONE_TILE_KV)
    assert plan.kv_tiles == 1 or s_kv > fa.FWD_ONE_TILE_KV
    assert plan.kv_tile * plan.kv_tiles >= s_kv > plan.kv_tile * (plan.kv_tiles - 1)
    small = s_q <= fa.SMALL_Q_ROWS and s_kv <= fa.FWD_ONE_TILE_KV
    assert plan.kernel == ("gated_flash_fwd_small" if small else "gated_flash_fwd_wgmma")
    assert plan.kernel == fa.forward_kernel(s_q, s_kv)
    if small:
        assert plan.q_rows == fa.SMALL_Q_ROWS and plan.q_tiles == 1
        assert plan.kv_tile == min(t for t in fa.FWD_SMALL_TILES if t >= s_kv)
    else:
        assert plan.q_rows == fa.FWD_Q_ROWS
        assert plan.kv_tile == (fa.FWD_ONE_TILE_KV if s_kv <= fa.FWD_ONE_TILE_KV
                                else fa.FWD_KV_ROWS)


@pytest.mark.parametrize("b,s_q,s_kv,h", FORWARD_CASES)
def test_forward_plan_grid_never_exceeds_the_items(b, s_q, s_kv, h):
    """A persistent grid of at most the items: two blocks a SM for the S_q <= 64
    kernel (one item set in flight per warpgroup), one a SM for the 128-row
    kernel."""
    plan = fa.forward_plan(b, h, s_q, s_kv)
    assert 1 <= plan.grid <= plan.items == b * h * plan.q_tiles
    if plan.kernel == "gated_flash_fwd_small":
        assert plan.grid == min(plan.items, 2 * fa.SM_COUNT)
        assert plan.launch_args == (plan.kv_tile, plan.grid)
    else:
        assert plan.grid == min(plan.items, fa.SM_COUNT)
        assert plan.launch_args == (plan.grid,)


def test_forward_plan_at_the_unet_sites():
    """B_eff 16: the 12 sites of the 64- and 16-token blocks run the S_q <= 64
    kernel with kv tiles of 64, 80, 16 and 80 rows, each of the 320 items a
    warpgroup of its own; the 20 sites with S_q > 64 the 128-row kernel."""
    plans = {(s_q, s_kv): fa.forward_plan(16, h, s_q, s_kv) for s_q, s_kv, h in SITES_256}
    small = {k: p.kv_tile for k, p in plans.items() if p.kernel == "gated_flash_fwd_small"}
    assert small == {(64, 64): 64, (64, 77): 80, (16, 16): 16, (16, 77): 80}
    assert all(plans[k].items_per_warpgroup == 1 and plans[k].grid == 264 for k in small)


@pytest.mark.parametrize("b,s_q,s_kv,h", [(16, 64, 77, 20), (64, 16, 16, 20), (4, 1024, 77, 5),
                                          (2, 40, 200, 3), (3, 1, 1, 3), (2, 65, 77, 20)])
@pytest.mark.parametrize("lse", [False, True])
def test_forward_wrappers_allocate_what_the_plan_states(monkeypatch, b, s_q, s_kv, h, lse):
    """Both forward wrappers launch the plan's kernel with the plan's kv
    tile and grid, and allocate o like q and lse (B·H, S_q) f32
    (meta tensors, the launches recorded, not run)."""
    calls = []

    def launch(name, device, *args):
        calls.append((name, args))

    monkeypatch.setattr(fa, "_device", lambda t: None)
    monkeypatch.setattr(fa.build, "launch", launch)
    q = torch.empty(b, s_q, h, 64, device="meta", dtype=torch.bfloat16)
    k, v = (torch.empty(b, s_kv, h, 64, device="meta", dtype=torch.bfloat16) for _ in range(2))
    gate = torch.empty(b, h, device="meta")
    plan = fa.forward_plan(b, h, s_q, s_kv)
    before = dict(fa.forward_launches)
    if lse:
        o, lse_out = fa.gated_flash_forward_lse(q, k, v, gate)
        assert lse_out.shape == (b * h, s_q) and lse_out.dtype == torch.float32
    else:
        o = fa.gated_flash_attention(q, k, v, gate)
    assert o.shape == q.shape and o.dtype == q.dtype
    (name, args), = calls
    assert name == plan.kernel and len(args) == len(fa.build.SIGNATURES[name][1]) - 1
    assert args[6:10] == (b, h, s_q, s_kv) and args[10:-1] == plan.launch_args
    assert args[-1] == pytest.approx(64 ** -0.5 * 1.4426950408889634)
    assert fa.forward_launches[name] == before[name] + 1


# ---------------------------------------------------------------- the linear's plan

# (S, C) of every proj_in site of the SD-2.1 U-Net at 256px and at 512px
LINEAR_SITES = {256: ((1024, 320), (256, 640), (64, 1280), (16, 1280)),
                512: ((4096, 320), (1024, 640), (256, 1280), (64, 1280))}
LINEAR_CASES = [(b, s, c) for res in (256, 512) for b in (4, 16, 64)
                for s, c in LINEAR_SITES[res]] + [(3, 100, 72), (40, 4, 64), (1, 1, 8)]


def _linear_items(plan):
    """(block, slice, first row, first column) of every work item, by the
    kernel's walk (norm_conv.cu: item w of block w % grid is tile (mt, nt)
    of slice z, w = (z·m_tiles + mt)·n_tiles + nt)."""
    for blk, w in _walk(plan.grid, plan.blocks):
        rest, nt = divmod(w, plan.n_tiles)
        z, mt = divmod(rest, plan.m_tiles)
        yield blk, z, mt * nc.LINEAR_ROWS, nt * plan.bn


@pytest.mark.parametrize("b,s,c", LINEAR_CASES)
def test_linear_plan_writes_every_output_tile_once(b, s, c):
    """The persistent grid's work items cover the B·S × C_out output (each
    K slice's partial, where the plan splits) exactly once, and the a and b
    staged with a chunk hold every batch element a tile's rows span."""
    plan = nc.linear_plan(b, s, c, c)
    m = b * s
    assert plan.m == m and plan.bn == nc.LINEAR_BN
    assert plan.blocks == plan.m_tiles * plan.n_tiles * plan.split
    assert 1 <= plan.grid <= nc.SM_COUNT
    covered = np.zeros((plan.split, m, c), dtype=np.int32)
    for _, z, r0, c0 in _linear_items(plan):
        covered[z, r0:r0 + nc.LINEAR_ROWS, c0:c0 + plan.bn] += 1
    assert (covered == 1).all(), plan
    spans = [min(b - 1, (mt * nc.LINEAR_ROWS + nc.LINEAR_ROWS - 1) // s)
             - (mt * nc.LINEAR_ROWS) // s + 1 for mt in range(plan.m_tiles)]
    if plan.ab_rows:
        assert max(spans) <= plan.ab_rows <= nc.LINEAR_MAX_AB_ROWS
    else:
        assert min(b, 126 // s + 2) > nc.LINEAR_MAX_AB_ROWS


@pytest.mark.parametrize("b,s,c", LINEAR_CASES)
def test_linear_plan_slices_cover_every_channel_chunk_once_in_order(b, s, c):
    plan = nc.linear_plan(b, s, c, c)
    assert 1 <= plan.split <= plan.chunks == math.ceil(c / nc.CONV_CHUNK)
    chunks = []
    for lo, hi in plan.slices:
        assert lo < hi and lo % nc.CONV_CHUNK == 0
        chunks += list(range(lo // nc.CONV_CHUNK, math.ceil(hi / nc.CONV_CHUNK)))
    assert chunks == list(range(plan.chunks))
    assert plan.slices[-1][1] == c


@pytest.mark.parametrize("b,s,c", LINEAR_CASES)
def test_linear_plan_splits_only_a_short_grid_and_fills_half_the_card(b, s, c):
    """A grid of more than half the SMs runs unsplit; a split one fits in
    one wave and fills at least half of the 132 SMs (unless every chunk is
    already its own slice)."""
    plan = nc.linear_plan(b, s, c, c)
    base = plan.m_tiles * plan.n_tiles
    if 2 * base > nc.SM_COUNT:
        assert plan.split == 1
    if plan.split > 1:
        assert plan.blocks <= nc.SM_COUNT and plan.grid == plan.blocks
        assert 2 * plan.blocks >= nc.SM_COUNT or plan.split == plan.chunks
    if (b, s) in ((16, 64), (16, 16)) and c == 1280:  # the 8×8 and 4×4 sites at B_eff 16
        assert plan.split > 1


@pytest.mark.parametrize("b,s,c", [(16, 1024, 320), (16, 64, 1280), (16, 16, 1280),
                                   (64, 16, 1280), (40, 4, 64), (3, 100, 72)])
def test_linear_wrapper_allocates_what_the_plan_states(monkeypatch, b, s, c):
    """norm_linear hands the kernel the plan's split and staging and a
    workspace of the plan's shape, and reduces it where the plan splits
    (shapes only: meta tensors, the launches recorded, not run)."""
    calls = []
    monkeypatch.setattr(nc.build, "require_cuda", lambda t: None)
    monkeypatch.setattr(nc.build, "launch", lambda name, device, *args: calls.append((name, args)))
    x = torch.empty(b, s, c, device="meta", dtype=torch.bfloat16)
    a, sh = (torch.empty(b, c, device="meta") for _ in range(2))
    weight = torch.empty(c, c, device="meta", dtype=torch.bfloat16)
    lbias = torch.empty(c, device="meta")
    plan = nc.linear_plan(b, s, c, c)
    out = nc.norm_linear(x, a, sh, weight, lbias)
    assert out.shape == (b, s, c) and out.dtype == torch.bfloat16
    names = [name for name, _ in calls]
    assert names == ["norm_linear"] + ["conv_split_reduce"] * (plan.split > 1)
    args = calls[0][1]
    assert len(args) == len(nc.build.SIGNATURES["norm_linear"][1]) - 1
    assert args[-7:] == (b, s, c, c, plan.split, plan.ab_rows, plan.grid)
    assert plan.grid == min(plan.blocks, nc.SM_COUNT)
    ws = nc.conv_workspace(plan, torch.device("meta"))
    if plan.split > 1:
        assert tuple(ws.shape) == (plan.split, b * s, c) == plan.workspace_shape
        assert ws.numel() * 4 == plan.workspace_bytes
        assert calls[1][1][-2:] == (c, plan.split)
    else:
        assert ws is None and plan.workspace_bytes == 0


@pytest.mark.parametrize("b,s,c", [(2, 100, 1280), (3, 16, 72)])
def test_sum_of_the_linear_plans_slices_is_the_linear(b, s, c):
    """Plain f32 products over the plan's channel slices, added in slice
    order with the bias by the reduction's plain version, equal the plain
    linear within 1e-5."""
    rng = np.random.default_rng(b + s + c)
    x = torch.from_numpy(rng.standard_normal((b, s, c), dtype=np.float32))
    a = torch.from_numpy(1.0 + 0.2 * rng.standard_normal((b, c), dtype=np.float32))
    sh = torch.from_numpy(0.3 * rng.standard_normal((b, c), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((c, c), dtype=np.float32) * c ** -0.5)
    bias = torch.from_numpy(0.1 * rng.standard_normal(c, dtype=np.float32))
    plan = dataclasses.replace(nc.linear_plan(b, s, c, c),
                               split=math.ceil(c / nc.CONV_CHUNK))
    y = a[:, None, :] * x + sh[:, None, :]
    ws = torch.stack([(y[..., lo:hi] @ w[:, lo:hi].T).reshape(-1, c) for lo, hi in plan.slices])
    out = nc.conv_split_reduce(ws, bias, torch.empty(b, s, c))
    want = nc.norm_linear_plain(x, a, sh, w, bias)
    assert (out - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# ---------------------------------------------------------------- the GroupNorm's plan

from diffusion_pruning_tpu_torch.ops import group_norm as gn  # noqa: E402

# (C, map side at 256px) of the GroupNorm sites of the SD-2.1 U-Net (resnet
# norms, transformer norms); at 512px every side doubles
GN_SITES_256 = ((320, 32), (640, 32), (960, 32), (320, 16), (640, 16), (960, 16), (1280, 16),
                (1920, 16), (640, 8), (1280, 8), (1920, 8), (2560, 8), (1280, 4), (2560, 4))
GN_CASES = [(b, c, side * res // 256) for res in (256, 512) for b in (4, 16, 64)
            for c, side in GN_SITES_256]
GN_ODD = [(2, 72, 10, 8), (1, 9600, 8, 32), (1, 960, 128, 32), (5, 96, 7, 32), (2, 60, 3, 6)]


def _gn_plans():
    return ([gn.group_norm_plan(b, side * side, c, 32) for b, c, side in GN_CASES]
            + [gn.group_norm_plan(b, side * side, c, g) for b, c, side, g in GN_ODD])


@pytest.mark.parametrize("plan", _gn_plans(), ids=lambda p: f"{p.b}x{p.c}x{p.hw}g{p.groups}")
def test_group_norm_plan_windows_hold_whole_groups(plan):
    """A window is whole groups, tiles C, and (where it stays in shared
    memory) is a multiple of 16 bytes of at most 256 channels, read 8
    channels a load; the vector divides it. Where no such window exists the
    window is one group."""
    cg = plan.c // plan.groups
    assert plan.window == plan.groups_per_window * cg
    assert plan.c % plan.window == 0 and plan.groups % plan.groups_per_window == 0
    assert plan.window % plan.vec == 0 and plan.vec in (1, 2, 4, 8)
    if plan.one_read:
        assert plan.window * 2 % 16 == 0 and plan.window <= 256 and plan.vec == 8
        assert plan.groups_per_window <= gn.GN_MAX_GROUPS
    if plan.window % 8 or plan.window > 256:
        assert not plan.one_read and plan.groups_per_window == 1
        assert all(plan.groups % k or k * cg % 8 or k * cg > 256
                   for k in range(1, plan.groups + 1))


@pytest.mark.parametrize("plan", _gn_plans(), ids=lambda p: f"{p.b}x{p.c}x{p.hw}g{p.groups}")
def test_group_norm_plan_cluster_covers_the_slab_rows_once(plan):
    """The blocks of a cluster hold the slab's HW rows exactly once, each in
    whole TMA boxes of at most 256 rows, within 227 KB of shared memory."""
    assert plan.cluster in gn.GN_CLUSTERS
    ranges = plan.row_ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.hw
    assert all(lo <= hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert sum(hi - lo for lo, hi in ranges) == plan.hw
    assert 1 <= plan.box_rows <= 256 and plan.rows % plan.box_rows == 0
    assert plan.smem_bytes <= gn.GN_SMEM_LIMIT or not plan.one_read
    assert plan.ctas == plan.b * (plan.c // plan.window) * plan.cluster
    assert plan.threads == (512 if plan.rows * plan.window * 2 >= gn.GN_BIG_PART else 256)
    assert plan.tma == (plan.one_read and plan.rows * plan.window * 2 > gn.GN_TMA_PART)


@pytest.mark.parametrize("b,c,side", GN_CASES)
def test_group_norm_plan_reads_every_unet_shape_once(b, c, side):
    """Every GroupNorm shape of the 256px and 512px forwards (and B = 64) is
    held in a cluster's shared memory: one read of x. The grid gives every
    SM a block unless a cluster of eight cannot."""
    plan = gn.group_norm_plan(b, side * side, c, 32)
    assert plan.one_read, plan
    assert plan.ctas >= gn.SM_COUNT or plan.cluster == 8


def test_group_norm_plan_holds_the_512px_slab_in_one_read():
    """960 channels at 64×64, B_eff 4: a (batch, group) slab of 245 KB (more
    than one block's shared memory) spread over a cluster and read once."""
    plan = gn.group_norm_plan(4, 64 * 64, 960, 32)
    assert 64 * 64 * 30 * 2 == 245760
    assert plan.one_read and plan.cluster > 1 and plan.tma
    assert plan.smem_bytes <= gn.GN_SMEM_LIMIT
    assert plan.rows * plan.window * 2 <= gn.GN_SMEM_LIMIT
    # a slab no cluster holds, and a group no window of 256 channels holds
    assert not gn.group_norm_plan(1, 128 * 128, 960, 32).one_read
    wide = gn.group_norm_plan(1, 64, 9600, 32)
    assert not wide.one_read and wide.window == 300 and wide.vec == 4


# an expert's resnet norm2: kept groups of C/32 ∈ {10, 20, 40} channels, an odd
# count, at the maps of the levels that keep them; (window, vec, one_read) of
# the route `group_norm_plan` states for them
GN_EXPERT = {(90, 9): (10, 2, False), (170, 17): (10, 2, False), (310, 31): (10, 2, False),
             (620, 31): (20, 4, False), (1240, 31): (40, 8, True)}


def _gn_thread_visits(plan, nrows):
    """How often the kernel's threads of one block visit each (vector, row)
    of its window (`group_norm_silu_kernel`: thread rr·vpr + j0 takes column
    j0 of rows rr, rr + rpi, …, or every nt-th column of every row where a
    row has more vectors than the block has threads)."""
    visits = np.zeros((plan.window // plan.vec, nrows), dtype=np.int64)
    vpr, nt = plan.window // plan.vec, plan.threads
    wide = vpr > nt
    rpi = 1 if wide else nt // vpr
    for tid in range(nt):
        rr, j0 = (0, tid) if wide else (tid // vpr, tid % vpr)
        if rr < rpi:
            for j in range(j0, vpr, nt if wide else vpr):
                visits[j, rr::rpi] += 1
    return visits


@pytest.mark.parametrize("c,groups", sorted(GN_EXPERT))
@pytest.mark.parametrize("side", [32, 16, 8])
@pytest.mark.parametrize("b", [8, 16])
def test_group_norm_plan_at_expert_widths_covers_every_group_row_once(c, groups, side, b):
    """The route an expert's GroupNorm takes (no window of whole groups makes
    a multiple of 8 channels at C/G = 10 or 20 with an odd group count: one
    group a block, 4- or 8-byte loads, x read in each pass), and every
    (batch, group, row) is held by one block and each of its channels by one
    thread."""
    plan = gn.group_norm_plan(b, side * side, c, groups)
    assert (plan.window, plan.vec, plan.one_read) == GN_EXPERT[(c, groups)]
    # every vector starts at a multiple of its own size: C and the window divide by it
    assert c % plan.vec == 0 and plan.window % plan.vec == 0
    held = np.zeros((b, c, side * side), dtype=np.int64)
    for bi in range(b):
        for win in range(c // plan.window):
            for lo, hi in plan.row_ranges():
                held[bi, win * plan.window:(win + 1) * plan.window, lo:hi] += 1
    assert (held == 1).all()
    for lo, hi in plan.row_ranges():
        assert (_gn_thread_visits(plan, hi - lo) == 1).all()


@pytest.mark.parametrize("b,c,side,groups", [(16, 320, 32, 32), (4, 960, 64, 32),
                                             (2, 72, 10, 8), (1, 9600, 8, 32)])
def test_group_norm_wrapper_launches_the_plan(monkeypatch, b, c, side, groups):
    calls = []
    monkeypatch.setattr(gn.build, "require_cuda", lambda t: None)
    monkeypatch.setattr(gn.build, "launch", lambda name, device, *args: calls.append((name, args)))
    x = torch.empty(b, c, side, side, device="meta", dtype=torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    scale, bias = (torch.empty(c, device="meta") for _ in range(2))
    out = gn.group_norm_silu_forward(x, scale, bias, groups, 1e-5, True)
    plan = gn.group_norm_plan(b, side * side, c, groups)
    assert out.shape == x.shape and out.is_contiguous(memory_format=torch.channels_last)
    assert [name for name, _ in calls] == ["group_norm_silu"]
    args = calls[0][1]
    assert len(args) == len(gn.build.SIGNATURES["group_norm_silu"][1]) - 1
    assert args[4:8] == (b, side * side, c, groups)
    assert args[-6:] == (plan.window, plan.cluster, plan.rows, plan.box_rows, plan.stash,
                         plan.threads)
    assert plan.stash == (0 if not plan.one_read else 1 if plan.tma else 2)
