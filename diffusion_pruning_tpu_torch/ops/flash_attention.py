"""Head-gated flash attention: the hand-written Hopper kernels, their
wrappers, their plain PyTorch versions, launch counters and the autograd
Function that joins them for training.

With gate g per (batch, head),

    masked SDPA(q·g, k·g, v·g) == softmax(q·kᵀ · d^-½ · g²) · v · g

so the kernels scale the logits by g² and the output by g. Two sources in
`csrc/`:

* the forward (gated_flash_fwd.cu) replaces all four inference forwards of
  the JAX package's Pallas flash attention; with an lse output it is also
  the training forward (f32 log-sum-exp of each row's logits, natural log).
  It is two wgmma/TMA kernels, chosen by `forward_plan`:
  `gated_flash_fwd_small` at S_q <= SMALL_Q_ROWS and S_kv <= 80 (the 64- and
  16-token blocks: one b·h a work item, whole items per warpgroup, one kv
  tile), and `gated_flash_fwd_wgmma` elsewhere (128-row query tiles, two
  warpgroups a tile, online softmax over 128-row kv tiles above 80);
* the backward (gated_flash_bwd.cu) replaces the four Pallas backward
  bodies: dq, dk, dv, and dgate[b, h] = Σ dq'∘q + Σ dk'∘k + Σ dv'∘v, summed
  here from per-warp partials. `backward_plan` picks the route: at
  S_kv <= BWD_ONE_PASS_KV one pass, `gated_flash_bwd_fused` (and
  `gated_flash_bwd_reduce` where it splits the query range), else
  `gated_flash_bwd_dq`, then `gated_flash_bwd_dkv`. All are wgmma/TMA
  kernels.

`gated_flash_attention` is the entry point. Without a gradient to take it runs
the lse-free forward; when q, k, v or the gate requires grad it runs
`GatedFlashAttention`, whose forward saves (q, k, v, gate, o, lse) and whose
backward runs the backward kernels of `backward_plan`. A CPU tensor takes the
plain versions (`gated_attention_reference`, `gated_attention_reference_lse`,
`gated_flash_backward_reference`); a CUDA tensor goes to the kernels or
raises. On the card the kernels take bf16 q/k/v, the dtype the U-Net runs in;
their checks hold them against the plain versions in f32 on the same inputs.

The sources are compiled and loaded at first use by `ops/build.py`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from diffusion_pruning_tpu_torch.ops import build
from diffusion_pruning_tpu_torch.ops.build import SM_COUNT
from diffusion_pruning_tpu_torch.ops.build import ptr as _ptr
from diffusion_pruning_tpu_torch.ops.build import require_cuda as _device

HEAD_DIM = 64
SMALL_Q_ROWS = 64  # query rows of one work item of gated_flash_fwd_small (S_q <= this)
_LOG2E = 1.4426950408889634


# ---------------------------------------------------------------- plain versions

def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(QKᵀ/√d + bias)V in plain torch ops, f32 softmax statistics.
    q: (B, S_q, H, D), k/v: (B, S_kv, H, D), bias broadcastable to
    (B, H, S_q, S_kv). The attention of the encoders and the VAE."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * q.shape[-1] ** -0.5
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def gated_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward kernel's plain version: mask q, k and v per head by the gate
    (B, H), then `plain_attention`."""
    if gate is not None:
        g = gate[:, None, :, None].to(q.dtype)
        q, k, v = q * g, k * g, v * g
    return plain_attention(q, k, v)


def _gated_logits(q, k, gate):
    """f32 logits q·kᵀ·d^-½·g², (B, H, S_q, S_kv)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    if gate is not None:
        s = s * gate.float()[:, :, None, None].square()
    return s


def gated_attention_reference_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  gate: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward's plain version: (o, lse) with o as
    `gated_attention_reference` and lse (B·H, S_q) f32, the natural-log
    log-sum-exp of each row's logits q·kᵀ·d^-½·g²."""
    b, s_q, h, _ = q.shape
    lse = torch.logsumexp(_gated_logits(q, k, gate), dim=-1).reshape(b * h, s_q)
    return gated_attention_reference(q, k, v, gate), lse


def gated_flash_backward_reference(q, k, v, gate, o, lse, do, bf16_products: bool = False):
    """The backward kernels' plain version, their formulas in f32:
    P = exp(q·kᵀ·d^-½·g² − lse), δ = rowsum(dO∘O), dP = g·dO·vᵀ,
    dS = P∘(dP − δ), dq' = d^-½·g·dS·k, dk' = d^-½·g·dSᵀ·q, dv' = Pᵀ·dO;
    returns (dq, dk, dv) = g·(dq', dk', dv') in q's dtype and
    dgate = Σ dq'∘q + dk'∘k + dv'∘v, (B, H) f32 (None without a gate).
    o, do: (B, S_q, H, D); lse: (B·H, S_q) as the forward gives it.
    With `bf16_products` P and dS are rounded to bf16 before the products
    that take them (Pᵀ·dO, dS·k, dSᵀ·q), as the kernels round them."""
    b, s_q, h, d = q.shape
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    g = (gate.float() if gate is not None else q.new_ones(b, h, dtype=torch.float32))
    g4 = g[:, :, None, None]                                    # (B, H, 1, 1)
    p = torch.exp(_gated_logits(q, k, gate) - lse.reshape(b, h, s_q, 1))
    delta = torch.einsum("bqhd,bqhd->bhq", dof, of)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf) * g4
    ds = p * (dp - delta)
    if bf16_products:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    c = d ** -0.5 * g[:, None, :, None]                         # (B, 1, H, 1)
    dq_ = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * c
    dk_ = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * c
    dv_ = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    gb = g[:, None, :, None]
    dgate = None
    if gate is not None:
        dgate = ((dq_ * qf).sum(dim=(1, 3)) + (dk_ * kf).sum(dim=(1, 3))
                 + (dv_ * vf).sum(dim=(1, 3)))
    return ((dq_ * gb).to(q.dtype), (dk_ * gb).to(k.dtype), (dv_ * gb).to(v.dtype), dgate)


# ---------------------------------------------------------------- kernel wrappers

def _check(q, k, v, gate):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, D)")
    b, s_q, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"head dim {d} not supported (kernel is built for {HEAD_DIM})")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    _check_bf16(q=q, k=k, v=v)
    if s_q < 1 or k.shape[1] < 1:
        raise ValueError("empty sequence")
    if b * h > 65535:
        raise ValueError(f"B·H = {b * h} exceeds the grid limit 65535")
    if gate is not None:
        if gate.shape != (b, h) or gate.dtype != torch.float32 or gate.device != q.device:
            raise ValueError(f"gate must be float32 (B, H) = ({b}, {h}) on {q.device}, got "
                             f"{gate.dtype} {tuple(gate.shape)} on {gate.device}")
        if not gate.is_contiguous():
            raise ValueError("gate must be contiguous")


def _check_bf16(**tensors):
    """Each tensor bf16, contiguous, 16-byte aligned, on the first one's device."""
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernels take bfloat16 tensors, got {name} {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, q on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_rows(name, t, b, h, s_q, device):
    if t.shape != (b * h, s_q) or t.dtype != torch.float32 or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32 (B·H, S_q) = ({b * h}, {s_q}) "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


# ---------------------------------------------------------------- the forward's plan

FWD_Q_ROWS = 128       # query rows a work tile of gated_flash_fwd_wgmma (two warpgroups)
FWD_ONE_TILE_KV = 80   # the kv tile where S_kv <= this: one tile, no online rescale
FWD_KV_ROWS = 128      # the kv tile above it (online softmax)
FWD_SMALL_TILES = (16, 64, 80)  # kv tiles of gated_flash_fwd_small: the least that holds S_kv runs


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
    """How the forward runs one shape (`forward_plan`).

    kernel "gated_flash_fwd_small" (S_q <= SMALL_Q_ROWS and S_kv <= 80): a
    work item is one b·h (a 64-row query tile, S_q rows of it loaded);
    `grid` persistent blocks walk the B·H items (block blk takes blk,
    blk + grid, …), whose items 0, 2, 4, … go to its consumer warpgroup 0
    and 1, 3, 5, … to warpgroup 1, each item whole, one item set (Q, K, V)
    per warpgroup in flight. kernel "gated_flash_fwd_wgmma" (every other
    shape): a work tile is (b·h, 128 query rows), rows 64·wg … of it by
    consumer warpgroup wg, `grid` persistent blocks walking them the same
    way. `kv_tile` rows of K and V a tile, `kv_tiles` of them a (b, h)."""
    kernel: str
    b: int
    h: int
    s_q: int
    s_kv: int
    q_rows: int
    kv_tile: int
    grid: int

    @property
    def q_tiles(self) -> int:
        return -(-self.s_q // self.q_rows)

    @property
    def kv_tiles(self) -> int:
        return -(-self.s_kv // self.kv_tile)

    @property
    def items(self) -> int:
        return self.b * self.h * self.q_tiles

    @property
    def items_per_warpgroup(self) -> int:
        """The most work items one consumer warpgroup takes (the wgmma kernel's
        two warpgroups share each work tile)."""
        per_block = -(-self.items // self.grid)
        return -(-per_block // 2) if self.kernel == "gated_flash_fwd_small" else per_block

    @property
    def launch_args(self) -> Tuple[int, ...]:
        """The plan's arguments of the kernel's C entry point, before the scale."""
        if self.kernel == "gated_flash_fwd_small":
            return (self.kv_tile, self.grid)
        return (self.grid,)


@functools.lru_cache(maxsize=256)
def forward_plan(b: int, h: int, s_q: int, s_kv: int) -> ForwardPlan:
    """The forward's plan for q (B, S_q, H, 64) and k/v (B, S_kv, H, 64).

    * S_q <= 64 and S_kv <= 80 (every 64- and 16-token site of the U-Net):
      `gated_flash_fwd_small`, whole items per warpgroup, one kv tile, the
      least of 16, 64 and 80 rows that holds S_kv (S_kv = 16 reads 16 rows,
      the 77 text tokens one 80-row tile); two blocks per SM, at most B·H
      blocks, so that at B_eff 16 each of the 320 items has a warpgroup of
      its own and every load is issued before the first product;
    * otherwise `gated_flash_fwd_wgmma`: 128-row work tiles, a kv tile of 80
      rows where S_kv <= 80 (one tile) and 128 above (online softmax), one
      block per SM with at most the work tiles (S_q <= 64 with S_kv > 80, a
      ragged shape no U-Net site has, leaves half of each tile's rows idle)."""
    one_tile = s_kv <= FWD_ONE_TILE_KV
    kv_tile = FWD_ONE_TILE_KV if one_tile else FWD_KV_ROWS
    if s_q <= SMALL_Q_ROWS and one_tile:
        items = b * h
        tile = next(t for t in FWD_SMALL_TILES if s_kv <= t)
        return ForwardPlan("gated_flash_fwd_small", b, h, s_q, s_kv, SMALL_Q_ROWS, tile,
                           min(items, 2 * SM_COUNT))
    tiles = b * h * -(-s_q // FWD_Q_ROWS)
    return ForwardPlan("gated_flash_fwd_wgmma", b, h, s_q, s_kv, FWD_Q_ROWS, kv_tile,
                       min(tiles, SM_COUNT))


def forward_kernel(s_q: int, s_kv: int) -> str:
    """The forward kernel that runs a shape (`forward_plan`):
    `gated_flash_fwd_small` at S_q <= SMALL_Q_ROWS and S_kv <= 80,
    `gated_flash_fwd_wgmma` elsewhere."""
    return forward_plan(1, 1, s_q, s_kv).kernel


def _forward(q, k, v, gate, lse):
    b, s_q, h, d = q.shape
    plan = forward_plan(b, h, s_q, k.shape[1])
    o = torch.empty_like(q)
    build.launch(plan.kernel, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(gate),
                 o.data_ptr(), _ptr(lse), b, h, s_q, k.shape[1], *plan.launch_args,
                 d ** -0.5 * _LOG2E)
    forward_launches[plan.kernel] += 1
    return o


def gated_flash_forward_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            gate: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (o, lse (B·H, S_q) f32, natural log). CPU tensors
    run `gated_attention_reference_lse`; CUDA tensors launch the forward
    kernel `forward_plan` picks, with its lse output (counted in
    `.launches`)."""
    if q.device.type == "cpu":
        return gated_attention_reference_lse(q, k, v, gate)
    _device(q)
    _check(q, k, v, gate)
    b, s_q, h, _ = q.shape
    lse = torch.empty(b * h, s_q, device=q.device, dtype=torch.float32)
    o = _forward(q, k, v, gate, lse)
    gated_flash_forward_lse.launches += 1
    return o, lse


# ---------------------------------------------------------------- the backward's plan

BWD_Q_ROWS = 128         # query rows a tile of the one-pass and dq kernels (two warpgroups)
BWD_ONE_PASS_KV = 80     # the one-pass kernel's kv tile: S_kv <= this runs one pass
BWD_DKV_ROWS = 128       # kv rows a block of the dk/dv kernel (two warpgroups)
BWD_DKV_Q = 64           # query rows a tile of the dk/dv kernel; the row stats' padding


def _last_round_fill(items: int) -> float:
    """How full the last round of `items` equal work items leaves the SMs."""
    rem = items % SM_COUNT
    return 1.0 if rem == 0 else rem / SM_COUNT


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """How the backward runs one shape (`backward_plan`).

    route "one_pass" (S_kv <= BWD_ONE_PASS_KV): `gated_flash_bwd_fused`,
    `blocks` persistent blocks walking B·H·`chunks` work items (b·h, slice of
    the `q_tiles` 128-row query tiles); with chunks > 1 its dk/dv go to an f32
    workspace that `gated_flash_bwd_reduce` sums in slice order. route
    "two_kernel": `gated_flash_bwd_dq`, `dq_blocks` persistent blocks over
    the B·H·q_tiles work tiles, which also writes the row stats (B·H, 2,
    s_q_pad), then `gated_flash_bwd_dkv`, `dkv_blocks` over the B·H·kv_tiles
    128-row kv tiles. A block walks items blk, blk + blocks, …, those of one
    b·h adjacent. Every dgate partial is one per consumer warp: eight per
    work item."""
    route: str
    b: int
    h: int
    s_q: int
    s_kv: int
    q_tiles: int
    kv_tiles: int
    chunks: int
    blocks: int
    s_q_pad: int

    @property
    def items(self) -> int:
        return self.b * self.h * self.chunks

    @property
    def dq_blocks(self) -> int:
        return min(self.b * self.h * self.q_tiles, SM_COUNT)

    @property
    def dkv_blocks(self) -> int:
        return min(self.b * self.h * self.kv_tiles, SM_COUNT)

    def slice_tiles(self, ch: int) -> Tuple[int, int]:
        """Query tiles [t0, t1) of slice `ch` (the kernel's t0 = ch·tiles / chunks)."""
        return ch * self.q_tiles // self.chunks, (ch + 1) * self.q_tiles // self.chunks

    @property
    def launches(self) -> Dict[str, int]:
        """Launches of each backward kernel for one backward of this shape."""
        if self.route == "one_pass":
            return {"gated_flash_bwd_fused": 1, "gated_flash_bwd_reduce": int(self.chunks > 1)}
        return {"gated_flash_bwd_dq": 1, "gated_flash_bwd_dkv": 1}

    @property
    def dgate_parts(self) -> Tuple[Tuple[int, int], ...]:
        """Shapes of the f32 dgate partials, each (B·H, parts)."""
        bh = self.b * self.h
        if self.route == "one_pass":
            return ((bh, 8 * self.chunks),)
        return ((bh, 8 * self.q_tiles), (bh, 8 * self.kv_tiles))

    @property
    def workspace_shape(self) -> Optional[Tuple[int, ...]]:
        """(chunks, 2: dk, dv, B, S_kv, H, 64) f32 of a split one pass, else None."""
        if self.route != "one_pass" or self.chunks == 1:
            return None
        return (self.chunks, 2, self.b, self.s_kv, self.h, HEAD_DIM)

    @property
    def stats_shape(self) -> Optional[Tuple[int, int, int]]:
        """(B·H, 2: lse·log2 e, δ, s_q_pad) f32 row stats of the two-kernel route."""
        return None if self.route == "one_pass" else (self.b * self.h, 2, self.s_q_pad)


def backward_plan(b: int, h: int, s_q: int, s_kv: int) -> BackwardPlan:
    """The backward's plan for q (B, S_q, H, 64) and k/v (B, S_kv, H, 64).

    * S_kv <= 80 (cross-attention, the 64- and 16-token blocks): one pass,
      the whole kv side of a (b, h) one tile; persistent blocks, at most one
      per SM (a block takes 217 KB of shared memory). The q range is split
      into the fewest slices that leave the last round of the 132 SMs at
      least half full (B·H items alone at 1024/77, h 5, B 64: 320 items,
      the last round 42 % full; two slices: 85 %), at most one query tile a
      slice; where no split reaches half, the fullest.
      At S_q <= 64 an item is one 64-row tile and the kernel's second
      instance gives each of its two warpgroups items of their own.
    * otherwise two kernels, dq (which writes δ) then dk/dv."""
    q_tiles = -(-s_q // BWD_Q_ROWS)
    if s_kv <= BWD_ONE_PASS_KV:
        bh = b * h
        fills = [(_last_round_fill(bh * c), c) for c in range(1, q_tiles + 1)]
        chunks = next((c for fill, c in fills if fill >= 0.5),
                      max(fills, key=lambda fc: (fc[0], -fc[1]))[1])
        return BackwardPlan("one_pass", b, h, s_q, s_kv, q_tiles, 1, chunks,
                            min(bh * chunks, SM_COUNT), 0)
    return BackwardPlan("two_kernel", b, h, s_q, s_kv, q_tiles, -(-s_kv // BWD_DKV_ROWS), 1,
                        0, -(-s_q // BWD_DKV_Q) * BWD_DKV_Q)


# ---------------------------------------------------------------- backward wrappers

def _check_backward(q, k, v, gate, lse, tensors):
    _device(q)
    _check(q, k, v, gate)
    b, s_q, h, _ = q.shape
    _check_bf16(q=q, **tensors)
    for name, t in tensors.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} differs from q {tuple(q.shape)}")
    if lse is not None:
        _check_rows("lse", lse, b, h, s_q, q.device)
    return backward_plan(b, h, s_q, k.shape[1])


def _empty_f32(shape, device):
    return torch.empty(shape, device=device, dtype=torch.float32)


def gated_flash_bwd_fused(q, k, v, gate, o, lse, do):
    """One-pass kernel (S_kv <= BWD_ONE_PASS_KV): (dq, dk, dv, dgate partials
    (B·H, 8·chunks) f32 or None without a gate), under `backward_plan`; a
    split plan launches `gated_flash_bwd_reduce` after it. CUDA tensors only,
    checked; counted in `.launches`."""
    plan = _check_backward(q, k, v, gate, lse, {"o": o, "do": do})
    if plan.route != "one_pass":
        raise ValueError(f"S_kv = {k.shape[1]} exceeds the one-pass kv tile {BWD_ONE_PASS_KV}")
    b, s_q, h, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    part = None if gate is None else _empty_f32(plan.dgate_parts[0], q.device)
    ws = None if plan.workspace_shape is None else _empty_f32(plan.workspace_shape, q.device)
    build.launch("gated_flash_bwd_fused", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), do.data_ptr(), lse.data_ptr(), _ptr(gate), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), _ptr(ws), _ptr(part), b, h, s_q, k.shape[1],
                 plan.chunks, plan.blocks, d ** -0.5)
    gated_flash_bwd_fused.launches += 1
    if ws is not None:
        gated_flash_bwd_reduce(ws, dk, dv)
    return dq, dk, dv, part


def gated_flash_bwd_reduce(ws, dk, dv):
    """dk, dv = Σ over slices of the f32 workspace (chunks, 2, *dk.shape), in
    slice order, rounded once (into dk and dv). CUDA tensors only; counted in
    `.launches`."""
    _device(ws)
    _check_bf16(dk=dk, dv=dv)
    if (ws.dtype != torch.float32 or not ws.is_contiguous() or ws.dim() != 6
            or ws.shape[1] != 2 or ws.shape[2:] != dk.shape or dv.shape != dk.shape):
        raise ValueError(f"workspace {ws.dtype} {tuple(ws.shape)} does not hold dk/dv "
                         f"{tuple(dk.shape)}")
    build.launch("gated_flash_bwd_reduce", ws.device, ws.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), ws.shape[0], dk.numel())
    gated_flash_bwd_reduce.launches += 1


def gated_flash_bwd_dq(q, k, v, gate, o, lse, do):
    """dq kernel of the two-kernel route (S_kv > BWD_ONE_PASS_KV): (dq, row
    stats (B·H, 2, S_q padded to 64) f32: lse·log2 e and δ, dgate partials
    (B·H, 8·q_tiles) f32 or None without a gate). CUDA tensors only, checked;
    counted in `.launches`."""
    plan = _check_backward(q, k, v, gate, lse, {"o": o, "do": do})
    if plan.route != "two_kernel":
        raise ValueError(f"S_kv = {k.shape[1]} runs the one-pass kernel")
    b, s_q, h, d = q.shape
    dq = torch.empty_like(q)
    stats = _empty_f32(plan.stats_shape, q.device)
    part = None if gate is None else _empty_f32(plan.dgate_parts[0], q.device)
    build.launch("gated_flash_bwd_dq", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), do.data_ptr(), lse.data_ptr(), _ptr(gate), dq.data_ptr(),
                 stats.data_ptr(), _ptr(part), b, h, s_q, k.shape[1], plan.s_q_pad,
                 plan.dq_blocks, d ** -0.5)
    gated_flash_bwd_dq.launches += 1
    return dq, stats, part


def gated_flash_bwd_dkv(q, k, v, gate, stats, do):
    """dk/dv kernel of the two-kernel route: (dk, dv, dgate partials
    (B·H, 8·kv_tiles) f32 or None without a gate); `stats` from
    `gated_flash_bwd_dq`. CUDA tensors only, checked; counted in `.launches`."""
    plan = _check_backward(q, k, v, gate, None, {"do": do})
    if plan.route != "two_kernel":
        raise ValueError(f"S_kv = {k.shape[1]} runs the one-pass kernel")
    if (stats.shape != plan.stats_shape or stats.dtype != torch.float32
            or stats.device != q.device or not stats.is_contiguous()):
        raise ValueError(f"stats must be contiguous float32 {plan.stats_shape} on {q.device}, "
                         f"got {stats.dtype} {tuple(stats.shape)} on {stats.device}")
    b, s_q, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    part = None if gate is None else _empty_f32(plan.dgate_parts[1], q.device)
    build.launch("gated_flash_bwd_dkv", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 do.data_ptr(), stats.data_ptr(), _ptr(gate), dk.data_ptr(), dv.data_ptr(),
                 _ptr(part), b, h, s_q, k.shape[1], plan.s_q_pad, plan.dkv_blocks, d ** -0.5)
    gated_flash_bwd_dkv.launches += 1
    return dk, dv, part


def gated_flash_backward(q, k, v, gate, o, lse, do):
    """(dq, dk, dv, dgate) of the gated attention at (q, k, v, gate), given the
    forward's o and lse and the output gradient do; dgate is (B, H) f32, None
    without a gate. CPU tensors run `gated_flash_backward_reference`; CUDA
    tensors the kernels of `backward_plan`'s route: the one-pass kernel
    (and, split, its reduction), or the dq kernel, then the dk/dv kernel.
    The dgate partials are summed in a fixed order."""
    if q.device.type == "cpu":
        return gated_flash_backward_reference(q, k, v, gate, o, lse, do)
    _device(q)
    if k.shape[1] <= BWD_ONE_PASS_KV:
        dq, dk, dv, part = gated_flash_bwd_fused(q, k, v, gate, o, lse, do)
        parts = (part,)
    else:
        dq, stats, part_q = gated_flash_bwd_dq(q, k, v, gate, o, lse, do)
        dk, dv, part_kv = gated_flash_bwd_dkv(q, k, v, gate, stats, do)
        parts = (part_q, part_kv)
    dgate = None
    if gate is not None:
        b, h = gate.shape
        dgate = sum(p.view(b, h, -1).sum(-1) for p in parts)
    return dq, dk, dv, dgate


class GatedFlashAttention(torch.autograd.Function):
    """Gated attention with gradients for q, k, v and the gate: the training
    forward (with lse) and the backward kernels on the card, their plain
    versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, gate):
        o, lse = gated_flash_forward_lse(q, k, v, gate)
        ctx.save_for_backward(q, k, v, gate, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, gate, o, lse = ctx.saved_tensors
        dq, dk, dv, dgate = gated_flash_backward(q, k, v, gate, o, lse, do.contiguous())
        if not ctx.needs_input_grad[3]:
            dgate = None
        return dq, dk, dv, dgate


def gated_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q·kᵀ·d^-½·g²)·v·g per (batch, head).

    q: (B, S_q, H, 64), k/v: (B, S_kv, H, 64); gate: (B, H) f32 or None.
    When grad is enabled and q, k, v or the gate requires it, this is
    `GatedFlashAttention`. Otherwise CPU tensors (any float dtype) run the
    plain version, and CUDA tensors must be bf16 and launch the lse-free
    forward on the current stream (counted in `.launches`)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, gate)):
        return GatedFlashAttention.apply(q, k, v, gate)
    if q.device.type == "cpu":
        return gated_attention_reference(q, k, v, gate)
    _device(q)
    _check(q, k, v, gate)
    o = _forward(q, k, v, gate, None)
    gated_flash_attention.launches += 1
    return o


# launches of each forward kernel, by either wrapper (the wrappers' own
# `.launches` count their calls)
forward_launches = {"gated_flash_fwd_wgmma": 0, "gated_flash_fwd_small": 0}
gated_flash_attention.launches = 0
gated_flash_forward_lse.launches = 0
gated_flash_bwd_fused.launches = 0
gated_flash_bwd_reduce.launches = 0
gated_flash_bwd_dq.launches = 0
gated_flash_bwd_dkv.launches = 0
