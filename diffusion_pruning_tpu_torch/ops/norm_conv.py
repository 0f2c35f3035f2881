"""GroupNorm(+gate)(+SiLU) fused into the input read of the consumer product:
the two hand-written Hopper kernels, their wrappers, plain PyTorch versions,
launch counters and autograd Functions.

Counterpart of the JAX package's `ops/norm_conv.py`, same argument order:

* `group_norm_silu_conv3x3(x, scale, bias, weight, conv_bias, gate_c, groups,
  eps, silu)` = conv3x3(silu(GroupNorm(gate·x))), the resnets' norm→SiLU→conv
  pairs and the U-Net's output head. Its kernel `norm_conv3x3`
  (`csrc/norm_conv.cu`) replaces the Pallas bodies `_nc_kernel` and
  `_nc_kernel_ht`.
* `group_norm_linear(x, scale, bias, weight, lbias, gate_c, groups, eps)` =
  proj(GroupNorm(x)), the spatial transformer's norm→proj_in. Its kernel
  `norm_linear` replaces `_nl_kernel`.

Both run in two phases, as on the JAX side. Phase 1, `affine_coeffs`, is plain
torch: f32 statistics per (batch, group) of the *gated* activation, folded to
one multiply-add per (batch, channel), y = a·x + b with a = gate·scale·inv and
b = bias − mean·scale·inv. Phase 2 is the kernel: it applies y (and SiLU) to
each x tile on its way into shared memory, rounds y to x's dtype, multiplies
on the tensor cores with f32 accumulation, adds the bias in f32 and rounds
once. Zero padding is in y-space: a tap outside the image contributes 0.

Layout. The JAX kernels are NHWC with HWIO weights. Here the conv form takes a
logical (B, C, H, W) tensor in `torch.channels_last` strides (the same
memory; other strides are converted first) and `nn.Conv2d`'s
(C_out, C_in, 3, 3) weight, which it repacks to (C_out, 3, 3, C_in) so that
the contraction index is contiguous for every tap. `PackedWeight` keeps that
copy beside the module and rebuilds it when the parameter changed. The linear
form takes (B, S, C) tokens and `nn.Linear`'s (C_out, C_in) weight as it is.

A CPU tensor takes the plain versions; a CUDA tensor must be bf16 with
C_in % 8 == 0 and goes to the kernels or raises. The conv kernel's plan (patch
shape, output-channel tile, split over K) is chosen per shape by `conv_plan`;
a split plan writes f32 partial sums to a workspace the wrapper allocates,
and a second kernel adds them in a fixed order. The backward recomputes
through the unfused composition (`norm_conv_unfused`, `norm_linear_unfused`)
under autograd and returns gradients for x, scale, bias, the weight, its bias
and `gate_c`, as the JAX ops' custom_vjps do; there is no backward kernel on
either side.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from diffusion_pruning_tpu_torch.ops import build
from diffusion_pruning_tpu_torch.ops.build import SM_COUNT
from diffusion_pruning_tpu_torch.ops.group_norm import (
    check_activation,
    check_vector,
    recompute_grads,
)


def affine_coeffs(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
                  eps: float, gate_c: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) affine (a, b), f32 (B, C), with a·x + b ==
    GroupNorm(gate·x)·scale + bias. x: (B, C, *spatial) in any strides.
    Statistics are those of the gated activation, var = E[x²] − mean² in f32.
    The per-channel sums are taken first (Σ gate·x = gate·Σ x), so x is read
    without an f32 copy of it."""
    b, c = x.shape[:2]
    dims = tuple(range(2, x.dim()))
    n = x[0, 0].numel() * (c // groups)
    grouped = (b, groups, c // groups)
    s1 = x.sum(dim=dims, dtype=torch.float32).view(grouped)
    s2 = torch.linalg.vector_norm(x, 2, dim=dims, dtype=torch.float32).square().view(grouped)
    if gate_c is not None:
        g = gate_c.float().reshape(grouped)
        s1, s2 = s1 * g, s2 * g * g
    mean = s1.sum(-1, keepdim=True) / n                                        # (B, G, 1)
    var = torch.addcmul(s2.sum(-1, keepdim=True) / n, mean, mean, value=-1.0)
    sc = scale.float().view(1, *grouped[1:]) * torch.rsqrt(var + eps)          # (B, G, C/G)
    a = sc if gate_c is None else sc * g
    shift = torch.addcmul(bias.float().view(1, *grouped[1:]), mean, sc, value=-1.0)
    return a.reshape(b, c), shift.reshape(b, c)


def pack_conv_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`nn.Conv2d`'s (C_out, C_in, 3, 3) weight as a contiguous
    (C_out, 3, 3, C_in) tensor of `dtype`."""
    return weight.detach().to(dtype).permute(0, 2, 3, 1).contiguous()


class PackedWeight:
    """The packed copy of one conv weight, kept beside its module. `get`
    rebuilds it when the parameter's storage, version counter, dtype or device
    differ from those it was packed from, so `load_state_dict`, `.to()` and an
    optimizer's in-place step cannot leave it stale."""

    def __init__(self):
        self._key = None
        self._packed = None

    def get(self, weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        key = (weight.data_ptr(), weight._version, weight.dtype, weight.device, dtype)
        if key != self._key:
            self._packed = pack_conv_weight(weight, dtype)
            self._key = key
        return self._packed


def affine_act(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, silu: bool) -> torch.Tensor:
    """act(a·x + b) in f32, rounded to x's dtype and returned in f32: the
    kernels' A operand. x: (B, C, *spatial)."""
    shape = a.shape + (1,) * (x.dim() - 2)
    y = a.reshape(shape) * x.float() + b.reshape(shape)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).float()


def norm_conv3x3_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, packed: torch.Tensor,
                       conv_bias: torch.Tensor, silu: bool) -> torch.Tensor:
    """The conv kernel's plain version: x (B, C_in, H, W), a/b (B, C_in) f32,
    packed (C_out, 3, 3, C_in), conv_bias (C_out,). f32 products of the
    rounded y and the weight, + bias, one rounding."""
    out = F.conv2d(affine_act(x, a, b, silu), packed.permute(0, 3, 1, 2).float(), conv_bias.float(),
                   padding=1)
    return out.to(x.dtype)


def norm_linear_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, weight: torch.Tensor,
                      lbias: torch.Tensor) -> torch.Tensor:
    """The linear kernel's plain version: x (B, S, C_in), a/b (B, C_in) f32,
    weight (C_out, C_in), lbias (C_out,)."""
    y = (a[:, None, :] * x.float() + b[:, None, :]).to(x.dtype).float()
    return F.linear(y, weight.float(), lbias.float()).to(x.dtype)


# ---------------------------------------------------------------- the conv kernel's plan

CONV_CHUNK = 64        # channels per K chunk of norm_conv3x3 (one 128-byte weight row)
CONV_BLOCK_PIXELS = 128
# (patch width, patch height, patches a block) by the map's width: 128 pixels a block
_PATCHES = ((8, (16, 8, 1)), (4, (8, 8, 2)), (0, (4, 4, 8)))


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How norm_conv3x3 cuts one shape: `patch` (TW, TH) pixels, `patches`
    of them a block (128 output pixels), `bn` output channels a block, and
    `split` slices of the `chunks` 64-channel chunks of K, one slice per
    blockIdx.z; `m` = B·H·W output pixels."""
    patch: Tuple[int, int]
    patches: int
    bn: int
    split: int
    chunks: int
    m_tiles: int
    n_tiles: int
    m: int
    cin: int
    cout: int

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles * self.split

    @property
    def slices(self) -> Tuple[Tuple[int, int], ...]:
        """The input channels [lo, hi) of each K slice, in slice order (the
        kernel's k_lo = z·chunks / split, k_hi = (z + 1)·chunks / split)."""
        out = []
        for z in range(self.split):
            lo, hi = z * self.chunks // self.split, (z + 1) * self.chunks // self.split
            out.append((lo * CONV_CHUNK, min(hi * CONV_CHUNK, self.cin)))
        return tuple(out)

    @property
    def workspace_shape(self) -> Optional[Tuple[int, int, int]]:
        """(split, B·H·W, C_out) f32 partial sums, or None when unsplit."""
        return (self.split, self.m, self.cout) if self.split > 1 else None

    @property
    def workspace_bytes(self) -> int:
        return 4 * self.split * self.m * self.cout if self.split > 1 else 0


def conv_plan(b: int, h: int, w: int, cin: int, cout: int) -> ConvPlan:
    """The plan of norm_conv3x3 for x (B, C_in, H, W) and C_out outputs.

    * patches: 8×16 pixels at maps wider than 8, two of 8×8 at 5-8, eight of
      4×4 below (a block at a 4×4 map spans eight images);
    * bn = 160 output channels (every C_out of the SD-2.1 U-Net is a
      multiple), 8 at C_out <= 8 (the output head);
    * where M tiles × N tiles leaves at least half of the 132 SMs idle (the
      8×8 and 4×4 maps), the channel chunks of K (never the taps) are split
      into as many slices as still fit in one wave (one block a SM: a block
      takes 130-170 KB of shared memory), at most one chunk a slice. Measured
      on the H100 (`PERF.md` §6), one full wave beats every split that spills
      into a second, and a grid of 128-256 blocks runs faster unsplit. A
      split needs C_out % 4 == 0 (the reduction's four-column stores)."""
    tw, th, npatch = next(p for wmin, p in _PATCHES if w > wmin)
    patches = b * -(-h // th) * -(-w // tw)
    m_tiles = -(-patches // npatch)
    bn = 8 if cout <= 8 else 160
    n_tiles = -(-cout // bn)
    chunks = -(-cin // CONV_CHUNK)
    base = m_tiles * n_tiles
    split = max(1, min(chunks, SM_COUNT // base)) if cout % 4 == 0 else 1
    return ConvPlan(patch=(tw, th), patches=npatch, bn=bn, split=split, chunks=chunks,
                    m_tiles=m_tiles, n_tiles=n_tiles, m=b * h * w, cin=cin, cout=cout)


def conv_workspace(plan: ConvPlan, device: torch.device) -> Optional[torch.Tensor]:
    """The f32 workspace of a split plan (uninitialised: every element is
    written by its slice), None when unsplit."""
    shape = plan.workspace_shape
    return None if shape is None else torch.empty(shape, device=device, dtype=torch.float32)


def _check_operands(x, a, b, weight, w_shape, out_bias, cin, cout):
    if cin % 8:
        raise ValueError(f"the kernel takes C_in % 8 == 0, got {cin}")
    for name, t in (("a", a), ("b", b)):
        if t.shape != (x.shape[0], cin) or t.dtype != torch.float32 or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 (B, C_in) = ({x.shape[0]}, "
                             f"{cin}) on {x.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if tuple(weight.shape) != w_shape:
        raise ValueError(f"weight must be {w_shape}, got {tuple(weight.shape)}")
    if weight.device != x.device:
        raise ValueError(f"weight is on {weight.device}, x on {x.device}")
    check_activation("weight", weight, channels_last=False)
    check_vector("bias", out_bias, cout, x.device)


def norm_conv3x3(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, packed: torch.Tensor,
                 conv_bias: torch.Tensor, silu: bool) -> torch.Tensor:
    """The conv kernel's wrapper. x: (B, C_in, H, W) channels_last; a, b:
    (B, C_in) f32; packed: (C_out, 3, 3, C_in) in x's dtype; conv_bias:
    (C_out,) f32. Returns (B, C_out, H, W) channels_last. CPU tensors run
    `norm_conv3x3_plain`; CUDA tensors launch norm_conv3x3 under
    `conv_plan` (counted in `.launches`), and with a split plan
    `conv_split_reduce` after it, or raise."""
    if x.device.type == "cpu":
        return norm_conv3x3_plain(x, a, b, packed, conv_bias, silu)
    build.require_cuda(x)
    if x.dim() != 4:
        raise ValueError("x must be (B, C, H, W)")
    bsz, cin, h, w = x.shape
    cout = packed.shape[0]
    check_activation("x", x, channels_last=True)
    _check_operands(x, a, b, packed, (cout, 3, 3, cin), conv_bias, cin, cout)
    out = torch.empty((bsz, cout, h, w), device=x.device, dtype=x.dtype,
                      memory_format=torch.channels_last)
    plan = conv_plan(bsz, h, w, cin, cout)
    ws = conv_workspace(plan, x.device)
    build.launch("norm_conv3x3", x.device, x.data_ptr(), a.data_ptr(), b.data_ptr(),
                 packed.data_ptr(), conv_bias.data_ptr(), out.data_ptr(), build.ptr(ws), bsz,
                 h, w, cin, cout, int(silu), plan.patch[0], plan.bn, plan.split)
    norm_conv3x3.launches += 1
    if ws is not None:
        conv_split_reduce(ws, conv_bias, out)
    return out


def conv_split_reduce_plain(ws: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype
                            ) -> torch.Tensor:
    """The reduction kernel's plain version: the (split, M, C_out) f32
    partial sums added in slice order, + bias in f32, rounded once; (M, C_out)."""
    total = ws[0].clone()
    for part in ws[1:]:
        total += part
    return (total + bias.float()).to(dtype)


def conv_split_reduce(ws: torch.Tensor, bias: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The reduction kernel's wrapper, the second launch of a split plan:
    out (B, C_out, H, W) channels_last ← Σ_s ws[s] + bias, the slices added in
    order (deterministic). ws: (split, B·H·W, C_out) f32. CPU tensors run
    `conv_split_reduce_plain`; CUDA tensors launch conv_split_reduce (counted
    in `.launches`) or raise."""
    split, m, cout = ws.shape
    if out.shape[0] * out.shape[2] * out.shape[3] != m or out.shape[1] != cout:
        raise ValueError(f"out {tuple(out.shape)} does not hold the workspace's {m} × {cout}")
    if ws.device.type == "cpu":
        nhwc = out.permute(0, 2, 3, 1)
        nhwc.copy_(conv_split_reduce_plain(ws, bias, out.dtype).view(nhwc.shape))
        return out
    build.require_cuda(ws)
    if ws.dtype != torch.float32 or not ws.is_contiguous() or ws.data_ptr() % 16 or cout % 4:
        raise ValueError("ws must be contiguous 16-byte aligned float32 with C_out % 4 == 0")
    check_activation("out", out, channels_last=True)
    check_vector("bias", bias, cout, ws.device)
    build.launch("conv_split_reduce", ws.device, ws.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 m, cout, split)
    conv_split_reduce.launches += 1
    return out


def norm_linear(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, weight: torch.Tensor,
                lbias: torch.Tensor) -> torch.Tensor:
    """The linear kernel's wrapper. x: (B, S, C_in) contiguous; a, b:
    (B, C_in) f32; weight: (C_out, C_in) in x's dtype; lbias: (C_out,) f32.
    CPU tensors run `norm_linear_plain`; CUDA tensors launch norm_linear
    (counted in `.launches`) or raise."""
    if x.device.type == "cpu":
        return norm_linear_plain(x, a, b, weight, lbias)
    build.require_cuda(x)
    if x.dim() != 3:
        raise ValueError("x must be (B, S, C)")
    bsz, s, cin = x.shape
    cout = weight.shape[0]
    check_activation("x", x, channels_last=False)
    _check_operands(x, a, b, weight, (cout, cin), lbias, cin, cout)
    out = torch.empty((bsz, s, cout), device=x.device, dtype=x.dtype)
    build.launch("norm_linear", x.device, x.data_ptr(), a.data_ptr(), b.data_ptr(),
                 weight.data_ptr(), lbias.data_ptr(), out.data_ptr(), bsz, s, cin, cout)
    norm_linear.launches += 1
    return out


norm_conv3x3.launches = 0
conv_split_reduce.launches = 0
norm_linear.launches = 0


# ---------------------------------------------------------------- unfused compositions

def _gated_group_norm(x, scale, bias, gate_c, groups, eps):
    """GroupNorm in f32 of gate·x (two-pass variance), affine, in f32."""
    xf = x.float()
    if gate_c is not None:
        xf = xf * gate_c.float().reshape(gate_c.shape + (1,) * (x.dim() - 2))
    return F.group_norm(xf, groups, scale.float(), bias.float(), eps)


def norm_conv_unfused(x, scale, bias, weight, conv_bias, gate_c, groups, eps, silu):
    """gate → GroupNorm (f32) → SiLU → cast → conv3x3 in x's dtype → + bias in
    f32: the composition the backward differentiates, and what the fused op
    must match. x: (B, C_in, H, W); weight: (C_out, C_in, 3, 3)."""
    y = _gated_group_norm(x, scale, bias, gate_c, groups, eps)
    if silu:
        y = F.silu(y)
    out = F.conv2d(y.to(x.dtype), weight.to(x.dtype), None, padding=1)
    return (out.float() + conv_bias.float()[None, :, None, None]).to(x.dtype)


def norm_linear_unfused(x, scale, bias, weight, lbias, gate_c, groups, eps):
    """gate → GroupNorm (f32, no SiLU) → cast → linear in x's dtype → + bias
    in f32. x: (B, S, C_in) tokens; weight: (C_out, C_in)."""
    xc = x.transpose(1, 2)                                   # (B, C, S)
    y = _gated_group_norm(xc, scale, bias, gate_c, groups, eps).transpose(1, 2)
    out = F.linear(y.to(x.dtype), weight.to(x.dtype))
    return (out.float() + lbias.float()).to(x.dtype)


# ---------------------------------------------------------------- public ops

class GroupNormSiLUConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, weight, conv_bias, gate_c, packed, groups, eps, silu):
        ctx.save_for_backward(x, scale, bias, weight, conv_bias, gate_c)
        ctx.static = (groups, eps, silu)
        a, b = affine_coeffs(x, scale, bias, groups, eps, gate_c)
        return norm_conv3x3(x, a, b, packed, conv_bias.float(), silu)

    @staticmethod
    def backward(ctx, grad_out):
        static = ctx.static
        grads = recompute_grads(lambda *args: norm_conv_unfused(*args, *static),
                                ctx.saved_tensors, ctx.needs_input_grad[:6], grad_out)
        return (*grads, None, None, None, None)


class GroupNormLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, weight, lbias, gate_c, groups, eps):
        ctx.save_for_backward(x, scale, bias, weight, lbias, gate_c)
        ctx.static = (groups, eps)
        a, b = affine_coeffs(x.transpose(1, 2), scale, bias, groups, eps, gate_c)
        return norm_linear(x, a, b, weight.to(x.dtype), lbias.float())

    @staticmethod
    def backward(ctx, grad_out):
        static = ctx.static
        grads = recompute_grads(lambda *args: norm_linear_unfused(*args, *static),
                                ctx.saved_tensors, ctx.needs_input_grad[:6], grad_out)
        return (*grads, None, None)


def group_norm_silu_conv3x3(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                            weight: torch.Tensor, conv_bias: torch.Tensor,
                            gate_c: Optional[torch.Tensor], groups: int, eps: float = 1e-5,
                            silu: bool = True, *, packed: PackedWeight) -> torch.Tensor:
    """conv3x3(silu(GroupNorm(gate·x))) in one input pass.

    x: logical (B, C_in, H, W), any strides (made channels_last, the JAX op's
    NHWC); scale/bias: (C_in,) GroupNorm affine; weight: (C_out, C_in, 3, 3)
    as `nn.Conv2d` holds it; conv_bias: (C_out,); gate_c: optional (B, C_in)
    per-channel gate, already group-expanded and CFG-tiled; packed: the
    holder of the weight's packed copy, kept by the caller beside the weight
    so that the copy is made once and not on every call. Returns
    (B, C_out, H, W) in x's dtype, channels_last. Differentiable in every
    tensor argument."""
    x = x.contiguous(memory_format=torch.channels_last)
    return GroupNormSiLUConv3x3.apply(x, scale, bias, weight, conv_bias, gate_c,
                                      packed.get(weight, x.dtype), groups, eps, silu)


def group_norm_linear(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      weight: torch.Tensor, lbias: torch.Tensor,
                      gate_c: Optional[torch.Tensor], groups: int, eps: float = 1e-6
                      ) -> torch.Tensor:
    """proj(GroupNorm(gate·x)) in one input pass (no SiLU).

    x: (B, S, C_in) tokens (made contiguous); weight: (C_out, C_in) as
    `nn.Linear` holds it (the JAX op takes its transpose); lbias: (C_out,).
    Returns (B, S, C_out) in x's dtype. Differentiable in every tensor
    argument."""
    return GroupNormLinear.apply(x.contiguous(), scale, bias, weight, lbias, gate_c, groups, eps)
