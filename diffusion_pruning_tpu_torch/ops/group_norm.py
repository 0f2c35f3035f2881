"""One-pass GroupNorm (+ optional SiLU): the hand-written Hopper kernel, its
wrapper, its plain PyTorch version, the launch counter and the autograd
Function that makes it trainable.

`group_norm_silu(x, scale, bias, groups, eps, silu)` is the counterpart of
the JAX package's `ops/group_norm.py:group_norm_silu` (same argument order),
whose Pallas body `_gn_kernel` the kernel in `csrc/group_norm.cu` replaces:
statistics over each (batch, group) slab in f32, affine, optional SiLU, one
read and one write of the activation.

Layout. The JAX kernel is NHWC. Here x is a logical (B, C, H, W) tensor in
`torch.channels_last` strides, which is the same memory; an input in other
strides is converted first (one extra pass), and the result is channels_last.
The U-Net converts once after `conv_in` when a fused flag is set, so that no
call converts.

A CPU tensor takes the plain version `group_norm_silu_plain`, which follows
the JAX body's arithmetic (E[x²] − mean² in f32). A CUDA tensor must be bf16
and goes to the kernel or raises. The kernel centres the slab on chip before
it takes the variance, which is at least as accurate as that formula. Its
plan, `group_norm_plan`, cuts each (batch, group) slab into channel windows
of whole groups and splits each window's rows over a thread-block cluster.

The backward recomputes through the unfused composition
(`group_norm_silu_unfused`: F.group_norm, then F.silu) under autograd, as the
JAX op's custom_vjp recomputes through its reference; there is no backward
kernel on either side.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from diffusion_pruning_tpu_torch.ops import build
from diffusion_pruning_tpu_torch.ops.build import SM_COUNT


def group_norm_silu_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          groups: int, eps: float, silu: bool) -> torch.Tensor:
    """The kernel's plain version. x: (B, C, *spatial); f32 statistics per
    (batch, group) with var = E[x²] − mean², as the JAX body computes them."""
    b, c = x.shape[:2]
    xg = x.float().reshape(b, groups, c // groups, -1)
    mean = xg.mean(dim=(2, 3), keepdim=True)
    var = (xg * xg).mean(dim=(2, 3), keepdim=True) - mean * mean
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    y = y * scale.float().reshape(shape) + bias.float().reshape(shape)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_silu_unfused(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                            groups: int, eps: float, silu: bool) -> torch.Tensor:
    """GroupNorm in f32 (two-pass variance), affine, optional SiLU, cast back:
    the composition the backward differentiates."""
    y = F.group_norm(x.float(), groups, scale.float(), bias.float(), eps)
    if silu:
        y = F.silu(y)
    return y.to(x.dtype)


def check_activation(name: str, x: torch.Tensor, channels_last: bool) -> None:
    """What every fused-norm kernel asks of its activation: bf16, dense in the
    layout it reads, 16-byte aligned."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernels take bfloat16 tensors, got {name} {x.dtype}")
    dense = (x.is_contiguous(memory_format=torch.channels_last) if channels_last
             else x.is_contiguous())
    if not dense:
        raise ValueError(f"{name} must be {'channels_last' if channels_last else 'contiguous'}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def check_vector(name: str, t: torch.Tensor, n: int, device: torch.device) -> None:
    if t.shape != (n,) or t.dtype != torch.float32 or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32 ({n},) on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


GN_MAX_GROUPS = 256          # groups a window holds at most
GN_SMEM_LIMIT = 232448       # 227 KB of shared memory a block may take
GN_CLUSTERS = (1, 2, 4, 8)   # blocks a slab, the portable cluster sizes
GN_MAX_BOX = 256             # TMA box dimensions
GN_BIG_PART = 64 * 1024      # a block holding this much of its slab runs 512 threads, else 256
GN_TMA_PART = 40 * 1024      # a block holding more of its slab reads it by TMA, else by loads
GN_AIM_PART = 48 * 1024      # the part of a slab a block best holds
STASH_NONE, STASH_TMA, STASH_LOADS = 0, 1, 2  # the kernel's `stash` argument


def _box_stride(window: int, box_rows: int) -> int:
    return -(-box_rows * window * 2 // 128) * 128


def gn_smem_bytes(window: int, rows: int, box_rows: int, stash: bool, threads: int) -> int:
    """Shared memory of one block, as the kernel lays it out
    (`smem_bytes` in csrc/group_norm.cu)."""
    boxes = -(-rows // box_rows) if stash else 0
    return (128 + boxes * _box_stride(window, box_rows)
            + (threads * 8 + -(-window // 32) * 32 + 4 * GN_MAX_GROUPS) * 4 + boxes * 8)


def _threads(rows: int, window: int) -> int:
    return 512 if rows * window * 2 >= GN_BIG_PART else 256


@dataclasses.dataclass(frozen=True)
class GroupNormPlan:
    """How group_norm_silu cuts x (B, HW, C): a block owns `window` channels
    (`groups_per_window` whole groups, read `vec` channels a load) of `rows`
    pixel rows of one batch element; the `cluster` blocks of a thread-block
    cluster split one (batch, window) slab's HW rows and exchange their
    group sums through distributed shared memory; `threads` a block.
    `one_read`: each block keeps its rows in shared memory (in blocks of
    `box_rows` rows; by TMA boxes where `tma`, else by pass 1's 16-byte
    loads), so x is read from device memory once; else it is read in each of
    three passes."""
    b: int
    hw: int
    c: int
    groups: int
    window: int
    groups_per_window: int
    vec: int
    cluster: int
    rows: int
    box_rows: int
    one_read: bool
    threads: int
    tma: bool

    @property
    def stash(self) -> int:
        """The kernel's `stash` argument."""
        if not self.one_read:
            return STASH_NONE
        return STASH_TMA if self.tma else STASH_LOADS

    @property
    def windows(self) -> int:
        return self.c // self.window

    @property
    def ctas(self) -> int:
        return self.b * self.windows * self.cluster

    @property
    def boxes(self) -> int:
        return -(-self.rows // self.box_rows) if self.one_read else 0

    @property
    def smem_bytes(self) -> int:
        return gn_smem_bytes(self.window, self.rows, self.box_rows, self.one_read, self.threads)

    def row_ranges(self):
        """The rows [lo, hi) of each block of a cluster, by rank (the
        kernel's r0 = rank·rows; the last blocks may hold fewer or none)."""
        return tuple((min(self.hw, q * self.rows), min(self.hw, (q + 1) * self.rows))
                     for q in range(self.cluster))


def _rows(hw: int, cluster: int):
    """Rows a block and rows a box: the slab's rows split evenly over the
    cluster, in whole boxes of at most 256 rows."""
    rows = -(-hw // cluster)
    boxes = -(-rows // GN_MAX_BOX)
    box_rows = -(-rows // boxes)
    return boxes * box_rows, box_rows


def group_norm_plan(b: int, hw: int, c: int, groups: int) -> GroupNormPlan:
    """The plan of group_norm_silu for x (B, HW, C) in `groups` groups.

    * windows: whole groups (dividing G) whose channels are a multiple of 8
      (16 bytes, the TMA row and 16-byte loads) and at most 256 (a TMA box
      dimension): multiples of 40 channels at C/G = 10, 20 and 40, of 80 at
      80, of 120 at 30 and 60;
    * of the windows and clusters (1, 2, 4, 8 blocks a slab) whose rows fit
      a block's 227 KB of shared memory: one that gives every SM a block
      where any does, then the smallest cluster (a cluster's blocks wait for
      each other twice), then the window whose part of a slab is nearest
      48 KB (small maps want wide windows: a block's fixed costs); 512
      threads a block where it holds 64 KB or more, else 256; TMA boxes where
      it holds more than 40 KB, else pass 1's 16-byte loads. Measured on the
      H100 (`PERF.md` §6, `scripts/torch_port/fused_norm_probe.py`);
    * where no window exists (a group of more than 256 channels, or one
      that no whole number of groups makes a multiple of 8), one group a
      block, read with the widest vector that divides it, from device memory
      in every pass; likewise a slab that no cluster holds (then the fewest
      blocks a slab that give every SM one)."""
    cg = c // groups
    wgs = [k for k in range(1, groups + 1)
           if groups % k == 0 and k * cg % 8 == 0 and k * cg <= GN_MAX_BOX]

    def fits(k, cl):
        rows, box_rows = _rows(hw, cl)
        return gn_smem_bytes(k * cg, rows, box_rows, True,
                             _threads(rows, k * cg)) <= GN_SMEM_LIMIT

    held = [(k, cl) for k in wgs for cl in GN_CLUSTERS if fits(k, cl)]
    if held:
        def key(kc):
            part = _rows(hw, kc[1])[0] * kc[0] * cg * 2
            fills = b * (groups // kc[0]) * kc[1] >= SM_COUNT
            return not fills, kc[1], abs(math.log(part / GN_AIM_PART))
        wg, cluster = min(held, key=key)
        vec, one_read = 8, True
    else:
        wg = wgs[0] if wgs else 1
        vec = 8 if wgs else next(v for v in (8, 4, 2, 1) if cg % v == 0)
        slabs = b * (groups // wg)
        cluster = next((k for k in GN_CLUSTERS if slabs * k >= SM_COUNT), GN_CLUSTERS[-1])
        one_read = False
    rows, box_rows = _rows(hw, cluster)
    return GroupNormPlan(b=b, hw=hw, c=c, groups=groups, window=wg * cg, groups_per_window=wg,
                         vec=vec, cluster=cluster, rows=rows, box_rows=box_rows,
                         one_read=one_read, threads=_threads(rows, wg * cg),
                         tma=one_read and rows * wg * cg * 2 > GN_TMA_PART)


def group_norm_silu_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                            groups: int, eps: float, silu: bool) -> torch.Tensor:
    """The kernel's wrapper. x: (B, C, H, W) channels_last, scale/bias: (C,)
    f32. CPU tensors run `group_norm_silu_plain`; CUDA tensors launch
    group_norm_silu under `group_norm_plan` (counted in `.launches`) or
    raise."""
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, scale, bias, groups, eps, silu)
    build.require_cuda(x)
    if x.dim() != 4:
        raise ValueError("x must be (B, C, H, W)")
    b, c, h, w = x.shape
    if c % groups:
        raise ValueError(f"{c} channels do not divide into {groups} groups")
    check_activation("x", x, channels_last=True)
    check_vector("scale", scale, c, x.device)
    check_vector("bias", bias, c, x.device)
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the grid limit 65535")
    plan = group_norm_plan(b, h * w, c, groups)
    out = torch.empty_like(x)  # keeps the channels_last strides
    build.launch("group_norm_silu", x.device, x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), b, h * w, c, groups, eps, int(silu), plan.window, plan.cluster,
                 plan.rows, plan.box_rows, plan.stash, plan.threads)
    group_norm_silu_forward.launches += 1
    return out


group_norm_silu_forward.launches = 0


def recompute_grads(fn, args, needs, grad_out):
    """Gradients of `fn(*args)` for the tensor args that `needs` marks, by
    running it again under autograd; None elsewhere. The backward of every
    fused-norm Function. The activation (the first arg) is differentiated
    whether asked for or not: PyTorch's CPU GroupNorm backward (2.13) crashes
    on a channels_last input that needs no gradient while scale or bias do."""
    taken = (True,) + tuple(needs[1:])
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_() if take else a for a, take in zip(args, taken)]
        out = fn(*leaves)
        wanted = [leaf for leaf, take in zip(leaves, taken) if take]
        grads = iter(torch.autograd.grad(out, wanted, grad_out.to(out.dtype)))
    found = [next(grads) if take else None for take in taken]
    return tuple(g if need else None for g, need in zip(found, needs))


class GroupNormSiLU(torch.autograd.Function):
    """The fused forward with the unfused composition's gradients for x, scale
    and bias."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.static = (groups, eps, silu)
        return group_norm_silu_forward(x, scale.float(), bias.float(), groups, eps, silu)

    @staticmethod
    def backward(ctx, grad_out):
        static = ctx.static
        grads = recompute_grads(lambda *a: group_norm_silu_unfused(*a, *static),
                                ctx.saved_tensors, ctx.needs_input_grad[:3], grad_out)
        return (*grads, None, None, None)


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5, silu: bool = True) -> torch.Tensor:
    """One-pass fused GroupNorm (+ optional SiLU).

    x: logical (B, C, H, W), any strides (made channels_last, the JAX op's
    NHWC); scale, bias: (C,) in any float dtype. Returns x's dtype,
    channels_last. Differentiable in x, scale and bias."""
    x = x.contiguous(memory_format=torch.channels_last)
    return GroupNormSiLU.apply(x, scale, bias, groups, eps, silu)
