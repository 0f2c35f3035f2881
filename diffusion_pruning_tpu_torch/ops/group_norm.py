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
it takes the variance, which is at least as accurate as that formula.

The backward recomputes through the unfused composition
(`group_norm_silu_unfused`: F.group_norm, then F.silu) under autograd, as the
JAX op's custom_vjp recomputes through its reference; there is no backward
kernel on either side.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from diffusion_pruning_tpu_torch.ops import build


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


def group_norm_silu_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                            groups: int, eps: float, silu: bool) -> torch.Tensor:
    """The kernel's wrapper. x: (B, C, H, W) channels_last, scale/bias: (C,)
    f32. CPU tensors run `group_norm_silu_plain`; CUDA tensors launch
    group_norm_silu (counted in `.launches`) or raise."""
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
    out = torch.empty_like(x)  # keeps the channels_last strides
    build.launch("group_norm_silu", x.device, x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), b, h * w, c, groups, eps, int(silu))
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
