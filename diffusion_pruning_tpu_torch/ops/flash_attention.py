"""Head-gated flash attention: the hand-written Hopper kernels, their
wrappers, their plain PyTorch versions, launch counters and the autograd
Function that joins them for training.

With gate g per (batch, head),

    masked SDPA(q·g, k·g, v·g) == softmax(q·kᵀ · d^-½ · g²) · v · g

so the kernels scale the logits by g² and the output by g. Four kernels, two
sources in `csrc/`:

* the forward (gated_flash_fwd.cu) replaces all four inference forwards of
  the JAX package's Pallas flash attention; with an lse output it is also
  the training forward (f32 log-sum-exp of each row's logits, natural log).
  It is two kernels, chosen by the query length: `gated_flash_fwd_wgmma`
  (wgmma, K/V by TMA, 128 query rows a block) at S_q > SMALL_Q_ROWS, and the
  first version `gated_flash_fwd` (mma.sync, 64 rows a block) at
  S_q <= SMALL_Q_ROWS, where a 128-row tile would leave most rows idle;
* `gated_flash_bwd_dq` and `gated_flash_bwd_dkv` (gated_flash_bwd.cu) replace
  the four Pallas backward bodies: dq, dk, dv, and dgate[b, h] =
  Σ dq'∘q + Σ dk'∘k + Σ dv'∘v, summed here from per-block partials.

`gated_flash_attention` is the entry point. Without a gradient to take it runs
the lse-free forward; when q, k, v or the gate requires grad it runs
`GatedFlashAttention`, whose forward saves (q, k, v, gate, o, lse) and whose
backward runs the dq kernel, then the dk/dv kernel. A CPU tensor takes the
plain versions (`gated_attention_reference`, `gated_attention_reference_lse`,
`gated_flash_backward_reference`); a CUDA tensor goes to the kernels or
raises. On the card the kernels take bf16 q/k/v, the dtype the U-Net runs in;
their checks hold them against the plain versions in f32 on the same inputs.

The sources are compiled and loaded at first use by `ops/build.py`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from diffusion_pruning_tpu_torch.ops import build
from diffusion_pruning_tpu_torch.ops.build import ptr as _ptr
from diffusion_pruning_tpu_torch.ops.build import require_cuda as _device

HEAD_DIM = 64
TILE = 64  # rows per tile of the mma.sync kernels, queries and kv alike
SMALL_Q_ROWS = 64  # the forward runs the mma.sync kernel at S_q <= this, wgmma above
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


def gated_flash_backward_reference(q, k, v, gate, o, lse, do):
    """The backward kernels' plain version, their formulas in f32:
    P = exp(q·kᵀ·d^-½·g² − lse), δ = rowsum(dO∘O), dP = g·dO·vᵀ,
    dS = P∘(dP − δ), dq' = d^-½·g·dS·k, dk' = d^-½·g·dSᵀ·q, dv' = Pᵀ·dO;
    returns (dq, dk, dv) = g·(dq', dk', dv') in q's dtype and
    dgate = Σ dq'∘q + dk'∘k + dv'∘v, (B, H) f32 (None without a gate).
    o, do: (B, S_q, H, D); lse: (B·H, S_q) as the forward gives it."""
    b, s_q, h, d = q.shape
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    g = (gate.float() if gate is not None else q.new_ones(b, h, dtype=torch.float32))
    g4 = g[:, :, None, None]                                    # (B, H, 1, 1)
    p = torch.exp(_gated_logits(q, k, gate) - lse.reshape(b, h, s_q, 1))
    delta = torch.einsum("bqhd,bqhd->bhq", dof, of)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf) * g4
    ds = p * (dp - delta)
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


def forward_kernel(s_q: int) -> str:
    """The forward kernel that runs a query length: `gated_flash_fwd_wgmma`
    above SMALL_Q_ROWS rows, the mma.sync `gated_flash_fwd` at or below."""
    return "gated_flash_fwd_wgmma" if s_q > SMALL_Q_ROWS else "gated_flash_fwd"


def _forward(q, k, v, gate, lse):
    b, s_q, h, d = q.shape
    o = torch.empty_like(q)
    name = forward_kernel(s_q)
    build.launch(name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(gate),
                 o.data_ptr(), _ptr(lse), b, h, s_q, k.shape[1], d ** -0.5 * _LOG2E)
    forward_launches[name] += 1
    return o


def gated_flash_forward_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            gate: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (o, lse (B·H, S_q) f32, natural log). CPU tensors
    run `gated_attention_reference_lse`; CUDA tensors launch the forward
    kernel `forward_kernel` picks, with its lse output (counted in
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


def gated_flash_bwd_dq(q, k, v, gate, o, lse, do):
    """dq kernel: (dq, δ (B·H, S_q) f32, dgate partials (B·H, q tiles) f32 or
    None without a gate). CUDA tensors only, checked; counted in `.launches`."""
    _device(q)
    _check(q, k, v, gate)
    b, s_q, h, d = q.shape
    _check_bf16(q=q, o=o, do=do)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o/do shapes {tuple(o.shape)}/{tuple(do.shape)} differ from q "
                         f"{tuple(q.shape)}")
    _check_rows("lse", lse, b, h, s_q, q.device)
    dq = torch.empty_like(q)
    delta = torch.empty(b * h, s_q, device=q.device, dtype=torch.float32)
    part = None if gate is None else torch.empty(
        b * h, -(-s_q // TILE), device=q.device, dtype=torch.float32)
    build.launch("gated_flash_bwd_dq", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), _ptr(gate), dq.data_ptr(),
            delta.data_ptr(), _ptr(part), b, h, s_q, k.shape[1], d ** -0.5)
    gated_flash_bwd_dq.launches += 1
    return dq, delta, part


def gated_flash_bwd_dkv(q, k, v, gate, lse, delta, do):
    """dk/dv kernel: (dk, dv, dgate partials (B·H, kv tiles) f32 or None
    without a gate). δ from `gated_flash_bwd_dq`. CUDA tensors only, checked;
    counted in `.launches`."""
    _device(q)
    _check(q, k, v, gate)
    b, s_q, h, d = q.shape
    _check_bf16(q=q, do=do)
    if do.shape != q.shape:
        raise ValueError(f"do shape {tuple(do.shape)} differs from q {tuple(q.shape)}")
    _check_rows("lse", lse, b, h, s_q, q.device)
    _check_rows("delta", delta, b, h, s_q, q.device)
    s_kv = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    part = None if gate is None else torch.empty(
        b * h, -(-s_kv // TILE), device=q.device, dtype=torch.float32)
    build.launch("gated_flash_bwd_dkv", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(gate), dk.data_ptr(),
            dv.data_ptr(), _ptr(part), b, h, s_q, s_kv, d ** -0.5)
    gated_flash_bwd_dkv.launches += 1
    return dk, dv, part


def gated_flash_backward(q, k, v, gate, o, lse, do):
    """(dq, dk, dv, dgate) of the gated attention at (q, k, v, gate), given the
    forward's o and lse and the output gradient do; dgate is (B, H) f32, None
    without a gate. CPU tensors run `gated_flash_backward_reference`; CUDA
    tensors the dq kernel, then the dk/dv kernel."""
    if q.device.type == "cpu":
        return gated_flash_backward_reference(q, k, v, gate, o, lse, do)
    dq, delta, part_q = gated_flash_bwd_dq(q, k, v, gate, o, lse, do)
    dk, dv, part_kv = gated_flash_bwd_dkv(q, k, v, gate, lse, delta, do)
    dgate = None
    if gate is not None:
        b, h = gate.shape
        dgate = part_q.view(b, h, -1).sum(-1) + part_kv.view(b, h, -1).sum(-1)
    return dq, dk, dv, dgate


class GatedFlashAttention(torch.autograd.Function):
    """Gated attention with gradients for q, k, v and the gate: the training
    forward (with lse) and the two backward kernels on the card, their plain
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
forward_launches = {"gated_flash_fwd_wgmma": 0, "gated_flash_fwd": 0}
gated_flash_attention.launches = 0
gated_flash_forward_lse.launches = 0
gated_flash_bwd_dq.launches = 0
gated_flash_bwd_dkv.launches = 0
