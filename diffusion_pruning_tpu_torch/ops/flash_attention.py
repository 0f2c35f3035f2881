"""Head-gated flash attention forward: the hand-written Hopper kernel, its
wrapper, its plain PyTorch version and its launch counter.

With gate g per (batch, head),

    masked SDPA(q·g, k·g, v·g) == softmax(q·kᵀ · d^-½ · g²) · v · g

so the kernel (csrc/gated_flash_fwd.cu) scales the logits by g² and the
output by g. It replaces all four inference forwards of the JAX package's
Pallas flash attention; see the note at the top of the CUDA source.

The kernel is compiled with nvcc for sm_90a at first use, into
`build/torch_kernels/` of the checkout, and loaded with ctypes. A CPU tensor
goes to the plain version; a CUDA tensor goes to the kernel or raises. The
kernel takes bf16 q/k/v, the dtype the U-Net runs in on the card; its checks
hold it against the plain version in f32 on the same bf16 inputs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "gated_flash_fwd.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
HEAD_DIM = 64
_LOG2E = 1.4426950408889634
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError("nvcc not found (set CUDA_HOME); the CUDA kernel is "
                            "built from source at first use")


def _library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{SOURCE.stem}-{digest}.so"


def build_kernel() -> Optional[float]:
    """Compile the kernel source unless an up-to-date library exists. Returns
    the compile's wall seconds, or None when the library was already built.
    The compiler's register/spill report lands in `BUILD_DIR` as
    `<stem>.ptxas.txt`. Raises with the compiler's output if it fails."""
    out = _library_path()
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    (BUILD_DIR / f"{SOURCE.stem}.ptxas.txt").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc exited {proc.returncode} on {SOURCE.name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return seconds


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build_kernel()
        lib = ctypes.CDLL(str(_library_path()))
        lib.gated_flash_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.gated_flash_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    """The kernel's plain version: mask q, k and v per head by the gate (B, H),
    then `plain_attention`."""
    if gate is not None:
        g = gate[:, None, :, None].to(q.dtype)
        q, k, v = q * g, k * g, v * g
    return plain_attention(q, k, v)


def _check(q, k, v, gate):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, D)")
    b, s_q, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"head dim {d} not supported (kernel is built for {HEAD_DIM})")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if (q.dtype, k.dtype, v.dtype) != (torch.bfloat16,) * 3:
        raise TypeError(f"the CUDA kernel takes bfloat16 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
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


def gated_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q·kᵀ·d^-½·g²)·v·g per (batch, head).

    q: (B, S_q, H, 64), k/v: (B, S_kv, H, 64); gate: (B, H) f32 or None.
    CPU tensors (any float dtype) run the plain version; CUDA tensors must be
    bf16 and launch the kernel on the current stream (counted in
    `.launches`)."""
    if q.device.type == "cpu":
        return gated_attention_reference(q, k, v, gate)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, gate)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, gate)):
        raise NotImplementedError("the gated flash kernel has no backward yet; run it "
                                  "under torch.no_grad() or torch.inference_mode()")
    b, s_q, h, d = q.shape
    o = torch.empty_like(q)
    fn = _library().gated_flash_fwd
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                gate.data_ptr() if gate is not None else None, o.data_ptr(),
                b, h, s_q, k.shape[1], d ** -0.5 * _LOG2E,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gated_flash_fwd launch failed: cudaError {rc}")
    gated_flash_attention.launches += 1
    return o


gated_flash_attention.launches = 0

