"""Build and load the port's CUDA kernels.

Each source under `csrc/` is compiled with nvcc for sm_90a at first use into
`build/torch_kernels/` of the checkout (all sources at once, one nvcc each)
and loaded with ctypes. A library's file name carries a hash of its source,
the shared headers and the compiler flags, so an edit rebuilds it. No
library links against the driver (libcuda): the kernels that take TMA tensor
maps find `cuTensorMapEncodeTiled` in the already-loaded driver with dlsym
(`csrc/sm90_common.cuh`; hence `-ldl`).

`SIGNATURES` lists every C entry point with the source that holds it;
`launch` calls one on PyTorch's current stream and raises on a refused
launch. The wrappers in `ops/flash_attention.py`, `ops/group_norm.py` and
`ops/norm_conv.py` go through it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = tuple(CSRC / f"{stem}.cu" for stem in (
    "gated_flash_fwd", "gated_flash_bwd", "group_norm", "norm_conv"))
HEADERS = (CSRC / "sm90_common.cuh",)
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SM_COUNT = 132  # H100 SXM: the kernels' plans size their grids for it
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-ldl")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
SIGNATURES = {  # C function -> (source stem, argtypes); the stream comes last
    "gated_flash_fwd_wgmma": ("gated_flash_fwd", [_P] * 6 + [_I] * 5 + [_F, _P]),
    "gated_flash_fwd_small": ("gated_flash_fwd", [_P] * 6 + [_I] * 6 + [_F, _P]),
    "gated_flash_bwd_fused": ("gated_flash_bwd", [_P] * 12 + [_I] * 6 + [_F, _P]),
    "gated_flash_bwd_reduce": ("gated_flash_bwd", [_P] * 3 + [_I, _L, _P]),
    "gated_flash_bwd_dq": ("gated_flash_bwd", [_P] * 10 + [_I] * 6 + [_F, _P]),
    "gated_flash_bwd_dkv": ("gated_flash_bwd", [_P] * 9 + [_I] * 6 + [_F, _P]),
    "group_norm_silu": ("group_norm", [_P] * 4 + [_I] * 4 + [_F] + [_I] * 7 + [_P]),
    "norm_conv3x3": ("norm_conv", [_P] * 7 + [_I] * 9 + [_P]),
    "conv_split_reduce": ("norm_conv", [_P] * 3 + [_L, _I, _I, _P]),
    "norm_linear": ("norm_conv", [_P] * 7 + [_I] * 7 + [_P]),
}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                            "built from source at first use")


def _library_path(source: Path) -> Path:
    text = source.read_bytes() + b"".join(h.read_bytes() for h in HEADERS)
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def _compile(source: Path) -> Optional[float]:
    out = _library_path(source)
    if out.exists():
        return None
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    (BUILD_DIR / f"{source.stem}.ptxas.txt").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc exited {proc.returncode} on {source.name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return seconds


def build_kernels() -> Dict[str, Optional[float]]:
    """Compile every kernel source that has no up-to-date library, one nvcc
    per source, all started together. Returns each source's compile wall
    seconds (None where the library was already built). The compiler's
    register/spill report lands in `BUILD_DIR` as `<stem>.ptxas.txt`. Raises
    with the compiler's output if a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        seconds = list(pool.map(_compile, SOURCES))
    return {s.stem: t for s, t in zip(SOURCES, seconds)}


def _fn(name: str):
    """The C entry point `name`, its library built and loaded at first use."""
    if name not in _fns:
        stem, argtypes = SIGNATURES[name]
        build_kernels()
        fn = getattr(ctypes.CDLL(str(_library_path(CSRC / f"{stem}.cu"))), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point `name` with `args` and the current stream of
    `device`, with `device` current for the call; raise if the launch was
    refused. It makes the calls that `torch.cuda.device` and
    `torch.cuda.current_stream` make, without building their Python
    objects: at the small attention shapes a wrapper's call is paced by the
    host, and those objects were half of it (`--host-cost` of
    scripts/torch_port/small_attention_probe.py)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    previous = torch.cuda._exchange_device(index)
    try:
        rc = _fn(name)(*args, torch._C._cuda_getCurrentRawStream(index))
    finally:
        torch.cuda._maybe_exchange_device(previous)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()
