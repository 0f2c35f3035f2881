#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (`diffusion_pruning_tpu_torch`) on one
CUDA card, from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which passes or ends the run with a non-zero exit:
  1. device     — require CUDA; print the card's name and power limit;
  2. build      — compile the CUDA kernel from `diffusion_pruning_tpu_torch/csrc/`
                  with nvcc into `build/torch_kernels/`;
  3. kernels    — the bf16 kernel against its plain PyTorch version run in f32
                  (TF32 off) on the same bf16 inputs, at the SD-2.1 shapes:
                  relative L2 per (batch, head) <= REL_L2, and two planted
                  faults, emulated in plain torch, must read above that limit;
                  also within atol/rtol 3e-2 of the bf16 plain version;
                  timed beside the plain version, the PyTorch library call and
                  the roofline bound;
  4. unet       — the SD-2.1 U-Net at full width (256px, bf16, B_eff 16, random
                  arch with ~60% of units kept): each of its 32 attention
                  calls held per head against f32 on its own inputs (<= REL_L2),
                  and its output against the same U-Net with f32 attention
                  (<= UNET_REL_L2); a planted fault must read above both
                  limits; 32 launches;
  5. serving    — the routed pipeline (CLIP → MPNet features → hypernet →
                  quantizer → CFG DDIM-25 → VAE decode) with random full-width
                  weights: four calls of 8 prompts at 256px, two of 2 at 512px;
                  800 kernel launches per call, finite images in [0, 1];
  6. profile    — one more 256px call under torch.profiler: stage times, device
                  kernel time by category, the device's busy share;
then a `kernels` JSON line and, last, the device JSON line.

Weights and inputs are random, from fixed seeds. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

SEED = 0
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# per (batch, head) relative L2 of the bf16 kernel against the f32 plain
# version on the same bf16 inputs; see PERF.md for the readings it sits between
REL_L2 = 1e-2
# and against the bf16 plain version, as the JAX package's flash tests hold it
BF16_TOL = 3e-2
# relative L2 of the full-width U-Net's output through the kernel against f32
# attention: any rounding-level change to the attention reads about 0.016
# through the bf16 network, a dropped kv tile about 0.11 (PERF.md)
UNET_REL_L2 = 2e-2
KV_TILE = 64  # the kernel's kv tile, for the planted fault that drops one
STEPS = 25
GUIDANCE = 7.5
# (prompts, resolution) per request; the first request of each resolution
# warms up, the host-clock times of the later ones are summarised
SERVING_CALLS = ((8, 256),) * 4 + ((2, 512),) * 2


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 3

def attention_flops(b: int, h: int, s_q: int, s_kv: int, d: int = 64) -> float:
    """Multiply-adds of QKᵀ and PV, counted as 2 operations each."""
    return 4.0 * b * h * s_q * s_kv * d


def attention_bytes(b: int, h: int, s_q: int, s_kv: int, elem: int, d: int = 64) -> float:
    """q, k and v read once and o written once."""
    return float(b * h * d * elem * (2 * s_q + 2 * s_kv))


def attention_cases():
    """(label, B_eff, S_q, S_kv, H, sites per 256px U-Net forward)."""
    cases = []
    for s, h, n in ((1024, 5, 5), (256, 10, 5), (64, 20, 5), (16, 20, 1)):
        cases.append(("256px", 16, s, s, h, n))
        cases.append(("256px", 16, s, 77, h, n))
    for s, h in ((4096, 5), (1024, 10), (256, 20), (64, 20)):
        cases.append(("512px", 4, s, s, h, 0))
        cases.append(("512px", 4, s, 77, h, 0))
    cases.append(("expert_h3", 16, 1024, 1024, 3, 0))
    cases.append(("expert_h3", 16, 1024, 77, 3, 0))
    return cases


def reference_f32(q, k, v, gate):
    """The plain version in f32 on the given (bf16) inputs, returned in f32."""
    from diffusion_pruning_tpu_torch.ops.flash_attention import gated_attention_reference
    return gated_attention_reference(q.float(), k.float(), v.float(), gate)


def planted_fault(q, k, v, gate, fault):
    """What a kernel with one fault would return, emulated in plain torch
    (f32), to show that the checks' limits catch it: `drop_last_kv_tile`
    leaves out the last 64-row kv tile (None when there is only one);
    `gate_once` scales the logits by g instead of g²."""
    from diffusion_pruning_tpu_torch.ops.flash_attention import plain_attention
    if fault == "drop_last_kv_tile":
        keep = (k.shape[1] - 1) // KV_TILE * KV_TILE
        return reference_f32(q, k[:, :keep], v[:, :keep], gate) if keep else None
    g = gate[:, None, :, None]
    return plain_attention(q.float() * g, k.float(), v.float() * g)


def per_head_rel_l2(out, ref):
    """||out - ref|| / ||ref|| for each (batch, head) of (B, S, H, D) tensors;
    0 where both are 0 (a closed gate)."""
    err = (out.float() - ref).square().sum(dim=(1, 3)).sqrt()
    return err / ref.square().sum(dim=(1, 3)).sqrt().clamp_min(1e-30)


def check_attention_kernel(device):
    import torch
    import torch.nn.functional as F
    from diffusion_pruning_tpu_torch.ops.flash_attention import (
        gated_attention_reference, gated_flash_attention)

    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = []
    worst = {"max_abs_err": 0.0, "rel_l2_worst_head": 0.0}
    least_fault = math.inf
    for label, b, s_q, s_kv, h, sites in attention_cases():
        q, k, v = (torch.randn(b, s, h, 64, device=device, generator=gen).bfloat16()
                   for s in (s_q, s_kv, s_kv))
        soft = torch.rand(b, h, device=device, generator=gen)
        hard = (torch.rand(b, h, device=device, generator=gen) < 0.6).float()
        for gate_name, gate in (("none", None), ("soft", soft), ("hard", hard)):
            out = gated_flash_attention(q, k, v, gate)
            ref = reference_f32(q, k, v, gate)
            rel = per_head_rel_l2(out, ref)
            plain = gated_attention_reference(q, k, v, gate).float()
            faults = {}
            for fault in ("drop_last_kv_tile", "gate_once"):
                if fault == "gate_once" and gate_name != "soft":
                    continue  # g ∈ {0, 1}: g == g²
                bad = planted_fault(q, k, v, gate, fault)
                if bad is not None:
                    faults[fault] = per_head_rel_l2(bad, ref).max().item()
            row = {"phase": "kernel_check", "case": label, "b": b, "s_q": s_q, "s_kv": s_kv,
                   "h": h, "gate": gate_name,
                   "max_abs_err": (out.float() - ref).abs().max().item(),
                   "ref_mean_abs": ref.abs().mean().item(),
                   "rel_l2": ((out.float() - ref).norm() / ref.norm()).item(),
                   "rel_l2_worst_head": rel.max().item(),
                   "bf16_plain_max_abs_err": (out.float() - plain).abs().max().item(),
                   "planted_fault_rel_l2_worst_head": faults}
            if not (math.isfinite(row["rel_l2_worst_head"])
                    and row["rel_l2_worst_head"] <= REL_L2
                    and torch.allclose(out.float(), plain, atol=BF16_TOL, rtol=BF16_TOL)):
                emit(row)
                fail(f"kernel disagrees with its plain version: {row}")
            if any(not r > REL_L2 for r in faults.values()):
                emit(row)
                fail(f"a planted fault reads within the limit {REL_L2}: {row}")
            for key in worst:
                worst[key] = max(worst[key], row[key])
            least_fault = min([least_fault, *faults.values()])
            if gate_name == "soft":
                gq, gk, gv = (t * soft[:, None, :, None].bfloat16() for t in (q, k, v))
                n_iter = 20 if s_q * s_kv < 2 ** 22 else 10
                row["ms"] = time_ms(lambda: gated_flash_attention(q, k, v, soft), n_iter)
                row["plain_ms"] = time_ms(lambda: gated_attention_reference(q, k, v, soft),
                                          max(n_iter // 4, 2))
                row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                    gq.transpose(1, 2), gk.transpose(1, 2), gv.transpose(1, 2)), n_iter)
                flop_ms = attention_flops(b, h, s_q, s_kv) / PEAK_BF16_FLOPS * 1e3
                byte_ms = attention_bytes(b, h, s_q, s_kv, 2) / PEAK_BYTES * 1e3
                row["bound_ms"] = max(flop_ms, byte_ms)
                row["bound_by"] = "operations" if flop_ms >= byte_ms else "bytes"
                row["sites_per_256px_forward"] = sites
                rows.append(row)
            emit(row)
    worst["least_planted_fault_rel_l2"] = least_fault
    return rows, worst


# ---------------------------------------------------------------- phase 4/5

def random_arch(spec, batch: int, gen):
    """~60% of width units kept, depth gates open (the JAX bench's expert)."""
    import torch
    arch = (torch.rand(batch, spec.vq_dim, generator=gen, device=gen.device) < 0.6).float()
    arch[:, spec.num_width:] = 1.0
    return arch


def build_unet(cfg, device, gen):
    import torch
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    from diffusion_pruning_tpu_torch.utils.init_utils import random_init_
    with torch.device(device):
        unet = GatedUNet(cfg)
    random_init_(unet, gen)
    return unet.to(torch.bfloat16).eval()


@contextlib.contextmanager
def unet_attention(fn):
    """Run every attention site of the U-Net through `fn(q, k, v, gate)`, in
    place of both the kernel wrapper and the plain version."""
    from diffusion_pruning_tpu_torch.models.unet import attention
    saved = attention.gated_flash_attention, attention.gated_attention_reference
    attention.gated_flash_attention = attention.gated_attention_reference = fn
    try:
        yield
    finally:
        attention.gated_flash_attention, attention.gated_attention_reference = saved


def check_unet(unet, device):
    import torch
    from diffusion_pruning_tpu_torch.ops.flash_attention import (
        gated_attention_reference, gated_flash_attention)

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    cfg = unet.cfg
    b = 8
    x = torch.randn(2 * b, cfg.sample_size, cfg.sample_size, 4, device=device, generator=gen)
    t = torch.randint(0, 1000, (2 * b,), device=device, generator=gen)
    ehs = torch.randn(2 * b, 77, cfg.cross_attention_dim, device=device, generator=gen)
    arch = random_arch(unet.spec, b, gen)
    sites, site_faults = [], []

    def checked_kernel(q, k, v, gate):
        """The kernel, held per head against f32 on this site's own inputs."""
        out = gated_flash_attention(q, k, v, gate)
        ref = reference_f32(q, k, v, gate)
        sites.append(per_head_rel_l2(out, ref).max().item())
        bad = planted_fault(q, k, v, gate, "drop_last_kv_tile")
        if bad is not None:
            site_faults.append(per_head_rel_l2(bad, ref).max().item())
        return out

    def f32_attention(q, k, v, gate):
        return reference_f32(q, k, v, gate).to(q.dtype)

    def faulty_attention(q, k, v, gate):
        bad = planted_fault(q, k, v, gate, "drop_last_kv_tile")
        return (reference_f32(q, k, v, gate) if bad is None else bad).to(q.dtype)

    with torch.inference_mode():
        before = gated_flash_attention.launches
        with unet_attention(checked_kernel):
            out = unet(x, t, ehs, arch=arch).float()
        launches = gated_flash_attention.launches - before
        fwd_ms = time_ms(lambda: unet(x, t, ehs, arch=arch), 10)
        # host time to issue one forward while the device is idle: when it
        # exceeds forward_ms, the eager U-Net is bound by its launches
        enqueue_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            unet(x, t, ehs, arch=arch)
            enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        with unet_attention(f32_attention):
            ref = unet(x, t, ehs, arch=arch).float()
        with unet_attention(faulty_attention):
            fault = unet(x, t, ehs, arch=arch).float()
        with unet_attention(gated_attention_reference):
            plain = unet(x, t, ehs, arch=arch).float()
            plain_fwd_ms = time_ms(lambda: unet(x, t, ehs, arch=arch), 10)

    def rel(a):
        return ((a - ref).norm() / ref.norm()).item()

    row = {"phase": "unet", "resolution": cfg.sample_size * 8, "b_eff": 2 * b,
           "sites_checked": len(sites), "site_rel_l2_worst_head": max(sites),
           "site_limit": REL_L2,
           "site_planted_fault_rel_l2_min_max": [min(site_faults), max(site_faults)],
           "rel_l2": rel(out), "limit": UNET_REL_L2,
           "rel_l2_bf16_plain_attention": rel(plain),
           "rel_l2_planted_fault_drop_last_kv_tile": rel(fault),
           "launches_per_forward": launches, "forward_ms": fwd_ms,
           "host_enqueue_ms_median": sorted(enqueue_ms)[2],
           "plain_attention_forward_ms": plain_fwd_ms,
           "finite": bool(torch.isfinite(out).all().item())}
    emit(row)
    if not max(sites) <= REL_L2:
        fail(f"the kernel disagrees with f32 attention at a U-Net site: {row}")
    if not max(site_faults) > REL_L2:
        fail(f"the planted fault reads within the site limit {REL_L2}: {row}")
    if not row["finite"] or not row["rel_l2"] <= UNET_REL_L2:
        fail(f"U-Net through the kernel disagrees with f32 attention: {row}")
    if not row["rel_l2_planted_fault_drop_last_kv_tile"] > UNET_REL_L2:
        fail(f"the planted fault reads within the U-Net limit {UNET_REL_L2}: {row}")
    if launches != 32:  # 16 transformer blocks × (attn1 + attn2)
        fail(f"expected 32 kernel launches per forward, got {launches}")
    return row


def build_pipeline(unet, device, gen):
    import torch
    from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
    from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
    from diffusion_pruning_tpu_torch.models.text_encoders import (
        CLIPTextConfig, CLIPTextEncoder, MPNetConfig, MPNetEncoder)
    from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from diffusion_pruning_tpu_torch.pipelines import PruningPipeline
    from diffusion_pruning_tpu_torch.utils.init_utils import random_init_

    with torch.device(device):
        clip = CLIPTextEncoder(CLIPTextConfig.sd21())
        mpnet = MPNetEncoder(MPNetConfig.base())
        hypernet = HyperStructure(unet.spec, input_dim=768)
        quantizer = StructureQuantizer(unet.spec, n_e=8)
        vae = AutoencoderKL(VAEConfig.sd())
    for m in (clip, mpnet, hypernet, quantizer, vae):
        random_init_(m, gen)
    quantizer.init_state()
    pipe = PruningPipeline(unet, vae, clip, hypernet, quantizer, device=device)
    return pipe, mpnet.eval()


def serve(pipe, mpnet, device):
    import torch
    from diffusion_pruning_tpu_torch.models.text_encoders import mean_pool
    from diffusion_pruning_tpu_torch.ops.flash_attention import gated_flash_attention

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    results = []
    gated_flash_attention.launches = 0
    for call, (b, res) in enumerate(SERVING_CALLS):
        ids = torch.randint(0, 49408, (b, 77), device=device, generator=gen)
        neg = torch.randint(0, 49408, (b, 77), device=device, generator=gen)
        mp_ids = torch.randint(0, 30527, (b, 128), device=device, generator=gen)
        lengths = torch.randint(8, 129, (b, 1), device=device, generator=gen)
        mask = (torch.arange(128, device=device)[None, :] < lengths).long()
        before = gated_flash_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            feats = mean_pool(mpnet(mp_ids, mask), mask)
        images, indices, ratios = pipe(ids, neg, gen, hyper_net_input=feats,
                                       num_inference_steps=STEPS, guidance_scale=GUIDANCE,
                                       height=res, width=res)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = gated_flash_attention.launches - before
        row = {"phase": "serving", "call": call, "prompts": b, "resolution": res,
               "steps": STEPS, "guidance": GUIDANCE, "seconds": seconds,
               "images_per_sec": b / seconds, "launches": launches,
               "expert_indices": indices.tolist(),
               "resource_ratios": [round(float(r), 4) for r in ratios],
               "image_min": float(images.min()), "image_max": float(images.max())}
        emit(row)
        if tuple(images.shape) != (b, res, res, 3):
            fail(f"images of shape {tuple(images.shape)}, expected {(b, res, res, 3)}")
        if not bool(torch.isfinite(images).all()) or row["image_min"] < 0 or row["image_max"] > 1:
            fail(f"images not finite in [0, 1]: {row}")
        if not bool(((indices >= 0) & (indices < pipe.quantizer.n_e)).all()):
            fail(f"expert indices out of range: {row['expert_indices']}")
        if launches != 32 * STEPS:
            fail(f"expected 800 kernel launches per {STEPS}-step call, got {launches}")
        results.append(row)
    return results, gated_flash_attention.launches


def _category(name: str) -> str:
    n = name.lower()
    if "gated_flash" in n:
        return "gated_flash_fwd"
    if "conv" in n or "fprop" in n or "dgrad" in n or "implicit" in n:
        return "convolution"
    if "gemm" in n or "nvjet" in n or "xmma" in n or "cutlass" in n or "sm90" in n:
        return "matmul"
    if "norm" in n:
        return "normalisation"
    if "softmax" in n:
        return "softmax"
    return "elementwise/other"


def profile_call(pipe, mpnet, device):
    """One more 256px call of 8 prompts under torch.profiler: per-stage host
    times, device kernel time by category, and the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from diffusion_pruning_tpu_torch.models.text_encoders import mean_pool

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    b = 8
    ids = torch.randint(0, 49408, (b, 77), device=device, generator=gen)
    neg = torch.randint(0, 49408, (b, 77), device=device, generator=gen)
    mp_ids = torch.randint(0, 30527, (b, 128), device=device, generator=gen)
    mask = torch.ones(b, 128, dtype=torch.long, device=device)

    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        feats = stage("mpnet_ms", lambda: mean_pool(mpnet(mp_ids, mask), mask))
        pe = stage("clip_ms", lambda: pipe.encode_prompt(ids))
        ne = stage("clip_negative_ms", lambda: pipe.encode_prompt(neg))
        arch, _ = stage("route_ms", lambda: pipe.route(pe, feats))
        lat = stage("denoise_ms", lambda: pipe.denoise(gen, pe, ne, arch, STEPS, GUIDANCE))
        stage("vae_decode_ms", lambda: pipe.decode(lat))
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_cat = {}
    kernels = []
    busy_us = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        busy_us += us
        cat = _category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + us / 1e3
        kernels.append((us / 1e3, e.count, cat, e.key[:90]))
    kernels.sort(reverse=True)
    row = {"phase": "profile", "resolution": 256, "prompts": b, "wall_ms": wall_ms,
           "stages_ms": stages,
           "device_kernel_ms": busy_us / 1e3 if busy_us else "not measured",
           "device_busy_share": busy_us / 1e3 / wall_ms if busy_us else "not measured",
           "kernel_ms_by_category": by_cat,
           "top_kernels": [{"ms": ms, "count": n, "category": c, "name": k}
                           for ms, n, c, k in kernels[:15]],
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(row)
    return row


# ---------------------------------------------------------------- main

def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from diffusion_pruning_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        fail(f"the port's package is not beside this script ({e})")
    device = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmuls and cuDNN convolutions in the comparison phases 3-4")

    # 2. build
    t0 = time.perf_counter()
    nvcc_s = fa.build_kernel()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "nvcc_seconds": nvcc_s})
    report = fa.BUILD_DIR / f"{fa.SOURCE.stem}.ptxas.txt"
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {fa.SOURCE.name}: {line.strip()}")

    # 3. kernel vs plain version
    t0 = time.perf_counter()
    rows, worst = check_attention_kernel(device)
    emit({"phase": "kernel_check_summary", "limit": REL_L2, **worst})
    log(f"phase 3 took {time.perf_counter() - t0:.1f}s")

    # 4. U-Net at full width, kernel vs plain attention
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    unet = build_unet(UNetConfig.sd21(256), device, gen)
    check_unet(unet, device)
    log(f"phase 4 took {time.perf_counter() - t0:.1f}s")

    # 5. routed serving (TF32 back to PyTorch's defaults)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    log("phase 5 runs with PyTorch's TF32 defaults (cuDNN on, matmul off)")
    t0 = time.perf_counter()
    pipe, mpnet = build_pipeline(unet, device, gen)
    calls, launches = serve(pipe, mpnet, device)
    log(f"phase 5 took {time.perf_counter() - t0:.1f}s")
    s256 = sorted(c["seconds"] for c in calls[1:4])
    emit({"phase": "serving_summary", "img_per_sec_256px_median": 8 / s256[1],
          "seconds_256px_min_median_max": s256, "seconds_512px": calls[5]["seconds"]})

    # 6. one more call under the profiler
    profile_call(pipe, mpnet, device)

    # 7. kernels line: times summed over the 32 sites of one 256px forward
    agg = {key: sum(r[key] * r["sites_per_256px_forward"] for r in rows)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    ops_share = sum(r["bound_ms"] * r["sites_per_256px_forward"] for r in rows
                    if r["bound_by"] == "operations") / agg["bound_ms"]
    emit({"kernels": [{
        "name": "gated_flash_fwd",
        "route": "cuda",
        "source": "diffusion_pruning_tpu_torch/csrc/gated_flash_fwd.cu",
        "replaces": "diffusion_pruning_tpu/ops/flash_attention.py:148",
        "also_replaces": ["diffusion_pruning_tpu/ops/flash_attention.py:181",
                          "diffusion_pruning_tpu/ops/flash_attention.py:215",
                          "diffusion_pruning_tpu/ops/flash_attention.py:284"],
        "launches": launches,
        "max_abs_err": worst["max_abs_err"],
        "rel_l2_worst_head": worst["rel_l2_worst_head"],
        "ms": agg["ms"], "kernel_ms": agg["ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": agg["bound_ms"],
        "bound_by": "operations" if ops_share >= 0.5 else "bytes",
        "library_ms": agg["library_ms"],
        "shapes": "the 32 attention sites of one SD-2.1 U-Net forward at 256px, "
                  "B_eff 16, bf16, soft gates",
    }]})
    log(f"total {time.perf_counter() - t_start:.1f}s; 256px img/s (median of 3) "
        f"{8 / s256[1]:.4f}; 512px seconds {calls[5]['seconds']:.4f}")
    # 8. last line
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
