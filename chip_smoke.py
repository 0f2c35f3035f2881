#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (`diffusion_pruning_tpu_torch`) on one
CUDA card, from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which passes or ends the run with a non-zero exit:
  1. device     — require CUDA; print the card's name and power limit;
  2. build      — compile the CUDA kernels from `diffusion_pruning_tpu_torch/csrc/`
                  with nvcc into `build/torch_kernels/`, one nvcc per source,
                  all started together; ptxas's register report and the
                  HGMMA/HMMA/UTMALDG count of each kernel's SASS; each
                  forward and backward kernel and norm_linear must show HGMMA
                  and UTMALDG and no HMMA (the S_q <= 64 forward also no
                  spills), group_norm_silu UTMALDG (their registers, spills
                  and ptxas notes reported, and the cluster size
                  group_norm_plan gives the U-Net's GroupNorm shapes);
  3. kernels    — the bf16 forward against its plain PyTorch version run in f32
                  (TF32 off) on the same bf16 inputs, at the SD-2.1 shapes
                  and ragged S_q <= 64 ones (`forward_plan`: S_q <= 64 with
                  S_kv <= 80 runs gated_flash_fwd_small, every other shape
                  the 128-row wgmma kernel; S_kv = 77 at B = 16 holds the
                  batch boundary of TMA boxes): relative L2 per (batch, head)
                  <= REL_L2, and planted faults, emulated in plain torch (the
                  last kv tile dropped, the tile's tail past S_kv left
                  unmasked, the gate applied once), must read above that
                  limit; also within atol/rtol 3e-2 of the bf16 plain
                  version; the SD-2.1 shapes timed beside the plain version,
                  the PyTorch library call and the roofline bound;
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
  7. training kernels — the training forward (with lse) and the backward
                  (the route `backward_plan` picks: one pass at S_kv <= 80,
                  with its reduction where it splits the query range, else
                  the dq and dk/dv kernels) against their plain versions run
                  in f32 (TF32 off) on the same bf16 inputs, at the 8
                  attention shapes of the SD-2.1 U-Net at 256px with the
                  train step's B = 64 and one ragged shape of each route,
                  gate none, soft and hard: lse by max-abs error, dq/dk/dv by
                  relative L2 per (batch, head), dgate per (batch, head)
                  relative to the head's RMS dgate over the batch; a second
                  backward on the same inputs must repeat every bit; planted
                  faults, emulated in plain torch, must read above each
                  limit; the backward as the caller runs it and each of its
                  kernels timed beside the plain versions, the bound (of the
                  function and of each kernel's own work) and the forward
                  and backward of PyTorch's SDPA, per shape and summed over
                  the 32 sites; the training forward at the S_q <= 64
                  shapes on its own line;
  8. train step — the stage-1 pruning step at full width (SD-2.1 U-Net at
                  256px in bf16, CLIP ViT-H text, SD VAE, hypernet 768→1620,
                  K = 8, B = 64, the coco yaml's losses and optimiser): one
                  pretrain step, then four codebook steps; finite losses,
                  trainables changed, 32 launches of each attention forward
                  per step and the backward kernels of each site's plan (22
                  one-pass, 5 reductions, 10 dq, 10 dk/dv), and the step's
                  hypernet and codebook grads through the kernels against
                  the same step with plain attention
                  (cosine per leaf, > GRAD_COS; with the kernels' dgate
                  dropped, a planted fault, it must read below); seconds per
                  step, samples/s, stage times,
                  peak memory, and one step under torch.profiler;
  9. fused-norm kernels — one-pass GroupNorm(+SiLU), GroupNorm→SiLU→conv3x3
                  and GroupNorm→linear against their plain versions run in f32
                  (TF32 off for matmuls and cuDNN) on the same bf16 inputs, at
                  every distinct shape the SD-2.1 U-Net gives them at 256px
                  with B_eff = 16 (read off the U-Net with hooks), plus the
                  512px level-0 shapes (one slab there exceeds shared memory)
                  and the output head (C_out = 4), and the conv and the linear
                  kernel at the same shapes with the train step's B = 64 too
                  (phase 11 launches them there); gate none, soft and hard (a
                  closed group): relative L2 per batch element <= FUSED_REL_L2,
                  and planted faults (x-space padding, ungated statistics, a
                  dropped tap, the other norm's eps, an uncentred variance, a
                  SiLU too many), emulated in plain torch, must read above it;
                  timed beside the bound, the plain version and the library
                  chain (F.group_norm + F.silu + F.conv2d / F.linear), hot
                  and cold; GroupNorm also at B = 64 (timed), under
                  `group_norm_plan` (window, cluster, rows); the conv under
                  its plan (`conv_plan`: patch, BN, split over K), the linear
                  under `linear_plan` (split over K, persistent grid), a
                  split plan's reduction kernel against its plain version;
                  and the conv's activation alone (identity centre tap, y over
                  [−8, 8]) within one bf16 ulp, with SiLU's tanh.approx form,
                  a planted fault, above; the conv's time under each split
                  over K at five shapes of the small maps and the linear's
                  at three (the plans' rule); the conv and the linear at an
                  expert's channel widths (C_in 90, 310, 620: zero-padded to
                  a multiple of 8 on the card; 1240 aligned), and
                  group_norm_silu at an expert's norm2 widths (C, G) = (90,
                  9), (170, 17), (310, 31), (620, 31), (1240, 31), with and
                  without SiLU, at B_eff 8 and 16, per batch element <=
                  FUSED_REL_L2; then every route of
                  `backward_plan`, the S_q <= 64 forward with lse and the
                  conv's and the linear's split workspaces run twice with
                  NaN in the allocator's free blocks and in every buffer the
                  wrappers allocate: finite, and equal bit for bit;
 10. fused U-Net — the full-width U-Net of phase 4 under `fused_norms`, then
                  under `fused_norm_conv`, same weights, against an f32 U-Net
                  (<= FUSED_UNET_REL_L2, with the unfused bf16 reading beside it)
                  and against the unfused bf16 one; planted faults must read
                  above the limit; 60, and 45 + 16, launches a forward, and no
                  fused op is handed an activation it must convert to the
                  layout its kernel reads;
 11. fused serving and training — one routed 256px call under `fused_norms`;
                  under `fused_norm_conv` one warm-up and two timed calls in
                  turns with the unfused pipeline (finite images in [0, 1],
                  1125 + 400 launches a call), then one pretrain and one
                  codebook step of the stage-1 trainer at B = 64 (finite
                  losses, trainables changed, 90 conv and 32 linear launches
                  a step) and the step's hypernet and codebook grads against
                  the unfused step (cosine per leaf > FUSED_GRAD_COS), and the
                  U-Net's d loss / d arch per gate site against the unfused
                  U-Net's (with the fused conv op's gate gradient dropped, a
                  planted fault, the resnet sites must read below the limit);
 12. expert serving — K = 8 physically pruned experts of the routed pipeline
                  (`ExpertServer.from_codebook`, bf16) cut from a seeded
                  codebook (units kept with p = 0.6, the odd-numbered codes
                  closing 2-4 depth gates): per expert its MACs ratio,
                  parameter bytes, dropped subblocks and kept heads at the
                  1024-token sites; each expert's forward at B_eff 8 through
                  the kernels, cut from weights whose resnet norm2 biases are
                  zeroed, against the dense U-Net in f32 with plain attention
                  under the expert's code (<= UNET_REL_L2; the planted fault
                  `heads_from_the_front` above it), under each fused flag
                  (<= FUSED_UNET_REL_L2), with its launches per forward (2 a
                  kept transformer) and its kernels' device time over the
                  forward's sites; then 16 prompts at 256px, DDIM-25, CFG
                  7.5, in two submits of 8 through a `ServingQueue`: `flush`
                  (experts) and `flush_async` (hybrid) and the gated
                  pipeline, in turns for two rounds (request ids, slot
                  accounting, finite images in [0, 1]; img/s of each); one
                  request of 2 prompts under PNDM and under DPM++; one expert
                  flush under torch.profiler;
 13. stage 1 as a program — seeded random SD-2.1-width weights written in
                  bf16 as diffusers/HF checkpoint folders (unet/, vae/,
                  text_encoder/, an MPNet folder) under build/ by the port's
                  safetensors writer; the prune entry point
                  (`python -m diffusion_pruning_tpu_torch.cli.prune`) on a
                  YAML derived from configs/pruning/sd-2-1_coco2014.yaml
                  (synthetic data, B = 64 at 256px): run 1 in a subprocess
                  for 3 steps (one pretraining; validation and heatmaps at
                  step 3; no unet/ export) must leave checkpoint-3 with
                  state/, quantizer_embeddings.pt (8 × 1620), hypernet/ and
                  quantizer/; run 2 in this process resumes `latest` to step
                  6 with 2 micro-batches of 32 a step: its resumed state
                  equal, bit for bit, to run 1's saved state and exports, each
                  step's attention launches those of `backward_plan` at B =
                  32 for both micro-batches, checkpoint-6/unet/ equal to the
                  written weights, checkpoint-3 rotated away, every logged
                  loss finite and each step's 64 prompts routed; then
                  `sample_progressive` (DDIM-25, a snapshot every 10 steps)
                  against `__call__` on the same latents and routing noise
                  (<= PROGRESSIVE_MAX_ABS), `SafetyChecker.from_diffusers` on
                  a written random ViT-L/14 folder whose concept is image 0's
                  embedding (the 4-tuple, image 0 alone flagged and black),
                  and the U-Net with 1×1-conv projections against f32 (<=
                  UNET_REL_L2), plain and under `fused_norm_conv` (no
                  `norm_linear` launch); seconds by part, the CLI's steps/s
                  and peak memory on a summary line; the written files are
                  removed;
then a `kernels` JSON line (every kernel of the paths, each with its
launches in the runs of phases 5, 8, 11, 12 and 13) and, last, the device
JSON line.

Kernel and library times (`ms`, `library_ms`) are device times: the launches
are captured into a CUDA graph whose replay is timed (`device_ms`); they run
back to back on one input, which a small shape keeps in L2. `cold_ms` and
`library_cold_ms` (`cold_device_ms`) cycle the launches over enough copies of
the operands that each finds them in device memory. The same calls issued
eagerly (`eager_ms`, `library_eager_ms`) read the larger of the device's time
and the host's pace.

Weights and inputs are random, from fixed seeds. Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import statistics
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
# phase 7: the training kernels at the train step's batch; limits between the
# sound readings and the planted faults' (PERF.md)
TRAIN_B = 64
TRAIN_CASES = ((1024, 1024, 5, 5), (1024, 77, 5, 5), (256, 256, 10, 5), (256, 77, 10, 5),
               (64, 64, 20, 5), (64, 77, 20, 5), (16, 16, 20, 1), (16, 77, 20, 1))
# one ragged case of each backward route (two kernels; one pass, S_q > 64 and
# S_q <= 64), checked, not timed
RAGGED_TRAIN_CASES = ((200, 200, 3, 0), (100, 77, 3, 0), (40, 50, 3, 0))
LSE_ATOL = 1e-3      # max |lse - reference|, natural log
GRAD_REL_L2 = 1e-2   # dq, dk, dv: relative L2 per (batch, head)
DGATE_REL = 5e-2     # |dgate - reference| / RMS over the batch of the head's dgate
# phase 8: the stage-1 step (configs/pruning/sd-2-1_coco2014.yaml)
DEPTH_ORDER = (-1, -2, 0, 1, -3, -4, 2, 3, -5, -6, 4, 5, -7, 6)
TRAIN_STEPS = 5      # one pretrain step, then codebook steps
GRAD_COS = 0.999     # per-leaf cosine of kernel-path grads vs plain attention
# phases 9-11: the fused-norm kernels; limits between the sound readings and
# the planted faults' (PERF.md)
PEAK_F32_FLOPS = 67e12    # H100 SXM f32 outside the tensor cores (GroupNorm's arithmetic)
FUSED_REL_L2 = 1e-2       # per batch element, kernel vs its f32 plain version
FUSED_B = 16              # B_eff of a 256px request of 8 prompts
# a fused U-Net's output against the f32 U-Net's: a sound path reads 0.0133-0.0136,
# as the unfused bf16 one (0.0144); the planted faults 0.0227 and 0.0322 (PERF.md)
FUSED_UNET_REL_L2 = 2e-2
FUSED_GRAD_COS = 0.99     # per-leaf cosine of the fused step's grads vs the unfused step's
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
    """Mean time of one call issued eagerly, from CUDA events around `iters`
    calls: the larger of the device's time and the host's pace of issuing."""
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


def device_ms(fn, iters: int) -> float:
    """Device time of one call: `iters` calls are captured into one CUDA graph
    and a replay of it is timed with CUDA events, so that the host's pace of
    issuing launches (the wrapper's checks, ctypes, PyTorch's dispatcher) is
    not in the reading, as it is in `time_ms` for a kernel of a few
    microseconds. The calls run back to back on the same inputs: a small
    input stays in the L2 cache, and such a reading can lie below the bound
    taken from the memory rate."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


L2_BYTES = 50e6  # the H100's L2


def cold_device_ms(fn, args, out_bytes: float = 0.0) -> float:
    """Device time of `fn(*args)` with its operands in device memory, not in
    L2: enough clones of the tensors among `args` that one pass over them
    (with the `out_bytes` each call writes, its outputs kept) touches more
    than twice the 50 MB L2 are cycled through in one CUDA graph, whose
    replay is timed; a call then finds what it reads evicted by the calls
    before it, as a caller that moves on to other tensors does. Mean per call."""
    import torch
    nbytes = out_bytes + sum(a.numel() * a.element_size() for a in args if torch.is_tensor(a))
    n = max(3, math.ceil(2 * L2_BYTES / max(nbytes, 1.0)) + 1)
    copies = [tuple(a.clone() if torch.is_tensor(a) else a for a in args) for _ in range(n)]
    for c in copies[:2]:
        fn(*c)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(graph):
        for c in copies:
            outs.append(fn(*c))
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    del graph, outs, copies
    return ms


# ---------------------------------------------------------------- phase 3

def attention_flops(b: int, h: int, s_q: int, s_kv: int, d: int = 64) -> float:
    """Multiply-adds of QKᵀ and PV, counted as 2 operations each."""
    return 4.0 * b * h * s_q * s_kv * d


def attention_bytes(b: int, h: int, s_q: int, s_kv: int, elem: int, d: int = 64) -> float:
    """q, k and v read once and o written once."""
    return float(b * h * d * elem * (2 * s_q + 2 * s_kv))


# ragged shapes of phase 3, checked and not timed: each kv tile of the S_q <= 64
# kernel (16, 64, 80) at and below its edge, and S_q past 64 or S_kv past 80
# (the 128-row kernel)
RAGGED_SMALL_Q = ((1, 1, 3), (40, 16, 20), (63, 77, 3), (64, 80, 3), (40, 50, 20), (1, 77, 20),
                  (65, 77, 3), (64, 81, 3), (40, 200, 20))


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
    for s_q, s_kv, h in RAGGED_SMALL_Q:
        cases.append(("ragged", 3, s_q, s_kv, h, 0))
    return cases



def forward_tile(b, h, s_q, s_kv):
    """(kv tile, kv tiles) of the forward kernel that runs the shape."""
    from diffusion_pruning_tpu_torch.ops.flash_attention import forward_plan
    plan = forward_plan(b, h, s_q, s_kv)
    return plan.kv_tile, plan.kv_tiles


def reference_f32(q, k, v, gate):
    """The plain version in f32 on the given (bf16) inputs, returned in f32."""
    from diffusion_pruning_tpu_torch.ops.flash_attention import gated_attention_reference
    return gated_attention_reference(q.float(), k.float(), v.float(), gate)


def planted_fault(q, k, v, gate, fault):
    """What a kernel with one fault would return, emulated in plain torch
    (f32), to show that the checks' limits catch it: `drop_last_kv_tile`
    leaves out the last kv tile of the kernel that runs the shape (None when
    there is only one); `kv_tail_unmasked` lets the zero rows that fill the
    last tile past S_kv into the softmax (None when S_kv fills it);
    `tile_fault` is the first of the two that exists; `gate_once` scales the
    logits by g instead of g²."""
    import torch.nn.functional as F
    from diffusion_pruning_tpu_torch.ops.flash_attention import plain_attention
    b, s_q, h, _ = q.shape
    s_kv = k.shape[1]
    tile, tiles = forward_tile(b, h, s_q, s_kv)
    if fault == "drop_last_kv_tile":
        keep = (tiles - 1) * tile
        return reference_f32(q, k[:, :keep], v[:, :keep], gate) if keep else None
    if fault == "kv_tail_unmasked":
        pad = tiles * tile - s_kv
        return (reference_f32(q, F.pad(k, (0, 0, 0, 0, 0, pad)), F.pad(v, (0, 0, 0, 0, 0, pad)),
                              gate) if pad else None)
    if fault == "tile_fault":
        bad = planted_fault(q, k, v, gate, "drop_last_kv_tile")
        return bad if bad is not None else planted_fault(q, k, v, gate, "kv_tail_unmasked")
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
        forward_kernel, gated_attention_reference, gated_flash_attention)

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
            for fault in ("drop_last_kv_tile", "kv_tail_unmasked", "gate_once"):
                if fault == "gate_once" and (gate_name != "soft" or s_kv == 1):
                    continue  # g ∈ {0, 1}: g == g²; one key's probability is 1 at any scale
                bad = planted_fault(q, k, v, gate, fault)
                if bad is not None:
                    faults[fault] = per_head_rel_l2(bad, ref).max().item()
            row = {"phase": "kernel_check", "case": label, "b": b, "s_q": s_q, "s_kv": s_kv,
                   "h": h, "gate": gate_name, "kernel": forward_kernel(s_q, s_kv),
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
            if gate_name == "soft" and label != "ragged":
                gq, gk, gv = (t * soft[:, None, :, None].bfloat16() for t in (q, k, v))
                n_iter = 20 if s_q * s_kv < 2 ** 22 else 10

                def kernel():
                    return gated_flash_attention(q, k, v, soft)

                def sdpa(a, b_, c):
                    return F.scaled_dot_product_attention(a.transpose(1, 2), b_.transpose(1, 2),
                                                          c.transpose(1, 2))

                def library():
                    return sdpa(gq, gk, gv)

                # device times (`device_ms`), the same with operands in device
                # memory (`cold_device_ms`), and the calls issued eagerly
                row["ms"] = device_ms(kernel, n_iter)
                row["cold_ms"] = cold_device_ms(gated_flash_attention, (q, k, v, soft),
                                                q.numel() * 2)
                row["eager_ms"] = time_ms(kernel, n_iter)
                row["plain_ms"] = time_ms(lambda: gated_attention_reference(q, k, v, soft),
                                          max(n_iter // 4, 2))
                row["library_ms"] = device_ms(library, n_iter)
                row["library_cold_ms"] = cold_device_ms(sdpa, (gq, gk, gv), q.numel() * 2)
                row["library_eager_ms"] = time_ms(library, n_iter)
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
        bad = planted_fault(q, k, v, gate, "tile_fault")
        if bad is not None:
            site_faults.append(per_head_rel_l2(bad, ref).max().item())
        return out

    def f32_attention(q, k, v, gate):
        return reference_f32(q, k, v, gate).to(q.dtype)

    def faulty_attention(q, k, v, gate):
        bad = planted_fault(q, k, v, gate, "tile_fault")
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
           "rel_l2_planted_fault_tile_fault": rel(fault),
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
    if not row["rel_l2_planted_fault_tile_fault"] > UNET_REL_L2:
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


def serve(pipe, mpnet, device, calls=SERVING_CALLS, per_forward=None, seed=SEED + 2,
          phase="serving"):
    """Routed requests through `pipe`, one per entry of `calls`; every launch
    count is set to 0 first. `per_forward`: the launches each kernel must show
    per U-Net forward (default: 32 of the lse-free attention forward, no
    other). Returns the rows and the launch counts of the whole run."""
    import torch
    from diffusion_pruning_tpu_torch.models.text_encoders import mean_pool

    per_forward = {"gated_flash_fwd": 32, **(per_forward or {})}
    gen = torch.Generator(device=device).manual_seed(seed)
    results = []
    reset_launch_counts()
    for call, (b, res) in enumerate(calls):
        ids = torch.randint(0, 49408, (b, 77), device=device, generator=gen)
        neg = torch.randint(0, 49408, (b, 77), device=device, generator=gen)
        mp_ids = torch.randint(0, 30527, (b, 128), device=device, generator=gen)
        lengths = torch.randint(8, 129, (b, 1), device=device, generator=gen)
        mask = (torch.arange(128, device=device)[None, :] < lengths).long()
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            feats = mean_pool(mpnet(mp_ids, mask), mask)
        images, indices, ratios = pipe(ids, neg, gen, hyper_net_input=feats,
                                       num_inference_steps=STEPS, guidance_scale=GUIDANCE,
                                       height=res, width=res)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: v - before[k] for k, v in launch_counts().items()}
        launches = counts["gated_flash_fwd"]
        row = {"phase": phase, "call": call, "prompts": b, "resolution": res,
               "steps": STEPS, "guidance": GUIDANCE, "seconds": seconds,
               "images_per_sec": b / seconds, "launches": launches,
               "launches_by_kernel": counts,
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
        checked = wrapper_counts(counts)
        want = {k: STEPS * per_forward.get(k, 0) for k in checked}
        if checked != want:
            fail(f"expected {want} kernel launches per {STEPS}-step call, got {counts}")
        results.append(row)
    return results, launch_counts()


def _category(name: str) -> str:
    n = name.lower()
    for kernel in ("gated_flash_fwd", "gated_flash_bwd_fused", "gated_flash_bwd_reduce",
                   "gated_flash_bwd_dq", "gated_flash_bwd_dkv"):
        if kernel + "_" in n:
            return kernel
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
    row = {"phase": "profile", "resolution": 256, "prompts": b, "wall_ms": wall_ms,
           "stages_ms": stages, **device_kernel_times(prof, wall_ms),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(row)
    return row


def device_kernel_times(prof, wall_ms: float) -> dict:
    """Device kernel time of a torch.profiler run: total, busy share of
    `wall_ms`, by category and the largest kernels."""
    import torch
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
    return {"device_kernel_ms": busy_us / 1e3 if busy_us else "not measured",
            "device_busy_share": busy_us / 1e3 / wall_ms if busy_us else "not measured",
            "kernel_ms_by_category": by_cat,
            "top_kernels": [{"ms": ms, "count": n, "category": c, "name": k}
                            for ms, n, c, k in kernels[:15]]}


# ---------------------------------------------------------------- phase 7

def dgate_rel(dgate, ref):
    """|dgate - ref| per (batch, head), relative to the RMS over the batch of
    the head's reference dgate: a sum of terms of both signs can land near 0
    for one sample, where a plain relative error says nothing."""
    return (dgate - ref).abs() / ref.square().mean(dim=0).sqrt().clamp_min(1e-30)


def training_bytes(kind: str, b: int, h: int, s_q: int, s_kv: int) -> float:
    """Bytes per (batch, head) that each training kernel (or the backward as
    one function, "bwd") must move: bf16 rows of 64 (128 bytes), f32 lse,
    δ and row stats per query row, each read or written once."""
    from diffusion_pruning_tpu_torch.ops import flash_attention as fa
    plan = fa.backward_plan(b, h, s_q, s_kv)
    if kind == "fwd_lse":  # q, k, v in; o, lse out
        return 128.0 * (2 * s_q + 2 * s_kv) + 4 * s_q
    if kind == "bwd":      # q, k, v, o, dO, lse in; dq, dk, dv out
        return 128.0 * (4 * s_q + 4 * s_kv) + 4 * s_q
    if kind == "fused":    # q, k, v, o, dO, lse in; dq out; dk, dv out or f32 partials
        kv_out = 2 * s_kv * (128.0 if plan.chunks == 1 else 256.0 * plan.chunks)
        return 128.0 * (4 * s_q + 2 * s_kv) + 4 * s_q + kv_out + 8 * plan.chunks
    if kind == "reduce":   # the partials in; dk, dv out
        return 2 * s_kv * (256.0 * plan.chunks + 128.0)
    if kind == "dq":       # q, k, v, o, dO, lse in; dq, row stats, dgate partials out
        return 128.0 * (4 * s_q + 2 * s_kv) + 4 * s_q + 8 * plan.s_q_pad + 8 * plan.q_tiles
    # dk/dv: q, k, v, dO, row stats in; dk, dv, dgate partials out
    return 128.0 * (2 * s_q + 4 * s_kv) + 8 * plan.s_q_pad + 8 * plan.kv_tiles


# products of 2·S_q·S_kv·64 operations; the reduction only adds
TRAINING_PRODUCTS = {"fwd_lse": 2, "bwd": 5, "fused": 5, "reduce": 0, "dq": 3, "dkv": 4}


def training_bound(kind: str, b: int, h: int, s_q: int, s_kv: int):
    flop_ms = b * h * TRAINING_PRODUCTS[kind] * 2.0 * s_q * s_kv * 64 / PEAK_BF16_FLOPS * 1e3
    byte_ms = b * h * training_bytes(kind, b, h, s_q, s_kv) / PEAK_BYTES * 1e3
    return max(flop_ms, byte_ms), "operations" if flop_ms >= byte_ms else "bytes"


def backward_kinds(b: int, h: int, s_q: int, s_kv: int):
    """The kernels, by `training_bound` kind, that the backward runs at a shape."""
    from diffusion_pruning_tpu_torch.ops import flash_attention as fa
    plan = fa.backward_plan(b, h, s_q, s_kv)
    if plan.route == "two_kernel":
        return ("dq", "dkv")
    return ("fused", "reduce") if plan.chunks > 1 else ("fused",)


def training_faults(qf, kf, vf, dof, gate, gate_name, lse_r, dq_r, dk_r, dv_r, dg_r):
    """What a kernel with one fault would return, emulated in plain torch (f32)
    from the reference results, read with each check's metric: the
    forward's lse in the wrong log, without its last kv tile or with the
    zero rows past S_kv of its one tile in the softmax (the tiles of the
    forward kernel that runs the shape); a
    backward block that never ran, by the route `backward_plan` picks (the
    dk/dv kernel's last 128-row kv tile, or the one pass's whole kv side; the
    one pass's last 128-row query tile of dq); dq' for dq; dgate without its
    dv term."""
    from diffusion_pruning_tpu_torch.ops import flash_attention as fa
    b, s_q, h, _ = qf.shape
    s_kv = kf.shape[1]
    plan = fa.backward_plan(b, h, s_q, s_kv)
    tile, tiles = forward_tile(b, h, s_q, s_kv)
    last = (tiles - 1) * tile  # first row of the forward's last kv tile
    out = {"lse_log2_domain": (lse_r * 1.4426950408889634 - lse_r).abs().max().item()}
    if last:
        _, lse_bad = fa.gated_attention_reference_lse(qf, kf[:, :last], vf[:, :last], gate)
        out["lse_drop_last_kv_tile"] = (lse_bad - lse_r).abs().max().item()
    elif tile > s_kv:
        import torch.nn.functional as F
        pad = (0, 0, 0, 0, 0, tile - s_kv)
        _, lse_bad = fa.gated_attention_reference_lse(qf, F.pad(kf, pad), F.pad(vf, pad), gate)
        out["lse_kv_tail_unmasked"] = (lse_bad - lse_r).abs().max().item()
    kv_tile = fa.BWD_DKV_ROWS if plan.route == "two_kernel" else fa.BWD_ONE_PASS_KV
    last_kv = (s_kv - 1) // kv_tile * kv_tile
    worst = 0.0  # the backward's block of the last kv tile never ran
    for ref in (dk_r, dv_r):
        bad = ref.clone()
        bad[:, last_kv:] = 0
        worst = max(worst, per_head_rel_l2(bad, ref).max().item())
    out["dkv_drop_last_kv_tile"] = worst
    if plan.route == "one_pass":  # a dq whose last query tile is never written
        bad = dq_r.clone()
        bad[:, (s_q - 1) // fa.BWD_Q_ROWS * fa.BWD_Q_ROWS:] = 0
        out["dq_drop_last_q_tile"] = per_head_rel_l2(bad, dq_r).max().item()
    if gate_name == "soft":  # dq' returned in place of dq = g·dq'
        out["dq_missing_g"] = per_head_rel_l2(dq_r / gate[:, None, :, None], dq_r).max().item()
    if gate is not None:  # dgate without Σ dv'∘v = Σ P ∘ (dO·vᵀ)
        import torch
        g2 = gate.square()[:, :, None, None]
        p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * 0.125 * g2, dim=-1)
        term_v = (p * torch.einsum("bqhd,bkhd->bhqk", dof, vf)).sum(dim=(2, 3))
        out["dgate_without_dv_term"] = dgate_rel(dg_r - term_v, dg_r).max().item()
    return out


def check_training_kernels(device):
    import torch
    from diffusion_pruning_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    b = TRAIN_B
    limits = {"lse_max_abs": LSE_ATOL, "o": REL_L2, "dq": GRAD_REL_L2, "dk": GRAD_REL_L2,
              "dv": GRAD_REL_L2, "dgate": DGATE_REL}
    fault_limit = {"lse_log2_domain": LSE_ATOL, "lse_drop_last_kv_tile": LSE_ATOL,
                   "lse_kv_tail_unmasked": LSE_ATOL,
                   "dkv_drop_last_kv_tile": GRAD_REL_L2, "dq_drop_last_q_tile": GRAD_REL_L2,
                   "dq_missing_g": GRAD_REL_L2, "dgate_without_dv_term": DGATE_REL}
    worst = {key: 0.0 for key in limits}
    worst.update(dq_max_abs=0.0, dkv_max_abs=0.0)
    by_route = {route: dict(worst) for route in ("one_pass", "two_kernel")}
    least_fault = {}
    rows = []
    for s_q, s_kv, h, sites in TRAIN_CASES + RAGGED_TRAIN_CASES:
        route = fa.backward_plan(b, h, s_q, s_kv).route
        q, do = (torch.randn(b, s_q, h, 64, device=device, generator=gen).bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(b, s_kv, h, 64, device=device, generator=gen).bfloat16()
                for _ in range(2))
        soft = torch.rand(b, h, device=device, generator=gen)
        hard = torch.ones(b, h, device=device)
        hard[:, h // 2] = 0.0  # one closed head
        for gate_name, gate in (("none", None), ("soft", soft), ("hard", hard)):
            o, lse = fa.gated_flash_forward_lse(q, k, v, gate)
            dq, dk, dv, dgate = fa.gated_flash_backward(q, k, v, gate, o, lse, do)
            again = fa.gated_flash_backward(q, k, v, gate, o, lse, do)
            torch.cuda.synchronize()
            repeats = all(x is None and y is None or torch.equal(x, y)
                          for x, y in zip((dq, dk, dv, dgate), again))
            del again
            # each kernel against its plain version on its own inputs: the
            # backward's include the forward's o and lse
            qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
            o_r, lse_r = fa.gated_attention_reference_lse(qf, kf, vf, gate)
            dq_r, dk_r, dv_r, dg_r = fa.gated_flash_backward_reference(qf, kf, vf, gate,
                                                                        o.float(), lse, dof)
            reading = {"lse_max_abs": (lse - lse_r).abs().max().item(),
                       "o": per_head_rel_l2(o, o_r).max().item(),
                       "dq": per_head_rel_l2(dq, dq_r).max().item(),
                       "dk": per_head_rel_l2(dk, dk_r).max().item(),
                       "dv": per_head_rel_l2(dv, dv_r).max().item()}
            if gate is not None:
                reading["dgate"] = dgate_rel(dgate, dg_r).max().item()
            faults = training_faults(qf, kf, vf, dof, gate, gate_name, lse_r, dq_r, dk_r, dv_r,
                                     dg_r)
            row = {"phase": "training_kernel_check", "b": b, "s_q": s_q, "s_kv": s_kv, "h": h,
                   "gate": gate_name, "route": route,
                   "backward_kernels": list(backward_kinds(b, h, s_q, s_kv)), **reading,
                   "repeats_bit_for_bit": repeats,
                   "dq_max_abs": (dq.float() - dq_r).abs().max().item(),
                   "dkv_max_abs": max((dk.float() - dk_r).abs().max().item(),
                                      (dv.float() - dv_r).abs().max().item()),
                   "dq_ref_mean_abs": dq_r.abs().mean().item(),
                   "planted_faults": faults}
            if gate is not None:
                row["dgate_ref_rms"] = dg_r.square().mean().sqrt().item()
                if gate_name == "hard":  # the closed head's dgate, kernel and reference
                    row["dgate_closed_head"] = [dgate[0, h // 2].item(), dg_r[0, h // 2].item()]
            bad = [key for key, value in reading.items()
                   if not (math.isfinite(value) and value <= limits[key])]
            if gate_name == "hard" and not all(bool((t[:, :, h // 2] == 0).all())
                                               for t in (dq, dk, dv)):
                bad.append("closed head gives nonzero dq/dk/dv")
            if not repeats:
                bad.append("a second backward on the same inputs gave other bits")
            if bad:
                emit(row)
                fail(f"training kernels disagree with their plain versions ({bad}): {row}")
            caught = [key for key, value in faults.items() if not value > fault_limit[key]]
            if caught:
                emit(row)
                fail(f"planted faults read within their limits ({caught}): {row}")
            for key in worst:
                worst[key] = max(worst[key], row.get(key, 0.0))
                by_route[route][key] = max(by_route[route][key], row.get(key, 0.0))
            for key, value in faults.items():
                least_fault[key] = min(least_fault.get(key, math.inf), value)
            del qf, kf, vf, dof, o_r, lse_r, dq_r, dk_r, dv_r, dg_r
            if gate_name == "soft" and sites:
                row.update(time_training_kernels(q, k, v, do, soft, o, lse))
                row["sites_per_256px_forward"] = sites
                for kind in ("fwd_lse", "bwd", *backward_kinds(b, h, s_q, s_kv)):
                    row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = training_bound(
                        kind, b, h, s_q, s_kv)
                rows.append(row)
            emit(row)
            del o, lse, dq, dk, dv, dgate
        torch.cuda.empty_cache()
    return rows, {"limits": limits, "worst": worst, "worst_by_route": by_route,
                  "least_planted_fault": least_fault, "repeats_bit_for_bit": True}


def fused_kernel_alone(q, k, v, gate, o, lse, do):
    """The one-pass kernel's launch alone, as `gated_flash_bwd_fused` makes it
    but without the reduction a split plan adds after it (for its time)."""
    import torch
    from diffusion_pruning_tpu_torch.ops import build
    from diffusion_pruning_tpu_torch.ops import flash_attention as fa
    b, s_q, h, d = q.shape
    plan = fa.backward_plan(b, h, s_q, k.shape[1])
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    part = torch.empty(plan.dgate_parts[0], device=q.device)
    ws = (None if plan.workspace_shape is None
          else torch.empty(plan.workspace_shape, device=q.device))
    build.launch("gated_flash_bwd_fused", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), do.data_ptr(), lse.data_ptr(), build.ptr(gate), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), build.ptr(ws), part.data_ptr(), b, h, s_q,
                 k.shape[1], plan.chunks, plan.blocks, d ** -0.5)
    return dq, ws, part


def time_training_kernels(q, k, v, do, gate, o, lse):
    """Device times (`device_ms`) at one shape of the training forward, of the
    backward as the caller runs it (`gated_flash_backward`: its kernels and
    the dgate sums, "bwd"), of each backward kernel of the shape's route
    alone, and of PyTorch's SDPA on pre-masked bf16 q/k/v: its forward under
    autograd (which keeps the lse) and its backward (dq, dk, dv; no dgate),
    taken as a forward and backward replayed together less the forward
    alone. The same with the operands in device memory under `*_cold_ms`,
    issued eagerly under `*_eager_ms`. The plain versions (bf16 inputs, as a
    caller without the kernels would run them) are timed eagerly by CUDA
    events."""
    import torch
    import torch.nn.functional as F
    from diffusion_pruning_tpu_torch.ops import flash_attention as fa

    b, s_q, h, _ = q.shape
    plan = fa.backward_plan(b, h, s_q, k.shape[1])
    n = 10 if q.shape[1] * k.shape[1] >= 2 ** 20 else 20
    g = gate[:, None, :, None].to(q.dtype)
    gq, gk, gv = ((t * g).transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    gdo = do.transpose(1, 2)

    def sdpa_step(a, b_, c, dout):  # leaves of their own: `cold_device_ms` hands it clones
        a, b_, c = (t.detach().requires_grad_() for t in (a, b_, c))
        return torch.autograd.grad(F.scaled_dot_product_attention(a, b_, c), (a, b_, c), dout)

    # each call with its arguments and the bytes it writes (for `cold_device_ms`)
    nq, nk = q.numel() * 2, k.numel() * 2
    args = (q, k, v, gate, o, lse, do)
    calls = {"fwd_lse": (fa.gated_flash_forward_lse, (q, k, v, gate), nq),
             "bwd": (fa.gated_flash_backward, args, nq + 2 * nk),
             "fwd_lse_library": (lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c),
                                 (gq, gk, gv), nq),
             "step_library": (sdpa_step, (gq, gk, gv, gdo), 2 * nq + 2 * nk)}
    if plan.route == "two_kernel":
        _, stats, _ = fa.gated_flash_bwd_dq(*args)
        calls["dq"] = (fa.gated_flash_bwd_dq, args, nq)
        calls["dkv"] = (fa.gated_flash_bwd_dkv, (q, k, v, gate, stats, do), 2 * nk)
    else:
        ws_bytes = 4 * math.prod(plan.workspace_shape) if plan.chunks > 1 else 2 * nk
        calls["fused"] = (fused_kernel_alone, args, nq + ws_bytes)
        if plan.chunks > 1:
            ws = torch.randn(plan.workspace_shape, device=q.device)
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            calls["reduce"] = (fa.gated_flash_bwd_reduce, (ws, dk, dv), 0)
    out = {}
    for name, (fn, fn_args, out_bytes) in calls.items():
        out[f"{name}_ms"] = device_ms(lambda: fn(*fn_args), n)
        out[f"{name}_eager_ms"] = time_ms(lambda: fn(*fn_args), n)
        out[f"{name}_cold_ms"] = cold_device_ms(fn, fn_args, out_bytes)
    for key in ("ms", "eager_ms", "cold_ms"):
        out[f"bwd_library_{key}"] = (out.pop(f"step_library_{key}")
                                     - out[f"fwd_lse_library_{key}"])
    out["fwd_lse_plain_ms"] = time_ms(
        lambda: fa.gated_attention_reference_lse(q, k, v, gate), 3, warmup=1)
    out["bwd_plain_ms"] = time_ms(
        lambda: fa.gated_flash_backward_reference(*args), 3, warmup=1)
    if "reduce" in calls:
        out["reduce_plain_ms"] = time_ms(lambda: ws.sum(0).to(q.dtype), 3, warmup=1)
    return out


# ---------------------------------------------------------------- phase 8

def build_trainer(pipe, device, gen):
    """The stage-1 modules at full width: the U-Net, VAE and CLIP of the
    serving phases in bf16 (frozen), a fresh hypernet and codebook (f32)."""
    import torch
    from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
    from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
    from diffusion_pruning_tpu_torch.training import PrunerConfig, PrunerModules, make_optimizer
    from diffusion_pruning_tpu_torch.utils.init_utils import random_init_

    spec = pipe.unet.spec
    with torch.device(device):
        hypernet = HyperStructure(spec, input_dim=768)
        quantizer = StructureQuantizer(spec, n_e=8, base=3.0, depth_order=DEPTH_ORDER)
    random_init_(hypernet, gen)
    quantizer.init_params(gen)
    quantizer.init_state()
    mods = PrunerModules(unet=pipe.unet, vae=pipe.vae.to(torch.bfloat16),
                         text_encoder=pipe.text_encoder.to(torch.bfloat16), hypernet=hypernet,
                         quantizer=quantizer, schedule=pipe.schedule)
    cfg = PrunerConfig()  # the coco yaml's losses, AdamW, √batch LR, 100 warmup steps
    return mods, cfg, make_optimizer(cfg, mods, TRAIN_B)


def trainables(mods):
    """(name, parameter) of everything the step trains."""
    return ([(f"hypernet.{n}", p) for n, p in mods.hypernet.named_parameters()]
            + [("codebook", mods.quantizer.embedding.weight)])


def kernel_wrappers():
    """Every kernel wrapper of the port, by the name its launches are reported under."""
    from diffusion_pruning_tpu_torch.ops import flash_attention as fa
    from diffusion_pruning_tpu_torch.ops import group_norm as gn
    from diffusion_pruning_tpu_torch.ops import norm_conv as nc
    return {"gated_flash_fwd": fa.gated_flash_attention,
            "gated_flash_fwd_lse": fa.gated_flash_forward_lse,
            "gated_flash_bwd_fused": fa.gated_flash_bwd_fused,
            "gated_flash_bwd_reduce": fa.gated_flash_bwd_reduce,
            "gated_flash_bwd_dq": fa.gated_flash_bwd_dq,
            "gated_flash_bwd_dkv": fa.gated_flash_bwd_dkv,
            "group_norm_silu": gn.group_norm_silu_forward,
            "norm_conv3x3": nc.norm_conv3x3,
            "norm_linear": nc.norm_linear}


def attention_per_step():
    """Launches of each attention kernel in one train step: 32 of the lse-free
    forward (the teacher), 32 of the training forward, and the backward
    kernels `backward_plan` picks at each of the 32 sites at B = 64."""
    from diffusion_pruning_tpu_torch.ops import flash_attention as fa
    out = collections.Counter({"gated_flash_fwd": 32, "gated_flash_fwd_lse": 32})
    for s_q, s_kv, h, sites in TRAIN_CASES:
        for name, n in fa.backward_plan(TRAIN_B, h, s_q, s_kv).launches.items():
            out[name] += n * sites
    return dict(out)


def kernel_counters():
    """Launches of the kernels that no wrapper counts alone, by kernel name:
    the two forward kernels the attention wrappers choose between by
    `forward_plan` (`forward_launches`), and the reduction a split conv plan
    adds."""
    from diffusion_pruning_tpu_torch.ops import flash_attention as fa
    from diffusion_pruning_tpu_torch.ops import norm_conv as nc
    return {"kernel:gated_flash_fwd_wgmma": (fa.forward_launches, "gated_flash_fwd_wgmma"),
            "kernel:gated_flash_fwd_small": (fa.forward_launches, "gated_flash_fwd_small"),
            "conv_split_reduce": (vars(nc.conv_split_reduce), "launches")}


def launch_counts():
    """Every wrapper's count (exact per forward and per step, checked) and
    every kernel counter's."""
    counts = {name: wrapper.launches for name, wrapper in kernel_wrappers().items()}
    counts.update({name: holder[key] for name, (holder, key) in kernel_counters().items()})
    return counts


def reset_launch_counts():
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0
    for holder, key in kernel_counters().values():
        holder[key] = 0


def wrapper_counts(counts):
    """The wrappers' entries of `counts`, whose launches per forward or step
    are fixed; the forward kernels' add up to the attention wrappers'."""
    if (counts["kernel:gated_flash_fwd_wgmma"] + counts["kernel:gated_flash_fwd_small"]
            != counts["gated_flash_fwd"] + counts["gated_flash_fwd_lse"]):
        fail(f"the forward kernels' launches do not add up to their wrappers': {counts}")
    return {k: v for k, v in counts.items() if k in kernel_wrappers()}


def train(mods, cfg, opt, device, n_steps=TRAIN_STEPS, per_step=None, phase="train_step"):
    """`n_steps` full-width steps (one pretrain step, then codebook steps) from
    random pixels, ids and MPNet embeddings: per-step seconds, stage times and
    launches, peak memory. `per_step`: the launches each kernel must show in
    a step (default: `attention_per_step`, no other)."""
    import torch
    from diffusion_pruning_tpu_torch.training import make_pruner_step

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    b, res = TRAIN_B, mods.unet.cfg.sample_size * mods.vae.cfg.spatial_scale
    vocab = mods.text_encoder.cfg.vocab_size
    batch = {"pixel_values": torch.rand(b, res, res, 3, device=device, generator=gen) * 2 - 1,
             "input_ids": torch.randint(0, vocab, (b, 77), device=device, generator=gen),
             "mpnet_embeddings": torch.randn(b, 768, device=device, generator=gen)}
    steps = {True: make_pruner_step(mods, cfg, opt, pretrain=True),
             False: make_pruner_step(mods, cfg, opt, pretrain=False)}
    before = {name: p.detach().clone() for name, p in trainables(mods)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    per_step = {**attention_per_step(), **(per_step or {})}
    rows = []
    for i in range(n_steps):
        pretrain = i == 0
        counts = launch_counts()
        marks = [("start", torch.cuda.Event(enable_timing=True))]
        marks[0][1].record()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

        t0 = time.perf_counter()
        metrics, aux = steps[pretrain](batch, generator=gen, mark=mark)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v - counts[k] for k, v in launch_counts().items()}
        row = {"phase": phase, "step": i, "pretrain": pretrain, "batch": b,
               "resolution": res, "seconds": seconds,
               "stages_ms": {name: marks[j - 1][1].elapsed_time(ev)
                             for j, (name, ev) in enumerate(marks) if j},
               "launches": launches,
               **{k: float(v) for k, v in metrics.items()},
               "expert_counts": torch.bincount(aux["expert_indices"], minlength=8).tolist()}
        emit(row)
        terms = [k for k in metrics if k != "skipped"]
        if row["skipped"] or not all(math.isfinite(row[k]) for k in terms):
            fail(f"train step {i} gave a non-finite loss or was skipped: {row}")
        checked = wrapper_counts(launches)
        if checked != {k: per_step.get(k, 0) for k in checked}:
            fail(f"expected {per_step} launches per step, got {launches}")
        rows.append(row)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    changed = {name: not torch.equal(p.detach(), before[name]) for name, p in trainables(mods)}
    if not (all(changed.values())):
        fail(f"trainables that did not change over {n_steps} steps: "
             f"{[n for n, c in changed.items() if not c]}")
    warm = [r["seconds"] for r in rows[1:]]
    median = statistics.median(warm)
    stages = {name: statistics.median(r["stages_ms"][name] for r in rows[1:])
              for name in rows[-1]["stages_ms"]}
    summary = {"phase": phase.replace("step", "summary"), "batch": b, "resolution": res,
               "seconds_per_step_median_warm": median, "seconds_warm": warm,
               "samples_per_sec": b / median, "stages_ms_median_warm": stages,
               "peak_memory_gib": peak_gib, "remat": mods.unet.cfg.remat,
               "launches": launch_counts()}
    emit(summary)
    return batch, summary


def step_grads(mods, cfg, batch, draws, pretrain):
    """The step's gradient of every trainable at the current parameters (no
    update)."""
    import torch
    from diffusion_pruning_tpu_torch.training import compute_losses
    for _, p in trainables(mods):
        p.grad = None
    p_actual = mods.resource_model.actual_pruning_target(cfg.pruning_target)
    loss, _ = compute_losses(mods, cfg, batch, draws, pretrain, p_actual)
    loss.backward()
    grads = {name: (p.grad.detach().float().clone() if p.grad is not None
                    else torch.zeros_like(p, dtype=torch.float32)) for name, p in trainables(mods)}
    for _, p in trainables(mods):
        p.grad = None
    return grads


@contextlib.contextmanager
def without_dgate():
    """A planted fault: the backward kernels' gate gradient dropped."""
    from diffusion_pruning_tpu_torch.ops import flash_attention as fa
    real = fa.gated_flash_backward

    def faulty(*args):
        dq, dk, dv, dgate = real(*args)
        return dq, dk, dv, None if dgate is None else dgate.zero_()

    fa.gated_flash_backward = faulty
    try:
        yield
    finally:
        fa.gated_flash_backward = real


def leaf_cosines(got, want):
    """Cosine per leaf, over the leaves whose reference gradient is not 0."""
    import torch
    out = {}
    for name, w in want.items():
        wn = w.norm()
        if wn > 0:
            out[name] = (torch.dot(got[name].flatten(), w.flatten())
                         / (got[name].norm() * wn).clamp_min(1e-30)).item()
    return out


def check_train_grads(mods, cfg, batch, device):
    """The step's grads through the kernels against the same step with plain
    attention (bf16, under autograd), in both phases, on one batch and one
    set of draws; and, in the pretrain phase, a planted fault (the kernels'
    dgate dropped) that the limit must catch."""
    import torch
    from diffusion_pruning_tpu_torch.ops.flash_attention import gated_attention_reference
    from diffusion_pruning_tpu_torch.training.pruner import complete_draws

    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    draws = complete_draws(mods, cfg, batch, None, gen)
    out = {"phase": "train_grad_check", "limit": GRAD_COS}
    for pretrain in (True, False):
        kernel = step_grads(mods, cfg, batch, draws, pretrain)
        with unet_attention(gated_attention_reference):
            plain = step_grads(mods, cfg, batch, draws, pretrain)
        cos = leaf_cosines(kernel, plain)
        worst = min(cos, key=cos.get)
        entry = {"leaves": len(cos), "min_cos": cos[worst], "min_cos_leaf": worst,
                 "median_cos": statistics.median(cos.values()),
                 "codebook_cos": cos.get("codebook")}
        with without_dgate():
            cos_fault = leaf_cosines(step_grads(mods, cfg, batch, draws, pretrain), plain)
        worst_fault = min(cos_fault, key=cos_fault.get)
        entry.update(planted_fault_no_dgate_min_cos=cos_fault[worst_fault],
                     planted_fault_leaf=worst_fault)
        out["pretrain" if pretrain else "codebook"] = entry
    emit(out)
    for phase in ("pretrain", "codebook"):
        if not out[phase]["min_cos"] > GRAD_COS:
            fail(f"kernel-path grads disagree with plain attention ({phase}): {out}")
    if not out["pretrain"]["planted_fault_no_dgate_min_cos"] <= GRAD_COS:
        fail(f"the planted fault reads within the limit {GRAD_COS}: {out}")
    return out


def profile_train_step(mods, cfg, opt, batch, device):
    """One more codebook step under torch.profiler: device kernel time by
    category and the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from diffusion_pruning_tpu_torch.training import make_pruner_step

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    step = make_pruner_step(mods, cfg, opt, pretrain=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    row = {"phase": "train_profile", "batch": TRAIN_B, "wall_ms": wall_ms,
           **device_kernel_times(prof, wall_ms)}
    emit(row)
    return row


def training_entry(rows, kind: str, plain_key: str, library_key) -> dict:
    """A training kernel's times summed over the attention sites of one
    student pass where it runs (the rows that time it). The plain and
    library times of the backward kernels are those of one call that
    computes dq, dk and dv together at the same sites."""
    mine = [r for r in rows if f"{kind}_ms" in r]

    def total(key):
        return sum(r[key] * r["sites_per_256px_forward"] for r in mine)
    ops = sum(r[f"{kind}_bound_ms"] * r["sites_per_256px_forward"] for r in mine
              if r[f"{kind}_bound_by"] == "operations")
    bound = total(f"{kind}_bound_ms")
    extra = {}
    if library_key is not None:
        extra.update(library_cold_ms=total(library_key.replace("_ms", "_cold_ms")),
                     library_eager_ms=total(library_key.replace("_ms", "_eager_ms")))
    return {"ms": total(f"{kind}_ms"), "cold_ms": total(f"{kind}_cold_ms"),
            "eager_ms": total(f"{kind}_eager_ms"), "plain_ms": total(plain_key),
            "bound_ms": bound, "bound_by": "operations" if ops >= bound / 2 else "bytes",
            "library_ms": None if library_key is None else total(library_key), **extra,
            "sites": sum(r["sites_per_256px_forward"] for r in mine),
            "shapes": "its attention sites of one student U-Net pass of the stage-1 step at "
                      "256px, B = 64, bf16, soft gates"}


def small_forward_summary(rows) -> dict:
    """The training forward (with lse) at the S_q <= 64 shapes of phase 7
    (B = 64): per shape, and summed over their 12 sites of a student pass."""
    from diffusion_pruning_tpu_torch.ops.flash_attention import forward_kernel
    mine = [r for r in rows if forward_kernel(r["s_q"], r["s_kv"]) == "gated_flash_fwd_small"]
    keys = ("ms", "cold_ms", "eager_ms", "bound_ms", "library_ms")
    per_shape = [{"s_q": r["s_q"], "s_kv": r["s_kv"], "h": r["h"],
                  "sites": r["sites_per_256px_forward"],
                  **{k: r[f"fwd_lse_{k}"] for k in keys}} for r in mine]
    return {"phase": "training_forward_small_q", "kernel": "gated_flash_fwd_small",
            "batch": TRAIN_B, "per_shape": per_shape,
            **{k: sum(r[k] * r["sites"] for r in per_shape) for k in keys},
            "sites": sum(r["sites"] for r in per_shape),
            "library_call": "F.scaled_dot_product_attention forward of pre-masked q/k/v under "
                            "autograd"}


def backward_summary(rows) -> dict:
    """The backward as one function over the 32 sites of a student pass: the
    caller's time (kernels and dgate sums) against the function's bound and
    SDPA's backward, the kernels' own times and bounds summed beside it, and
    one line per shape."""
    whole = training_entry(rows, "bwd", "bwd_plain_ms", "bwd_library_ms")
    kernels = {kind: training_entry(rows, kind, "bwd_plain_ms", None)
               for kind in ("fused", "reduce", "dq", "dkv")}
    per_shape = [{"s_q": r["s_q"], "s_kv": r["s_kv"], "h": r["h"],
                  "sites": r["sites_per_256px_forward"], "route": r["route"],
                  "kernels": r["backward_kernels"], "ms": r["bwd_ms"],
                  "cold_ms": r["bwd_cold_ms"], "eager_ms": r["bwd_eager_ms"],
                  "bound_ms": r["bwd_bound_ms"], "bound_by": r["bwd_bound_by"],
                  "library_ms": r["bwd_library_ms"], "library_cold_ms": r["bwd_library_cold_ms"],
                  "x_library": r["bwd_ms"] / r["bwd_library_ms"],
                  "x_bound": r["bwd_ms"] / r["bwd_bound_ms"],
                  **{f"{k}_ms": r[f"{k}_ms"] for k in r["backward_kernels"]}}
                 for r in rows]
    return {"phase": "backward_summary", **whole,
            "x_library": whole["ms"] / whole["library_ms"],
            "x_bound": whole["ms"] / whole["bound_ms"],
            "kernels_ms": sum(e["ms"] for e in kernels.values()),
            "kernels_cold_ms": sum(e["cold_ms"] for e in kernels.values()),
            "kernels_bound_ms": sum(e["bound_ms"] for e in kernels.values()),
            "by_kernel": kernels, "per_shape": per_shape}


# ---------------------------------------------------------------- phase 9

def fused_twin(unet, **flags):
    """A U-Net under the given fused flags on the same parameter tensors."""
    import torch
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    with torch.device("meta"):
        twin = GatedUNet(dataclasses.replace(unet.cfg, **flags))
    twin.load_state_dict(unet.state_dict(), assign=True)
    return twin.requires_grad_(False).eval()


def unet_inputs(unet, device, seed=SEED + 1, b=FUSED_B // 2):
    """The inputs of phase 4: B_eff = 2·b latents, timesteps, text states, b arch rows."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    cfg = unet.cfg
    x = torch.randn(2 * b, cfg.sample_size, cfg.sample_size, 4, device=device, generator=gen)
    t = torch.randint(0, 1000, (2 * b,), device=device, generator=gen)
    ehs = torch.randn(2 * b, 77, cfg.cross_attention_dim, device=device, generator=gen)
    return x, t, ehs, random_arch(unet.spec, b, gen)


def fused_sites(unet, device):
    """The shapes the U-Net gives the fused-norm ops in one 256px forward, read
    off its resnets, transformers and output head with forward hooks:
    {"gn": {(C, H, W, silu, eps): sites}, "conv": {(C_in, C_out, H, W, gated):
    sites}, "linear": {(S, C): sites}}."""
    import torch
    from diffusion_pruning_tpu_torch.models.unet.blocks import (GatedResnetBlock,
                                                                GatedTransformer2D)
    sites = {k: collections.Counter() for k in ("gn", "conv", "linear")}

    def resnet_hook(block, args, kwargs):
        x = args[0]
        gated = (args[2] if len(args) > 2 else kwargs.get("gate")) is not None
        cin, (h, w), cout = x.shape[1], x.shape[2:], block.conv1.out_channels
        eps = block.norm1.eps
        sites["gn"][(cin, h, w, True, eps)] += 1
        sites["gn"][(cout, h, w, True, eps)] += 1
        sites["conv"][(cin, cout, h, w, False)] += 1
        sites["conv"][(cout, cout, h, w, gated)] += 1

    def transformer_hook(block, args, kwargs):
        c, h, w = args[0].shape[1:]
        sites["gn"][(c, h, w, False, block.norm.eps)] += 1
        sites["linear"][(h * w, c)] += 1

    def head_hook(conv, args):
        cin, h, w = args[0].shape[1:]
        sites["conv"][(cin, conv.out_channels, h, w, False)] += 1

    hooks = [unet.conv_out.register_forward_pre_hook(head_hook)]
    for m in unet.modules():
        if isinstance(m, GatedResnetBlock):
            hooks.append(m.register_forward_pre_hook(resnet_hook, with_kwargs=True))
        elif isinstance(m, GatedTransformer2D):
            hooks.append(m.register_forward_pre_hook(transformer_hook, with_kwargs=True))
    x, t, ehs, arch = unet_inputs(unet, device)
    with torch.inference_mode():
        unet(x, t, ehs, arch=arch)
    for hook in hooks:
        hook.remove()
    return sites


# the 512px level-0 shapes (B_eff = 4 for 2 prompts); none is a site of the 256px forward
GN_512 = ((320, 64, 64, True, 1e-5), (640, 64, 64, True, 1e-5), (960, 64, 64, True, 1e-5),
          (320, 64, 64, False, 1e-6))
CONV_512 = ((320, 320, 64, 64, True), (960, 320, 64, 64, False), (640, 320, 64, 64, False),
            (320, 4, 64, 64, False))
LINEAR_512 = ((4096, 320),)


def per_sample_rel_l2(out, ref):
    """||out - ref|| / ||ref|| for each batch element."""
    dims = tuple(range(1, out.dim()))
    err = (out.float() - ref.float()).square().sum(dim=dims).sqrt()
    return err / ref.float().square().sum(dim=dims).sqrt().clamp_min(1e-30)


def fused_inputs(b, c, h, w, gen, groups=32):
    """A bf16 channels_last activation whose groups differ in scale over three
    decades (std 1e-3 to 1, mean half a std), so that the epsilon matters in
    some of them; a GroupNorm affine; a soft and a hard per-channel gate (the
    hard one closes the first group of every row and ~40 % of the others)."""
    import torch
    device = gen.device
    std = 10 ** (-3 * torch.rand(b, groups, device=device, generator=gen))
    std_c = std.repeat_interleave(c // groups, dim=1)[:, :, None, None]
    x = ((torch.randn(b, c, h, w, device=device, generator=gen) + 0.5) * std_c).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last)
    scale = 1.0 + 0.1 * torch.randn(c, device=device, generator=gen)
    bias = 0.1 * torch.randn(c, device=device, generator=gen)
    soft = torch.rand(b, groups, device=device, generator=gen)
    hard = (torch.rand(b, groups, device=device, generator=gen) < 0.6).float()
    hard[:, 0] = 0.0
    expand = lambda g: g.repeat_interleave(c // groups, dim=1)  # noqa: E731
    return x, scale, bias, {"none": None, "soft": expand(soft), "hard": expand(hard)}


def bound_ms(flops: float, peak_flops: float, nbytes: float):
    flop_ms, byte_ms = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(flop_ms, byte_ms), "operations" if flop_ms >= byte_ms else "bytes"


class FusedCheck:
    """Readings of one fused-norm kernel over its cases: the worst sound
    reading, the least reading of each planted fault, and the timed rows.
    In a timed row `ms` and `library_ms` are device times (`device_ms`),
    `eager_ms` and `library_eager_ms` the same calls issued eagerly
    (`time_ms`: the larger of the host's pace and the device's), `op_ms` the
    public op issued eagerly, phase 1 included."""

    def __init__(self, name):
        self.name = name
        self.worst = {"rel_l2": 0.0, "max_abs_err": 0.0, "rel_l2_vs_unfused": 0.0}
        self.least_fault = {}
        self.rows = []
        self.batches = set()

    def take(self, row, out, ref, unfused, faults):
        """Hold one case to the limit and its planted faults above it."""
        import torch
        row.update(phase="fused_kernel_check", kernel=self.name,
                   rel_l2=per_sample_rel_l2(out, ref).max().item(),
                   rel_l2_vs_unfused=per_sample_rel_l2(out, unfused).max().item(),
                   max_abs_err=(out.float() - ref).abs().max().item(),
                   ref_mean_abs=ref.abs().mean().item(),
                   planted_faults={k: per_sample_rel_l2(v, ref).max().item()
                                   for k, v in faults.items()})
        sound = (bool(torch.isfinite(out).all()) and row["rel_l2"] <= FUSED_REL_L2
                 and row["rel_l2_vs_unfused"] <= FUSED_REL_L2)
        if not sound:
            emit(row)
            fail(f"{self.name} disagrees with its plain version: {row}")
        caught = [k for k, v in row["planted_faults"].items() if not v > FUSED_REL_L2]
        if caught:
            emit(row)
            fail(f"planted faults read within the limit {FUSED_REL_L2} ({caught}): {row}")
        self.batches.add(row["b"])
        for key in self.worst:
            self.worst[key] = max(self.worst[key], row[key])
        for key, value in row["planted_faults"].items():
            self.least_fault[key] = min(self.least_fault.get(key, math.inf), value)

    def entry(self):
        """The kernel's times summed over the sites of one 256px forward."""
        def total(key):
            return sum(r[key] * r["sites"] for r in self.rows)
        ops = sum(r["bound_ms"] * r["sites"] for r in self.rows if r["bound_by"] == "operations")
        cold = {key: total(key) for key in ("cold_ms", "library_cold_ms")
                if all(key in r for r in self.rows)}
        return {"ms": total("ms"), **cold, "eager_ms": total("eager_ms"), "op_ms": total("op_ms"),
                "plain_ms": total("plain_ms"), "library_ms": total("library_ms"),
                "library_eager_ms": total("library_eager_ms"), "bound_ms": total("bound_ms"),
                "bound_by": "operations" if ops >= total("bound_ms") / 2 else "bytes",
                "launches_per_forward": sum(r["sites"] for r in self.rows),
                "max_abs_err": self.worst["max_abs_err"], "rel_l2_worst": self.worst["rel_l2"]}


def check_group_norm_kernel(sites, device, check):
    import torch
    import torch.nn.functional as F
    from diffusion_pruning_tpu_torch.ops import group_norm as gn

    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    cases = ([(FUSED_B, key, n) for key, n in sorted(sites.items())] + [(4, k, 0) for k in GN_512]
             + [(TRAIN_B, key, 0) for key in sorted(sites)])
    for b, (c, h, w, silu, eps), n in cases:
        x0, scale, bias, gates = fused_inputs(b, c, h, w, gen)
        for gate_name, gate_c in gates.items():
            x = x0 if gate_c is None else x0 * gate_c[:, :, None, None].bfloat16()
            out = gn.group_norm_silu_forward(x, scale, bias, 32, eps, silu)
            xf = x.float()
            ref = gn.group_norm_silu_plain(xf, scale, bias, 32, eps, silu)
            unfused = gn.group_norm_silu_unfused(xf, scale, bias, 32, eps, silu)
            # the other norm's eps; a variance that forgets mean²
            xg = xf.reshape(b, 32, c // 32, h * w)
            uncentred = (xg - xg.mean(dim=(2, 3), keepdim=True)) * torch.rsqrt(
                (xg * xg).mean(dim=(2, 3), keepdim=True) + eps)
            uncentred = uncentred.reshape(x.shape) * scale[None, :, None, None] \
                + bias[None, :, None, None]
            faults = {"other_eps": gn.group_norm_silu_plain(xf, scale, bias, 32,
                                                            1e-6 if eps > 5e-6 else 1e-5, silu),
                      "uncentred_variance": F.silu(uncentred) if silu else uncentred}
            plan = gn.group_norm_plan(b, h * w, c, 32)
            row = {"b": b, "c": c, "h": h, "w": w, "silu": silu, "eps": eps, "gate": gate_name,
                   "sites": n,
                   "plan": {"window": plan.window, "cluster": plan.cluster, "rows": plan.rows,
                            "threads": plan.threads, "ctas": plan.ctas,
                            "one_read": plan.one_read, "tma": plan.tma,
                            "smem_bytes": plan.smem_bytes}}
            check.take(row, out, ref, unfused, faults)
            if gate_name == "hard":  # the closed group: variance 0, act(bias)
                want = bias[: c // 32]
                want = want * torch.sigmoid(want) if silu else want
                row["closed_group_max_abs_err"] = (
                    out[:, : c // 32].float() - want[None, :, None, None]).abs().max().item()
                if not row["closed_group_max_abs_err"] <= 1e-2:
                    emit(row)
                    fail(f"a closed group does not give act(bias): {row}")
            if gate_name == "none":
                sb, bb = scale.bfloat16(), bias.bfloat16()
                act = F.silu if silu else (lambda y: y)
                iters = 20

                def kernel():
                    return gn.group_norm_silu_forward(x, scale, bias, 32, eps, silu)

                def library():
                    return act(F.group_norm(x, 32, sb, bb, eps))

                row["ms"] = device_ms(kernel, iters)
                row["cold_ms"] = cold_device_ms(
                    lambda t: gn.group_norm_silu_forward(t, scale, bias, 32, eps, silu), (x,),
                    2.0 * x.numel())
                row["library_cold_ms"] = cold_device_ms(
                    lambda t: act(F.group_norm(t, 32, sb, bb, eps)), (x,), 2.0 * x.numel())
                row["eager_ms"] = time_ms(kernel, iters)
                row["op_ms"] = time_ms(
                    lambda: gn.group_norm_silu(x, scale, bias, 32, eps, silu), iters)
                row["plain_ms"] = time_ms(
                    lambda: gn.group_norm_silu_plain(x, scale, bias, 32, eps, silu), 3, warmup=1)
                row["library_ms"] = device_ms(library, iters)
                row["library_eager_ms"] = time_ms(library, iters)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    10.0 * x.numel(), PEAK_F32_FLOPS, 4.0 * x.numel() + 8.0 * c)
                check.rows.append(row)
            emit(row)
        del x0, x, out, xf, ref, unfused, xg, uncentred, faults
    torch.cuda.empty_cache()


def time_split_reduce(row, plan, cbias, check):
    """The split plan's reduction kernel at one timed conv shape, on a random
    workspace: held against its plain version (f32 sums in the same slice
    order, so it must agree to the bf16 rounding) and timed. Adds its times
    to `row` under `reduce_*`."""
    import torch
    from diffusion_pruning_tpu_torch.ops import norm_conv as nc
    gen = torch.Generator(device=cbias.device).manual_seed(SEED + 16)
    ws = torch.randn(plan.workspace_shape, device=cbias.device, generator=gen)
    b, h, w = row["b"], row["h"], row["w"]

    def kernel(ws_):
        out = torch.empty((b, plan.cout, h, w), device=ws_.device, dtype=torch.bfloat16,
                          memory_format=torch.channels_last)
        return nc.conv_split_reduce(ws_, cbias, out)

    got = kernel(ws).permute(0, 2, 3, 1).reshape(plan.m, plan.cout).float()
    want = nc.conv_split_reduce_plain(ws, cbias, torch.float32)
    err = (got - want).abs().max().item()
    # the kernel's sum in slice order, rounded once: within half a bf16 ulp of the f32 sum
    ulp = (got - want).abs().div(want.abs().clamp_min(1e-30)).max().item()
    check["max_abs_err"] = max(check["max_abs_err"], err)
    check["max_rel_err"] = max(check["max_rel_err"], ulp)
    if not ulp <= 2.0 ** -8:
        fail(f"conv_split_reduce disagrees with its plain version: {ulp} > 2^-8 at {row}")
    row["reduce_ms"] = device_ms(lambda: kernel(ws), 20)
    row["reduce_cold_ms"] = cold_device_ms(kernel, (ws,), 2.0 * plan.m * plan.cout)
    row["reduce_plain_ms"] = time_ms(
        lambda: nc.conv_split_reduce_plain(ws, cbias, torch.bfloat16), 5, warmup=1)
    row["reduce_bound_ms"] = (4.0 * ws.numel() + 4.0 * plan.cout
                              + 2.0 * plan.m * plan.cout) / PEAK_BYTES * 1e3
    row["reduce_max_rel_err"] = ulp


SPLIT_SWEEP = ((16, 1280, 1280, 4, 4), (16, 2560, 1280, 4, 4), (16, 1280, 1280, 8, 8),
               (64, 2560, 1280, 4, 4), (16, 640, 640, 16, 16))


def sweep_conv_splits(device):
    """Device ms of the conv kernel (with its reduction) under each split over
    K at a few shapes of the small maps, the rest of `conv_plan`'s plan
    kept: the measurement behind its rule (one full wave, never a second)."""
    import torch
    from diffusion_pruning_tpu_torch.ops import build
    from diffusion_pruning_tpu_torch.ops import norm_conv as nc
    gen = torch.Generator(device=device).manual_seed(SEED + 18)
    for b, cin, cout, h, w in SPLIT_SWEEP:
        x = torch.randn(b, cin, h, w, device=device, generator=gen).bfloat16()
        x = x.contiguous(memory_format=torch.channels_last)
        a = torch.ones(b, cin, device=device)
        shift = torch.zeros(b, cin, device=device)
        packed = (torch.randn(cout, 3, 3, cin, device=device, generator=gen)
                  * (9 * cin) ** -0.5).bfloat16()
        cbias = torch.zeros(cout, device=device)
        plan = nc.conv_plan(b, h, w, cin, cout)

        def conv(split):
            p = dataclasses.replace(plan, split=split)
            out = torch.empty((b, cout, h, w), device=device, dtype=torch.bfloat16,
                              memory_format=torch.channels_last)
            ws = nc.conv_workspace(p, device)
            build.launch("norm_conv3x3", device, x.data_ptr(), a.data_ptr(), shift.data_ptr(),
                         packed.data_ptr(), cbias.data_ptr(), out.data_ptr(), build.ptr(ws), b,
                         h, w, cin, cout, 1, p.patch[0], p.bn, split)
            return out if ws is None else nc.conv_split_reduce(ws, cbias, out)

        splits = sorted({1, 2, 4, 8, 16, plan.split} & set(range(1, plan.chunks + 1)))
        emit({"phase": "conv_split_sweep", "b": b, "c_in": cin, "c_out": cout, "h": h, "w": w,
              "plan_split": plan.split, "base_blocks": plan.m_tiles * plan.n_tiles,
              "ms_by_split": {sp: device_ms(lambda: conv(sp), 10) for sp in splits}})
    torch.cuda.empty_cache()


LINEAR_SPLIT_SWEEP = ((16, 64, 1280), (16, 16, 1280), (64, 16, 1280), (4, 256, 1280),
                      (16, 256, 640))


def sweep_linear_splits(device):
    """Device ms of the linear kernel (with its reduction) under each split
    over K at the short-grid proj_in shapes, the rest of `linear_plan`'s plan
    kept: the measurement behind its rule."""
    import torch
    from diffusion_pruning_tpu_torch.ops import build
    from diffusion_pruning_tpu_torch.ops import norm_conv as nc
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    for b, s_len, c in LINEAR_SPLIT_SWEEP:
        x = torch.randn(b, s_len, c, device=device, generator=gen).bfloat16()
        a = torch.ones(b, c, device=device)
        shift = torch.zeros(b, c, device=device)
        weight = (torch.randn(c, c, device=device, generator=gen) * c ** -0.5).bfloat16()
        lbias = torch.zeros(c, device=device)
        plan = nc.linear_plan(b, s_len, c, c)

        def linear(split):
            p = dataclasses.replace(plan, split=split)
            out = torch.empty((b, s_len, c), device=device, dtype=torch.bfloat16)
            ws = nc.conv_workspace(p, device)
            build.launch("norm_linear", device, x.data_ptr(), a.data_ptr(), shift.data_ptr(),
                         weight.data_ptr(), lbias.data_ptr(), out.data_ptr(), build.ptr(ws), b,
                         s_len, c, c, split, p.ab_rows, p.grid)
            return out if ws is None else nc.conv_split_reduce(ws, lbias, out)

        splits = sorted({1, 2, 3, 4, 5, 8, 10, plan.split} & set(range(1, plan.chunks + 1)))
        emit({"phase": "linear_split_sweep", "b": b, "s": s_len, "c": c,
              "plan_split": plan.split, "base_blocks": plan.m_tiles * plan.n_tiles,
              "ms_by_split": {sp: device_ms(lambda: linear(sp), 10) for sp in splits}})
    torch.cuda.empty_cache()


# an expert's channel widths (C_in, groups): kept groups of the full model's C/32 ∈
# {10, 20, 40} channels; 90, 310 and 620 are no multiple of 8, 1240 is
EXPERT_CHANNELS = ((90, 9), (310, 31), (620, 31), (1240, 31))


def check_expert_channels(device):
    """The fused conv and linear ops at an expert's channel widths, which the
    card path zero-pads to C_in (and the linear's C_out) ≡ 0 mod 8: at 16×16
    and 8×8 maps (256 and 64 tokens), B_eff 16, C_out = C_in, soft gates,
    against their plain versions in f32 on the same bf16 inputs per batch
    element (<= FUSED_REL_L2); one launch of each kernel per op (and the
    reduction where the plan splits K)."""
    import torch
    from diffusion_pruning_tpu_torch.ops import norm_conv as nc
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    rows = []
    for c, groups in EXPERT_CHANNELS:
        for side in (16, 8):
            x, scale, bias, gates = fused_inputs(FUSED_B, c, side, side, gen, groups)
            gate_c = gates["soft"]
            weight = (torch.randn(c, c, 3, 3, device=device, generator=gen)
                      * (9 * c) ** -0.5).bfloat16()
            cbias = 0.1 * torch.randn(c, device=device, generator=gen)
            lweight = (torch.randn(c, c, device=device, generator=gen) * c ** -0.5).bfloat16()
            lbias = 0.1 * torch.randn(c, device=device, generator=gen)
            tokens = x.flatten(2).transpose(1, 2).contiguous()  # (B, S, C)
            before = launch_counts()
            conv = nc.group_norm_silu_conv3x3(x, scale, bias, weight, cbias, gate_c, groups,
                                              1e-5, True, packed=nc.PackedWeight())
            linear = nc.group_norm_linear(tokens, scale, bias, lweight, lbias, gate_c, groups,
                                          1e-6)
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
            a, b = nc.affine_coeffs(x, scale, bias, groups, 1e-5, gate_c)
            conv_ref = nc.norm_conv3x3_plain(x.float(), a, b, weight.float().permute(0, 2, 3, 1),
                                             cbias, True)
            a, b = nc.affine_coeffs(tokens.transpose(1, 2), scale, bias, groups, 1e-6, gate_c)
            linear_ref = nc.norm_linear_plain(tokens.float(), a, b, lweight.float(), lbias)
            splits = (nc.conv_plan(FUSED_B, side, side, nc.aligned_channels(c), c).split,
                      nc.linear_plan(FUSED_B, side * side, nc.aligned_channels(c),
                                     nc.aligned_channels(c)).split)
            want = {"norm_conv3x3": 1, "norm_linear": 1,
                    **({"conv_split_reduce": (splits[0] > 1) + (splits[1] > 1)}
                       if max(splits) > 1 else {})}
            row = {"phase": "expert_channels", "b": FUSED_B, "c_in": c, "groups": groups,
                   "padded_c_in": nc.aligned_channels(c), "h": side, "w": side,
                   "conv_rel_l2": per_sample_rel_l2(conv, conv_ref).max().item(),
                   "linear_rel_l2": per_sample_rel_l2(linear, linear_ref).max().item(),
                   "conv_shape": list(conv.shape), "linear_shape": list(linear.shape),
                   "launches": launched, "limit": FUSED_REL_L2}
            emit(row)
            sound = (row["conv_rel_l2"] <= FUSED_REL_L2 and row["linear_rel_l2"] <= FUSED_REL_L2
                     and conv.shape == conv_ref.shape and linear.shape == linear_ref.shape
                     and bool(torch.isfinite(conv).all()) and bool(torch.isfinite(linear).all()))
            if not sound:
                fail(f"the fused ops disagree at an expert's channel width: {row}")
            if launched != want:
                fail(f"expected {want} launches at an expert's channel width, got {launched}")
            rows.append(row)
    rows += check_expert_group_norm(device, gen)
    torch.cuda.empty_cache()
    return rows


# the GroupNorm of an expert's resnet norm2 (C, groups, map side at 256px):
# kept groups of C/32 ∈ {10, 20, 40} channels, an odd count; at C/G = 10 and 20
# no window of whole groups makes a multiple of 8 channels, so `group_norm_plan`
# takes one group a block with 4- or 8-byte loads over rows of 2·C bytes
GN_EXPERT_CHANNELS = ((90, 9, 32), (170, 17, 32), (310, 31, 32), (620, 31, 16), (1240, 31, 8))


def check_expert_group_norm(device, gen):
    """group_norm_silu at an expert's norm2 widths, with and without SiLU, at
    B_eff 8 and 16, a hard-closed group in every row (variance 0), against
    its plain version in f32 on the same bf16 input per batch element
    (<= FUSED_REL_L2); one launch each."""
    import torch
    from diffusion_pruning_tpu_torch.ops import group_norm as gn
    rows = []
    for c, groups, side in GN_EXPERT_CHANNELS:
        for b in (8, FUSED_B):
            x, scale, bias, gates = fused_inputs(b, c, side, side, gen, groups)
            x = (x * gates["hard"][:, :, None, None].bfloat16()).contiguous(
                memory_format=torch.channels_last)
            plan = gn.group_norm_plan(b, side * side, c, groups)
            for silu, eps in ((True, 1e-5), (False, 1e-6)):
                before = launch_counts()
                out = gn.group_norm_silu(x, scale, bias, groups, eps, silu)
                torch.cuda.synchronize()
                launched = {k: v - before[k] for k, v in launch_counts().items()
                            if v != before[k]}
                ref = gn.group_norm_silu_plain(x.float(), scale, bias, groups, eps, silu)
                row = {"phase": "expert_channels", "kernel": "group_norm_silu", "b": b, "c": c,
                       "groups": groups, "h": side, "w": side, "silu": silu,
                       "rel_l2": per_sample_rel_l2(out, ref).max().item(),
                       "max_abs_err": (out.float() - ref).abs().max().item(),
                       "plan": {"window": plan.window, "vec": plan.vec, "cluster": plan.cluster,
                                "one_read": plan.one_read, "threads": plan.threads},
                       "launches": launched, "limit": FUSED_REL_L2}
                emit(row)
                if not (row["rel_l2"] <= FUSED_REL_L2 and bool(torch.isfinite(out).all())):
                    fail(f"group_norm_silu disagrees at an expert's channel width: {row}")
                if launched != {"group_norm_silu": 1}:
                    fail(f"expected one group_norm_silu launch, got {launched}")
                rows.append(row)
    return rows


def poison_allocator():
    """Leave NaN in the caching allocator's free blocks: the cache is emptied,
    then tensors of 512 B to 256 MB are filled with NaN and freed."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = [torch.full((n // 4,), float("nan"), device="cuda")
            for n in (2 ** k for k in range(9, 29)) for _ in range(2)]
    del held


def nan_filled(alloc):
    """`alloc` (torch.empty or torch.empty_like) whose floating tensors come
    back filled with NaN."""
    def empty(*args, **kwargs):
        t = alloc(*args, **kwargs)
        return t.fill_(float("nan")) if t.is_floating_point() else t
    return empty


def check_poisoned_workspaces(device):
    """The S_q <= 64 forward with lse (the kv tiles 80, 16 and 64), every
    route of `backward_plan` and the conv's and the linear's split
    workspaces, each run twice with NaN in the allocator's free blocks and in
    every buffer the wrappers allocate: finite outputs, equal bit for bit
    (an element read or left unwritten would show)."""
    import torch
    from diffusion_pruning_tpu_torch.ops import flash_attention as fa
    from diffusion_pruning_tpu_torch.ops import norm_conv as nc
    gen = torch.Generator(device=device).manual_seed(SEED + 20)

    def bwd(s_q, s_kv, h, b=4):
        q, k, v = (torch.randn(b, s, h, 64, device=device, generator=gen).bfloat16()
                   for s in (s_q, s_kv, s_kv))
        gate = torch.rand(b, h, device=device, generator=gen)
        gate[0, 0] = 0.0
        do = torch.randn_like(q)
        o, lse = fa.gated_flash_forward_lse(q, k, v, gate)
        plan = fa.backward_plan(b, h, s_q, s_kv)
        info = {"route": plan.route, "split": plan.chunks,
                "padded_stats": plan.route == "two_kernel" and plan.s_q_pad > s_q}
        return info, lambda: fa.gated_flash_backward(q, k, v, gate, o, lse, do)

    def fwd(s_q, s_kv, h, b=16):
        q, k, v = (torch.randn(b, s, h, 64, device=device, generator=gen).bfloat16()
                   for s in (s_q, s_kv, s_kv))
        gate = torch.rand(b, h, device=device, generator=gen)
        gate[0, 0] = 0.0
        plan = fa.forward_plan(b, h, s_q, s_kv)
        return ({"kernel": plan.kernel, "kv_tile": plan.kv_tile},
                lambda: fa.gated_flash_forward_lse(q, k, v, gate))

    def conv(b, c, side):
        x, scale, bias, gates = fused_inputs(b, c, side, side, gen)
        a, bb = nc.affine_coeffs(x, scale, bias, 32, 1e-5, gates["soft"])
        packed = (torch.randn(c, 3, 3, c, device=device, generator=gen) * (9 * c) ** -0.5
                  ).bfloat16()
        cbias = 0.1 * torch.randn(c, device=device, generator=gen)
        plan = nc.conv_plan(b, side, side, c, c)
        return ({"split": plan.split, "workspace_bytes": plan.workspace_bytes},
                lambda: (nc.norm_conv3x3(x, a, bb, packed, cbias, True),))

    def linear(b, s_len, c):
        x4, scale, bias, gates = fused_inputs(b, c, s_len, 1, gen)
        x = x4[:, :, :, 0].transpose(1, 2).contiguous()
        a, bb = nc.affine_coeffs(x.transpose(1, 2), scale, bias, 32, 1e-6, gates["soft"])
        weight = (torch.randn(c, c, device=device, generator=gen) * c ** -0.5).bfloat16()
        lbias = 0.1 * torch.randn(c, device=device, generator=gen)
        plan = nc.linear_plan(b, s_len, c, c)
        return ({"split": plan.split, "workspace_bytes": plan.workspace_bytes},
                lambda: (nc.norm_linear(x, a, bb, weight, lbias),))

    routes = {"fwd_small_q_lse_64_77": lambda: fwd(64, 77, 20),
              "fwd_small_q_lse_16_16": lambda: fwd(16, 16, 20),
              "fwd_small_q_lse_40_50": lambda: fwd(40, 50, 3),
              "bwd_one_pass": lambda: bwd(256, 77, 20),
              "bwd_one_pass_split": lambda: bwd(1024, 77, 5),
              "bwd_one_pass_small_q": lambda: bwd(64, 77, 20),
              "bwd_one_pass_16": lambda: bwd(16, 16, 20),
              "bwd_two_kernel": lambda: bwd(256, 256, 10),
              "bwd_two_kernel_padded_stats": lambda: bwd(200, 200, 3),
              "conv_split_workspace": lambda: conv(FUSED_B, 1280, 4),
              "linear_split_workspace_64": lambda: linear(FUSED_B, 64, 1280),
              "linear_split_workspace_16": lambda: linear(FUSED_B, 16, 1280)}
    rows = {}
    for name, make in routes.items():
        info, run = make()
        results = []
        with patched(torch, "empty", nan_filled(torch.empty)), \
                patched(torch, "empty_like", nan_filled(torch.empty_like)):
            for _ in range(2):
                poison_allocator()
                results.append([t.clone() for t in run() if t is not None])
                torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(t).all()) for t in results[0] + results[1])
        equal = all(torch.equal(u, v) for u, v in zip(*results))
        rows[name] = {**info, "finite": finite, "bit_equal": equal}
        if not (finite and equal):
            emit({"phase": "poisoned_allocator", "routes": rows})
            fail(f"{name} reads memory it did not write: {rows[name]}")
    if not (rows["bwd_one_pass_split"]["split"] > 1 and rows["bwd_one_pass"]["split"] == 1
            and all(rows[k]["kernel"] == "gated_flash_fwd_small" for k in rows if "fwd" in k)
            and rows["bwd_two_kernel_padded_stats"]["padded_stats"]
            and all(rows[k]["split"] > 1 for k in rows if "workspace" in k)):
        fail(f"the poisoned-allocator routes do not cover their plans: {rows}")
    emit({"phase": "poisoned_allocator", "routes": rows})
    torch.cuda.empty_cache()
    return rows


def check_norm_conv_kernel(sites, device, check):
    import torch
    import torch.nn.functional as F
    from diffusion_pruning_tpu_torch.ops import norm_conv as nc

    reduce_check = check.reduce = {"max_abs_err": 0.0, "max_rel_err": 0.0}

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    eps = 1e-5
    cases = ([(FUSED_B, key, n, True) for key, n in sorted(sites.items())]
             + [(4, key, 0, True) for key in CONV_512]
             + [(TRAIN_B, key, 0, False) for key in sorted(sites)])
    for b, (cin, cout, h, w, gated), n, timed in cases:
        x, scale, bias, gates = fused_inputs(b, cin, h, w, gen)
        weight = (torch.randn(cout, cin, 3, 3, device=device, generator=gen)
                  * (9 * cin) ** -0.5).bfloat16()
        cbias = 0.1 * torch.randn(cout, device=device, generator=gen)
        packed = nc.pack_conv_weight(weight, torch.bfloat16)
        xf, wf = x.float(), packed.float()
        for gate_name, gate_c in gates.items():
            a, bb = nc.affine_coeffs(x, scale, bias, 32, eps, gate_c)
            out = nc.norm_conv3x3(x, a, bb, packed, cbias, True)
            ref = nc.norm_conv3x3_plain(xf, a, bb, wf, cbias, True)
            unfused = nc.norm_conv_unfused(xf, scale, bias, weight.float(), cbias, gate_c, 32,
                                           eps, True)
            # zero padding applied to x, before the affine and the activation
            y_pad = nc.affine_act(F.pad(xf, (1, 1, 1, 1)), a, bb, True)
            no_tap = wf.clone()
            no_tap[:, 2, 2] = 0
            a6, b6 = nc.affine_coeffs(x, scale, bias, 32, 1e-6, gate_c)
            faults = {"x_space_padding": F.conv2d(y_pad, wf.permute(0, 3, 1, 2), cbias),
                      "dropped_tap": nc.norm_conv3x3_plain(xf, a, bb, no_tap, cbias, True),
                      "other_eps": nc.norm_conv3x3_plain(xf, a6, b6, wf, cbias, True)}
            if gate_c is not None:  # the gate folded into a, the statistics of the ungated x
                a0, b0 = nc.affine_coeffs(x, scale, bias, 32, eps, None)
                faults["ungated_statistics"] = nc.norm_conv3x3_plain(xf, a0 * gate_c, b0, wf,
                                                                     cbias, True)
            plan = nc.conv_plan(b, h, w, cin, cout)
            row = {"b": b, "c_in": cin, "c_out": cout, "h": h, "w": w, "gate": gate_name,
                   "site_gated": gated, "sites": n,
                   "plan": {"patch": plan.patch, "bn": plan.bn, "split": plan.split,
                            "blocks": plan.blocks, "workspace_bytes": plan.workspace_bytes}}
            check.take(row, out, ref, unfused, faults)
            if timed and gate_name == ("soft" if gated else "none"):
                w_cl = weight.contiguous(memory_format=torch.channels_last)
                sb, bb16, cb16 = scale.bfloat16(), bias.bfloat16(), cbias.bfloat16()
                g4 = None if gate_c is None else gate_c[:, :, None, None].bfloat16()

                def chain(x_, w_, g_):
                    y = x_ if g_ is None else x_ * g_
                    return F.conv2d(F.silu(F.group_norm(y, 32, sb, bb16, eps)), w_, cb16,
                                    padding=1)

                def library():
                    return chain(x, w_cl, g4)

                def kernel():
                    return nc.norm_conv3x3(x, a, bb, packed, cbias, True)

                iters, holder = 10, nc.PackedWeight()
                out_bytes = 2.0 * b * h * w * cout
                row["ms"] = device_ms(kernel, iters)
                row["cold_ms"] = cold_device_ms(
                    lambda *t: nc.norm_conv3x3(*t, cbias, True), (x, a, bb, packed), out_bytes)
                row["library_cold_ms"] = cold_device_ms(chain, (x, w_cl, g4), out_bytes)
                row["eager_ms"] = time_ms(kernel, iters)
                row["op_ms"] = time_ms(lambda: nc.group_norm_silu_conv3x3(
                    x, scale, bias, weight, cbias, gate_c, 32, eps, True, packed=holder), iters)
                row["plain_ms"] = time_ms(
                    lambda: nc.norm_conv3x3_plain(x, a, bb, packed, cbias, True), 3, warmup=1)
                row["library_ms"] = device_ms(library, iters)
                row["library_eager_ms"] = time_ms(library, iters)
                m = b * h * w
                row["bound_ms"], row["bound_by"] = bound_ms(
                    2.0 * m * cout * 9 * cin, PEAK_BF16_FLOPS,
                    2.0 * (m * cin + 9 * cin * cout + m * cout) + 8.0 * b * cin + 4.0 * cout)
                if plan.split > 1:
                    time_split_reduce(row, plan, cbias, reduce_check)
                check.rows.append(row)
            emit(row)
        del x, xf, wf, weight, packed, out, ref, unfused, y_pad, no_tap, faults
        torch.cuda.empty_cache()


def check_norm_linear_kernel(sites, device, check):
    import torch
    import torch.nn.functional as F
    from diffusion_pruning_tpu_torch.ops import norm_conv as nc

    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    eps = 1e-6
    cases = ([(FUSED_B, key, n, True) for key, n in sorted(sites.items())]
             + [(4, key, 0, True) for key in LINEAR_512]
             + [(TRAIN_B, key, 0, True) for key in sorted(sites)])
    for b, (s_len, c), n, timed in cases:
        x4, scale, bias, gates = fused_inputs(b, c, s_len, 1, gen)
        x = x4[:, :, :, 0].transpose(1, 2).contiguous()         # (B, S, C) tokens
        weight = (torch.randn(c, c, device=device, generator=gen) * c ** -0.5).bfloat16()
        lbias = 0.1 * torch.randn(c, device=device, generator=gen)
        xf, wf = x.float(), weight.float()
        for gate_name, gate_c in gates.items():
            a, bb = nc.affine_coeffs(x.transpose(1, 2), scale, bias, 32, eps, gate_c)
            out = nc.norm_linear(x, a, bb, weight, lbias)
            ref = nc.norm_linear_plain(xf, a, bb, wf, lbias)
            unfused = nc.norm_linear_unfused(xf, scale, bias, wf, lbias, gate_c, 32, eps)
            a5, b5 = nc.affine_coeffs(x.transpose(1, 2), scale, bias, 32, 1e-5, gate_c)
            y = a[:, None, :] * xf + bb[:, None, :]
            faults = {"other_eps": nc.norm_linear_plain(xf, a5, b5, wf, lbias),
                      "silu_applied": F.linear(F.silu(y), wf, lbias)}
            if gate_c is not None:
                a0, b0 = nc.affine_coeffs(x.transpose(1, 2), scale, bias, 32, eps, None)
                faults["ungated_statistics"] = nc.norm_linear_plain(xf, a0 * gate_c, b0, wf,
                                                                    lbias)
            plan = nc.linear_plan(b, s_len, c, c)
            row = {"b": b, "s": s_len, "c": c, "gate": gate_name, "sites": n,
                   "plan": {"bn": plan.bn, "split": plan.split, "blocks": plan.blocks,
                            "ab_rows": plan.ab_rows, "workspace_bytes": plan.workspace_bytes}}
            check.take(row, out, ref, unfused, faults)
            if timed and gate_name == "none":  # the U-Net's transformers pass no gate
                sb, bb16, lb16 = scale.bfloat16(), bias.bfloat16(), lbias.bfloat16()
                iters = 20

                def kernel():
                    return nc.norm_linear(x, a, bb, weight, lbias)

                def pair(x_, w_):
                    return F.linear(F.group_norm(x_.transpose(1, 2), 32, sb, bb16, eps)
                                    .transpose(1, 2), w_, lb16)

                def library():
                    return pair(x, weight)

                out_bytes = 2.0 * b * s_len * c
                row["ms"] = device_ms(kernel, iters)
                row["cold_ms"] = cold_device_ms(lambda *t: nc.norm_linear(*t, lbias),
                                                (x, a, bb, weight), out_bytes)
                row["library_cold_ms"] = cold_device_ms(pair, (x, weight), out_bytes)
                row["eager_ms"] = time_ms(kernel, iters)
                row["op_ms"] = time_ms(lambda: nc.group_norm_linear(
                    x, scale, bias, weight, lbias, None, 32, eps), iters)
                row["plain_ms"] = time_ms(
                    lambda: nc.norm_linear_plain(x, a, bb, weight, lbias), 3, warmup=1)
                row["library_ms"] = device_ms(library, iters)
                row["library_eager_ms"] = time_ms(library, iters)
                m = b * s_len
                row["bound_ms"], row["bound_by"] = bound_ms(
                    2.0 * m * c * c, PEAK_BF16_FLOPS,
                    2.0 * (2 * m * c + c * c) + 8.0 * b * c + 4.0 * c)
                check.rows.append(row)
            emit(row)
    torch.cuda.empty_cache()


IDENTITY_TAP_CASES = ((16, 320, 32, 32), (16, 1280, 4, 4))  # (B, C, H, W): unsplit and split


def ulp_reading(out, ref):
    """max |out − ref| / (2^-7·|ref| + 1e-6): at most 1 when every element is
    within one bf16 ulp of the reference."""
    return ((out.float() - ref.float()).abs() / (ref.float().abs() * 2.0 ** -7 + 1e-6)).max().item()


def check_conv_identity_tap(device):
    """The activation alone, through the conv kernel: C_out = C_in, the centre
    tap the identity, the other taps and the bias 0, so out = bf16(act(a·x +
    b)) exactly; y spans [−8, 8] (gated: a carries the gate, b is random), so
    that the cancellation of SiLU's tanh.approx form near y = −5 shows. Each
    element within one bf16 ulp of the plain version; the tanh.approx form,
    emulated by rounding tanh(y/2) to 11 significant bits (its documented
    error is about 2^-11), must read above."""
    import torch
    from diffusion_pruning_tpu_torch.ops import norm_conv as nc
    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    rows = []
    for b, c, h, w in IDENTITY_TAP_CASES:
        x = (torch.rand(b, c, h, w, device=device, generator=gen) * 2 - 1).bfloat16()
        x = x.contiguous(memory_format=torch.channels_last)
        packed = torch.zeros(c, 3, 3, c, device=device, dtype=torch.bfloat16)
        packed[:, 1, 1] = torch.eye(c, device=device, dtype=torch.bfloat16)
        zero = torch.zeros(c, device=device)
        g = torch.rand(b, c, device=device, generator=gen) * 0.75 + 0.25
        g[:, : c // 32] = 0.0  # a closed group
        coeffs = {"none": (torch.full((b, c), 8.0, device=device), torch.zeros(b, c, device=device)),
                  "soft": (8.0 * g, torch.rand(b, c, device=device, generator=gen) * 2 - 1)}
        for gate_name, (a, bb) in coeffs.items():
            for silu in (True, False):
                out = nc.norm_conv3x3(x, a, bb, packed, zero, silu)
                # the plain version's operand, bf16(act(y)), is its output here:
                # exact, where a cuDNN f32 conv of it may take a Winograd path
                ref = nc.affine_act(x, a, bb, silu)
                row = {"phase": "conv_identity_tap", "b": b, "c": c, "h": h, "w": w,
                       "gate": gate_name, "silu": silu,
                       "split": nc.conv_plan(b, h, w, c, c).split,
                       "ulp_reading": ulp_reading(out, ref), "limit": 1.0}
                if silu:
                    y = (a[:, :, None, None] * x.float() + bb[:, :, None, None]).bfloat16().float()
                    t = torch.tanh(y / 2).half().float()
                    fault = (y * (0.5 + 0.5 * t)).bfloat16()
                    row["planted_fault_tanh_approx_ulp_reading"] = ulp_reading(fault, ref)
                emit(row)
                if not row["ulp_reading"] <= 1.0:
                    fail(f"the conv kernel's activation is off by more than one bf16 ulp: {row}")
                if silu and not row["planted_fault_tanh_approx_ulp_reading"] > 1.0:
                    fail(f"the tanh.approx form reads within one bf16 ulp: {row}")
                rows.append(row)
    return {"worst_ulp_reading": max(r["ulp_reading"] for r in rows),
            "least_planted_fault_ulp_reading": min(r["planted_fault_tanh_approx_ulp_reading"]
                                                   for r in rows if r["silu"])}


def split_reduce_entry(check):
    """conv_split_reduce's times summed over the conv sites of one 256px
    forward whose plan splits K."""
    rows = [r for r in check.rows if "reduce_ms" in r]

    def total(key):
        return sum(r[key] * r["sites"] for r in rows)
    return {"ms": total("reduce_ms"), "cold_ms": total("reduce_cold_ms"),
            "plain_ms": total("reduce_plain_ms"), "bound_ms": total("reduce_bound_ms"),
            "bound_by": "bytes", "library_ms": None,
            "launches_per_forward": sum(r["sites"] for r in rows),
            "max_abs_err": check.reduce["max_abs_err"],
            "max_rel_err": check.reduce["max_rel_err"]}


def check_fused_kernels(unet, device):
    """Phase 9: the three kernels at the shapes of the 256px forward (B_eff
    16, timed) and the 512px extras (B_eff 4, timed); the conv and the linear
    kernel, which the train step of phase 11 launches, at the same shapes with
    the train step's batch of 64 as well (not timed). Returns {kernel name:
    FusedCheck}."""
    sites = fused_sites(unet, device)
    emit({"phase": "fused_sites", "launches_per_forward": {k: sum(v.values())
                                                           for k, v in sites.items()},
          "distinct_shapes": {k: len(v) for k, v in sites.items()}})
    checks = {name: FusedCheck(name) for name in ("group_norm_silu", "norm_conv3x3",
                                                  "norm_linear")}
    check_group_norm_kernel(sites["gn"], device, checks["group_norm_silu"])
    check_norm_conv_kernel(sites["conv"], device, checks["norm_conv3x3"])
    checks["norm_conv3x3"].identity_tap = check_conv_identity_tap(device)
    sweep_conv_splits(device)
    check_norm_linear_kernel(sites["linear"], device, checks["norm_linear"])
    sweep_linear_splits(device)
    for name, check in checks.items():
        emit({"phase": "fused_kernel_check_summary", "kernel": name, "limit": FUSED_REL_L2,
              "batches": sorted(check.batches), "worst": check.worst, "least_planted_fault": check.least_fault,
              "per_256px_forward": check.entry()})
    return checks


# ---------------------------------------------------------------- phase 10

@contextlib.contextmanager
def patched(module, name, fn):
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield real
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def layout_watch():
    """Count the U-Net's calls of the fused ops, and those whose activation is
    not yet in the layout the kernel reads: the public ops convert such an
    input silently, one hidden pass over it a site."""
    import torch
    from diffusion_pruning_tpu_torch.models.unet import blocks
    seen = collections.Counter(calls=0, converted=0)

    def watch(stack, name, dense):
        real = getattr(blocks, name)

        def op(x, *args, **kwargs):
            seen["calls"] += 1
            seen["converted"] += not dense(x)
            return real(x, *args, **kwargs)

        stack.enter_context(patched(blocks, name, op))

    def channels_last(x):
        return x.is_contiguous(memory_format=torch.channels_last)

    with contextlib.ExitStack() as stack:
        watch(stack, "group_norm_silu", channels_last)
        watch(stack, "group_norm_silu_conv3x3", channels_last)
        watch(stack, "group_norm_linear", torch.Tensor.is_contiguous)
        yield seen


def faulty_norm_conv(x, a, b, packed, conv_bias, silu):
    """A planted fault: a conv kernel that pads x with zeros before the
    affine and the activation (x-space padding), emulated in plain torch."""
    import torch.nn.functional as F
    from diffusion_pruning_tpu_torch.ops import norm_conv as nc
    y = nc.affine_act(F.pad(x, (1, 1, 1, 1)), a, b, silu).to(x.dtype)
    return F.conv2d(y, packed.permute(0, 3, 1, 2), conv_bias.to(x.dtype))


def faulty_group_norm(x, scale, bias, groups, eps, silu):
    """A planted fault: a GroupNorm kernel whose variance forgets mean²,
    emulated in plain torch."""
    import torch
    import torch.nn.functional as F
    b, c = x.shape[:2]
    xg = x.float().reshape(b, groups, c // groups, -1)
    y = (xg - xg.mean(dim=(2, 3), keepdim=True)) * torch.rsqrt(
        (xg * xg).mean(dim=(2, 3), keepdim=True) + eps)
    y = y.reshape(x.shape) * scale[None, :, None, None] + bias[None, :, None, None]
    y = F.silu(y) if silu else y
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def check_fused_unet(unet, device):
    """Phase 10: the full-width U-Net under each fused flag against an f32
    copy of itself and against the unfused bf16 forward, with launch counts,
    forward times and the host's time to enqueue a forward."""
    import copy
    import torch
    from diffusion_pruning_tpu_torch.ops import group_norm as gn
    from diffusion_pruning_tpu_torch.ops import norm_conv as nc
    from diffusion_pruning_tpu_torch.ops.flash_attention import gated_attention_reference

    x, t, ehs, arch = unet_inputs(unet, device)
    twins = {"fused_norms": fused_twin(unet, fused_norms=True),
             "fused_norm_conv": fused_twin(unet, fused_norm_conv=True)}
    expected = {"fused_norms": {"group_norm_silu": 60},
                "fused_norm_conv": {"norm_conv3x3": 45, "norm_linear": 16}}
    faults = {"fused_norms": (gn, "group_norm_silu_forward", faulty_group_norm),
              "fused_norm_conv": (nc, "norm_conv3x3", faulty_norm_conv)}

    def forward_times(model):
        ms = time_ms(lambda: model(x, t, ehs, arch=arch), 10)
        enqueue = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(x, t, ehs, arch=arch)
            enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return ms, sorted(enqueue)[2]

    with torch.inference_mode():
        f32 = copy.deepcopy(unet).float()
        with unet_attention(gated_attention_reference):
            ref = f32(x, t, ehs, arch=arch).float()
        del f32
        torch.cuda.empty_cache()
        plain = unet(x, t, ehs, arch=arch).float()

        def rel(a, b=ref):
            return ((a - b).norm() / b.norm()).item()

        row = {"phase": "fused_unet", "resolution": unet.cfg.sample_size * 8, "b_eff": x.shape[0],
               "limit": FUSED_UNET_REL_L2, "unfused_rel_l2_vs_f32": rel(plain)}
        # in turns: unfused, each fused flag, unfused again
        row["unfused_forward_ms"], row["unfused_host_enqueue_ms"] = forward_times(unet)
        for flag, twin in twins.items():
            reset_launch_counts()
            with layout_watch() as layout:
                out = twin(x, t, ehs, arch=arch).float()
            all_counts = launch_counts()
            counts = {k: v for k, v in wrapper_counts(all_counts).items()
                      if k != "gated_flash_fwd"}
            module, name, faulty = faults[flag]
            with patched(module, name, faulty):
                bad = twin(x, t, ehs, arch=arch).float()
            ms, enqueue = forward_times(twin)
            row[flag] = {"rel_l2_vs_f32": rel(out), "rel_l2_vs_unfused_bf16": rel(out, plain),
                         "planted_fault": faulty.__name__,
                         "planted_fault_rel_l2_vs_f32": rel(bad),
                         "planted_fault_rel_l2_vs_unfused_bf16": rel(bad, plain),
                         "launches_per_forward": {k: v for k, v in all_counts.items() if v},
                         "fused_op_calls": layout["calls"],
                         "fused_op_calls_that_converted_the_layout": layout["converted"],
                         "finite": bool(torch.isfinite(out).all()),
                         "forward_ms": ms, "host_enqueue_ms_median": enqueue}
            want = {k: expected[flag].get(k, 0) for k in counts}
            if counts != want:
                emit(row)
                fail(f"{flag}: expected {expected[flag]} launches per forward, got {counts}")
            if layout["calls"] != sum(expected[flag].values()) or layout["converted"]:
                emit(row)
                fail(f"{flag}: {layout['converted']} of {layout['calls']} fused ops were handed "
                     f"an activation in another layout than the kernel reads")
        row["unfused_forward_ms_again"], _ = forward_times(unet)
    row["packed_weights_mib"] = sum(
        p._packed.numel() * p._packed.element_size() for m in twins["fused_norm_conv"].modules()
        for p in (*getattr(m, "_packed", ()), getattr(m, "_packed_out", None))
        if p is not None and p._packed is not None) / 2 ** 20
    emit(row)
    for flag in twins:
        r = row[flag]
        if not r["finite"] or not r["rel_l2_vs_f32"] <= FUSED_UNET_REL_L2:
            fail(f"the U-Net under {flag} disagrees with the f32 U-Net: {r}")
        if not r["planted_fault_rel_l2_vs_f32"] > FUSED_UNET_REL_L2:
            fail(f"{flag}: the planted fault reads within the limit {FUSED_UNET_REL_L2}: {r}")
    return twins, row


# ---------------------------------------------------------------- phase 11

def fused_pipeline(pipe, unet, device):
    from diffusion_pruning_tpu_torch.pipelines import PruningPipeline
    return PruningPipeline(unet, pipe.vae, pipe.text_encoder, pipe.hypernet, pipe.quantizer,
                           device=device)


def serve_fused(pipe, mpnet, twins, device):
    """One routed 256px request under `fused_norms`; under `fused_norm_conv`
    a warm-up and two timed requests, in turns with the unfused pipeline on
    the same prompts. Returns the summary row and the launch counts."""
    call = ((8, 256),)
    _, counts_gn = serve(fused_pipeline(pipe, twins["fused_norms"], device), mpnet, device, call,
                         {"group_norm_silu": 60}, SEED + 11, "serving_fused_norms")
    fused = fused_pipeline(pipe, twins["fused_norm_conv"], device)
    per_forward = {"norm_conv3x3": 45, "norm_linear": 16}
    seconds = {"fused_norm_conv": [], "unfused": []}
    counts_nc = collections.Counter()
    for turn in range(3):  # the first turn warms up
        rows, counts = serve(fused, mpnet, device, call, per_forward, SEED + 12 + turn,
                             "serving_fused_norm_conv")
        counts_nc.update(counts)
        plain_rows, _ = serve(pipe, mpnet, device, call, None, SEED + 12 + turn,
                              "serving_unfused_in_turn")
        if turn:
            seconds["fused_norm_conv"].append(rows[0]["seconds"])
            seconds["unfused"].append(plain_rows[0]["seconds"])
    row = {"phase": "serving_fused_summary", "prompts": 8, "resolution": 256,
           "seconds_timed_calls": seconds,
           "img_per_sec": {k: 8 / statistics.mean(v) for k, v in seconds.items()},
           "launches_fused_norms_call": {k: v for k, v in counts_gn.items() if v},
           "launches_fused_norm_conv_3_calls": {k: v for k, v in counts_nc.items() if v}}
    emit(row)
    return row, counts_gn, dict(counts_nc)


@contextlib.contextmanager
def without_fused_gate_grad():
    """A planted fault: the fused conv op's gate gradient dropped."""
    from diffusion_pruning_tpu_torch.ops import norm_conv as nc
    real = nc.GroupNormSiLUConv3x3.backward

    def faulty(ctx, grad_out):
        grads = list(real(ctx, grad_out))
        if grads[5] is not None:
            grads[5] = grads[5].zero_()
        return tuple(grads)

    nc.GroupNormSiLUConv3x3.backward = staticmethod(faulty)
    try:
        yield
    finally:
        nc.GroupNormSiLUConv3x3.backward = staticmethod(real)


def unet_arch_grad(model, x, t, ehs, arch):
    """d/d arch of the U-Net's mean-square output and block features."""
    arch = arch.clone().requires_grad_()
    out, feats = model(x, t, ehs, arch=arch, return_features=True)
    loss = out.float().square().mean() + sum(f.float().square().mean() for f in feats.values())
    loss.backward()
    return arch.grad.float()


def check_fused_gate_grads(unet, twin, device):
    """The gradient that trains the router, held directly: d loss / d arch of
    one full-width forward (B_eff 16 on 8 soft arch rows, so the CFG tiling is
    differentiated too) through the fused ops' recompute backward against the
    unfused U-Net's, cosine per gate site; with the fused conv op's gate
    gradient dropped, a planted fault, the resnet sites must read below the
    limit."""
    import torch
    x, t, ehs, _ = unet_inputs(unet, device, SEED + 14)
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    arch = torch.rand(x.shape[0] // 2, unet.spec.vq_dim, device=device, generator=gen)
    want = unet_arch_grad(unet, x, t, ehs, arch)
    got = unet_arch_grad(twin, x, t, ehs, arch)
    with without_fused_gate_grad():
        bad = unet_arch_grad(twin, x, t, ehs, arch)

    def cosines(g):
        out = {}
        for sb in unet.spec.subblocks:
            for i, site in enumerate(sb.sites):
                cols = slice(site.start, site.start + site.width)
                a, b = g[:, cols].flatten(), want[:, cols].flatten()
                out[f"{sb.name}.{i}"] = (torch.dot(a, b) / (a.norm() * b.norm()).clamp_min(1e-30)
                                         ).item()
        nw = unet.spec.num_width
        out["depth"] = (torch.dot(g[:, nw:].flatten(), want[:, nw:].flatten())
                        / (g[:, nw:].norm() * want[:, nw:].norm()).clamp_min(1e-30)).item()
        return out

    cos, cos_bad = cosines(got), cosines(bad)
    resnet_bad = {k: v for k, v in cos_bad.items() if "resnet" in k}
    worst = min(cos, key=cos.get)
    row = {"phase": "fused_gate_grad_check", "limit": FUSED_GRAD_COS, "sites": len(cos),
           "min_cos": cos[worst], "min_cos_site": worst,
           "median_cos": statistics.median(cos.values()),
           "resnet_sites": len(resnet_bad),
           "planted_fault_no_gate_grad_max_cos_resnet_sites": max(resnet_bad.values()),
           "arch_grad_rms": want.square().mean().sqrt().item()}
    emit(row)
    if not row["min_cos"] > FUSED_GRAD_COS:
        fail(f"the fused U-Net's gate gradients disagree with the unfused U-Net's: {row}")
    if not row["planted_fault_no_gate_grad_max_cos_resnet_sites"] <= FUSED_GRAD_COS:
        fail(f"the planted fault reads within the limit {FUSED_GRAD_COS}: {row}")
    return row


def train_fused(pipe, twins, device, gen):
    """One pretrain and one codebook step under `fused_norm_conv`, then the
    step's grads against the unfused step's on the same batch and draws."""
    import torch
    from diffusion_pruning_tpu_torch.training.pruner import complete_draws

    unfused_pipe = pipe
    pipe = fused_pipeline(pipe, twins["fused_norm_conv"], device)
    mods, cfg, opt = build_trainer(pipe, device, gen)
    per_step = {"norm_conv3x3": 90, "norm_linear": 32}  # teacher + student
    batch, summary = train(mods, cfg, opt, device, 2, per_step, "train_fused_step")
    plain_mods = dataclasses.replace(mods, unet=unfused_pipe.unet)
    draws = complete_draws(mods, cfg, batch, None,
                           torch.Generator(device=device).manual_seed(SEED + 13))
    out = {"phase": "train_fused_grad_check", "limit": FUSED_GRAD_COS}
    for pretrain in (True, False):
        fused = step_grads(mods, cfg, batch, draws, pretrain)
        plain = step_grads(plain_mods, cfg, batch, draws, pretrain)
        cos = leaf_cosines(fused, plain)
        worst = min(cos, key=cos.get)
        entry = {"leaves": len(cos), "min_cos": cos[worst], "min_cos_leaf": worst,
                 "median_cos": statistics.median(cos.values()),
                 "codebook_cos": cos.get("codebook")}
        if pretrain:
            with without_fused_gate_grad():
                cos_fault = leaf_cosines(step_grads(mods, cfg, batch, draws, pretrain), plain)
            worst_fault = min(cos_fault, key=cos_fault.get)
            entry.update(planted_fault_no_gate_grad_min_cos=cos_fault[worst_fault],
                         planted_fault_leaf=worst_fault)
        out["pretrain" if pretrain else "codebook"] = entry
    emit(out)
    for phase in ("pretrain", "codebook"):
        if not out[phase]["min_cos"] > FUSED_GRAD_COS:
            fail(f"fused-step grads disagree with the unfused step's ({phase}): {out}")
    # the whole step's leaves mix the U-Net's gradient with the resource and
    # contrastive terms', so the planted fault is held where it acts alone
    check_fused_gate_grads(unfused_pipe.unet, mods.unet, device)
    return summary


# ---------------------------------------------------------------- phase 12

EXPERT_KEEP = 0.6          # the share of width units each code keeps
EXPERT_B_EFF = 8           # the expert forwards of the check: 4 prompts under CFG
# prompts the served traffic routes to each of the 8 experts, in two submits
# of 8: every expert serves, and the tier plans (batch_size 4) take every
# tier shape: 4 and a tail of 1, a padded 4 (3 prompts), 2 and 1
EXPERT_COUNTS = (5, 3, 1, 2, 1, 1, 2, 1)
EXPERT_PROMPTS = sum(EXPERT_COUNTS)
EXPERT_ROUNDS = 2          # timed rounds of expert, hybrid and gated serving, in turns
# a served image against the same prompt run alone, with the same initial
# latents, through its expert's pipe (or, a hybrid remainder, through the
# gated pipe under its code): relative L2 per image. Set from the readings,
# between the sound rows' and the planted fault's (another row's image;
# PERF.md)
SERVED_REL_L2 = 5e-2
FUSED_TIMED_EXPERTS = 2    # experts whose forward under each fused flag is also timed


def expert_codebook(quantizer, spec):
    """Codes from the seed into the quantizer's `embedding_gs` snapshot (soft
    values on either side of 0.5): each width unit kept with p = EXPERT_KEEP,
    the first unit of each site always; the odd-numbered codes close 2-4
    depth gates. Returns the hard codes (K, vq_dim) on the quantizer's device."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 30)
    k, nw = quantizer.n_e, spec.num_width
    codes = (torch.rand(k, spec.vq_dim, generator=gen) < EXPERT_KEEP).float()
    for sb in spec.subblocks:
        for site in sb.sites:
            codes[:, site.start] = 1.0
    codes[:, nw:] = 1.0
    for e in range(1, k, 2):
        n = int(torch.randint(2, 5, (1,), generator=gen))
        codes[e, nw + torch.randperm(spec.num_depth, generator=gen)[:n]] = 0.0
    codes = codes.to(quantizer.embedding_gs.device)
    quantizer.embedding_gs.copy_(torch.where(codes >= 0.5, 0.8, 0.2))
    return codes


def site_tokens(cfg, name: str) -> int:
    """Tokens of an attention subblock's self-attention ('down.0.attn.1', …)."""
    parts = name.split(".")
    level = {"down": lambda: int(parts[1]), "up": lambda: cfg.num_levels - 1 - int(parts[1]),
             "mid": lambda: cfg.num_levels - 1}[parts[0]]()
    return (cfg.sample_size >> level) ** 2


def expert_summary(server, dense_unet):
    """Per expert: MACs ratio, parameter bytes (all, and those it does not
    share with the dense U-Net), dropped subblocks, kept heads (attn1,
    attn2) at the 1024-token sites."""
    dense_ptrs = {p.data_ptr() for p in dense_unet.parameters()}
    rows = []
    for e, model in enumerate(server.expert_models):
        plan = model.plan
        params = list(model.parameters())
        rows.append({
            "phase": "expert", "expert": e, "macs_ratio": server.expert_ratios[e],
            "param_bytes": sum(p.numel() * p.element_size() for p in params),
            "param_bytes_own": sum(p.numel() * p.element_size() for p in params
                                   if p.data_ptr() not in dense_ptrs),
            "dropped": [sb.name for sb in plan.subblocks if sb.dropped],
            "kept_heads_1024_tokens": {
                sb.name: [len(sb.site("attn1").kept), len(sb.site("attn2").kept)]
                for sb in plan.subblocks if sb.kind == "transformer" and not sb.dropped
                and site_tokens(dense_unet.cfg, sb.name) == 1024}})
        emit(rows[-1])
    heads = {len(site.kept) for m in server.expert_models for sb in m.plan.subblocks
             if sb.kind == "transformer" and not sb.dropped for site in sb.sites[:2]}
    if not ({h % 2 for h in heads} == {0, 1}):
        fail(f"the codes keep no odd and even head counts at an attention site: {heads}")
    return rows


def heads_from_the_front(plan):
    """A planted fault: the plan with each attention site's kept heads taken
    as the first len(kept) heads instead of the kept ones."""
    subs = []
    for sb in plan.subblocks:
        sites = tuple(dataclasses.replace(site, kept=tuple(range(len(site.kept))))
                      if site.kind in ("attn1", "attn2") else site for site in sb.sites)
        subs.append(dataclasses.replace(sb, sites=sites))
    return dataclasses.replace(plan, subblocks=tuple(subs))


OWN_KERNELS = ("gated_flash_fwd_wgmma", "gated_flash_fwd_small", "group_norm_silu",
               "norm_conv3x3", "norm_linear", "conv_split_reduce")


def own_kernel_ms(fn):
    """Device ms of each of the port's kernels in one call of `fn`, summed
    over its launches, and of every kernel of the call (`all_kernels`):
    torch.profiler's kernel times, no host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"all_kernels": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        out["all_kernels"] += us / 1e3
        for name in OWN_KERNELS:
            if f"{name}_kernel" in e.key:
                out[name] = out.get(name, 0.0) + us / 1e3
    return out


def mean_ms(maps):
    """{name: mean over `maps` of its value (0 where a map lacks it)}."""
    names = sorted({k for m in maps for k in m})
    return {k: statistics.mean(m.get(k, 0.0) for m in maps) for k in names}


def check_experts(server, unet, codes, device):
    """Phase 12's check: each expert's bf16 forward through the kernels at
    B_eff 8 — cut from the dense weights with every resnet norm2 bias zeroed —
    against the dense U-Net in f32 with plain attention under the expert's
    hard code (<= UNET_REL_L2), the planted fault `heads_from_the_front` above
    it, the same forward under each fused flag, launches per forward, and
    forward times against the gated U-Net's; the port's kernels' device time
    in one forward (`own_kernel_ms`), each expert's and the gated U-Net's.
    Then each served expert (`server.expert_models`, bf16, through the
    kernels): its plan is its code's, and its forward agrees with the same
    cut of the dense weights in f32 with plain attention (<= UNET_REL_L2)."""
    import copy
    import torch
    from diffusion_pruning_tpu_torch.models.unet.pruned import (
        make_expert_plan, slice_expert_params)
    from diffusion_pruning_tpu_torch.ops import flash_attention as fa
    from diffusion_pruning_tpu_torch.pipelines.expert_server import build_expert

    cfg = unet.cfg
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    b = EXPERT_B_EFF
    x = torch.randn(b, cfg.sample_size, cfg.sample_size, 4, device=device, generator=gen)
    t = torch.randint(0, 1000, (b,), device=device, generator=gen)
    ehs = torch.randn(b, 77, cfg.cross_attention_dim, device=device, generator=gen)
    zeroed = {k: (torch.zeros_like(v) if k.endswith("norm2.bias") and ".resnets." in k else v)
              for k, v in unet.state_dict().items()}
    f32 = copy.deepcopy(unet).float()
    f32.load_state_dict(zeroed)

    def forward(model, arch=None, profiled=True):
        """One forward: output, the launches it made (every counter), and
        (`profiled`) the kernels' device ms in a second forward."""
        reset_launch_counts()
        out = model(x, t, ehs, arch=arch).float()
        counts = launch_counts()
        ms = own_kernel_ms(lambda: model(x, t, ehs, arch=arch)) if profiled else None
        return out, counts, ms

    rows = []
    with torch.inference_mode():
        _, dense_counts, dense_ms = forward(unet, codes[:1])
        gated_fwd_ms = time_ms(lambda: unet(x, t, ehs, arch=codes[:1]), 10)
        for e, served in enumerate(server.expert_models):
            plan = served.plan
            expert = build_expert(cfg, plan, slice_expert_params(zeroed, plan))
            with unet_attention(fa.gated_attention_reference):
                ref = f32(x, t, ehs, arch=codes[e: e + 1]).float()
            out, counts, kernel_ms = forward(expert)
            if plan != make_expert_plan(unet.spec, (codes[e] >= 0.5).cpu().numpy()):
                fail(f"served expert {e}'s plan is not its code's")
            cut = {k: v.float() for k, v in slice_expert_params(unet.state_dict(), plan).items()}
            with unet_attention(fa.gated_attention_reference):
                served_ref = build_expert(cfg, plan, cut)(x, t, ehs).float()
            served_out = served(x, t, ehs).float()
            del cut
            faulty = heads_from_the_front(plan)
            bad = build_expert(cfg, faulty, slice_expert_params(zeroed, faulty))(x, t, ehs).float()
            kept_res = sum(1 for sb in plan.subblocks if sb.kind == "resnet" and not sb.dropped)
            kept_tf = sum(1 for sb in plan.subblocks if sb.kind == "transformer" and not sb.dropped)
            want = {"gated_flash_fwd": 2 * kept_tf}
            fused = {}
            timed = e < FUSED_TIMED_EXPERTS
            for flag, want_flag in (("fused_norms", {"group_norm_silu": 2 * kept_res + kept_tf}),
                                    ("fused_norm_conv", {"norm_conv3x3": 2 * kept_res + 1,
                                                         "norm_linear": kept_tf})):
                twin = build_expert(dataclasses.replace(cfg, **{flag: True}), plan,
                                    expert.state_dict())
                f_out, f_counts, f_ms = forward(twin, profiled=timed)
                fused[flag] = {"rel_l2": ((f_out - ref).norm() / ref.norm()).item(),
                               "launches_per_forward": {k: v for k, v in f_counts.items() if v},
                               "finite": bool(torch.isfinite(f_out).all())}
                if timed:
                    fused[flag].update(kernel_device_ms=f_ms,
                                       forward_ms=time_ms(lambda: twin(x, t, ehs), 5))
                want_all = {**want_flag, **want}
                if wrapper_counts(f_counts) != {k: want_all.get(k, 0) for k in kernel_wrappers()}:
                    fail(f"expert {e} under {flag}: expected {want_all} launches per forward, "
                         f"got {f_counts}")
                del twin
            row = {"phase": "expert_check", "expert": e, "b_eff": b,
                   "rel_l2": ((out - ref).norm() / ref.norm()).item(), "limit": UNET_REL_L2,
                   "rel_l2_planted_fault_heads_from_the_front":
                       ((bad - ref).norm() / ref.norm()).item(),
                   "served_rel_l2": ((served_out - served_ref).norm() / served_ref.norm()).item(),
                   "served_finite": bool(torch.isfinite(served_out).all()),
                   "finite": bool(torch.isfinite(out).all()),
                   "kept_resnets": kept_res, "kept_transformers": kept_tf,
                   "launches_per_forward": {k: v for k, v in counts.items() if v},
                   "kernel_device_ms": kernel_ms,
                   "forward_ms": time_ms(lambda: expert(x, t, ehs), 10),
                   "gated_forward_ms": gated_fwd_ms, "fused": fused}
            emit(row)
            if not row["finite"] or not row["rel_l2"] <= UNET_REL_L2:
                fail(f"expert {e} disagrees with the f32 dense U-Net under its code: {row}")
            if not row["rel_l2_planted_fault_heads_from_the_front"] > UNET_REL_L2:
                fail(f"expert {e}: the planted fault reads within the limit: {row}")
            if not row["served_finite"] or not row["served_rel_l2"] <= UNET_REL_L2:
                fail(f"served expert {e} disagrees with its cut in f32: {row}")
            if wrapper_counts(counts) != {k: want.get(k, 0) for k in kernel_wrappers()}:
                fail(f"expert {e}: expected {want} launches per forward, got {counts}")
            for flag, r in fused.items():
                if not r["finite"] or not r["rel_l2"] <= FUSED_UNET_REL_L2:
                    fail(f"expert {e} under {flag} disagrees with the f32 dense U-Net: {r}")
            rows.append(row)
            del expert, out, ref, bad, served_out, served_ref
        del f32
    torch.cuda.empty_cache()
    summary = {"phase": "expert_check_summary", "b_eff": b, "experts": len(rows),
               "rel_l2_worst": max(r["rel_l2"] for r in rows),
               "served_rel_l2_worst": max(r["served_rel_l2"] for r in rows),
               "planted_fault_least": min(r["rel_l2_planted_fault_heads_from_the_front"]
                                          for r in rows),
               "fused_rel_l2_worst": {flag: max(r["fused"][flag]["rel_l2"] for r in rows)
                                      for flag in ("fused_norms", "fused_norm_conv")},
               "forward_ms": [r["forward_ms"] for r in rows], "gated_forward_ms": gated_fwd_ms,
               "device_ms": [r["kernel_device_ms"]["all_kernels"] for r in rows],
               "gated_device_ms": dense_ms["all_kernels"],
               "attention_device_ms": [sum(v for k, v in r["kernel_device_ms"].items()
                                           if k.startswith("gated_flash")) for r in rows],
               "gated_attention_device_ms": sum(v for k, v in dense_ms.items()
                                                if k.startswith("gated_flash")),
               "dense_launches_per_forward": {k: v for k, v in dense_counts.items() if v},
               # each kernel's device ms over one forward's sites: the mean over
               # the experts (under a fused flag over the timed ones), the gated U-Net's
               "kernel_device_ms_mean": mean_ms([r["kernel_device_ms"] for r in rows]),
               "fused_kernel_device_ms_mean": {
                   flag: mean_ms([r["fused"][flag]["kernel_device_ms"] for r in rows
                                  if "kernel_device_ms" in r["fused"][flag]])
                   for flag in ("fused_norms", "fused_norm_conv")},
               "gated_kernel_device_ms": dense_ms}
    emit(summary)
    return rows, summary


def steering_noise(quantizer, codes, experts):
    """Routing noise (N, vq_dim) that sends prompt i to expert experts[i]:
    gumbel noise of +-1e3 saturates every gate to that expert's hard code,
    whose cosine to its own snapshot row is then the highest."""
    import torch
    nw, nd = quantizer.spec.num_width, quantizer.spec.num_depth
    noise = 1e3 * (2 * codes[experts.to(codes.device)] - 1)
    # the depth samples are ranked: depth slot order[i] takes the i-th sample
    order = quantizer.depth_order if quantizer.depth_order is not None else range(nd)
    noise[:, nw:] = noise[:, nw + torch.as_tensor([i % nd for i in order])]
    return noise


def expert_requests(device, mpnet, pipe, codes):
    """EXPERT_PROMPTS prompts from the seed: CLIP ids, negative ids, MPNet
    features (the router's input), the routing noise that sends
    EXPERT_COUNTS[e] of them, shuffled, to expert e (`experts`), and their
    initial latents."""
    import torch
    from diffusion_pruning_tpu_torch.models.text_encoders import mean_pool
    gen = torch.Generator(device=device).manual_seed(SEED + 32)
    n = EXPERT_PROMPTS
    ids = torch.randint(0, 49408, (n, 77), device=device, generator=gen)
    neg = torch.randint(0, 49408, (n, 77), device=device, generator=gen)
    mp_ids = torch.randint(0, 30527, (n, 128), device=device, generator=gen)
    lengths = torch.randint(8, 129, (n, 1), device=device, generator=gen)
    mask = (torch.arange(128, device=device)[None, :] < lengths).long()
    cfg = pipe.unet.cfg
    latents = torch.randn(n, cfg.sample_size, cfg.sample_size, cfg.in_channels, device=device,
                          generator=gen)
    with torch.inference_mode():
        feats = mean_pool(mpnet(mp_ids, mask), mask)
    experts = torch.repeat_interleave(torch.arange(len(EXPERT_COUNTS)),
                                      torch.as_tensor(EXPERT_COUNTS))
    experts = experts[torch.randperm(n, generator=torch.Generator().manual_seed(SEED + 36))]
    return {"ids": ids, "neg": neg, "feats": feats, "latents": latents, "experts": experts,
            "noise": steering_noise(pipe.quantizer, codes, experts)}


def tier_plans(server, pending, hybrid):
    """The tiers a flush of `pending` ({expert: prompts}) runs, as
    {expert or "pooled": [(tier, prompts), ...]}: each expert's tier plan,
    or under hybrid its full largest tiers plus one pooled plan over all
    remainders."""
    plan = lambda n: server.plan_batches(n, server.batch_shapes)  # noqa: E731
    size = server.batch_size
    plans = {str(e): plan(n // size * size if hybrid else n) for e, n in sorted(pending.items())}
    plans = {e: p for e, p in plans.items() if p}
    rest = sum(n % size for n in pending.values())
    if hybrid and rest:
        plans["pooled"] = plan(rest)
    return plans


def serve_queue(server, requests, hybrid):
    """The prompts through a ServingQueue in two submits of 8, with their
    routing noise and initial latents, then `flush` (expert mode) or
    `flush_async` (hybrid); checks the routing, the request ids, the slot
    accounting and the images. Returns the row and the images (N, H, W, 3)
    on the host."""
    import torch
    from diffusion_pruning_tpu_torch.pipelines.expert_server import ServingQueue
    queue = ServingQueue(server, num_inference_steps=STEPS, guidance_scale=GUIDANCE,
                         hybrid=hybrid)
    half = EXPERT_PROMPTS // 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [rid for lo in (0, half) for rid in queue.submit(
        requests["ids"][lo: lo + half], requests["neg"][lo: lo + half],
        hyper_net_input=requests["feats"][lo: lo + half],
        route_noise=requests["noise"][lo: lo + half],
        latents=requests["latents"][lo: lo + half])]
    pending = queue.pending_per_expert()
    results = queue.flush_async().result(timeout=600) if hybrid else queue.flush()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    images = torch.stack([results[r] for r in sorted(results)]) if results else None
    tiers = tier_plans(server, pending, hybrid)
    row = {"phase": "serving_experts", "mode": "hybrid" if hybrid else "experts",
           "prompts": EXPERT_PROMPTS, "resolution": 256, "steps": STEPS, "guidance": GUIDANCE,
           "seconds": seconds, "images_per_sec": EXPERT_PROMPTS / seconds,
           "pending_per_expert": {str(k): v for k, v in sorted(pending.items())},
           "tiers": tiers, "slots_used": queue.last_slots_used,
           "slots_planned": sum(t for p in tiers.values() for t, _ in p),
           "image_min": float(images.min()), "image_max": float(images.max())}
    emit(row)
    if pending != dict(enumerate(EXPERT_COUNTS)):
        fail(f"the routing noise did not send {EXPERT_COUNTS} prompts to the experts: {pending}")
    if rids != list(range(EXPERT_PROMPTS)) or sorted(results) != rids:
        fail(f"requests lost or duplicated: submitted {rids}, got {sorted(results)}")
    if queue.pending_per_expert():
        fail(f"the queue did not drain every prompt: {queue.pending_per_expert()}")
    if row["slots_used"] != row["slots_planned"]:
        fail(f"slots used differ from the tier plans: {row}")
    if tuple(images.shape) != (EXPERT_PROMPTS, 256, 256, 3) or not bool(
            torch.isfinite(images).all()) or row["image_min"] < 0 or row["image_max"] > 1:
        fail(f"expert serving images not finite in [0, 1] of shape (16, 256, 256, 3): {row}")
    return row, images


def checked_rows(requests, hybrid):
    """The served rows held against a run alone, as (row, gated): in expert
    mode each expert's last prompt (its tail tier) and expert 0's first (a
    full tier); under hybrid expert 0's first (its full tier, through the
    expert) and the last prompt of experts 0, 3 and 7 (pooled remainders,
    through the gated U-Net under their codes)."""
    experts = requests["experts"].tolist()
    rows = {e: [r for r, x in enumerate(experts) if x == e] for e in range(len(EXPERT_COUNTS))}
    if not hybrid:
        return [(rows[0][0], False)] + [(rows[e][-1], False) for e in sorted(rows)]
    return [(rows[0][0], False)] + [(rows[e][-1], True) for e in (0, 3, 7)]


def check_served_images(server, requests, images, hybrid):
    """Each checked row's served image against the same prompt run alone,
    with the same initial latents, through `server.expert_pipe(e)` or (a
    hybrid remainder) the gated pipe under expert e's code: relative L2 <=
    SERVED_REL_L2, and the planted fault (each row's image held against the
    next checked row's run) above it."""
    import torch
    from diffusion_pruning_tpu_torch.core.estimators import hard_concrete
    base = server.base_pipeline
    codes = hard_concrete(base.quantizer.embedding_gs.float())
    checked = checked_rows(requests, hybrid)
    alone = []
    for r, gated in checked:
        e = int(requests["experts"][r])
        pipe = base if gated else server.expert_pipe(e)
        pe = base.encode_prompt(requests["ids"][r: r + 1])
        ne = base.encode_prompt(requests["neg"][r: r + 1])
        lat = pipe.denoise(None, pe, ne, codes[e: e + 1] if gated else None, STEPS, GUIDANCE,
                           latents=requests["latents"][r: r + 1])
        alone.append(pipe.decode(lat)[0].cpu())
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    errs = [rel(images[r], ref) for (r, _), ref in zip(checked, alone)]
    swapped = [rel(images[r], alone[(i + 1) % len(alone)]) for i, (r, _) in enumerate(checked)]
    row = {"phase": "serving_experts_check", "mode": "hybrid" if hybrid else "experts",
           "rows": [[r, int(requests["experts"][r]), "gated" if g else "expert"]
                    for r, g in checked],
           "rel_l2": errs, "limit": SERVED_REL_L2,
           "rel_l2_planted_fault_next_rows_image": swapped}
    emit(row)
    if not max(errs) <= SERVED_REL_L2:
        fail(f"served images disagree with the prompts run alone: {row}")
    if not min(swapped) > SERVED_REL_L2:
        fail(f"the planted fault reads within the limit: {row}")
    return row


def serve_gated(pipe, requests):
    """The same prompts (routing noise, initial latents) through the gated
    routed pipeline in one call."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images, _, _ = pipe(requests["ids"], requests["neg"], hyper_net_input=requests["feats"],
                        num_inference_steps=STEPS, guidance_scale=GUIDANCE,
                        latents=requests["latents"], route_noise=requests["noise"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    row = {"phase": "serving_experts", "mode": "gated", "prompts": EXPERT_PROMPTS,
           "resolution": 256, "seconds": seconds, "images_per_sec": EXPERT_PROMPTS / seconds}
    emit(row)
    if not bool(torch.isfinite(images).all()) or images.min() < 0 or images.max() > 1:
        fail(f"gated serving images not finite in [0, 1]: {row}")
    return row


def serve_samplers(pipe, requests, device):
    """One 256px request of 2 prompts through the routed pipeline under each
    of the other samplers: finite images in [0, 1], 32 attention launches a
    model evaluation."""
    import torch
    from diffusion_pruning_tpu_torch.pipelines import PruningPipeline
    ids, neg, feats = requests["ids"], requests["neg"], requests["feats"]
    rows = []
    for name in ("pndm", "dpm++"):
        routed = PruningPipeline(pipe.unet, pipe.vae, pipe.text_encoder, pipe.hypernet,
                                 pipe.quantizer, device=device, sampler=name)
        evals = len(routed._sampler().timesteps(STEPS))
        gen = torch.Generator(device=device).manual_seed(SEED + 33)
        before = launch_counts()["gated_flash_fwd"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images, indices, _ = routed(ids[:2], neg[:2], gen, hyper_net_input=feats[:2],
                                    num_inference_steps=STEPS, guidance_scale=GUIDANCE)
        torch.cuda.synchronize()
        row = {"phase": "serving_sampler", "sampler": name, "prompts": 2, "resolution": 256,
               "steps": STEPS, "model_evaluations": evals,
               "seconds": time.perf_counter() - t0,
               "launches": launch_counts()["gated_flash_fwd"] - before,
               "expert_indices": indices.tolist(),
               "image_min": float(images.min()), "image_max": float(images.max())}
        emit(row)
        if tuple(images.shape) != (2, 256, 256, 3) or not bool(torch.isfinite(images).all()) \
                or row["image_min"] < 0 or row["image_max"] > 1:
            fail(f"{name}: images not finite in [0, 1]: {row}")
        if row["launches"] != 32 * evals:
            fail(f"{name}: expected {32 * evals} attention launches, got {row['launches']}")
        rows.append(row)
    return rows


def profile_expert_flush(server, requests):
    """One expert-mode flush of the prompts under torch.profiler: device
    kernel time by category and the device's busy share. Only the device's
    activity is recorded: the host's op events of a whole flush slow it
    and take minutes to reduce."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_queue(server, requests, False)
        wall_ms = (time.perf_counter() - t0) * 1e3
    row = {"phase": "profile_experts", "mode": "experts", "prompts": EXPERT_PROMPTS,
           "wall_ms": wall_ms, **device_kernel_times(prof, wall_ms)}
    emit(row)
    return row


def serve_experts(pipe, mpnet, unet, device):
    """Phase 12: K = 8 experts cut from a seeded codebook, checked against the
    f32 dense U-Net, then served: two rounds of expert, hybrid and gated
    serving of the same 16 prompts (routed to every expert), in turns (every
    launch count set to 0 before the first and read after the last), the
    first round's served images held against each prompt run alone, the
    PNDM and DPM++ requests and one profiled expert flush."""
    import torch
    from diffusion_pruning_tpu_torch.pipelines.expert_server import ExpertServer

    parts = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    codes = expert_codebook(pipe.quantizer, unet.spec)
    server = ExpertServer.from_codebook(pipe, unet.spec, unet.cfg, batch_size=4,
                                        param_dtype=torch.bfloat16)
    lap("materialise")
    expert_summary(server, unet)
    check_rows, check = check_experts(server, unet, codes, device)
    lap("expert_check")
    torch.backends.cudnn.allow_tf32 = True  # serving as phase 5 serves
    warm = server.warmup(STEPS, GUIDANCE, hybrid=True)
    lap("warmup")
    requests = expert_requests(device, mpnet, pipe, codes)
    seconds = {"experts": [], "hybrid": [], "gated": []}
    served, tiers = {}, {}
    reset_launch_counts()
    for _ in range(EXPERT_ROUNDS):
        for mode, hybrid in (("experts", False), ("hybrid", True)):
            row, images = serve_queue(server, requests, hybrid)
            seconds[mode].append(row["seconds"])
            served.setdefault(mode, images)
            tiers[mode] = row["tiers"]
        seconds["gated"].append(serve_gated(pipe, requests)["seconds"])
    torch.cuda.synchronize()
    counts = launch_counts()
    lap("serving")
    served_checks = {mode: check_served_images(server, requests, served[mode], mode == "hybrid")
                     for mode in ("experts", "hybrid")}
    lap("served_image_check")
    samplers = serve_samplers(pipe, requests, device)
    lap("samplers")
    profiled = profile_expert_flush(server, requests)
    lap("profiled_flush")
    torch.backends.cudnn.allow_tf32 = False
    summary = {"phase": "serving_experts_summary", "experts": len(server.expert_models),
               "seconds_by_part": parts, "warmup": warm,
               "prompts_per_expert": list(EXPERT_COUNTS), "tiers": tiers,
               "seconds": seconds,
               "img_per_sec": {k: EXPERT_PROMPTS / statistics.mean(v)
                               for k, v in seconds.items()},
               "launches": {k: v for k, v in counts.items() if v},
               "served_rel_l2_worst": {k: max(r["rel_l2"]) for k, r in served_checks.items()},
               "served_planted_fault_least": {
                   k: min(r["rel_l2_planted_fault_next_rows_image"])
                   for k, r in served_checks.items()},
               "profiled_flush_busy_share": profiled["device_busy_share"],
               "sampler_seconds": {r["sampler"]: r["seconds"] for r in samplers},
               "expert_forward_ms_b8": check["forward_ms"],
               "gated_forward_ms_b8": check["gated_forward_ms"],
               "expert_forward_device_ms_b8": check["device_ms"],
               "gated_forward_device_ms_b8": check["gated_device_ms"]}
    emit(summary)
    return summary, counts, check


def forward_entry(name, rows, train_rows, worst, train_check, serve_counts, train_launches,
                  expert_counts, expert_check, cli_counts):
    """One forward kernel's line: its share of the phase-3 sites (by
    `forward_kernel`) and of the phase-7 training sites, its launches in the
    serving, train-step, expert-serving and prune-CLI (run 2) runs, its
    device time over one expert forward's sites (phase 12)."""
    from diffusion_pruning_tpu_torch.ops.flash_attention import forward_kernel
    mine = [r for r in rows if r["kernel"] == name]
    mine_train = [r for r in train_rows if forward_kernel(r["s_q"], r["s_kv"]) == name]
    agg = {key: sum(r[key] * r["sites_per_256px_forward"] for r in mine)
           for key in ("ms", "cold_ms", "eager_ms", "plain_ms", "library_ms", "library_cold_ms",
                       "library_eager_ms", "bound_ms")}
    ops = sum(r["bound_ms"] * r["sites_per_256px_forward"] for r in mine
              if r["bound_by"] == "operations")
    key = f"kernel:{name}"
    by_path = {"serving": serve_counts[key], "train_step": train_launches[key],
               "serving_experts": expert_counts[key], "stage1_cli": cli_counts[key]}
    small = name == "gated_flash_fwd_small"
    return {
        "name": name, "route": "cuda",
        "source": "diffusion_pruning_tpu_torch/csrc/gated_flash_fwd.cu",
        "replaces": "diffusion_pruning_tpu/ops/flash_attention.py:148",
        "also_replaces": ["diffusion_pruning_tpu/ops/flash_attention.py:181",
                          "diffusion_pruning_tpu/ops/flash_attention.py:215",
                          "diffusion_pruning_tpu/ops/flash_attention.py:284"],
        "dispatch": ("S_q <= 64 and S_kv <= 80 (wgmma, TMA; whole items per warpgroup)" if small
                     else "S_q > 64 or S_kv > 80 (wgmma, TMA; 128-row query tiles)"),
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in mine),
        "rel_l2_worst_head": max(r["rel_l2_worst_head"] for r in mine),
        "rel_l2_worst_head_all_gates": worst["rel_l2_worst_head"],
        **agg, "bound_by": "operations" if ops >= agg["bound_ms"] / 2 else "bytes",
        "library_call": "F.scaled_dot_product_attention of pre-masked q/k/v",
        "shapes": "its attention sites of one SD-2.1 U-Net forward at 256px, B_eff 16, bf16, "
                  "soft gates",
        "expert_path": expert_path_entry(expert_check["kernel_device_ms_mean"], name,
                                         expert_check["gated_kernel_device_ms"]),
        "training_forward": {**training_entry(mine_train, "fwd_lse", "fwd_lse_plain_ms",
                                              "fwd_lse_library_ms"),
                             "lse_max_abs_err": train_check["worst"]["lse_max_abs"],
                             "library_call": "F.scaled_dot_product_attention forward of "
                                             "pre-masked q/k/v under autograd"},
    }


def expert_path_entry(expert_ms, name, gated_ms=None):
    """A kernel's device ms over the sites of one expert forward (256px,
    B_eff 8, kept widths; the mean over the experts), beside the gated
    U-Net's where measured."""
    return {"ms_per_forward_mean_over_experts": expert_ms.get(name, 0.0),
            **({"gated_ms_per_forward": gated_ms.get(name, 0.0)} if gated_ms else {}),
            "shapes": "the sites of one expert forward at 256px, B_eff 8 (torch.profiler "
                      "kernel times, phase 12)"}


def fused_kernel_entry(check, name, source, replaces, also, library_call, launches_by_path,
                       expert_ms):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "also_replaces": also, "launches": sum(launches_by_path.values()),
            "expert_path": expert_path_entry(expert_ms, name),
            "launches_by_path": launches_by_path, **check.entry(),
            **({"identity_tap_silu": check.identity_tap} if hasattr(check, "identity_tap") else {}),
            "least_planted_fault_rel_l2": check.least_fault, "library_call": library_call,
            "shapes": "the sites of one SD-2.1 U-Net forward at 256px, B_eff 16, bf16"}


def backward_entries(train_rows, train_check, train_launches, cli_counts):
    """The backward kernels' lines: each kernel's times summed over the
    sites of one student pass where `backward_plan` runs it, its launches in
    the train-step run and the prune CLI's run 2, its worst readings on its
    route's phase-7 cases."""
    src = "diffusion_pruning_tpu_torch/csrc/gated_flash_bwd.cu"
    fa_py = "diffusion_pruning_tpu/ops/flash_attention.py"
    one, two = (train_check["worst_by_route"][r] for r in ("one_pass", "two_kernel"))
    spec = (
        ("gated_flash_bwd_fused", "fused", 586, [638, 686, 741], "one pass, S_kv <= 80",
         max(one["dq_max_abs"], one["dkv_max_abs"]), max(one["dq"], one["dk"], one["dv"]),
         one["dgate"], "bwd_library_ms"),
        ("gated_flash_bwd_reduce", "reduce", 638, [741],
         "the fixed-order sum of a split one pass's dk/dv slices", one["dkv_max_abs"],
         max(one["dk"], one["dv"]), one["dgate"], None),
        ("gated_flash_bwd_dq", "dq", 586, [686], "S_kv > 80, first of two", two["dq_max_abs"],
         two["dq"], two["dgate"], "bwd_library_ms"),
        ("gated_flash_bwd_dkv", "dkv", 638, [741], "S_kv > 80, second of two",
         two["dkv_max_abs"], max(two["dk"], two["dv"]), two["dgate"], "bwd_library_ms"))
    out = []
    for name, kind, line, also, role, max_abs, rel, dgate, library in spec:
        entry = {"name": name, "route": "cuda", "source": src, "replaces": f"{fa_py}:{line}",
                 "also_replaces": [f"{fa_py}:{n}" for n in also], "role": role,
                 "launches": train_launches[name] + cli_counts[name],
                 "launches_by_path": {"train_step": train_launches[name],
                                      "stage1_cli": cli_counts[name]},
                 "max_abs_err": max_abs,
                 "rel_l2_worst_head": rel, "dgate_rel_worst": dgate,
                 **training_entry(train_rows, kind, "reduce_plain_ms" if kind == "reduce"
                                  else "bwd_plain_ms", library)}
        if library is not None:
            entry["library_call"] = ("the backward of F.scaled_dot_product_attention on "
                                     "pre-masked q/k/v at the same sites (no dgate)")
        out.append(entry)
    return out


def sass_counts(build):
    """Tensor-core and TMA instructions in each built kernel's SASS
    (`cuobjdump --dump-sass`): HGMMA (wgmma), HMMA (mma.sync), UTMALDG (TMA
    tile loads), by source and kernel function."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "not measured"
    out = {}
    for source in build.SOURCES:
        lib = build._library_path(source)
        sass = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True,
                              text=True).stdout
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                out[f"{source.stem}:{fn}"] = dict.fromkeys(("HGMMA", "HMMA", "UTMALDG"), 0)
            elif fn is not None:
                for op in ("HGMMA", "HMMA", "UTMALDG"):
                    out[f"{source.stem}:{fn}"][op] += f" {op}." in line or f" {op} " in line
    return out


def ptxas_report(text: str) -> dict:
    """Registers, spill bytes and ptxas warnings (C7513: wgmma serialised) of
    each kernel function in one `-Xptxas=-v` report."""
    import re
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {"registers": None, "spill_store_bytes": None, "spill_load_bytes": None,
                       "warnings": []}
            continue
        if "warning" in line:
            m = re.search(r"function '([^']+)'", line)
            target = m.group(1) if m and m.group(1) in out else fn
            if target is not None:
                out[target]["warnings"].append(line.strip())
            continue
        if fn is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[fn]["spill_store_bytes"], out[fn]["spill_load_bytes"] = map(int, m.groups())
    return out


FORWARD_KERNELS = ("gated_flash_fwd_small_kernel", "gated_flash_fwd_wgmma_kernel")


def check_forward_build(build, sass):
    """Every kernel of gated_flash_fwd.cu runs on HGMMA and TMA with no
    mma.sync left, and the S_q <= 64 instances spill nothing; their
    registers, spills and ptxas notes are reported."""
    report = ptxas_report((build.BUILD_DIR / "gated_flash_fwd.ptxas.txt").read_text())
    rows = {}
    for key, counts in (sass.items() if isinstance(sass, dict) else ()):
        stem, fn = key.split(":", 1)
        if stem == "gated_flash_fwd":
            rows[fn] = {**counts, **report.get(fn, {})}
    emit({"phase": "forward_sass", "kernels": rows})
    if isinstance(sass, dict):
        wrong = [fn for fn, r in rows.items()
                 if not (r["HGMMA"] > 0 and r["UTMALDG"] > 0 and r["HMMA"] == 0)
                 or ("small" in fn and r.get("spill_store_bytes") != 0)]
        found = {name for name in FORWARD_KERNELS if any(name in fn for fn in rows)}
        if found != set(FORWARD_KERNELS) or wrong:
            fail(f"the forward kernels are not spill-free wgmma/TMA kernels: {rows}")


BACKWARD_WGMMA_KERNELS = ("gated_flash_bwd_fused_kernel", "gated_flash_bwd_fused_small_kernel",
                          "gated_flash_bwd_dq_kernel", "gated_flash_bwd_dkv_kernel")


def check_backward_build(build, sass):
    """Each wgmma kernel of gated_flash_bwd.cu runs on HGMMA and TMA and has
    no mma.sync left; its registers, spills and ptxas notes are reported."""
    report = ptxas_report((build.BUILD_DIR / "gated_flash_bwd.ptxas.txt").read_text())
    rows = {}
    for key, counts in (sass.items() if isinstance(sass, dict) else ()):
        stem, fn = key.split(":", 1)
        if stem != "gated_flash_bwd" or "reduce" in fn:
            continue
        rows[fn] = {**counts, **report.get(fn, {})}
    emit({"phase": "backward_sass", "kernels": rows})
    if isinstance(sass, dict):
        wrong = [fn for fn, r in rows.items()
                 if not (r["HGMMA"] > 0 and r["UTMALDG"] > 0 and r["HMMA"] == 0)]
        found = {name for name in BACKWARD_WGMMA_KERNELS if any(name in fn for fn in rows)}
        if found != set(BACKWARD_WGMMA_KERNELS) or wrong:
            fail(f"the backward kernels are not wgmma/TMA kernels: {rows}")


def check_fused_build(build, sass):
    """norm_linear runs on HGMMA and TMA with no mma.sync left; group_norm_silu
    on TMA; their registers, spills and ptxas notes, and the cluster size
    group_norm_plan launches the 256px and 512px shapes with."""
    from diffusion_pruning_tpu_torch.ops import group_norm as gn
    rows = {}
    for stem, want in (("norm_conv", "norm_linear_kernel"), ("group_norm", "group_norm_silu")):
        report = ptxas_report((build.BUILD_DIR / f"{stem}.ptxas.txt").read_text())
        for key, counts in (sass.items() if isinstance(sass, dict) else ()):
            src, fn = key.split(":", 1)
            if src == stem and want in fn:
                rows[fn] = {**counts, **report.get(fn, {})}
    clusters = {f"{b}x{c}@{side}x{side}": gn.group_norm_plan(b, side * side, c, 32).cluster
                for b, c, side in ((16, 320, 32), (16, 960, 32), (16, 1280, 16), (16, 2560, 8),
                                   (4, 960, 64), (4, 320, 64), (64, 320, 32), (64, 960, 32))}
    emit({"phase": "fused_sass", "kernels": rows, "group_norm_cluster_by_shape": clusters})
    if isinstance(sass, dict):
        linear = [r for fn, r in rows.items() if "norm_linear_kernel" in fn]
        gnorm = [r for fn, r in rows.items() if "group_norm_silu" in fn]
        if not linear or any(not (r["HGMMA"] > 0 and r["UTMALDG"] > 0 and r["HMMA"] == 0)
                             for r in linear):
            fail(f"norm_linear is not a wgmma/TMA kernel: {rows}")
        if not gnorm or not any(r["UTMALDG"] > 0 for r in gnorm):
            fail(f"group_norm_silu reads no TMA box: {rows}")


# ---------------------------------------------------------------- phase 13

HERE = os.path.dirname(os.path.abspath(__file__))
STAGE1_DIR = os.path.join(HERE, "build", "stage1_program")  # ignored by git; removed at the end
CLI_STEPS = (3, 6)            # run 1 ends at step 3, run 2 resumes it to step 6
CLI_ACCUM = 2                 # run 2's micro-batches a step (2 × 32 at B = 64)
CODEBOOK_SHAPE = (8, 1620)    # K experts × the SD-2.1 U-Net's arch vector
SAFETY_TOWER = "vit_l14"      # the safety checker's CLIP tower (CLIPVisionConfig)
PROGRESSIVE_EVERY = 10        # snapshots of the DDIM-25 progressive trajectory
# the last snapshot against __call__ with the same latents and routing noise:
# the same kernels on the same batch, so every element is expected to repeat
PROGRESSIVE_MAX_ABS = 0.0
LOSS_KEYS = ("loss", "diffusion_loss", "distillation_loss", "block_loss", "contrastive_loss",
             "resource_loss", "resource_ratio", "grad_norm")


def write_sd_weights(root, device):
    """Seeded random weights at SD-2.1 width in the layout of a diffusers
    checkpoint and an HF MPNet folder, bf16, through safetensors:
    unet/, vae/, text_encoder/ under `root`, and root/mpnet. Returns the
    bytes written."""
    import torch
    from diffusion_pruning_tpu_torch.models.text_encoders import (
        CLIPTextConfig, CLIPTextEncoder, MPNetConfig, MPNetEncoder)
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from diffusion_pruning_tpu_torch.utils.init_utils import random_init_
    from safetensors.torch import save_file

    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    parts = (("unet", "diffusion_pytorch_model.safetensors", GatedUNet, UNetConfig.sd21(256)),
             ("vae", "diffusion_pytorch_model.safetensors", AutoencoderKL, VAEConfig.sd()),
             ("text_encoder", "model.safetensors", CLIPTextEncoder, CLIPTextConfig.sd21()),
             ("mpnet", "model.safetensors", MPNetEncoder, MPNetConfig.base()))
    nbytes = 0
    for sub, fname, cls, cfg in parts:
        with torch.device(device):
            module = cls(cfg)
        random_init_(module, gen)
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        path = os.path.join(root, sub, fname)
        save_file({k: v.bfloat16().contiguous() for k, v in module.state_dict().items()}, path)
        nbytes += os.path.getsize(path)
        del module
    torch.cuda.empty_cache()
    return nbytes


def stage1_yaml(path, **changes):
    """configs/pruning/sd-2-1_coco2014.yaml with `changes` (dotted paths) and
    no data_dir, read and written by the port's own YAML code."""
    from diffusion_pruning_tpu_torch.utils.config import load_config
    cfg = load_config(os.path.join(HERE, "configs", "pruning", "sd-2-1_coco2014.yaml"))
    cfg.set_path("data.data_dir", None)
    cfg.set_path("training.logging.logging_dir", os.path.join(STAGE1_DIR, "runs"))
    for key, value in changes.items():
        cfg.set_path(key, value)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cfg.dump(path)
    return path


def cli_argv(config_path, weights):
    return ["--base_config_path", config_path, "--pretrained_model_name_or_path", weights,
            "--prompt_encoder_model_name_or_path", os.path.join(weights, "mpnet"),
            "--wandb_run_name", "cli", "--seed", str(SEED)]


def metrics_lines(run_dir):
    """The run directory's logged lines: (the steps', the validations')."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return [m for m in lines if "loss" in m], [m for m in lines if "val_loss" in m]


def to_host(tree):
    """A copy of a state tree with every tensor cloned to the host."""
    import torch
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree.detach().to("cpu", copy=True) if torch.is_tensor(tree) else tree


def state_equal(a, b, path=""):
    """Paths where two saved states (dicts, lists, tensors, numbers) differ."""
    import torch
    if isinstance(a, dict):
        if sorted(a) != sorted(b):
            return [f"{path}: keys {sorted(set(a) ^ set(b))}"]
        return [d for k in a for d in state_equal(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{path}: length"]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in state_equal(x, y, f"{path}/{i}")]
    if torch.is_tensor(a):
        return [] if torch.equal(a.cpu(), b.cpu()) else [path]
    return [] if a == b else [path]


def cli_step_launches(b):
    """Each attention kernel's launches in one micro-batch of `b` at 256px:
    the teacher's 32 lse-free forwards, the student's 32 forwards with lse,
    and the backward kernels `backward_plan` picks at each site."""
    from diffusion_pruning_tpu_torch.ops import flash_attention as fa
    out = collections.Counter({"gated_flash_fwd": 32, "gated_flash_fwd_lse": 32})
    for s_q, s_kv, h, sites in TRAIN_CASES:
        for name, n in fa.backward_plan(b, h, s_q, s_kv).launches.items():
            out[name] += n * sites
    return out


def run_cli_in_process(argv, device):
    """The prune entry point's `main(argv)` in this process, timed by part:
    the factory (from the call to the loop's start), the steps (each checked
    for its attention launches: `CLI_ACCUM` micro-batches of `cli_step_launches`),
    validation, the checkpoint saves with their export, the resume (whose
    state is kept for the caller). The loop is asked to log every step (its
    `LoopConfig.log_every`, 10 from the entry point), so that each step's
    losses, expert usage and the loop's own steps/s reach metrics.jsonl."""
    import torch
    import diffusion_pruning_tpu_torch.training as training
    from diffusion_pruning_tpu_torch.cli import prune
    from diffusion_pruning_tpu_torch.training import loop as loop_module

    parts = collections.defaultdict(float)
    steps, resumed = [], {}
    per_step = collections.Counter()
    for name, n in cli_step_launches(TRAIN_B // CLI_ACCUM).items():
        per_step[name] = n * CLI_ACCUM
    real_make_step = training.make_pruner_step

    def make_step(*args, **kwargs):
        step = real_make_step(*args, **kwargs)

        def timed(batch, **kw):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(batch, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {k: v - before[k] for k, v in launch_counts().items()}
            checked = wrapper_counts(launches)
            if checked != {k: per_step.get(k, 0) for k in checked}:
                fail(f"expected {dict(per_step)} launches per CLI step, got {launches}")
            steps.append({"seconds": seconds, "launches": launches})
            return out
        return timed

    def timed_method(name, part):
        real = getattr(loop_module.PrunerLoop, name)

        def wrapper(self, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(self, *a, **k)
            torch.cuda.synchronize()
            parts[part] += time.perf_counter() - t0
            if name == "maybe_resume":
                resumed.update(step=self.global_step, state=to_host(self.state_dict()))
            return out
        return wrapper

    real_train = loop_module.PrunerLoop.train

    def train(self, *a, **k):
        parts["factory_build_and_load"] = time.perf_counter() - t_main
        return real_train(self, *a, **k)

    real_export = loop_module.export_pruning_checkpoint

    def export(*a, **k):
        t0 = time.perf_counter()
        real_export(*a, **k)
        parts["export"] += time.perf_counter() - t0

    saved = {name: getattr(loop_module.PrunerLoop, name)
             for name in ("maybe_resume", "save_checkpoint", "validate")}
    real_loop_config = loop_module.LoopConfig
    try:
        training.make_pruner_step = make_step
        loop_module.LoopConfig = functools.partial(real_loop_config, log_every=1)
        loop_module.export_pruning_checkpoint = export
        for name, part in (("maybe_resume", "resume"), ("save_checkpoint", "checkpoint_save"),
                           ("validate", "validation")):
            setattr(loop_module.PrunerLoop, name, timed_method(name, part))
        loop_module.PrunerLoop.train = train
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t_main = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            loop = prune.main(argv)
        counts = launch_counts()
    finally:
        training.make_pruner_step = real_make_step
        loop_module.LoopConfig = real_loop_config
        loop_module.export_pruning_checkpoint = real_export
        for name, fn in saved.items():
            setattr(loop_module.PrunerLoop, name, fn)
        loop_module.PrunerLoop.train = real_train
    parts["steps"] = sum(s["seconds"] for s in steps)
    parts["checkpoint_save"] -= parts["export"]
    return loop, dict(parts), steps, resumed, counts, torch.cuda.max_memory_allocated() / 2 ** 30


def check_cli_runs(weights, device):
    """Run 1 as a user runs it (a subprocess: 3 steps, one of them
    pretraining, validation and heatmaps at step 3, no unet/ export), then run
    2 in this process: resume from `latest` to step 6 with 2 micro-batches a
    step and the unet/ export. Returns the summary row and run 2's kernel
    counts."""
    import torch
    from diffusion_pruning_tpu_torch.utils.checkpoint import CheckpointManager, load_torch_artifact
    from diffusion_pruning_tpu_torch.utils.export import load_torch_state_dict

    parts = {}
    yaml1 = stage1_yaml(os.path.join(STAGE1_DIR, "run1", "sd21_prune.yaml"), **{
        "training.max_train_steps": CLI_STEPS[0], "training.hypernet_pretraining_steps": 1,
        "training.validation_steps": CLI_STEPS[0], "training.image_logging_steps": CLI_STEPS[0],
        "training.logging.export_unet": False})
    yaml2 = stage1_yaml(os.path.join(STAGE1_DIR, "run2", "sd21_prune.yaml"), **{
        "training.max_train_steps": CLI_STEPS[1], "training.hypernet_pretraining_steps": 1,
        "training.validation_steps": CLI_STEPS[0], "training.image_logging_steps": CLI_STEPS[0],
        "training.gradient_accumulation_steps": CLI_ACCUM,
        "training.logging.resume_from_checkpoint": "latest"})
    run_dir = os.path.join(STAGE1_DIR, "runs", "sd21_prune", "cli")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "diffusion_pruning_tpu_torch.cli.prune",
                           *cli_argv(yaml1, weights)], capture_output=True, text=True,
                          timeout=600, cwd=HERE)
    parts["run1_subprocess"] = time.perf_counter() - t0
    with open(os.path.join(HERE, "build", "stage1_cli_run1.log"), "w") as f:  # ignored by git
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        fail(f"prune run 1 exited {proc.returncode}: {proc.stderr[-3000:]}")
    ckpt = CheckpointManager(run_dir)
    d3 = ckpt.dir_for(CLI_STEPS[0])
    layout = sorted(os.listdir(d3)) if os.path.isdir(d3) else None
    if ckpt.list_steps() != [CLI_STEPS[0]] or layout != [
            "hypernet", "quantizer", "quantizer_embeddings.pt", "state"]:
        fail(f"run 1 left {ckpt.list_steps()} with {layout}")
    saved = ckpt.restore(CLI_STEPS[0])
    emb = load_torch_artifact(os.path.join(d3, "quantizer_embeddings.pt"))
    exported_hn = load_torch_state_dict(os.path.join(d3, "hypernet"))
    exported_q = load_torch_state_dict(os.path.join(d3, "quantizer"))
    if tuple(emb.shape) != CODEBOOK_SHAPE:
        fail(f"quantizer_embeddings.pt is {tuple(emb.shape)}, not {CODEBOOK_SHAPE}")
    # run 1 logs at the entry point's period (10 steps): its validation alone
    train1, val1 = metrics_lines(run_dir)
    if train1 or [m["step"] for m in val1] != [CLI_STEPS[0]] or not all(
            math.isfinite(v) for k, v in val1[0].items() if k.startswith("val_")):
        fail(f"run 1 logged steps {[m['step'] for m in train1]} and validations {val1}")

    loop, run2_parts, steps, resumed, counts, peak = run_cli_in_process(
        cli_argv(yaml2, weights), device)
    parts.update({f"run2_{k}": v for k, v in run2_parts.items()})
    # the state run 2 resumed against run 1's saved tensors and artifacts
    diff = state_equal(resumed.get("state", {}), saved)
    r = resumed["state"]
    export_diff = [k for k in r["hypernet"]  # the heads' weights and biases
                   if not torch.equal(r["hypernet"][k].float(), exported_hn[k])]
    export_diff += [k for k in ("embedding.weight", "embedding_gs")
                    if not torch.equal(r["quantizer"][k].cpu(), exported_q[k])]
    if not torch.equal(r["quantizer"]["embedding_gs"].cpu(), emb):
        export_diff.append("quantizer_embeddings.pt")
    if resumed.get("step") != CLI_STEPS[0] or diff or export_diff:
        fail(f"run 2 resumed step {resumed.get('step')}, differing from run 1's saved state at "
             f"{diff[:8]} and its exports at {export_diff}")
    # the unet/ export against the weights the factory loaded, and the rotation
    d6 = ckpt.dir_for(CLI_STEPS[1])
    if ckpt.list_steps() != [CLI_STEPS[1]]:
        fail(f"rotation left {ckpt.list_steps()}")
    src = load_torch_state_dict(os.path.join(weights, "unet"))
    out = load_torch_state_dict(os.path.join(d6, "unet"))
    unet_diff = sorted(set(src) ^ set(out)) + [
        k for k in src if k in out and not (out[k].dtype == torch.float32
                                            and torch.equal(out[k], src[k].float()))]
    if unet_diff:
        fail(f"checkpoint-{CLI_STEPS[1]}/unet differs from the loaded weights at {unet_diff[:8]}")
    lines, vals = metrics_lines(run_dir)
    bad = [m["step"] for m in lines if not all(math.isfinite(m[k]) for k in LOSS_KEYS)
           or sum(m[f"expert_usage/{e}"] for e in range(8)) != TRAIN_B or m["skipped"]]
    bad += [m["step"] for m in vals if not all(
        math.isfinite(v) for k, v in m.items() if k.startswith("val_"))]
    if ([m["step"] for m in lines] != list(range(CLI_STEPS[0] + 1, CLI_STEPS[1] + 1))
            or [m["step"] for m in vals] != list(CLI_STEPS) or bad):
        fail(f"the CLI logged steps {[m['step'] for m in lines]} and validations "
             f"{[m['step'] for m in vals]}; non-finite, skipped or not {TRAIN_B} routed at {bad}")
    if len(steps) != CLI_STEPS[1] - CLI_STEPS[0]:
        fail(f"run 2 took {len(steps)} steps")
    row = {"phase": "stage1_cli", "batch": TRAIN_B, "resolution": 256,
           "run2_micro_batches": CLI_ACCUM, "resumed_step": resumed["step"],
           "resumed_state_equal_to_run1_saved": True, "unet_export_equal_to_loaded": True,
           "unet_export_tensors": len(out), "rotation_left": ckpt.list_steps(),
           "losses": [{k: m[k] for k in ("step", "loss", "resource_ratio")} for m in lines],
           "expert_usage": [[m[f"expert_usage/{e}"] for e in range(8)] for m in lines],
           "cli_steps_per_sec": [m["steps_per_sec"] for m in lines],
           "run2_step_seconds": [s["seconds"] for s in steps],
           "run2_launches_per_step": steps[-1]["launches"],
           "run2_peak_memory_gib": peak, "seconds_by_part": parts}
    emit(row)
    del loop
    torch.cuda.empty_cache()
    return row, counts



def check_progressive(pipe, mpnet, device):
    """`sample_progressive` at 256px, DDIM-25, a snapshot every 10 steps,
    against `__call__` under DDIM on the same latents and routing noise (2
    prompts, CFG 7.5); 800 lse-free forward launches. Returns the call's
    images and inputs for the safety check."""
    import torch
    from diffusion_pruning_tpu_torch.core.estimators import sample_gumbel

    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    b, vocab = 2, pipe.text_encoder.cfg.vocab_size
    ids = torch.randint(0, vocab, (b, 77), device=device, generator=gen)
    neg = torch.zeros_like(ids)
    feats = torch.randn(b, pipe.hypernet.input_dim, device=device, generator=gen)
    size = pipe.unet.cfg.sample_size
    latents = torch.randn(b, size, size, 4, device=device, generator=gen)
    noise = sample_gumbel((b, pipe.unet.spec.vq_dim), gen)
    kw = dict(hyper_net_input=feats, num_inference_steps=STEPS, guidance_scale=GUIDANCE,
              latents=latents, route_noise=noise)
    pipe.sampler = "ddim"
    reset_launch_counts()
    t0 = time.perf_counter()
    snaps, idx = pipe.sample_progressive(ids, neg, snapshot_every=PROGRESSIVE_EVERY, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = wrapper_counts(launch_counts())
    images, call_idx, _ = pipe(ids, neg, **kw)
    err = (snaps[-1] - images).abs().max().item()
    row = {"phase": "progressive", "resolution": size * 8, "prompts": b, "steps": STEPS,
           "snapshots": len(snaps), "last_vs_call_max_abs": err, "limit": PROGRESSIVE_MAX_ABS,
           "indices_equal": bool(torch.equal(idx, call_idx)), "seconds": seconds,
           "launches": launches,
           "finite_in_unit_range": all(bool(torch.isfinite(s).all() and s.min() >= 0
                                            and s.max() <= 1) for s in snaps)}
    emit(row)
    want = {k: (STEPS * 32 if k == "gated_flash_fwd" else 0) for k in launches}
    if not (err <= PROGRESSIVE_MAX_ABS and row["indices_equal"] and row["finite_in_unit_range"]
            and len(snaps) == math.ceil(STEPS / PROGRESSIVE_EVERY) and launches == want):
        fail(f"progressive sampling: {row}")
    return images, ids, neg, kw


def check_safety(pipe, images, ids, neg, kw, device):
    """`SafetyChecker.from_diffusers` on a written random ViT-L/14
    `safety_checker/` whose first concept is image 0's embedding (through
    the written weights): `__call__` returns 4, flags image 0 alone, blacks
    it out and leaves image 1 as it was."""
    import torch
    from diffusion_pruning_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder
    from diffusion_pruning_tpu_torch.models.safety import SafetyChecker, clip_preprocess
    from diffusion_pruning_tpu_torch.utils.init_utils import random_init_
    from safetensors.torch import save_file

    vcfg = getattr(CLIPVisionConfig, SAFETY_TOWER)()
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    with torch.device(device):
        enc = CLIPVisionEncoder(vcfg)
    random_init_(enc, gen)
    for p in enc.parameters():  # the weights as the bf16 file will hold them
        p.data.copy_(p.data.bfloat16().float())
    with torch.inference_mode():
        emb = enc(clip_preprocess(images, vcfg.image_size))[1].float()
    unit = emb / emb.norm(dim=-1, keepdim=True)
    cos_other = (unit[1] @ unit[0]).item()
    threshold = (1.0 + cos_other) / 2 if cos_other < 0.999 else None
    if threshold is None:
        fail(f"the two images' embeddings are too alike to plant a concept: cos {cos_other}")
    other = torch.randn(2, vcfg.projection_dim, device=device, generator=gen)
    sd = {f"vision_model.{k}" if k.startswith("vision_model.") else k: v.bfloat16()
          for k, v in enc.state_dict().items()}
    sd.update(concept_embeds=torch.cat([emb[:1], other[:1]]),
              concept_embeds_weights=torch.tensor([threshold, 0.5], device=device),
              special_care_embeds=other[1:], special_care_embeds_weights=torch.tensor(
                  [0.5], device=device))
    folder = os.path.join(STAGE1_DIR, "safety_checker")
    os.makedirs(folder, exist_ok=True)
    save_file(sd, os.path.join(folder, "model.safetensors"))
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump({"projection_dim": vcfg.projection_dim, "vision_config": {
            "hidden_size": vcfg.hidden_size, "intermediate_size": vcfg.intermediate_size,
            "num_hidden_layers": vcfg.num_layers, "num_attention_heads": vcfg.num_heads,
            "image_size": vcfg.image_size, "patch_size": vcfg.patch_size,
            "hidden_act": vcfg.hidden_act}}, f)
    del enc, sd
    t0 = time.perf_counter()
    checker = SafetyChecker.from_diffusers(folder)
    load_s = time.perf_counter() - t0
    pipe.safety_checker = checker.to(device).eval()
    try:
        out = pipe(ids, neg, **kw)
    finally:
        pipe.safety_checker = None
    ok = len(out) == 4
    row = {"phase": "safety", "tower": f"CLIPVisionConfig.{SAFETY_TOWER} (random, bf16 on disk)",
           "returned": len(out), "cos_image1_to_planted": cos_other, "threshold": threshold,
           "load_seconds": load_s}
    if ok:
        got, _, _, nsfw = out
        row.update(nsfw=nsfw.tolist(), image0_black=bool((got[0] == 0).all()),
                   image1_unchanged=bool(torch.equal(got[1], images[1])))
        ok = row["nsfw"] == [True, False] and row["image0_black"] and row["image1_unchanged"]
    emit(row)
    if not ok:
        fail(f"the safety checker: {row}")


def check_conv_projection(cfg, device, gen):
    """The full-width U-Net with 1×1-conv proj_in/proj_out (random, bf16, the
    kernels) against an f32 copy with plain attention, at B_eff 16, plain
    and under `fused_norm_conv` (45 conv launches a forward and no
    `norm_linear`: its norm stays unfused)."""
    import copy
    import torch
    from diffusion_pruning_tpu_torch.ops.flash_attention import gated_attention_reference

    unet = build_unet(cfg, device, gen)
    x, t, ehs, arch = unet_inputs(unet, device)
    twin = fused_twin(unet, fused_norm_conv=True)
    row = {"phase": "conv_projection_unet", "resolution": cfg.sample_size * 8,
           "b_eff": x.shape[0],
           "proj_in_weight": list(unet.state_dict()[
               "mid_block.attentions.0.proj_in.weight"].shape), "limit": UNET_REL_L2}
    with torch.inference_mode():
        f32 = copy.deepcopy(unet).float()
        with unet_attention(gated_attention_reference):
            ref = f32(x, t, ehs, arch=arch).float()
        del f32
        torch.cuda.empty_cache()
        for name, model in (("unfused", unet), ("fused_norm_conv", twin)):
            reset_launch_counts()
            out = model(x, t, ehs, arch=arch).float()
            counts = {k: v for k, v in wrapper_counts(launch_counts()).items() if v}
            row[name] = {"rel_l2_vs_f32": ((out - ref).norm() / ref.norm()).item(),
                         "finite": bool(torch.isfinite(out).all()), "launches": counts}
    emit(row)
    want = {"unfused": {"gated_flash_fwd": 32},
            "fused_norm_conv": {"gated_flash_fwd": 32, "norm_conv3x3": 45}}
    for name in want:
        r = row[name]
        if not (r["finite"] and r["rel_l2_vs_f32"] <= UNET_REL_L2 and r["launches"] == want[name]):
            fail(f"the conv-projection U-Net ({name}): {r}; expected launches {want[name]}")
    del unet, twin
    torch.cuda.empty_cache()
    return row


def stage1_program(pipe, mpnet, device):
    """Phase 13: stage 1 as a user runs it, and the rest of the pipeline."""
    import shutil
    import torch
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig

    parts = {}
    shutil.rmtree(STAGE1_DIR, ignore_errors=True)
    weights = os.path.join(STAGE1_DIR, "weights")
    t0 = time.perf_counter()
    nbytes = write_sd_weights(weights, device)
    parts["write_weights"] = time.perf_counter() - t0
    try:
        cli, cli_counts = check_cli_runs(weights, device)
        parts.update(cli["seconds_by_part"])
        torch.backends.cudnn.allow_tf32 = True  # serving as phase 5 serves
        t0 = time.perf_counter()
        images, ids, neg, kw = check_progressive(pipe, mpnet, device)
        parts["progressive"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        check_safety(pipe, images, ids, neg, kw, device)
        parts["safety"] = time.perf_counter() - t0
        torch.backends.cudnn.allow_tf32 = False  # the f32 reference in full f32
        t0 = time.perf_counter()
        conv = check_conv_projection(UNetConfig.sd21(256, use_linear_projection=False), device,
                                     torch.Generator(device=device).manual_seed(SEED + 16))
        parts["conv_projection"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(STAGE1_DIR, ignore_errors=True)
    summary = {"phase": "stage1_program_summary", "weights_written_gib": nbytes / 2 ** 30,
               "seconds_by_part": parts, "cli_steps_per_sec": cli["cli_steps_per_sec"],
               "cli_run2_peak_memory_gib": cli["run2_peak_memory_gib"],
               "conv_projection_rel_l2": {k: conv[k]["rel_l2_vs_f32"]
                                          for k in ("unfused", "fused_norm_conv")}}
    emit(summary)
    return summary, cli_counts


# ---------------------------------------------------------------- main

def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from diffusion_pruning_tpu_torch.ops import build
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
    nvcc_s = build.build_kernels()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "nvcc_seconds": nvcc_s})
    for source in build.SOURCES:
        report = build.BUILD_DIR / f"{source.stem}.ptxas.txt"
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log(f"ptxas {source.name}: {line.strip()}")
    sass = sass_counts(build)
    emit({"phase": "sass", "instructions_by_kernel": sass})
    check_forward_build(build, sass)
    check_backward_build(build, sass)
    check_fused_build(build, sass)

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
    calls, serve_counts = serve(pipe, mpnet, device)
    launches = serve_counts["gated_flash_fwd"]
    log(f"phase 5 took {time.perf_counter() - t0:.1f}s")
    s256 = sorted(c["seconds"] for c in calls[1:4])
    emit({"phase": "serving_summary", "img_per_sec_256px_median": 8 / s256[1],
          "seconds_256px_min_median_max": s256, "seconds_512px": calls[5]["seconds"]})

    # 6. one more call under the profiler
    profile_call(pipe, mpnet, device)

    # 7. training kernels vs their plain versions (TF32 off for the references)
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    train_rows, train_check = check_training_kernels(device)
    emit({"phase": "training_kernel_check_summary", **train_check})
    emit(backward_summary(train_rows))
    emit(small_forward_summary(train_rows))
    log(f"phase 7 took {time.perf_counter() - t0:.1f}s")

    # 8. the stage-1 train step at full width
    t0 = time.perf_counter()
    mods, cfg, opt = build_trainer(pipe, device, gen)
    batch, train_summary = train(mods, cfg, opt, device)
    check_train_grads(mods, cfg, batch, device)
    profile_train_step(mods, cfg, opt, batch, device)
    log(f"phase 8 took {time.perf_counter() - t0:.1f}s")

    # 9. fused-norm kernels vs their plain versions (TF32 stays off for matmuls
    # and cuDNN: the f32 references of phases 9-10 run in full f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    fused_checks = check_fused_kernels(unet, device)
    check_expert_channels(device)
    check_poisoned_workspaces(device)
    log(f"phase 9 took {time.perf_counter() - t0:.1f}s")

    # 10. the U-Net under each fused flag
    t0 = time.perf_counter()
    twins, _ = check_fused_unet(unet, device)
    log(f"phase 10 took {time.perf_counter() - t0:.1f}s")

    # 11. serving and two train steps under the fused flags; the VAE and CLIP,
    # which phase 8 turned to bf16, serve in f32 again as in phase 5
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    pipe.vae.float()
    pipe.text_encoder.float()
    fused_serving, counts_gn, counts_nc = serve_fused(pipe, mpnet, twins, device)
    torch.backends.cudnn.allow_tf32 = False
    fused_train = train_fused(pipe, twins, device, gen)
    log(f"phase 11 took {time.perf_counter() - t0:.1f}s")

    # 12. expert serving: the VAE and CLIP, which phase 11's train steps turned
    # to bf16, serve in f32 again
    t0 = time.perf_counter()
    pipe.vae.float()
    pipe.text_encoder.float()
    expert_serving, expert_counts, expert_check = serve_experts(pipe, mpnet, unet, device)
    log(f"phase 12 took {time.perf_counter() - t0:.1f}s")

    # 13. stage 1 as a program (the prune entry point twice, from checkpoint
    # folders at full width) and the rest of the pipeline
    t0 = time.perf_counter()
    stage1, cli_counts = stage1_program(pipe, mpnet, device)
    log(f"phase 13 took {time.perf_counter() - t0:.1f}s")

    # kernels line: inference times summed over the sites of one 256px
    # forward (B_eff 16) that each forward kernel serves (`forward_plan`),
    # training times over the sites of one student pass of the train step
    # (B = 64)
    train_launches = train_summary["launches"]
    forward_entries = [
        forward_entry(name, rows, train_rows, worst, train_check, serve_counts, train_launches,
                      expert_counts, expert_check, cli_counts)
        for name in ("gated_flash_fwd_wgmma", "gated_flash_fwd_small")]
    kernels = [*forward_entries,
               *backward_entries(train_rows, train_check, train_launches, cli_counts),
               fused_kernel_entry(
        fused_checks["group_norm_silu"], "group_norm_silu",
        "diffusion_pruning_tpu_torch/csrc/group_norm.cu",
        "diffusion_pruning_tpu/ops/group_norm.py:26", [], "F.group_norm, then F.silu",
        {"serving_fused_norms": counts_gn["group_norm_silu"]},
        expert_check["fused_kernel_device_ms_mean"]["fused_norms"]),
        fused_kernel_entry(
        fused_checks["norm_conv3x3"], "norm_conv3x3",
        "diffusion_pruning_tpu_torch/csrc/norm_conv.cu",
        "diffusion_pruning_tpu/ops/norm_conv.py:98",
        ["diffusion_pruning_tpu/ops/norm_conv.py:140"],
        "gate multiply, F.group_norm, F.silu, F.conv2d (channels_last, bf16)",
        {"serving_fused_norm_conv": counts_nc["norm_conv3x3"],
         "train_fused_norm_conv": fused_train["launches"]["norm_conv3x3"]},
        expert_check["fused_kernel_device_ms_mean"]["fused_norm_conv"]),
        fused_kernel_entry(
        fused_checks["norm_linear"], "norm_linear",
        "diffusion_pruning_tpu_torch/csrc/norm_conv.cu",
        "diffusion_pruning_tpu/ops/norm_conv.py:279", [], "F.group_norm, then F.linear",
        {"serving_fused_norm_conv": counts_nc["norm_linear"],
         "train_fused_norm_conv": fused_train["launches"]["norm_linear"]},
        expert_check["fused_kernel_device_ms_mean"]["fused_norm_conv"]),
        {"name": "conv_split_reduce", "route": "cuda",
         "source": "diffusion_pruning_tpu_torch/csrc/norm_conv.cu",
         "replaces": "diffusion_pruning_tpu/ops/norm_conv.py:98",
         "role": "the fixed-order sum of the K slices of norm_conv3x3 and norm_linear where "
                 "their plans split K (a split linear site's ms includes it)",
         "launches": counts_nc["conv_split_reduce"]
                     + fused_train["launches"]["conv_split_reduce"],
         "launches_by_path": {"serving_fused_norm_conv": counts_nc["conv_split_reduce"],
                              "train_fused_norm_conv":
                                  fused_train["launches"]["conv_split_reduce"]},
         **split_reduce_entry(fused_checks["norm_conv3x3"]),
         "expert_path": expert_path_entry(
             expert_check["fused_kernel_device_ms_mean"]["fused_norm_conv"], "conv_split_reduce"),
         "shapes": "the split conv sites of one SD-2.1 U-Net forward at 256px, B_eff 16"},
    ]
    idle = [k["name"] for k in kernels if not k["launches"] > 0]
    if idle:
        fail(f"kernels of the path launched no time in its run: {idle}")
    emit({"kernels": kernels})
    log(f"total {time.perf_counter() - t_start:.1f}s; 256px img/s (median of 3) "
        f"{8 / s256[1]:.4f}; 512px seconds {calls[5]['seconds']:.4f}; train step "
        f"{train_summary['seconds_per_step_median_warm']:.4f} s "
        f"({train_summary['samples_per_sec']:.2f} samples/s); under fused_norm_conv "
        f"{fused_serving['img_per_sec']['fused_norm_conv']:.4f} img/s against "
        f"{fused_serving['img_per_sec']['unfused']:.4f} in turns; 16 prompts by experts "
        f"{expert_serving['img_per_sec']['experts']:.4f} img/s, hybrid "
        f"{expert_serving['img_per_sec']['hybrid']:.4f}, gated "
        f"{expert_serving['img_per_sec']['gated']:.4f} in turns; prune CLI steps/s "
        f"{stage1['cli_steps_per_sec']}")
    # last line
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
