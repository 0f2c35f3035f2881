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
                  relative to the head's RMS dgate over the batch, against
                  the plain backward with P and dS rounded to bf16 as the
                  kernels round them (the f32 reading beside it); a second
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
                  (<= FUSED_UNET_REL_L2), with its launches per forward (2
                  attention a kept transformer; served NHWC, 2 group_norm_silu
                  a kept resnet, 1 a kept transformer and 1 the output head)
                  and its kernels' device time over the
                  forward's sites; then 16 prompts at 256px, DDIM-25, CFG
                  7.5, in two submits of 8 through a `ServingQueue`: `flush`
                  (experts) and `flush_async` (hybrid) and the gated
                  pipeline, in turns for one round, phase 19 has the turns (request ids, slot
                  accounting, finite images in [0, 1]; img/s of each); one
                  request of 2 prompts under PNDM and under DPM++ (all eager,
                  every denoise cache emptied, `eager_programs`; its warm-up
                  captures the server's CUDA graphs, which phase 19 replays);
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
                  and peak memory on a summary line (its stage-1 run starts
                  from a codebook biased toward pruning, quantizer_base 0,
                  so that its rows prune as a trained router's would);
 14. stage 2 as a program — the finetune entry point on a YAML derived from
                  configs/finetuning/sd-2-1_coco2014.yaml (synthetic data,
                  B = 128 at 256px, v-prediction, min-SNR γ 5, AdamW at
                  1e-5 × √128) on phase 13's weights, fine-tuning the row of
                  phase 13's codebook with the least MACs ratio (below
                  FT_MACS_MAX): run 1 in a subprocess for 3 steps
                  (validation at step 3, checkpoint-3 with arch_vector.pt,
                  the model card), run 2 in this process resumes `latest`
                  to step 7 with --use_ema and 2 micro-batches of 64 a step
                  (validation at step 6):
                  its resumed state equal bit for bit to run 1's saved one,
                  arch_vector.pt equal to the codebook row, the teacher's
                  weights unchanged bit for bit, the student a bf16 copy of
                  f32 masters, each step's launches those of `forward_plan`
                  and `backward_plan` at the expert's kept heads; a B = 8
                  step's student gradients through the kernels against
                  plain attention (cosine per leaf > GRAD_COS, and a planted
                  fault, dk dropped, below it); the training forward and the
                  backward kernels at each of the expert's shapes at B = 64
                  (run 2's micro-batch) and B = 128 (run 1's batch) against
                  their plain versions and timed beside their bound;
                  the magnitude baseline in a subprocess for 2 steps of 32;
                  seconds by part, step times, samples/s, the loop's steps/s
                  and peak memory on a summary line;
 15. the pipeline on a dataset folder — a COCO-2014 layout written under
                  build/ (512 train and 32 validation JPEGs at 640×480 and
                  480×640, quality 90, captions from a seeded word list; two
                  unreadable train files in the loader's first batch), SD-2.1's
                  tokenizer/ (byte-level BPE, pad "!") and MPNet's vocab.txt
                  beside phase 13's weights, dpt_native built from
                  native/decoder.cpp into build/native/ (the compiler's error
                  printed if it fails; Pillow decodes then); the prune entry
                  point on the folder (B = 64 at 256px, 3 steps, one
                  pretraining; validation and the image logger at step 3,
                  DDIM-4 of 4 prompts): every batch at its static shape, the
                  unreadable files resampled, each step's launches those of
                  `backward_plan` at B = 64, finite losses, both PNG grids;
                  `cli.filter_dataset` on its checkpoint: int64 indices, one a
                  caption, equal to the same router called in this process;
                  `cli.cache_latents` (B = 32, center crop, bf16 VAE), then
                  stage-1 steps from its `LatentPipeline` batches and from
                  pixel batches in turns (no VAE encode in the first);
                  the loader's own pace at B = 64 by each decoder there is;
                  `cli.finetune` for the expert with most train captions, 2
                  steps at the largest B of 64, 32, 16 its captions fill
                  twice, its batches holding only its captions; which decoder
                  served each batch, seconds by part, the loop's steps/s
                                    against the step's and peak memory on a summary line;
 16. data parallel — (a) a one-rank NCCL group in this process
                  (`utils/launch.init_distributed` from torchrun's variables):
                  the stage-1 mesh step at B = 64 with phase 8's models and one
                  set of explicit draws equal, bit for bit, to the mesh=None
                  step, and the stage-2 ZeRO-1 step on phase 14's expert (B =
                  32) equal to the replicated one, each with a repeat of the
                  one-process step as the control that the step repeats its
                  bits (deterministic algorithms on); (b) two ranks spawned
                  with torchrun's variables (`chip_smoke.py --dp-rank`),
                  sharing the card under gloo, each building phase 8's models
                  from the seed and taking rows [32r, 32r + 32) of two global
                  batches and draw sets: a pretrain and a codebook step,
                  against the one-process B = 64 steps on the same rows and
                  draws (hypernet and codebook grads by cosine per leaf >
                  GRAD_COS with the relative L2 beside it; the expert indices
                  equal, a differing one listed with its Sinkhorn margin and
                  allowed only under DP_TIE_MARGIN; the replicas equal bit for
                  bit), and a planted fault (the contrastive gather without
                  the splice) below the limit; (c) on the same two ranks,
                  `cli.prune` on phase 13's config and weights (3 steps at 32
                  a rank, a checkpoint, a resume to step 4 bit for bit) and
                  `cli.finetune` with ZeRO-1 on phase 14's expert (2 steps at
                  32 a rank), each step's launches those of `backward_plan` at
                  B = 32, rank 1 writing nothing under the runs' folder, the
                  replicas equal, each rank's moments half of world 1's; each
                  rank's peak memory, moment bytes, step seconds (two
                  processes on one card under gloo: not a scaling number) and
                  the phase's seconds on a summary line;
 17. evaluation and serving through the entry points — on phase 13's weights
                  and stage-1 run, phase 14's expert and phase 15's COCO
                  folder: `cli.filter_dataset` (phase 13's router on the
                  folder's captions); `cli.serve` in experts and routed modes,
                  once each, phase 19 has the turns (16 of the folder's
                  validation captions a call in
                  two waves of 8, tiers up to 4, DDIM-10, phase 14's stage-2
                  masters in its expert's slot): 16 uint8 256×256 images, each
                  prompt's expert, both attention kernels launched; then
                  `cli.generate_fid_images` (phase 14's expert with its
                  masters where the router gives it at least 4 validation
                  captions, else the busiest expert's slices) and
                  `cli.generate_images --pruning_type magnitude`, 8 images
                  each at most, PNDM-25; `cli.resize_and_save_images` on the
                  validation JPEGs, `cli.save_captions`; `cli.clip_score` on a
                  seeded random ViT-B/32 CLIP folder (HF names, phase 15's
                  tokenizer files), `cli.cmmd` on a seeded random
                  ViT-L/14-336 vision folder, `cli.fid` with a seeded
                  TorchScript stand-in of the InceptionV3 contract (N×3×H×W in
                  0-255 → N×2048) against the resized JPEGs; each tower's
                  card embeddings against the same entry point's `--device
                  cpu` ones, cosine per row >= TOWER_COS (the metric values of
                  random weights are printed, not judged); img/s by mode,
                  generated images/s, each tower's embeddings/s, seconds by
                  part and peak memory on a summary line;
 18. tensor parallel — ranks spawned with torchrun's variables
                  (`chip_smoke.py --tp-rank`), sharing the card under gloo:
                  (1) two ranks on a 1 × 2 mesh, each building phase 4's
                  U-Net and phase 5's pipeline from the seed: the U-Net
                  sharded (`parallel.tp.shard_unet`: heads 3/2, 5/5, 10/10)
                  on phase 4's inputs (256px, bf16, B_eff 16, the random
                  arch) against the one-process forward on the same weights
                  in f32 with plain attention (<= UNET_REL_L2; the
                  one-process bf16 forward's own reading and the two bf16
                  forwards' difference beside it), plain and under
                  `fused_norm_conv`, with
                  32 attention launches and 70 reductions a forward (45
                  norm_conv3x3 and 16 norm_linear under the flag), and two
                  planted faults, emulated in the sharded forward (each
                  row-parallel bias, drawn from the seed, added on both
                  ranks; rank 1's partial dropped), above the limit; the sharded and one-process
                  forwards timed in turns, the host seconds inside the
                  reductions; (2) on the same ranks `shard_pipeline` and
                  `ExpertServer.from_codebook` on it (phase 12's codebook,
                  bf16), 8 prompts steered to 4 experts, DDIM-4, against
                  the one-process pipeline and server rank 0 runs first:
                  the same expert indices, each image <= SERVED_REL_L2;
                  (3) four ranks on a 2 × 2 mesh: `cli.finetune` with
                  `optim.tensor_parallel: 2` on phase 14's expert, a
                  global B = 16, 2 steps, each step's launches those of
                  `backward_plan` at the rank's local heads and rows, the
                  checkpoint gathered whole; against the one-process run of
                  the same config and draws in this process: each step's
                  loss within TP_LOSS_REL, each leaf's update at cosine >=
                  TP_UPDATE_COS, and the planted fault (the one-process run
                  with model rank 1's partials dropped) beyond one of them;
                  times, peak memory and reduction seconds per rank on
                  summary lines;
                  phase 13's to 18's written files are removed;
 19. the last modules — (sd21-256-graphs, run right after phase 12 on its
                  server and the graphs its warm-up captured) the
                  routed pipeline (8 prompts, DDIM-25, CFG 7.5) with its
                  trajectory captured as a CUDA graph
                  (`PruningPipeline.prepare_denoise`, `pipelines/aot.py`)
                  and eager, GRAPH_TURNS times each in turns; then phase
                  12's 16 steered prompts in experts and hybrid modes, eager
                  (every denoise cache emptied) and through the graphs
                  phase 12's `ExpertServer.warmup` captured (one per
                  (expert, tier) and per gated tier), GRAPH_TURNS times each
                  in turns, each program replayed as often as its tier plan
                  runs it; one
                  captured request under `fused_norm_conv`, `fused_norms`,
                  PNDM and DPM++ each beside the eager one: captured images equal
                  to eager ones bit for bit (or within GRAPH_FALLBACK_ATOL,
                  reported), the same expert indices and routes, the same
                  launch counts (each replay adds the launches its capture
                  recorded), two back-to-back captured calls on different
                  latents that do not alias; img/s, capture and warm-up
                  seconds, the graphs, the pool's bytes and peak memory by
                  mode, one captured request's busy share under
                  `utils.profiling.trace` beside phase 6's eager one;
                  (sd21-256-convergence, after phase 18) `cli.convergence_run`
                  at SD-2.1 width on the JAX script's smoke schedule (60
                  steps at B = 8, 20 pretraining, 10 stage-2 steps, one
                  expert, planted redundancy) in this process: its summary
                  and metrics written, every logged loss finite, the
                  training kernels launched; C1-C5 are readings;
                  (sd21-256-replay) `cli.replay_chain --experts 1` on phase
                  13's weights and phase 15's tokenizer files, every link a
                  subprocess on the card: each exits 0, finite FID, CLIP-score
                  and CMMD, the seconds of each link;
then a `kernels` JSON line (every kernel of the paths, each with its
launches in the runs of phases 5, 8, 11, 12, 13, 14, 15, 16, 17, 18 and 19;
phase 19's under `graphs`, the captured calls' replays alone, and
`convergence`)
and, last, the device JSON line.

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
# |dgate - reference| / RMS over the batch of the head's dgate, the reference
# the plain backward with P and dS rounded to bf16 as the kernels round them:
# a sound kernel reads at most 4.6e-3 there over 300 gradients at 15 shapes
# (scripts/torch_port/dgate_spread_probe.py), the planted fault far above
# (PERF.md); against the f32 plain backward it spread to 0.168, and the limit
# was 5e-2
DGATE_REL = 1e-2
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


def took(name: str, t0: float) -> None:
    log(f"{name} took {time.perf_counter() - t0:.1f}s")


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
    worst.update(dq_max_abs=0.0, dkv_max_abs=0.0, dgate_vs_f32=0.0)
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
            # dgate against the plain backward that rounds P and dS to bf16,
            # as the kernels do (their products take bf16 operands)
            dg_r16 = None if gate is None else fa.gated_flash_backward_reference(
                qf, kf, vf, gate, o.float(), lse, dof, bf16_products=True)[3]
            reading = {"lse_max_abs": (lse - lse_r).abs().max().item(),
                       "o": per_head_rel_l2(o, o_r).max().item(),
                       "dq": per_head_rel_l2(dq, dq_r).max().item(),
                       "dk": per_head_rel_l2(dk, dk_r).max().item(),
                       "dv": per_head_rel_l2(dv, dv_r).max().item()}
            if gate is not None:
                reading["dgate"] = dgate_rel(dgate, dg_r16).max().item()
            faults = training_faults(qf, kf, vf, dof, gate, gate_name, lse_r, dq_r, dk_r, dv_r,
                                     dg_r16)
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
                row["dgate_vs_f32"] = dgate_rel(dgate, dg_r).max().item()
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
            del qf, kf, vf, dof, o_r, lse_r, dq_r, dk_r, dv_r, dg_r, dg_r16
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
    part = None if gate is None else torch.empty(plan.dgate_parts[0], device=q.device)
    ws = (None if plan.workspace_shape is None
          else torch.empty(plan.workspace_shape, device=q.device))
    build.launch("gated_flash_bwd_fused", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), do.data_ptr(), lse.data_ptr(), build.ptr(gate), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), build.ptr(ws), build.ptr(part), b, h, s_q,
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
EXPERT_ROUNDS = 1          # timed rounds of expert, hybrid and gated serving, in turns
                           # (phase 19 serves the same prompts eager GRAPH_TURNS times)
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
            attn = {"gated_flash_fwd": 2 * kept_tf}
            # a bf16 expert on the card is served NHWC (`build_expert`): every
            # norm, the output head's too, runs group_norm_silu
            nhwc = {"group_norm_silu": 2 * kept_res + kept_tf + 1}
            want = {**attn, **nhwc}
            fused = {}
            timed = e < FUSED_TIMED_EXPERTS
            for flag, want_flag in (("fused_norms", nhwc),
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
                want_all = {**want_flag, **attn}
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


def serve_queue(server, requests, hybrid, phase="serving_experts"):
    """The prompts through a ServingQueue in two submits of 8, with their
    routing noise and initial latents, then `flush` (expert mode) or
    `flush_async` (hybrid); checks the routing, the request ids, the slot
    accounting and the images. Returns the row (with each request's expert)
    and the images (N, H, W, 3) on the host."""
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
    row = {"phase": phase, "mode": "hybrid" if hybrid else "experts",
           "prompts": EXPERT_PROMPTS, "resolution": 256, "steps": STEPS, "guidance": GUIDANCE,
           "seconds": seconds, "images_per_sec": EXPERT_PROMPTS / seconds,
           "routes": [queue.routes[r] for r in rids],
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


@contextlib.contextmanager
def eager_programs(server):
    """Serve through the eager loop: every denoise cache of `server` (its
    experts' and the gated pipeline's) emptied for the block and restored
    after."""
    caches = [*server._expert_caches.values(), server.base_pipeline._denoise_cache]
    saved = [dict(c) for c in caches]
    for c in caches:
        c.clear()
    try:
        yield
    finally:
        for c, kept in zip(caches, saved):
            c.clear()
            c.update(kept)


def serve_experts(pipe, mpnet, unet, device):
    """Phase 12: K = 8 experts cut from a seeded codebook, checked against the
    f32 dense U-Net, then served: EXPERT_ROUNDS rounds of expert, hybrid and gated
    serving of the same 16 prompts (routed to every expert), in turns (every
    launch count set to 0 before the first and read after the last), the
    first round's served images held against each prompt run alone, the
    PNDM and DPM++ requests."""
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
    # the server's CUDA graphs, one per (expert, tier) and gated tier: phase 19
    # replays them; this phase serves through the eager loop (`eager_programs`)
    held = torch.cuda.memory_allocated()
    warm = server.warmup(STEPS, GUIDANCE, hybrid=True)
    warm["graph_pool_bytes"] = torch.cuda.memory_allocated() - held
    lap("warmup")
    warm["seconds"] = parts["warmup"]
    requests = expert_requests(device, mpnet, pipe, codes)
    seconds = {"experts": [], "hybrid": [], "gated": []}
    served, tiers = {}, {}
    with eager_programs(server):
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
        served_checks = {mode: check_served_images(server, requests, served[mode],
                                                   mode == "hybrid")
                         for mode in ("experts", "hybrid")}
        lap("served_image_check")
        samplers = serve_samplers(pipe, requests, device)
        lap("samplers")
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
               "sampler_seconds": {r["sampler"]: r["seconds"] for r in samplers},
               "expert_forward_ms_b8": check["forward_ms"],
               "gated_forward_ms_b8": check["gated_forward_ms"],
               "expert_forward_device_ms_b8": check["device_ms"],
               "gated_forward_device_ms_b8": check["gated_device_ms"]}
    emit(summary)
    return summary, counts, check, server, requests


def forward_entry(name, rows, train_rows, worst, train_check, serve_counts, train_launches,
                  expert_counts, expert_check, cli_counts, ft_counts, ft_totals, data_counts,
                  dp_counts, eval_counts, tp_counts):
    """One forward kernel's line: its share of the phase-3 sites (by
    `forward_kernel`) and of the phase-7 training sites, its launches in the
    serving, train-step, expert-serving, prune-CLI (run 2), finetune-CLI
    (run 2), dataset-folder (phase 15), data-parallel (phase 16), serve-CLI and
    evaluation (phase 17) and tensor-parallel (phase 18, every rank) runs, its device time over one expert forward's sites (phase 12)
    and, with lse, over the fine-tuned expert's sites at each batch phase 14
    times (null where the expert has no site of this kernel)."""
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
               "serving_experts": expert_counts[key], "stage1_cli": cli_counts[key],
               "finetune": ft_counts[key], "data_path": data_counts[key],
               "dp": dp_counts[key], "serve_cli": eval_counts["serve_cli"][key],
               "eval": eval_counts["eval"][key], "tp": tp_counts[key]}
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
        "finetune_path": {**{f"b{b}": finetune_reading(t, f"{name}_lse")
                             for b, t in sorted(ft_totals.items())},
                          "shapes": "with lse, no gate, at the kept heads of the fine-tuned "
                                    "expert's attention sites, at run 2's micro-batch (B = "
                                    f"{FT_B // FT_ACCUM}) and run 1's batch (B = {FT_B}), "
                                    "phase 14"},
    }


def finetune_reading(totals, kind):
    """A kernel's device ms and bound summed over the fine-tuned expert's
    sites where it runs at one batch (phase 14); null where it runs at none,
    since nothing was timed."""
    sites = int(totals.get(f"{kind}_sites", 0))
    return {"ms": totals[f"{kind}_ms"] if sites else None,
            "bound_ms": totals[f"{kind}_bound_ms"] if sites else None, "sites": sites}


def expert_path_entry(expert_ms, name, gated_ms=None):
    """A kernel's device ms over the sites of one expert forward (256px,
    B_eff 8, kept widths; the mean over the experts), beside the gated
    U-Net's where measured; null where the profile shows no launch of it."""
    return {"ms_per_forward_mean_over_experts": expert_ms.get(name),
            **({"gated_ms_per_forward": gated_ms.get(name)} if gated_ms else {}),
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


def backward_entries(train_rows, train_check, train_launches, cli_counts, ft_counts, ft_totals,
                     data_counts, dp_counts, tp_counts):
    """The backward kernels' lines: each kernel's times summed over the
    sites of one student pass where `backward_plan` runs it, its launches in
    the train-step run, the prune CLI's run 2, the finetune CLI's run 2, the
    dataset-folder, data-parallel and tensor-parallel phases,
    its worst readings on its route's phase-7 cases, and its times over the
    fine-tuned expert's sites at each batch phase 14 times (no gate; null
    where `backward_plan` runs it at none of them)."""
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
                 "launches": (train_launches[name] + cli_counts[name] + ft_counts[name]
                              + data_counts[name] + dp_counts[name] + tp_counts[name]),
                 "launches_by_path": {"train_step": train_launches[name],
                                      "stage1_cli": cli_counts[name],
                                      "finetune": ft_counts[name],
                                      "data_path": data_counts[name],
                                      "dp": dp_counts[name], "tp": tp_counts[name]},
                 "finetune_path": {**{f"b{b}": finetune_reading(t, kind)
                                      for b, t in sorted(ft_totals.items())},
                                   "shapes": "no gate, at the kept heads of the fine-tuned "
                                             "expert's attention sites, at run 2's micro-batch "
                                             f"(B = {FT_B // FT_ACCUM}) and run 1's batch "
                                             f"(B = {FT_B}), phase 14"},
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
    from concurrent.futures import ThreadPoolExecutor

    def dump(source):
        return subprocess.run([tool, "--dump-sass", str(build._library_path(source))],
                              capture_output=True, text=True).stdout

    with ThreadPoolExecutor(len(build.SOURCES)) as pool:  # one cuobjdump a library, together
        dumps = dict(zip(build.SOURCES, pool.map(dump, build.SOURCES)))
    for source, sass in dumps.items():
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
# the stage-1 run starts from a codebook whose gates open half the time
# (quantizer_base 0 in place of 3): 6 steps cannot train a router to its 0.6
# target, and a codebook biased open keeps every unit (MACs ratio 0.99-1.0),
# which leaves phase 14 no pruned expert to fine-tune
STAGE1_QUANTIZER_BASE = 0.0
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


def run_cli_in_process(argv, device, per_step=None, check_batch=None):
    """The prune entry point's `main(argv)` in this process, timed by part:
    the factory (from the call to the loop's start), the steps (each checked
    for its attention launches, `per_step`: by default `CLI_ACCUM`
    micro-batches of `cli_step_launches`, and each batch by `check_batch`
    when given), validation, the checkpoint saves with their export, the
    resume (whose state is kept for the caller). The loop is asked to log
    every step (its `LoopConfig.log_every`, 10 from the entry point), so that
    each step's losses, expert usage and the loop's own steps/s reach
    metrics.jsonl."""
    import torch
    import diffusion_pruning_tpu_torch.training as training
    from diffusion_pruning_tpu_torch.cli import prune
    from diffusion_pruning_tpu_torch.training import loop as loop_module

    parts = collections.defaultdict(float)
    steps, resumed = [], {}
    if per_step is None:
        per_step = collections.Counter()
        for name, n in cli_step_launches(TRAIN_B // CLI_ACCUM).items():
            per_step[name] = n * CLI_ACCUM
    real_make_step = training.make_pruner_step

    def make_step(*args, **kwargs):
        step = real_make_step(*args, **kwargs)

        def timed(batch, **kw):
            if check_batch is not None:
                check_batch(batch)
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
        "model.quantizer.quantizer_base": STAGE1_QUANTIZER_BASE,
        "training.max_train_steps": CLI_STEPS[0], "training.hypernet_pretraining_steps": 1,
        "training.validation_steps": CLI_STEPS[0], "training.image_logging_steps": CLI_STEPS[0],
        "training.logging.export_unet": False})
    yaml2 = stage1_yaml(os.path.join(STAGE1_DIR, "run2", "sd21_prune.yaml"), **{
        "model.quantizer.quantizer_base": STAGE1_QUANTIZER_BASE,
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
    row = {"phase": "stage1_cli", "batch": TRAIN_B, "resolution": 256, "run_dir": run_dir,
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
    """Phase 13: stage 1 as a user runs it, and the rest of the pipeline. The
    written folder (weights and the stage-1 run) stays for phase 14; the
    caller removes it."""
    import shutil
    import torch
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig

    parts = {}
    shutil.rmtree(STAGE1_DIR, ignore_errors=True)
    weights = os.path.join(STAGE1_DIR, "weights")
    t0 = time.perf_counter()
    nbytes = write_sd_weights(weights, device)
    parts["write_weights"] = time.perf_counter() - t0
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
    summary = {"phase": "stage1_program_summary", "weights_written_gib": nbytes / 2 ** 30,
               "weights": weights, "run_dir": cli["run_dir"],
               "seconds_by_part": parts, "cli_steps_per_sec": cli["cli_steps_per_sec"],
               "cli_run2_peak_memory_gib": cli["run2_peak_memory_gib"],
               "conv_projection_rel_l2": {k: conv[k]["rel_l2_vs_f32"]
                                          for k in ("unfused", "fused_norm_conv")}}
    emit(summary)
    return summary, cli_counts


# ---------------------------------------------------------------- phase 14

FT_DIR = os.path.join(STAGE1_DIR, "finetune")  # under phase 13's folder; removed with it
FT_STEPS = (3, 7)          # run 1 ends at step 3; run 2 resumes it to step 7 (3 warm steps)
FT_B = 128                 # configs/finetuning/sd-2-1_coco2014.yaml's train_batch_size
FT_ACCUM = 2               # run 2's micro-batches a step (2 × 64)
FT_GRAD_B = 8              # the gradient check's batch
FT_MACS_MAX = 0.75         # the fine-tuned expert's MACs ratio lies below this
FT_BASELINE_STEPS = 2
FT_BASELINE_B = 32         # the baseline's batch: a check of the entry point, not a reading
FT_LOSS_KEYS = ("loss", "diffusion_loss", "distillation_loss", "block_loss", "grad_norm")


RUN1_PEAK = ("import runpy, sys, torch; sys.argv[0] = 'finetune'; "
             "runpy.run_module('diffusion_pruning_tpu_torch.cli.finetune', run_name='__main__', "
             "alter_sys=True); "
             "print('peak_memory_gib', torch.cuda.max_memory_allocated() / 2 ** 30)")


def finetune_yaml(path, **changes):
    """configs/finetuning/sd-2-1_coco2014.yaml with `changes` (dotted paths)
    and no data_dir, read and written by the port's own YAML code."""
    from diffusion_pruning_tpu_torch.utils.config import load_config
    cfg = load_config(os.path.join(HERE, "configs", "finetuning", "sd-2-1_coco2014.yaml"))
    cfg.set_path("data.data_dir", None)
    cfg.set_path("training.logging.logging_dir", os.path.join(FT_DIR, "runs"))
    for key, value in changes.items():
        cfg.set_path(key, value)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cfg.dump(path)
    return path


def pick_expert(pruning_dir):
    """The codebook row of the stage-1 run's latest checkpoint with the least
    MACs ratio: (row index, ratio, row, plan, every row's ratio)."""
    from diffusion_pruning_tpu_torch.core.structure import build_structure
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    from diffusion_pruning_tpu_torch.models.unet.pruned import expert_macs_ratio, make_expert_plan
    from diffusion_pruning_tpu_torch.utils.checkpoint import (latest_checkpoint_dir,
                                                              load_torch_artifact)
    spec = build_structure(UNetConfig.sd21(256))
    rows = load_torch_artifact(os.path.join(latest_checkpoint_dir(pruning_dir),
                                            "quantizer_embeddings.pt"))
    ratios = [expert_macs_ratio(spec, make_expert_plan(spec, r)) for r in rows]
    e = min(range(len(ratios)), key=ratios.__getitem__)
    if not ratios[e] < FT_MACS_MAX:
        fail(f"no codebook row of {pruning_dir} lies below MACs ratio {FT_MACS_MAX}: {ratios}")
    return e, ratios[e], rows[e], make_expert_plan(spec, rows[e]), ratios


def expert_attention_sites(cfg, plan):
    """(S_q, S_kv, kept heads) of each attention site the expert runs."""
    out = []
    for sb in plan.subblocks:
        if sb.kind == "transformer" and not sb.dropped:
            s = site_tokens(cfg, sb.name)
            out += [(s, s, len(sb.site("attn1").kept)), (s, 77, len(sb.site("attn2").kept))]
    return out


def finetune_step_launches(cfg, plan, b, micro):
    """Each attention wrapper's and forward kernel's launches in one step of
    `micro` micro-batches of `b`: the teacher's 32 lse-free forwards at dense
    heads, the student's forward with lse at each kept site, and the backward
    kernels `backward_plan` picks there at the kept head count."""
    from diffusion_pruning_tpu_torch.ops import flash_attention as fa
    out = collections.Counter()
    for s_q, s_kv, _, sites in TRAIN_CASES:
        out["gated_flash_fwd"] += sites * micro
        out[f"kernel:{fa.forward_kernel(s_q, s_kv)}"] += sites * micro
    for s_q, s_kv, h in expert_attention_sites(cfg, plan):
        out["gated_flash_fwd_lse"] += micro
        out[f"kernel:{fa.forward_kernel(s_q, s_kv)}"] += micro
        for name, n in fa.backward_plan(b, h, s_q, s_kv).launches.items():
            out[name] += n * micro
    return dict(out)


def finetune_argv(config_path, weights, pruning_dir, expert, *extra):
    return ["--base_config_path", config_path, "--pretrained_model_name_or_path", weights,
            "--pruning_ckpt_dir", pruning_dir, "--expert_id", str(expert),
            "--wandb_run_name", "cli", "--seed", str(SEED), *extra]


def log_seconds(path):
    """(seconds since the epoch, message) of each line of a run's train.log."""
    import datetime
    out = []
    with open(path) as f:
        for line in f:
            try:
                stamp = datetime.datetime.strptime(line[:23], "%Y-%m-%d %H:%M:%S,%f")
            except ValueError:
                continue
            out.append((stamp.timestamp(), line[24:].strip()))
    return out


def run_finetune_in_process(argv, per_step, gspmd=False, tamper=None, save=True,
                            keep_masters=False):
    """The finetune entry point's `main(argv)` in this process, timed by part
    (the factory from the call to the loop's start, each step, the
    checkpoint saves, the resume), each step's launches checked against
    `per_step`. Returns the loop, the parts, the steps, the state right after
    the resume, the modules, the teacher's state (and, `keep_masters`, the
    masters) before any step (on the host), the counts and the peak memory.
    `gspmd`: the entry point builds the 2-D step (`optim.tensor_parallel`);
    `tamper(mods, optimizer)` runs before the first step; `save=False` writes
    no checkpoint."""
    import torch
    import diffusion_pruning_tpu_torch.training as training
    from diffusion_pruning_tpu_torch.cli import finetune
    from diffusion_pruning_tpu_torch.training import finetuner
    from diffusion_pruning_tpu_torch.training import loop as loop_module

    parts = collections.defaultdict(float)
    steps, resumed, held = [], {}, {}
    owner, attr = (finetuner, "make_finetune_step_gspmd") if gspmd else (training,
                                                                          "make_finetune_step")
    real_make_step = getattr(owner, attr)

    def make_step(mods, cfg, optimizer, *args, **kwargs):
        held["mods"], held["cfg"] = mods, cfg
        held["teacher"] = to_host(mods.teacher.state_dict())
        if tamper is not None:
            tamper(mods, optimizer)
        if keep_masters:
            held["masters"] = to_host(optimizer.masters.state_dict())
        step = real_make_step(mods, cfg, optimizer, *args, **kwargs)

        def timed(batch, **kw):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(batch, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {k: v - before[k] for k, v in launch_counts().items()}
            checked = wrapper_counts(launches)
            checked.update({k: launches[k] for k in launches if k.startswith("kernel:")})
            if checked != {k: per_step.get(k, 0) for k in checked}:
                fail(f"expected {per_step} launches per finetune step, got {launches}")
            steps.append({"seconds": seconds, "launches": launches,
                          **{k: float(out[k]) for k in FT_LOSS_KEYS}, "skipped": out["skipped"]})
            return out
        return timed

    def timed_method(name, part):
        real = getattr(loop_module.FineTuneLoop, name)

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

    real_train = loop_module.FineTuneLoop.train

    def train(self, *a, **k):
        parts["factory_build_and_load"] = time.perf_counter() - t_main
        return real_train(self, *a, **k)

    saved = {name: getattr(loop_module.FineTuneLoop, name)
             for name in ("maybe_resume", "save_checkpoint", "validate")}
    real_loop_config = loop_module.LoopConfig
    try:
        setattr(owner, attr, make_step)
        loop_module.LoopConfig = functools.partial(real_loop_config, log_every=1)
        for name, part in (("maybe_resume", "resume"), ("save_checkpoint", "checkpoint_save"),
                           ("validate", "validation")):
            setattr(loop_module.FineTuneLoop, name, timed_method(name, part))
        if not save:
            loop_module.FineTuneLoop.save_checkpoint = lambda self: None
        loop_module.FineTuneLoop.train = train
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t_main = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            loop = finetune.main(argv)
        counts = launch_counts()
    finally:
        setattr(owner, attr, real_make_step)
        loop_module.LoopConfig = real_loop_config
        for name, fn in saved.items():
            setattr(loop_module.FineTuneLoop, name, fn)
        loop_module.FineTuneLoop.train = real_train
    parts["steps"] = sum(s["seconds"] for s in steps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return loop, dict(parts), steps, resumed, held, counts, peak


def finetune_grads(mods, cfg, batch, draws):
    """The student's gradient of every weight at its current values (no
    update), f32 on the host side of the comparison."""
    from diffusion_pruning_tpu_torch.training.finetuner import compute_losses
    student = mods.student
    for p in student.parameters():
        p.grad = None
    loss, _ = compute_losses(mods, cfg, batch, draws)
    loss.backward()
    grads = {n: p.grad.detach().float().clone() for n, p in student.named_parameters()}
    for p in student.parameters():
        p.grad = None
    return grads


@contextlib.contextmanager
def without_dk():
    """A planted fault: the backward kernels' dk dropped."""
    from diffusion_pruning_tpu_torch.ops import flash_attention as fa
    real = fa.gated_flash_backward

    def faulty(*args):
        dq, dk, dv, dgate = real(*args)
        return dq, dk.zero_(), dv, dgate

    fa.gated_flash_backward = faulty
    try:
        yield
    finally:
        fa.gated_flash_backward = real


def check_finetune_grads(mods, ft_cfg, device):
    """A B = FT_GRAD_B step's student gradients through the kernels against
    the same step with plain attention (bf16 compute copy, under autograd),
    on one batch and one set of draws: cosine per leaf > GRAD_COS; and a
    planted fault (the backward kernels' dk dropped) that the limit must catch."""
    import torch
    from diffusion_pruning_tpu_torch.ops.flash_attention import gated_attention_reference
    from diffusion_pruning_tpu_torch.training.finetuner import complete_draws

    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    res = mods.student.cfg.sample_size * mods.vae.cfg.spatial_scale
    batch = {"pixel_values": torch.rand(FT_GRAD_B, res, res, 3, device=device, generator=gen)
             * 2 - 1,
             "input_ids": torch.randint(0, mods.text_encoder.cfg.vocab_size, (FT_GRAD_B, 77),
                                        device=device, generator=gen)}
    draws = complete_draws(mods, ft_cfg, batch, None, gen)
    kernel = finetune_grads(mods, ft_cfg, batch, draws)
    with unet_attention(gated_attention_reference):
        plain = finetune_grads(mods, ft_cfg, batch, draws)
    cos = leaf_cosines(kernel, plain)
    worst = min(cos, key=cos.get)
    with without_dk():
        cos_fault = leaf_cosines(finetune_grads(mods, ft_cfg, batch, draws), plain)
    worst_fault = min(cos_fault, key=cos_fault.get)
    row = {"phase": "finetune_grad_check", "batch": FT_GRAD_B, "limit": GRAD_COS,
           "leaves": len(cos), "min_cos": cos[worst], "min_cos_leaf": worst,
           "median_cos": statistics.median(cos.values()),
           "planted_fault_no_dk_min_cos": cos_fault[worst_fault],
           "planted_fault_leaf": worst_fault}
    emit(row)
    if not row["min_cos"] > GRAD_COS:
        fail(f"finetune grads through the kernels disagree with plain attention: {row}")
    if not row["planted_fault_no_dk_min_cos"] <= GRAD_COS:
        fail(f"the planted fault reads within the limit {GRAD_COS}: {row}")
    return row


def check_expert_kernels(cfg, plan, device, b):
    """The training forward (no gate) and the backward kernels at each
    distinct (S_q, S_kv, kept heads) shape of the expert at batch `b`: held
    against their plain versions in f32 on the same bf16 inputs (o, dq, dk, dv
    per (batch, head) relative L2, lse max abs) and timed (`device_ms`) beside
    their bound; sums over the expert's sites of one student pass."""
    import torch
    from diffusion_pruning_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    shapes = collections.Counter(expert_attention_sites(cfg, plan))
    rows = []
    totals = collections.defaultdict(float)
    for (s_q, s_kv, h), sites in sorted(shapes.items()):
        q, do = (torch.randn(b, s_q, h, 64, device=device, generator=gen).bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(b, s_kv, h, 64, device=device, generator=gen).bfloat16()
                for _ in range(2))
        o, lse = fa.gated_flash_forward_lse(q, k, v, None)
        dq, dk, dv, _ = fa.gated_flash_backward(q, k, v, None, o, lse, do)
        reading = {}
        for lo in range(0, b, 32):  # the f32 references a quarter of the batch at a time
            sl, rows_sl = slice(lo, lo + 32), slice(lo * h, (lo + 32) * h)  # lse: (B·H, S_q)
            qf, kf, vf, dof = (t[sl].float() for t in (q, k, v, do))
            o_r, lse_r = fa.gated_attention_reference_lse(qf, kf, vf, None)
            dq_r, dk_r, dv_r, _ = fa.gated_flash_backward_reference(
                qf, kf, vf, None, o[sl].float(), lse[rows_sl], dof)
            part = {"lse_max_abs": (lse[rows_sl] - lse_r).abs().max().item(),
                    "o": per_head_rel_l2(o[sl], o_r).max().item(),
                    "dq": per_head_rel_l2(dq[sl], dq_r).max().item(),
                    "dk": per_head_rel_l2(dk[sl], dk_r).max().item(),
                    "dv": per_head_rel_l2(dv[sl], dv_r).max().item()}
            reading = {key: max(reading.get(key, 0.0), value) for key, value in part.items()}
            del qf, kf, vf, dof, o_r, lse_r, dq_r, dk_r, dv_r
        limits = {"lse_max_abs": LSE_ATOL, "o": REL_L2, "dq": GRAD_REL_L2, "dk": GRAD_REL_L2,
                  "dv": GRAD_REL_L2}
        plan_b = fa.backward_plan(b, h, s_q, s_kv)
        row = {"phase": "finetune_kernel_check", "b": b, "s_q": s_q, "s_kv": s_kv, "h": h,
               "sites": sites, "forward_kernel": fa.forward_kernel(s_q, s_kv),
               "backward_route": plan_b.route, "backward_chunks": plan_b.chunks, **reading}
        args = (q, k, v, None, o, lse, do)
        n = 10 if s_q * s_kv >= 2 ** 20 else 20
        timed = {"fwd_lse": lambda: fa.gated_flash_forward_lse(q, k, v, None)}
        if plan_b.route == "two_kernel":
            _, stats, _ = fa.gated_flash_bwd_dq(*args)
            timed["dq"] = lambda: fa.gated_flash_bwd_dq(*args)
            timed["dkv"] = lambda: fa.gated_flash_bwd_dkv(q, k, v, None, stats, do)
        else:
            timed["fused"] = lambda: fused_kernel_alone(*args)
            if plan_b.chunks > 1:
                ws = torch.randn(plan_b.workspace_shape, device=device)
                dk2, dv2 = torch.empty_like(k), torch.empty_like(v)
                timed["reduce"] = lambda: fa.gated_flash_bwd_reduce(ws, dk2, dv2)
        for kind, fn in timed.items():
            row[f"{kind}_ms"] = device_ms(fn, n)
            row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = training_bound(kind, b, h, s_q,
                                                                              s_kv)
            totals[f"{kind}_ms"] += row[f"{kind}_ms"] * sites
            totals[f"{kind}_bound_ms"] += row[f"{kind}_bound_ms"] * sites
            totals[f"{kind}_sites"] += sites
        fwd_name = fa.forward_kernel(s_q, s_kv)
        totals[f"{fwd_name}_lse_ms"] += row["fwd_lse_ms"] * sites
        totals[f"{fwd_name}_lse_bound_ms"] += row["fwd_lse_bound_ms"] * sites
        totals[f"{fwd_name}_lse_sites"] += sites
        emit(row)
        bad = [key for key, value in reading.items()
               if not (math.isfinite(value) and value <= limits[key])]
        if bad:
            fail(f"the training kernels disagree at the expert's shape ({bad}): {row}")
        rows.append(row)
        del q, k, v, do, o, lse, dq, dk, dv
        torch.cuda.empty_cache()
    worst = {key: max(r[key] for r in rows) for key in ("lse_max_abs", "o", "dq", "dk", "dv")}
    return rows, dict(totals), worst


def check_finetune_runs(weights, pruning_dir, device):
    """Phase 14's runs: run 1 as a user runs it (a subprocess: 3 steps at B =
    128, validation at step 3, a checkpoint and the model card), run 2 in this
    process (resume from `latest` to step 7 with --use_ema and 2
    micro-batches a step), the gradient check, the kernels at the expert's
    shapes, and the magnitude baseline (a subprocess, 2 steps)."""
    import torch
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    from diffusion_pruning_tpu_torch.utils.checkpoint import CheckpointManager, load_torch_artifact

    parts = {}
    t0 = time.perf_counter()
    expert, macs, row_e, plan, ratios = pick_expert(pruning_dir)
    cfg256 = UNetConfig.sd21(256)
    sites = expert_attention_sites(cfg256, plan)
    emit({"phase": "finetune_expert", "expert": expert, "macs_ratio": macs,
          "codebook_macs_ratios": ratios, "attention_sites": len(sites),
          "kept_heads": sorted({h for _, _, h in sites}),
          "dropped": [sb.name for sb in plan.subblocks if sb.dropped]})
    yaml1 = finetune_yaml(os.path.join(FT_DIR, "run1", "sd21_finetune.yaml"), **{
        "training.max_train_steps": FT_STEPS[0], "training.validation_steps": FT_STEPS[0]})
    yaml2 = finetune_yaml(os.path.join(FT_DIR, "run2", "sd21_finetune.yaml"), **{
        "training.max_train_steps": FT_STEPS[1], "training.validation_steps": FT_STEPS[0],
        "training.gradient_accumulation_steps": FT_ACCUM,
        "training.logging.resume_from_checkpoint": "latest"})
    run_dir = os.path.join(FT_DIR, "runs", "sd21_finetune", f"cli-expert{expert}")
    parts["pick_expert_and_yaml"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.time()
    # `python -m diffusion_pruning_tpu_torch.cli.finetune ...` through runpy,
    # which then prints the process's peak device memory
    proc = subprocess.run([sys.executable, "-c", RUN1_PEAK,
                           *finetune_argv(yaml1, weights, pruning_dir, expert)],
                          capture_output=True, text=True, timeout=600, cwd=HERE)
    parts["run1_subprocess"] = time.time() - t0
    with open(os.path.join(HERE, "build", "finetune_cli_run1.log"), "w") as f:  # ignored by git
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        fail(f"finetune run 1 exited {proc.returncode}: {proc.stderr[-3000:]}")
    stamps = log_seconds(os.path.join(run_dir, "train.log"))
    parts["run1_start_to_first_log"] = stamps[0][0] - t0  # interpreter, imports, flags
    parts["run1_first_log_to_checkpoint_saved"] = next(
        s for s, msg in stamps if "saved checkpoint" in msg) - stamps[0][0]
    if f"expert {expert}: MACs ratio {macs:.3f} of dense" not in proc.stderr:
        fail(f"run 1 did not print expert {expert}'s MACs ratio {macs:.3f}")
    run1_peak = float(proc.stdout.split("peak_memory_gib")[-1])
    ckpt = CheckpointManager(run_dir)
    d3 = ckpt.dir_for(FT_STEPS[0])
    layout = sorted(os.listdir(d3)) if os.path.isdir(d3) else None
    if ckpt.list_steps() != [FT_STEPS[0]] or layout != ["arch_vector.pt", "state"]:
        fail(f"finetune run 1 left {ckpt.list_steps()} with {layout}")
    with open(os.path.join(run_dir, "README.md")) as f:
        card = f.read()
    if f"# APTP expert {expert}" not in card or f"**{macs:.3f}**" not in card:
        fail(f"the model card does not name expert {expert} and its MACs ratio: {card[:400]}")
    saved = CheckpointManager(run_dir).restore(FT_STEPS[0])
    train1, val1 = metrics_lines(run_dir)
    if train1 or [m["step"] for m in val1] != [FT_STEPS[0]] or not all(
            math.isfinite(v) for k, v in val1[0].items() if k.startswith("val_")):
        fail(f"finetune run 1 logged steps {[m['step'] for m in train1]} and validations {val1}")

    per_step = finetune_step_launches(cfg256, plan, FT_B // FT_ACCUM, FT_ACCUM)
    loop, run2_parts, steps, resumed, held, counts, peak = run_finetune_in_process(
        finetune_argv(yaml2, weights, pruning_dir, expert, "--use_ema"), per_step)
    parts.update({f"run2_{k}": v for k, v in run2_parts.items()})
    mods = held["mods"]
    diff = state_equal({k: v for k, v in resumed.get("state", {}).items() if k != "ema"}, saved)
    ema_diff = state_equal(resumed["state"]["ema"], saved["student"])
    arch_diff = [p for p in (os.path.join(run_dir, "arch_vector.pt"),
                             os.path.join(ckpt.dir_for(FT_STEPS[1]), "arch_vector.pt"))
                 if not torch.equal(load_torch_artifact(p), row_e)]
    teacher_diff = state_equal(to_host(mods.teacher.state_dict()), held["teacher"])
    masters = loop.masters
    precision = {"copy_dtype": str(masters.copies[0].dtype),
                 "master_dtype": str(masters.masters[0].dtype),
                 "copy_is_rounded_masters": all(torch.equal(c.detach(), m.to(c.dtype))
                                                for c, m in zip(masters.copies, masters.masters))}
    if (resumed.get("step") != FT_STEPS[0] or diff or ema_diff or arch_diff or teacher_diff
            or precision != {"copy_dtype": "torch.bfloat16", "master_dtype": "torch.float32",
                             "copy_is_rounded_masters": True}):
        fail(f"finetune run 2 resumed step {resumed.get('step')}; differing from run 1's saved "
             f"state at {diff[:8]}, EMA {ema_diff[:4]}; arch vectors {arch_diff}; teacher "
             f"changed at {teacher_diff[:8]}; precision {precision}")
    if ckpt.list_steps() != [FT_STEPS[1]] or "ema" not in ckpt.restore(FT_STEPS[1]):
        fail(f"finetune rotation left {ckpt.list_steps()}, or checkpoint-{FT_STEPS[1]} has "
             "no EMA")
    lines, _ = metrics_lines(run_dir)
    bad = [m["step"] for m in lines if not all(math.isfinite(m[k]) for k in FT_LOSS_KEYS)
           or m["skipped"]]
    if [m["step"] for m in lines] != list(range(FT_STEPS[0] + 1, FT_STEPS[1] + 1)) or bad:
        fail(f"finetune run 2 logged steps {[m['step'] for m in lines]}; non-finite or skipped "
             f"at {bad}")
    if len(steps) != FT_STEPS[1] - FT_STEPS[0]:
        fail(f"finetune run 2 took {len(steps)} steps")

    t0 = time.perf_counter()
    grad_check = check_finetune_grads(mods, held["cfg"], device)
    parts["grad_check"] = time.perf_counter() - t0
    warm = [s["seconds"] for s in steps[1:]]
    run2 = {"launches_per_step": steps[-1]["launches"], "launches_expected": per_step,
            "step_seconds": [s["seconds"] for s in steps],
            "losses": [{k: m[k] for k in ("step", "loss", "diffusion_loss", "distillation_loss",
                                          "block_loss", "grad_norm")} for m in lines],
            "cli_steps_per_sec": [m["steps_per_sec"] for m in lines],
            "warm_steps": len(warm), "seconds_per_step_median_warm": statistics.median(warm),
            "samples_per_sec": FT_B / statistics.median(warm), "peak_memory_gib": peak,
            "run1_peak_memory_gib": run1_peak}
    del loop, mods, held, masters
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    at_shapes = {}  # run 2's micro-batch, whose launches the kernels line counts, and run 1's
    for b in sorted({FT_B // FT_ACCUM, FT_B}):
        kernel_rows, kernel_totals, kernel_worst = check_expert_kernels(cfg256, plan, device, b)
        at_shapes[b] = {"worst": kernel_worst, "totals_over_sites": kernel_totals,
                        "shapes": len(kernel_rows)}
    parts["kernels_at_expert_shapes"] = time.perf_counter() - t0

    yaml_b = finetune_yaml(os.path.join(FT_DIR, "baseline", "sd21_baseline.yaml"), **{
        "training.max_train_steps": FT_BASELINE_STEPS,
        "data.dataloader.train_batch_size": FT_BASELINE_B})
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "diffusion_pruning_tpu_torch.cli.finetune_baseline",
                           "--base_config_path", yaml_b, "--pretrained_model_name_or_path", weights,
                           "--pruning_type", "magnitude", "--seed", str(SEED)],
                          capture_output=True, text=True, timeout=600, cwd=HERE)
    parts["baseline_subprocess"] = time.perf_counter() - t0
    with open(os.path.join(HERE, "build", "finetune_baseline.log"), "w") as f:  # ignored by git
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        fail(f"the magnitude baseline exited {proc.returncode}: {proc.stderr[-3000:]}")
    found = [line for line in proc.stderr.splitlines() if "magnitude: MACs ratio " in line]
    base_dir = CheckpointManager(os.path.join(FT_DIR, "runs", "sd21_baseline",
                                              "baseline-magnitude"))
    base_layout = sorted(os.listdir(base_dir.dir_for(FT_BASELINE_STEPS))) if os.path.isdir(
        base_dir.dir_for(FT_BASELINE_STEPS)) else None
    base_macs = float(found[0].split("MACs ratio ")[1].split()[0]) if found else None
    if base_macs is None or not base_macs < 1.0 or base_layout != ["arch_vector.pt", "state"]:
        fail(f"the magnitude baseline printed {found} and left {base_layout}")

    row = {"phase": "finetune_cli", "batch": FT_B, "resolution": 256, "expert": expert,
           "macs_ratio": macs, "run2_micro_batches": FT_ACCUM, "run2_use_ema": True,
           "resumed_step": resumed["step"], "resumed_state_equal_to_run1_saved": True,
           "teacher_unchanged": True, "precision": precision, **run2,
           "grad_check_min_cos": grad_check["min_cos"],
           "kernels_at_expert_shapes": at_shapes,
           "magnitude_baseline": {"macs_ratio": base_macs, "steps": FT_BASELINE_STEPS,
                                  "batch": FT_BASELINE_B},
           "seconds_by_part": parts}
    emit(row)
    return row, counts


# ---------------------------------------------------------------- phase 15

DATA_DIR = os.path.join(STAGE1_DIR, "coco")            # under phase 13's folder; removed with it
DATA_RUNS = os.path.join(STAGE1_DIR, "data_runs")
DATA_CACHE = os.path.join(STAGE1_DIR, "latent_cache")
NATIVE_DIR = os.path.join(HERE, "build", "native")     # dpt_native built from native/decoder.cpp
DATA_IMAGES = {"train": 512, "val": 32}
DATA_SIZES = ((640, 480), (480, 640))   # COCO's median image, landscape and portrait
DATA_QUALITY = 90
DATA_UNREADABLE = 2     # train files no decoder reads, placed in the first epoch's first batch
DATA_STEPS = 3          # stage 1 on the folder: one pretraining step, then codebook steps
DATA_DDIM_STEPS = 4     # the image logger's DDIM
DATA_PROMPTS = ("a red bus on a city street", "two dogs playing in the snow",
                "a bowl of fruit on a wooden table", "a man riding a horse on the beach")
DATA_FT_STEPS = 2
DATA_FT_BATCHES = (64, 32, 16)   # stage 2 at the largest the expert's captions fill twice
DATA_LOADER_BATCHES = 4          # batches of B = 64 timed for each decoder
DATA_DECODE_IMAGES = 32          # images decoded one by one for the decode time an image
DATA_STEP_TURNS = 3              # latent-cache and pixel steps, in turns, each
CLIP_VOCAB, MPNET_VOCAB = 49408, 30527
CAPTION_WORDS = (
    "a an the two three man woman child dog cat horse bus train car bicycle plate bowl pizza "
    "table street city beach snow field kitchen room window tree sky red blue green white "
    "black small large old young sitting standing riding playing eating holding on in with "
    "near under next to of at and is are wooden busy empty sunny cloudy").split()


def start_native_build():
    """`python native/setup.py build_ext` into build/native/ (libjpeg's
    headers needed), in the background."""
    os.makedirs(NATIVE_DIR, exist_ok=True)
    return subprocess.Popen(
        [sys.executable, os.path.join("native", "setup.py"), "build_ext", "--build-lib",
         NATIVE_DIR, "--build-temp", os.path.join(NATIVE_DIR, "temp")],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_native_build(proc):
    """Wait for the build; put its library first on the import path when it
    built. Returns what happened, with the compiler's error if it failed,
    and which file `dpt_native` imports from (None: Pillow decodes)."""
    from diffusion_pruning_tpu_torch.data.loader import native_decoder
    try:
        out, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    if proc.returncode == 0:
        sys.path.insert(0, NATIVE_DIR)
    module = native_decoder()
    row = {"phase": "native_decoder_build", "built": proc.returncode == 0,
           "error": None if proc.returncode == 0 else out[-3000:],
           "dpt_native_file": getattr(module, "__file__", None),
           "decoder": "dpt_native" if module is not None else "pillow"}
    emit(row)
    return row


def data_caption(rng):
    return " ".join(rng.choice(CAPTION_WORDS, size=int(rng.integers(5, 12))))


def data_image(seed, w, h):
    """JPEG bytes (quality 90) of a smooth field with noise on it."""
    import io
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = rng.uniform(0.005, 0.03, (3, 2)).astype(np.float32)
    phase = rng.uniform(0, 6.3, 3).astype(np.float32)
    field = np.stack([127 + 90 * np.sin(xx * f[c, 0] + yy * f[c, 1] + phase[c])
                      for c in range(3)], -1)
    field += rng.normal(0, 8, field.shape).astype(np.float32)
    buf = io.BytesIO()
    Image.fromarray(np.clip(field, 0, 255).astype(np.uint8)).save(buf, format="JPEG",
                                                                   quality=DATA_QUALITY)
    return buf.getvalue()


def write_coco_folder(root):
    """COCO-2014's layout: images/{train,val}2014 (JPEGs at 640×480 and
    480×640), annotations/captions_{train,val}2014.json with captions drawn
    from a seeded word list. The first `DATA_UNREADABLE` images of the
    loader's first train epoch (`RandomState(SEED)` order) are unreadable:
    bytes that are no JPEG, and an empty file. Returns their ids."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    order = np.arange(DATA_IMAGES["train"])
    np.random.RandomState(SEED).shuffle(order)
    unreadable = {int(i): data for i, data in zip(order[:DATA_UNREADABLE], (b"not a jpeg", b""))}
    rng = np.random.default_rng(SEED + 15)
    jobs = []
    for split, n in DATA_IMAGES.items():
        img_dir = os.path.join(root, "images", f"{split}2014")
        os.makedirs(img_dir, exist_ok=True)
        ann = {"annotations": [{"image_id": i, "caption": data_caption(rng)} for i in range(n)]}
        os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
        with open(os.path.join(root, "annotations", f"captions_{split}2014.json"), "w") as f:
            json.dump(ann, f)
        jobs += [(os.path.join(img_dir, f"COCO_{split}2014_{i:012d}.jpg"),
                  unreadable.get(i) if split == "train" else None,
                  (SEED + 1000 * (split == "val") + i, *DATA_SIZES[i % 2])) for i in range(n)]

    def write(job):
        path, data, image = job
        with open(path, "wb") as f:
            f.write(data if data is not None else data_image(*image))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))
    return sorted(unreadable)


def write_tokenizer_files(weights):
    """SD-2.1's `tokenizer/` folder (byte-level vocab.json, merges.txt that
    build every caption word, the special tokens at 49406 and 49407, pad
    "!") and all-mpnet-base-v2's vocab.txt (30,527 lines, `<mask>` last) with
    their JSON files, beside phase 13's weights."""
    from diffusion_pruning_tpu_torch.data.tokenizers import bytes_to_unicode
    b2u = bytes_to_unicode()
    chars = list(b2u.values())
    vocab = {t: i for i, t in enumerate(chars + [c + "</w>" for c in chars])}
    merges = []
    for word in dict.fromkeys(CAPTION_WORDS + list(" ".join(DATA_PROMPTS).split())):
        pieces = [b2u[b] for b in word.encode()]
        pieces[-1] += "</w>"
        cur = pieces[0]
        for piece in pieces[1:]:
            merges.append((cur, piece))
            cur += piece
    merges = list(dict.fromkeys(merges))
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab.update({"<|startoftext|>": CLIP_VOCAB - 2, "<|endoftext|>": CLIP_VOCAB - 1})
    tok = os.path.join(weights, "tokenizer")
    os.makedirs(tok, exist_ok=True)
    added = lambda c: {"content": c, "lstrip": False, "normalized": True,  # noqa: E731
                       "rstrip": False, "single_word": False}
    files = {"vocab.json": vocab,
             "special_tokens_map.json": {"bos_token": added("<|startoftext|>"),
                                         "eos_token": added("<|endoftext|>"), "pad_token": "!",
                                         "unk_token": added("<|endoftext|>")},
             "tokenizer_config.json": {"do_lower_case": True, "model_max_length": 77,
                                       "pad_token": "<|endoftext|>",
                                       "tokenizer_class": "CLIPTokenizer"}}
    for name, obj in files.items():
        with open(os.path.join(tok, name), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(tok, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    words = ["<s>", "<pad>", "</s>", "<unk>", "[UNK]"]
    words += [chr(c) for c in range(33, 127)] + [f"##{chr(c)}" for c in range(97, 123)]
    words += CAPTION_WORDS + " ".join(DATA_PROMPTS).split()
    words = list(dict.fromkeys(words))
    words += [f"[unused{i}]" for i in range(MPNET_VOCAB - 1 - len(words))] + ["<mask>"]
    mp = os.path.join(weights, "mpnet")
    with open(os.path.join(mp, "vocab.txt"), "w") as f:
        f.write("\n".join(words) + "\n")
    with open(os.path.join(mp, "special_tokens_map.json"), "w") as f:
        json.dump({"bos_token": "<s>", "cls_token": "<s>", "eos_token": "</s>",
                   "mask_token": {"content": "<mask>", "lstrip": True}, "pad_token": "<pad>",
                   "sep_token": "</s>", "unk_token": "[UNK]"}, f)
    with open(os.path.join(mp, "tokenizer_config.json"), "w") as f:
        json.dump({"do_lower_case": True, "model_max_length": 384,
                   "tokenizer_class": "MPNetTokenizer"}, f)
    return {"clip_merges": len(merges), "clip_max_id": max(vocab.values()),
            "mpnet_vocab": len(words)}


class DecoderLog:
    """Which decoder served each batch of every `DataPipeline` while in use:
    the images of each batch by dpt_native, Pillow, resampled or zero."""

    def __enter__(self):
        from diffusion_pruning_tpu_torch.data import loader
        self.loader, self.real = loader, loader.DataPipeline._make_batch
        self.batches = []
        log_ = self

        def make_batch(pipe, idxs, rng, pool):
            with pipe._count_lock:
                before = collections.Counter(pipe.decoded)
            out = log_.real(pipe, idxs, rng, pool)
            with pipe._count_lock:
                served = dict(pipe.decoded - before)
            log_.batches.append({"pipeline": f"{'train' if pipe.train else 'eval'}-"
                                             f"{pipe.batch_size}", **served})
            return out

        loader.DataPipeline._make_batch = make_batch
        return self

    def __exit__(self, *exc):
        self.loader.DataPipeline._make_batch = self.real


def check_data_batch(batch):
    """A stage-1 batch from the folder or its latent cache: the static shapes
    of B = 64 at 256px."""
    want = {"input_ids": (TRAIN_B, 77), "mpnet_embeddings": (TRAIN_B, 768)}
    if "latent_mean" in batch:
        want.update(latent_mean=(TRAIN_B, 32, 32, 4), latent_logvar=(TRAIN_B, 32, 32, 4))
    else:
        want["pixel_values"] = (TRAIN_B, 256, 256, 3)
    got = {k: tuple(batch[k].shape) for k in want}
    if got != want or "mpnet_input_ids" in batch:
        fail(f"a stage-1 batch from the dataset folder has shapes {got}, keys {sorted(batch)}")


def first(batches):
    """The first batch of a generator, which is then closed (a pipeline's
    prefetch thread stops with it)."""
    try:
        return next(batches)
    finally:
        batches.close()


def time_loader(cols, data, native, unreadable):
    """The loader's own pace at B = 64, 256px, train (crops, flips, both
    tokenizers), by one decoder: batches/s over `DATA_LOADER_BATCHES`
    batches (the prefetch thread's start included), and the decode time of
    one image, one thread, one image at a time."""
    import numpy as np
    from diffusion_pruning_tpu_torch.data import loader
    pipe = loader.DataPipeline(cols, TRAIN_B, 256, data.tokenize_clip, data.tokenize_mpnet,
                               train=True, seed=SEED + 1, use_native=native)
    t0 = time.perf_counter()
    it = pipe.epoch(0)
    for _ in range(DATA_LOADER_BATCHES):
        next(it)
    seconds = time.perf_counter() - t0
    it.close()
    paths = [p for i, p in enumerate(cols["image"]) if i not in unreadable][:DATA_DECODE_IMAGES]
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    if native:
        raws = [loader.read_image_bytes(p) for p in paths]
        for raw in raws:
            pipe.native.decode_batch([raw], 256, [0.5], [0.5], [0], 1)
    else:
        for p in paths:
            loader.load_and_transform_image(p, 256, True, False, True, rng)
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
    return {"batches_per_sec": DATA_LOADER_BATCHES / seconds,
            "images_per_sec": DATA_LOADER_BATCHES * TRAIN_B / seconds,
            "decode_ms_per_image_one_thread": decode_ms, "decoded": dict(pipe.decoded)}


def latent_and_pixel_steps(loop, data, device):
    """One codebook step of the stage-1 trainer from `LatentPipeline` batches
    of the cache and one from the folder's pixel batches, in turns, at B =
    64: seconds, finite losses, and the VAE encodes each ran (none from the
    cache)."""
    import torch
    from diffusion_pruning_tpu_torch.data.latent_cache import LatentPipeline
    cached = LatentPipeline(os.path.join(DATA_CACHE, "train"), TRAIN_B, train=True, seed=SEED,
                            tokenize_clip=data.tokenize_clip, tokenize_mpnet=data.tokenize_mpnet)
    batches = {"latent": first(data._embedded(cached.epoch(0))),
               "pixel": first(data.train_batches(1))}
    size = loop.mods.unet.cfg.sample_size  # the cache's latents: 256px / 8
    if batches["latent"]["latent_mean"].shape != (TRAIN_B, size, size, 4):
        fail(f"latent batch of {batches['latent']['latent_mean'].shape}")
    vae = loop.mods.vae
    encodes = []
    real_encode = vae.encode_moments

    def counted(*a, **k):
        encodes.append(1)
        return real_encode(*a, **k)

    vae.encode_moments = counted
    out = {"latent": [], "pixel": []}
    try:
        for _ in range(DATA_STEP_TURNS):
            for kind in ("latent", "pixel"):
                placed = loop._place(batches[kind])
                before = len(encodes)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics, _ = loop.step_fns[False](placed, generator=loop.generator)
                torch.cuda.synchronize()
                out[kind].append({"seconds": time.perf_counter() - t0,
                                  "vae_encodes": len(encodes) - before,
                                  "loss": float(metrics["loss"])})
    finally:
        del vae.encode_moments
    bad = [r for k in out for r in out[k] if not math.isfinite(r["loss"])]
    if bad or any(r["vae_encodes"] for r in out["latent"]) or not all(
            r["vae_encodes"] for r in out["pixel"]):
        fail(f"latent-cache and pixel steps: {out}")
    warm = {k: statistics.median(r["seconds"] for r in v[1:]) for k, v in out.items()}
    return {"steps": out, "seconds_median_warm": warm,
            "latent_saves_seconds": warm["pixel"] - warm["latent"]}


def data_finetune(weights, prune_dir, indices, cols, ucfg):
    """Stage 2 on the folder for the expert with the most train captions, at
    the largest B of `DATA_FT_BATCHES` its captions fill twice (both steps in
    one epoch): its batches hold only its captions."""
    import numpy as np
    import torch
    from diffusion_pruning_tpu_torch.cli import finetune
    from diffusion_pruning_tpu_torch.core.structure import build_structure
    from diffusion_pruning_tpu_torch.models.unet.pruned import expert_macs_ratio, make_expert_plan
    from diffusion_pruning_tpu_torch.utils.checkpoint import (latest_checkpoint_dir,
                                                              load_torch_artifact)
    counts = np.bincount(indices, minlength=CODEBOOK_SHAPE[0])
    expert = int(counts.argmax())
    b = next((b for b in DATA_FT_BATCHES if counts[expert] >= 2 * b), None)
    if b is None:
        fail(f"the busiest expert has {counts[expert]} captions: {counts.tolist()}")
    mine = {c for c, e in zip(cols["caption"], indices) if e == expert}
    spec = build_structure(ucfg)
    row = load_torch_artifact(os.path.join(latest_checkpoint_dir(prune_dir),
                                           "quantizer_embeddings.pt"))[expert]
    plan = make_expert_plan(spec, row)
    config = finetune_yaml(os.path.join(DATA_RUNS, "sd21_finetune_data.yaml"), **{
        "data.data_dir": DATA_DIR, "data.max_validation_samples": DATA_IMAGES["val"],
        "data.dataloader.train_batch_size": b, "training.max_train_steps": DATA_FT_STEPS,
        "training.validation_steps": DATA_FT_STEPS,
        "training.logging.logging_dir": DATA_RUNS})
    seen = []
    real_batches = finetune.dataset_batches

    def recording(*a, **k):
        train, val = real_batches(*a, **k)

        def train_batches(epoch):
            for batch in train(epoch):
                seen.append(batch["captions"].tolist())
                yield batch
        return train_batches, val

    finetune.dataset_batches = recording
    try:
        loop, parts, steps, _, held, counts_run, peak = run_finetune_in_process(
            finetune_argv(config, weights, prune_dir, expert),
            finetune_step_launches(ucfg, plan, b, 1))
    finally:
        finetune.dataset_batches = real_batches
    foreign = [c for batch in seen for c in batch if c not in mine]
    lines, vals = metrics_lines(loop.run_dir)
    if (len(steps) != DATA_FT_STEPS or foreign or any(len(x) != b for x in seen)
            or [m["step"] for m in vals] != [DATA_FT_STEPS]
            or not all(math.isfinite(s[k]) for s in steps for k in FT_LOSS_KEYS)):
        fail(f"stage 2 on the folder: {len(steps)} steps, {len(foreign)} captions of other "
             f"experts, batches {[len(x) for x in seen]}, validations {vals}")
    row = {"expert": expert, "captions": int(counts[expert]), "captions_by_expert":
           counts.tolist(), "batch": b, "macs_ratio": expert_macs_ratio(spec, plan),
           "batches_drawn": len(seen), "captions_all_the_experts": True,
           "step_seconds": [s["seconds"] for s in steps],
           "losses": [{k: s[k] for k in ("loss", "diffusion_loss")} for s in steps],
           "cli_steps_per_sec": [m["steps_per_sec"] for m in lines],
           "launches_per_step": steps[-1]["launches"], "peak_memory_gib": peak,
           "seconds_by_part": parts, "run_dir": loop.run_dir}
    del loop, held
    torch.cuda.empty_cache()
    return row, counts_run


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] += v


def data_path(weights, device):
    """Phase 15: stage 1, routing, stage 2 and the latent cache on a written
    COCO-2014 folder, through the entry points, at SD-2.1 width on phase
    13's weights. Returns the summary and the launches of the whole phase."""
    import numpy as np
    import torch
    from PIL import Image
    from diffusion_pruning_tpu_torch.cli import cache_latents, filter_dataset, prune
    from diffusion_pruning_tpu_torch.data import get_dataset
    from diffusion_pruning_tpu_torch.utils.checkpoint import load_torch_artifact

    parts = {}
    total = collections.Counter()
    t0 = time.perf_counter()
    build = start_native_build()
    unreadable = write_coco_folder(DATA_DIR)
    vocab = write_tokenizer_files(weights)
    parts["write_dataset_and_tokenizers"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = finish_native_build(build)
    parts["native_build_wait"] = time.perf_counter() - t0
    os.makedirs(DATA_RUNS, exist_ok=True)
    argv = cli_argv(stage1_yaml(os.path.join(DATA_RUNS, "sd21_prune_data.yaml"), **{
        "data.data_dir": DATA_DIR, "data.prompts": list(DATA_PROMPTS),
        "data.max_validation_samples": DATA_IMAGES["val"],
        "model.quantizer.quantizer_base": STAGE1_QUANTIZER_BASE,
        "training.max_train_steps": DATA_STEPS, "training.hypernet_pretraining_steps": 1,
        "training.validation_steps": DATA_STEPS, "training.image_logging_steps": DATA_STEPS,
        "training.num_inference_steps": DATA_DDIM_STEPS,
        "training.logging.export_unet": False, "training.logging.logging_dir": DATA_RUNS}),
        weights)
    config = argv[1]
    logger_seconds = []
    real_logger = prune.log_sample_images

    def timed_logger(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real_logger(*a, **k)
        torch.cuda.synchronize()
        logger_seconds.append(time.perf_counter() - t)

    prune.log_sample_images = timed_logger
    t0 = time.perf_counter()
    try:
        with DecoderLog() as decoders:
            loop, run_parts, steps, _, counts, peak = run_cli_in_process(
                argv, device, per_step=cli_step_launches(TRAIN_B), check_batch=check_data_batch)
    finally:
        prune.log_sample_images = real_logger
    parts["stage1"] = time.perf_counter() - t0
    step_seconds = [s["seconds"] for s in steps]  # the list grows with later steps
    parts.update({f"stage1_{k}": v for k, v in run_parts.items()})
    parts["stage1_image_logger"] = sum(logger_seconds)
    add_counts(total, counts)
    data = loop.image_logger.keywords["data"]
    run_dir = loop.run_dir
    lines, vals = metrics_lines(run_dir)
    samples = sorted(os.listdir(os.path.join(run_dir, "samples")))
    served = dict(data.train_pipe.decoded)
    if ([m["step"] for m in lines] != list(range(1, DATA_STEPS + 1))
            or [m["step"] for m in vals] != [DATA_STEPS]
            or not all(math.isfinite(m[k]) for m in lines for k in LOSS_KEYS)
            or samples != [f"quantizer_samples_{DATA_STEPS}.png", f"samples_{DATA_STEPS}.png"]
            or len(steps) != DATA_STEPS or len(logger_seconds) != 1
            or served.get("resampled", 0) < DATA_UNREADABLE or served.get("zeros")):
        fail(f"stage 1 on the folder logged steps {[m['step'] for m in lines]}, validations "
             f"{[m['step'] for m in vals]}, samples {samples}, {len(steps)} steps, decoded "
             f"{served}")
    grids = {}
    for name in samples:
        with Image.open(os.path.join(run_dir, "samples", name)) as img:
            grids[name] = list(img.size)
    emit({"phase": "data_batches", "decoder": native["decoder"],
          "decoded_by_batch": decoders.batches})

    # routing
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        indices = filter_dataset.main([
            "--base_config_path", config, "--pretrained_model_name_or_path", weights,
            "--prompt_encoder_model_name_or_path", os.path.join(weights, "mpnet"),
            "--pruning_ckpt_dir", run_dir, "--seed", str(SEED)])
    parts["routing"] = time.perf_counter() - t0
    cols = get_dataset(type("DataCfg", (), {"data_dir": DATA_DIR, "dataset_name": "coco",
                                            "year": 2014}))
    routing = {}
    for split, key in (("train", "train"), ("validation", "val")):
        saved = load_torch_artifact(os.path.join(run_dir, f"coco_{split}_mapped_indices.pt"))
        caps = cols[split]["caption"]
        enc = data.tokenize_mpnet(caps)
        with torch.no_grad():
            emb = data.embed(enc["mpnet_input_ids"], enc["mpnet_attention_mask"])
            want = loop.mods.quantizer.cosine_indices(loop.mods.hypernet(emb)).cpu().numpy()
        if (saved.dtype != torch.int64 or len(saved) != DATA_IMAGES[key]
                or not np.array_equal(saved.numpy(), want)
                or not np.array_equal(indices[split], want)):
            fail(f"{split} routing: {saved.dtype}, {len(saved)} indices, "
                 f"{int((saved.numpy() != want).sum())} differ from the router in this process")
        routing[split] = np.bincount(want, minlength=CODEBOOK_SHAPE[0]).tolist()

    # the latent cache, then steps from it and from pixels in turns
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        shards = cache_latents.main([
            "--base_config_path", config, "--pretrained_model_name_or_path", weights,
            "--cache_dir", DATA_CACHE, "--seed", str(SEED)])
    parts["latent_cache"] = time.perf_counter() - t0
    if {k: len(v) for k, v in shards.items()} != {"train": 1, "validation": 1}:
        fail(f"the latent cache wrote {shards}")
    reset_launch_counts()
    t0 = time.perf_counter()
    turns = latent_and_pixel_steps(loop, data, device)
    parts["latent_and_pixel_steps"] = time.perf_counter() - t0
    add_counts(total, launch_counts())

    # the loader alone, by each decoder there is
    t0 = time.perf_counter()
    loader_pace = {name: time_loader(cols["train"], data, name == "dpt_native", unreadable)
                   for name in (("dpt_native", "pillow") if native["decoder"] == "dpt_native"
                                else ("pillow",))}
    parts["loader_timing"] = time.perf_counter() - t0
    ucfg = loop.mods.unet.cfg
    del loop, data
    torch.cuda.empty_cache()

    # stage 2 on the busiest expert's captions
    t0 = time.perf_counter()
    stage2, ft_counts = data_finetune(weights, run_dir, indices["train"], cols["train"], ucfg)
    parts["stage2"] = time.perf_counter() - t0
    add_counts(total, ft_counts)
    summary = {"phase": "data_path_summary", "images": DATA_IMAGES, "batch": TRAIN_B,
               "resolution": 256, "unreadable_train_ids": unreadable, "tokenizer_files": vocab,
               "decoder": native["decoder"], "dpt_native_file": native["dpt_native_file"],
               "native_build_error": native["error"], "train_images_decoded": served,
               "stage1_losses": [{k: m[k] for k in ("step", "loss", "resource_ratio")}
                                 for m in lines],
               "stage1_step_seconds": step_seconds,
               "stage1_cli_steps_per_sec": [m["steps_per_sec"] for m in lines],
               "stage1_step_steps_per_sec": [1 / s for s in step_seconds],
               "stage1_peak_memory_gib": peak, "sample_grids": grids,
               "routing_counts": routing, "latent_and_pixel_steps": turns,
               "loader": loader_pace, "stage2": stage2, "seconds_by_part": parts,
               "peak_memory_gib": max(peak, stage2["peak_memory_gib"])}
    emit(summary)
    return summary, total


# ---------------------------------------------------------------- main

# ---------------------------------------------------------------- phase 16

DP_WORLD = 2               # ranks sharing the card under gloo
DP_B = TRAIN_B // DP_WORLD  # the rows a rank takes of the global B = 64
DP_DIR = os.path.join(STAGE1_DIR, "dp")  # under phase 13's folder; removed with it
DP_CLI_STEPS = (3, 4)      # prune at world 2: run 1 ends at step 3, run 2 resumes it to step 4
DP_FT_STEPS = 2
DP_TIE_MARGIN = 1e-3       # a Sinkhorn top-1 lead under which two routes may differ by rounding
DP_TIMEOUT = 900           # seconds the two ranks may take


@contextlib.contextmanager
def torchrun_env(world, rank, port):
    """torchrun's variables for one rank of `world` on this host."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms (cuDNN's, and PyTorch's where an op has one;
    a warning where it has none), so that a repeated step repeats its bits
    (the bit-for-bit comparisons of phase 16, each with a repeat as its
    control)."""
    import torch
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def trainable_state(mods):
    return {"hypernet": to_host(mods.hypernet.state_dict()),
            "quantizer": to_host(mods.quantizer.state_dict())}


def load_trainables(mods, state):
    mods.hypernet.load_state_dict(state["hypernet"])
    mods.quantizer.load_state_dict(state["quantizer"])


def fingerprint(mods):
    """Σ of each module's floating-point tensors (float64): equal models read
    equal sums."""
    return {name: float(sum(t.detach().double().sum() for t in m.state_dict().values()
                            if t.is_floating_point()))
            for name, m in (("unet", mods.unet), ("vae", mods.vae), ("text", mods.text_encoder),
                            ("hypernet", mods.hypernet), ("quantizer", mods.quantizer))}


def bit_sums(tensors):
    """Σ of each tensor's raw 32- or 16-bit words (int64): a bit-for-bit
    comparison of replicas that cannot be sent whole."""
    import torch
    out = []
    for t in tensors:
        t = t.detach().contiguous()
        words = t.view(torch.int32 if t.element_size() == 4 else torch.int16)
        out.append(int(words.long().sum()))
    return out


def dp_batch_and_draws(mods, cfg, device, seed):
    """A global B = 64 batch at 256px and a complete set of its draws."""
    import torch
    from diffusion_pruning_tpu_torch.training.pruner import complete_draws
    gen = torch.Generator(device=device).manual_seed(seed)
    res = mods.unet.cfg.sample_size * mods.vae.cfg.spatial_scale
    batch = {"pixel_values": torch.rand(TRAIN_B, res, res, 3, device=device, generator=gen) * 2
             - 1,
             "input_ids": torch.randint(0, mods.text_encoder.cfg.vocab_size, (TRAIN_B, 77),
                                        device=device, generator=gen),
             "mpnet_embeddings": torch.randn(TRAIN_B, 768, device=device, generator=gen)}
    return batch, complete_draws(mods, cfg, batch, None, gen)


def rank_rows(tree, rank):
    """Rank `rank`'s rows [32r, 32r + 32) of a global batch or draw set; the
    codebook's gumbel noise is shared whole."""
    return {k: v if k == "codebook_gumbel" else v[rank * DP_B:(rank + 1) * DP_B]
            for k, v in tree.items()}


def pruner_step_record(mods, step, batch, draws):
    """One step: its loss terms, per-sample outputs, grads (f32, host) and the
    trainables after it (host)."""
    metrics, aux = step(batch, draws)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "expert_indices": aux["expert_indices"].cpu(),
            "grads": {n: (p.grad.detach().float().cpu() if p.grad is not None
                          else torch_zeros_like_host(p)) for n, p in trainables(mods)},
            "trainables": {n: p.detach().cpu().clone() for n, p in trainables(mods)}}


def torch_zeros_like_host(p):
    import torch
    return torch.zeros(p.shape, dtype=torch.float32)


def world1_stage1(mods, cfg, initial, mesh, device):
    """The stage-1 mesh step at world 1 against the mesh=None step (and the
    mesh=None step again, the control that the step repeats its bits), one
    codebook step at B = 64 on one set of explicit draws."""
    import torch
    from diffusion_pruning_tpu_torch.training import make_optimizer, make_pruner_step
    batch, draws = dp_batch_and_draws(mods, cfg, device, SEED + 40)
    runs = {}
    for name, on in (("none", None), ("none_again", None), ("mesh", mesh)):
        load_trainables(mods, initial)
        opt = make_optimizer(cfg, mods, TRAIN_B)
        step = make_pruner_step(mods, cfg, opt, pretrain=False, mesh=on)
        runs[name] = pruner_step_record(mods, step, batch, draws)
    torch.cuda.synchronize()

    def differ(a, b):
        out = [k for k in a["metrics"] if a["metrics"][k] != b["metrics"][k]]
        out += [f"grad {n}" for n in a["grads"] if not torch.equal(a["grads"][n], b["grads"][n])]
        out += [f"param {n}" for n in a["trainables"]
                if not torch.equal(a["trainables"][n], b["trainables"][n])]
        if not torch.equal(a["expert_indices"], b["expert_indices"]):
            out.append("expert_indices")
        return out

    return {"control_differs_at": differ(runs["none"], runs["none_again"]),
            "mesh_differs_at": differ(runs["none"], runs["mesh"])}


def stage2_modules(weights, plan, device):
    """Stage 2's modules as the finetune entry point builds them from phase
    13's weights: the expert of `plan` cut from the f32 dense U-Net as a
    student with f32 masters and a bf16 copy, the bf16 teacher, VAE and
    CLIP."""
    import torch
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    from diffusion_pruning_tpu_torch.schedulers import DiffusionSchedule
    from diffusion_pruning_tpu_torch.training import FineTunerModules, MasterWeights
    from diffusion_pruning_tpu_torch.training.factory import (build_student, build_text_encoder,
                                                              build_unet, build_vae)
    dense = build_unet(UNetConfig.sd21(256), weights, device, torch.float32)
    student = build_student(dense, plan)
    masters = MasterWeights(student, separate=True)
    student.to(torch.bfloat16)
    mods = FineTunerModules(student=student, teacher=dense.to(torch.bfloat16),
                            vae=build_vae(weights, device=device, dtype=torch.bfloat16),
                            text_encoder=build_text_encoder(weights, device=device,
                                                            dtype=torch.bfloat16),
                            schedule=DiffusionSchedule(prediction_type="v_prediction"))
    return mods, masters


def world1_stage2(weights, plan, mesh, device):
    """Phase 14's expert at B = 32: the ZeRO-1 step at world 1 against the
    replicated mesh step (and the replicated step again, the control), from
    the same masters on the same draws; the moments' bytes."""
    import torch
    from diffusion_pruning_tpu_torch.training import finetuner as ft
    mods, masters = stage2_modules(weights, plan, device)
    cfg = ft.FineTuneConfig(lr_warmup_steps=0)
    gen = torch.Generator(device=device).manual_seed(SEED + 41)
    res = mods.student.cfg.sample_size * mods.vae.cfg.spatial_scale
    batch = {"pixel_values": torch.rand(DP_B, res, res, 3, device=device, generator=gen) * 2 - 1,
             "input_ids": torch.randint(0, mods.text_encoder.cfg.vocab_size, (DP_B, 77),
                                        device=device, generator=gen)}
    draws = ft.complete_draws(mods, cfg, batch, None, gen)
    start = {k: v.clone() for k, v in masters.state_dict().items()}
    runs, moment_bytes = {}, {}
    for name, zero1 in (("replicated", False), ("replicated_again", False), ("zero1", True)):
        masters.load_state_dict(start)
        opt = ft.make_finetune_optimizer(cfg, masters, DP_B, zero1_mesh=mesh if zero1 else None)
        step = ft.make_finetune_step(mods, cfg, opt, zero1=zero1, mesh=mesh)
        metrics = step(batch, draws)
        runs[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                      "bits": bit_sums(masters.masters)}
        moment_bytes[name] = sum(t.numel() * t.element_size() for s in opt.state.values()
                                 for k, t in s.items() if k in ("mu", "nu"))
        del opt, step
    total = sum(m.numel() for m in masters.masters)
    del mods, masters, start
    torch.cuda.empty_cache()

    def differ(a, b):
        out = [k for k in a["metrics"] if a["metrics"][k] != b["metrics"][k]]
        return out + [f"master {i}" for i, (x, y) in enumerate(zip(a["bits"], b["bits"]))
                      if x != y]

    return {"control_differs_at": differ(runs["replicated"], runs["replicated_again"]),
            "zero1_differs_at": differ(runs["replicated"], runs["zero1"]),
            "parameters": total, "moment_bytes_world1": moment_bytes,
            "loss": runs["zero1"]["metrics"]["loss"]}


def check_world1_nccl(mods, cfg, initial, weights, plan, device):
    """Phase 16 part 1: a one-rank NCCL group in this process; the stage-1
    mesh step and stage 2's ZeRO-1 step at world 1 bit for bit."""
    import torch
    import torch.distributed as dist
    from diffusion_pruning_tpu_torch.parallel.mesh import data_mesh
    from diffusion_pruning_tpu_torch.utils.launch import init_distributed
    with torchrun_env(1, 0, free_port()), deterministic():
        dev = init_distributed()
        try:
            mesh = data_mesh(dev)
            if mesh.backend != "nccl" or mesh.world_size != 1:
                fail(f"the one-rank group is {mesh}, not NCCL at world 1")
            s1 = world1_stage1(mods, cfg, initial, mesh, device)
            s2 = world1_stage2(weights, plan, mesh, device)
        finally:
            dist.destroy_process_group()
    row = {"phase": "dp_world1_nccl", "backend": "nccl", "stage1_b": TRAIN_B, "stage2_b": DP_B,
           "stage1": s1, "stage2": s2}
    emit(row)
    for part, key in ((s1, "mesh_differs_at"), (s2, "zero1_differs_at")):
        if part["control_differs_at"]:
            fail(f"a step repeated on the same inputs does not repeat its bits: {row}")
        if part[key]:
            fail(f"at world 1 the data-parallel step differs from the one-process step: {row}")
    return row


def watch_writes(root, log):
    """Record every file this process opens for writing, and every directory
    it makes or file it moves or removes, under `root`."""
    root = os.path.realpath(root)

    def hook(event, args):
        if event == "open" and args and isinstance(args[0], (str, bytes, os.PathLike)):
            mode = args[1] if len(args) > 1 and isinstance(args[1], str) else "r"
            flags = args[2] if len(args) > 2 and isinstance(args[2], int) else 0
            if not (any(c in mode for c in "wax+") or flags & (os.O_WRONLY | os.O_RDWR)):
                return
        elif event not in ("os.mkdir", "os.rename", "os.replace", "os.remove", "os.rmdir",
                           "shutil.rmtree") or not args:
            return
        try:
            path = os.path.realpath(os.fsdecode(args[0]))
        except (TypeError, ValueError):
            return
        if path.startswith(root):
            log.append((event, path))
    sys.addaudithook(hook)


def dp_rank_steps(mesh, job, device):
    """A rank's two stage-1 steps (pretrain, then codebook) on its rows of the
    global batches and draws, with phase 8's models built from the seed; and,
    first, the planted fault's step-1 grads (the contrastive gather without
    the splice: the other ranks' rows gathered with no gradient and this
    rank's rows not spliced back in, so no contrastive gradient), with the
    trainables restored after it."""
    import torch
    import diffusion_pruning_tpu_torch.training.pruner as pruner
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    from diffusion_pruning_tpu_torch.parallel.mesh import all_gather
    from diffusion_pruning_tpu_torch.training import make_optimizer, make_pruner_step
    gen = torch.Generator(device=device).manual_seed(SEED)
    unet = build_unet(UNetConfig.sd21(256), device, gen)
    pipe, mpnet = build_pipeline(unet, device, gen)
    mods, cfg, _ = build_trainer(pipe, device, gen)
    del mpnet
    out = {"fingerprint": fingerprint(mods)}
    r = mesh.rank
    batches = [{k: v.to(device) for k, v in rank_rows(b, r).items()} for b in job["batches"]]
    draws = [{k: v.to(device) for k, v in rank_rows(d, r).items()} for d in job["draws"]]
    initial = trainable_state(mods)
    real = pruner.gather_spliced
    pruner.gather_spliced = lambda m, local: all_gather(m, local)
    try:
        step = make_pruner_step(mods, cfg, make_optimizer(cfg, mods, TRAIN_B), pretrain=True,
                                mesh=mesh)
        out["fault_grads"] = pruner_step_record(mods, step, batches[0], draws[0])["grads"]
    finally:
        pruner.gather_spliced = real
    load_trainables(mods, initial)
    opt = make_optimizer(cfg, mods, TRAIN_B)
    steps = {p: make_pruner_step(mods, cfg, opt, pretrain=p, mesh=mesh) for p in (True, False)}
    per_step = {**attention_per_step_at(DP_B)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    rows = []
    for i, (batch, d) in enumerate(zip(batches, draws)):
        before = launch_counts()
        t0 = time.perf_counter()
        row = pruner_step_record(mods, steps[i == 0], batch, d)
        torch.cuda.synchronize()
        row["seconds"] = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        checked = wrapper_counts(launches)
        if checked != {k: per_step.get(k, 0) for k in checked}:
            fail(f"rank {r}: expected {per_step} launches per step at B = {DP_B}, got {launches}")
        row["launches"] = launches
        rows.append(row)
    out.update(steps=rows, counts=launch_counts(),
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del mods, pipe, unet, steps, opt
    torch.cuda.empty_cache()
    return out


def attention_per_step_at(b):
    """`cli_step_launches` of one micro-batch of `b` as a plain dict."""
    return dict(cli_step_launches(b))


def dp_rank_cli(mesh, job, device):
    """A rank's runs of the entry points at world 2: `cli.prune` on phase
    13's config and weights (3 steps at 32 per rank with a checkpoint, then a
    resume to step 4) and `cli.finetune` with ZeRO-1 (the default at world
    2) on phase 14's expert for 2 steps at 32 per rank; each step's launches
    held against `backward_plan` at B = 32. Rank 1 records what it writes
    under the runs' folder."""
    import torch
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    writes = []
    if mesh.rank != 0:
        watch_writes(os.path.join(DP_DIR, "runs"), writes)
    out = {}
    t0 = time.perf_counter()
    _, parts1, steps1, _, counts1, peak1 = run_cli_in_process(
        cli_argv(job["prune"], job["weights"]), device, per_step=cli_step_launches(DP_B))
    out["prune"] = {"parts": parts1, "step_seconds": [s["seconds"] for s in steps1],
                    "peak_memory_gib": peak1, "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    loop, _, steps2, resumed, counts2, peak2 = run_cli_in_process(
        cli_argv(job["prune_resume"], job["weights"]), device, per_step=cli_step_launches(DP_B))
    out["prune_resume"] = {"resumed_step": resumed["step"], "resumed_state": resumed["state"],
                           "global_step": loop.global_step, "run_dir": loop.run_dir,
                           "trainables": bit_sums(p for _, p in trainables(loop.mods)),
                           "step_seconds": [s["seconds"] for s in steps2],
                           "peak_memory_gib": peak2, "seconds": time.perf_counter() - t0}
    del loop
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    per_step = finetune_step_launches(UNetConfig.sd21(256), job["plan"], DP_B, 1)
    loop, parts3, steps3, _, held, counts3, peak3 = run_finetune_in_process(
        finetune_argv(job["finetune"], job["weights"], job["pruning_dir"], job["expert"]),
        per_step)
    opt = loop.optimizer
    out["finetune"] = {"optimizer": type(opt).__name__, "global_step": loop.global_step,
                       "run_dir": loop.run_dir, "masters": bit_sums(loop.masters.masters),
                       "parameters": sum(m.numel() for m in loop.masters.masters),
                       "moment_bytes": sum(t.numel() * t.element_size()
                                           for s in opt.state.values() for k, t in s.items()
                                           if k in ("mu", "nu")),
                       "parts": parts3, "step_seconds": [s["seconds"] for s in steps3],
                       "losses": [s["loss"] for s in steps3],
                       "peak_memory_gib": peak3, "seconds": time.perf_counter() - t0}
    del loop, held, opt
    torch.cuda.empty_cache()
    out["counts"] = {k: counts1[k] + counts2[k] + counts3[k] for k in counts1}
    out["writes"] = writes
    return out


def dp_worker(job_path, out_dir, rank):
    """One rank of phase 16's two, run as `python3 chip_smoke.py --dp-rank
    JOB OUT_DIR RANK` with torchrun's variables: the group (gloo: the ranks
    share the card), the stage-1 steps, then the entry points. Never on the
    CPU."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from diffusion_pruning_tpu_torch.ops import build
    from diffusion_pruning_tpu_torch.parallel.mesh import barrier, data_mesh
    from diffusion_pruning_tpu_torch.utils.launch import init_distributed
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = init_distributed()
    mesh = data_mesh(device)
    if device.type != "cuda" or mesh.backend != "gloo" or mesh.world_size != DP_WORLD:
        fail(f"rank on {device} in {mesh}: two ranks on one card run under gloo")
    build.build_kernels()  # this checkout's kernels, built by the script before it
    job = torch.load(job_path, weights_only=False)
    t0 = time.perf_counter()
    out = {"rank": mesh.rank, "steps": dp_rank_steps(mesh, job, device),
           "steps_seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    out["cli"] = dp_rank_cli(mesh, job, device)
    out["cli_seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    barrier(mesh)
    torch.distributed.destroy_process_group()


def set_trainables(mods, values):
    """The trainables set to `values` (name → host tensor, `trainables`' names)."""
    import torch
    with torch.no_grad():
        for name, p in trainables(mods):
            p.copy_(values[name])


def ddp_objective_grads(mods, cfg, batch, draws, pretrain):
    """The two ranks' mean gradient, evaluated in this one process: each
    rank's loss on its rows, with the global batch's Sinkhorn assignment
    and contrastive matrix in which the other rank's rows carry no gradient
    (torch DDP's semantics, the JAX package's gather-and-splice), summed over
    the ranks and divided by their count. The one-process B = 64 step is not
    this function: its contrastive gradient is twice the ranks' mean, and
    its resource, std and max terms see the whole batch."""
    import torch
    import diffusion_pruning_tpu_torch.training.pruner as pruner
    from diffusion_pruning_tpu_torch.core.sinkhorn import sinkhorn
    from diffusion_pruning_tpu_torch.parallel.mesh import DataMesh
    q = mods.quantizer
    p_actual = mods.resource_model.actual_pruning_target(cfg.pruning_target)
    text = batch["mpnet_embeddings"].float()
    with torch.no_grad():
        logits = mods.hypernet(text)
        codes = q.gumbel_sigmoid_trick(q.embedding.weight, draws["codebook_gumbel"])
        sink = sinkhorn(q._scores(q.gumbel_sigmoid_trick(logits, draws["gates_gumbel"]), codes))
        indices = sink.argmax(-1)
        gates_norm = q.width_depth_normalize(q.gumbel_sigmoid_trick(logits, draws["gumbel"]))
    for _, p in trainables(mods):
        p.grad = None
    real_gather = pruner.all_gather
    try:
        for r in range(DP_WORLD):
            rows = slice(r * DP_B, (r + 1) * DP_B)
            gathered = iter([text, gates_norm])  # compute_losses gathers text, then gates

            def forward_train(z, cb, gg, mesh=None, rows=rows):
                e = q.gumbel_sigmoid_trick(q.embedding.weight, cb)
                return e[indices[rows]], indices[rows], e.detach()

            q.forward_train = forward_train
            pruner.all_gather = lambda mesh, x, gathered=gathered: next(gathered)
            loss, _ = pruner.compute_losses(
                mods, cfg, rank_rows(batch, r), rank_rows(draws, r), pretrain, p_actual,
                mesh=DataMesh(r, DP_WORLD, text.device))
            loss.backward()
    finally:
        pruner.all_gather = real_gather
        del q.forward_train
    grads = {n: (p.grad.detach().float().cpu() / DP_WORLD if p.grad is not None
                 else torch_zeros_like_host(p)) for n, p in trainables(mods)}
    for _, p in trainables(mods):
        p.grad = None
    return grads, indices.cpu(), sink


def dp_reference(mods, cfg, initial, job, ranks_steps, device):
    """Per step of the two ranks, at the trainables they held before it: the
    two ranks' objective's gradient in one process (`ddp_objective_grads`),
    the global Sinkhorn assignment with each prompt's top-1 lead, and, for
    comparison, the one-process B = 64 step's gradient."""
    rows = []
    for i, (batch, draws) in enumerate(zip(job["batches"], job["draws"])):
        if i == 0:
            load_trainables(mods, initial)
        else:
            set_trainables(mods, ranks_steps[i - 1]["trainables"])
        batch = {k: v.to(device) for k, v in batch.items()}
        draws = {k: v.to(device) for k, v in draws.items()}
        grads, indices, sink = ddp_objective_grads(mods, cfg, batch, draws, i == 0)
        top = sink.topk(2, dim=-1).values
        rows.append({"grads": grads, "expert_indices": indices,
                     "margins": (top[:, 0] - top[:, 1]).cpu(),
                     "one_process_grads": {n: g.cpu() for n, g in step_grads(
                         mods, cfg, batch, draws, i == 0).items()}})
    return rows


def leaf_rel_l2(got, want):
    return {n: float((got[n] - w).norm() / w.norm()) for n, w in want.items() if w.norm() > 0}


def check_two_ranks(mods, cfg, initial, weights, pruning_dir, expert, plan, device):
    """Phase 16 parts 2 and 3: two ranks sharing the card under gloo, spawned
    with torchrun's variables; their stage-1 steps against the one-process
    B = 64 steps, and the entry points at world 2."""
    import torch
    os.makedirs(DP_DIR, exist_ok=True)
    job = {"weights": weights, "pruning_dir": pruning_dir, "expert": expert, "plan": plan,
           "batches": [], "draws": []}
    for i in range(2):
        batch, draws = dp_batch_and_draws(mods, cfg, device, SEED + 42 + i)
        job["batches"].append({k: v.cpu() for k, v in batch.items()})
        job["draws"].append({k: v.cpu() for k, v in draws.items()})
    job["prune"] = stage1_yaml(os.path.join(DP_DIR, "run1", "sd21_dp.yaml"), **{
        "model.quantizer.quantizer_base": STAGE1_QUANTIZER_BASE,
        "data.dataloader.train_batch_size": DP_B,
        "training.logging.logging_dir": os.path.join(DP_DIR, "runs"),
        "training.logging.checkpoints_total_limit": 2,
        "training.max_train_steps": DP_CLI_STEPS[0], "training.hypernet_pretraining_steps": 1,
        "training.validation_steps": DP_CLI_STEPS[0],
        "training.image_logging_steps": DP_CLI_STEPS[0], "training.logging.export_unet": False})
    job["prune_resume"] = stage1_yaml(os.path.join(DP_DIR, "run2", "sd21_dp.yaml"), **{
        "model.quantizer.quantizer_base": STAGE1_QUANTIZER_BASE,
        "data.dataloader.train_batch_size": DP_B,
        "training.logging.logging_dir": os.path.join(DP_DIR, "runs"),
        "training.logging.checkpoints_total_limit": 2,
        "training.max_train_steps": DP_CLI_STEPS[1], "training.hypernet_pretraining_steps": 1,
        "training.validation_steps": DP_CLI_STEPS[0],
        "training.image_logging_steps": DP_CLI_STEPS[0], "training.logging.export_unet": False,
        "training.logging.resume_from_checkpoint": "latest"})
    job["finetune"] = finetune_yaml(os.path.join(DP_DIR, "ft", "sd21_dp_ft.yaml"), **{
        "data.dataloader.train_batch_size": DP_B,
        "training.logging.logging_dir": os.path.join(DP_DIR, "runs"),
        "training.max_train_steps": DP_FT_STEPS, "training.validation_steps": DP_FT_STEPS})
    job_path = os.path.join(DP_DIR, "job.pt")
    torch.save(job, job_path)
    load_trainables(mods, initial)
    ref_fingerprint = fingerprint(mods)
    torch.cuda.empty_cache()
    ranks_seconds = run_ranks(DP_WORLD, ["--dp-rank", job_path, DP_DIR], "dp", DP_TIMEOUT)
    got = [torch.load(os.path.join(DP_DIR, f"rank{r}.pt"), weights_only=False)
           for r in range(DP_WORLD)]
    reference = dp_reference(mods, cfg, initial, job, got[0]["steps"]["steps"], device)
    torch.cuda.empty_cache()
    return reference, ref_fingerprint, got, ranks_seconds


def summarise_two_ranks(reference, ref_fingerprint, got, world1, ranks_seconds):
    """The readings of parts 2 and 3, checked."""
    import torch
    from diffusion_pruning_tpu_torch.utils.checkpoint import CheckpointManager
    s0, s1 = got[0]["steps"], got[1]["steps"]
    model_diff = {k: (s0["fingerprint"][k], s1["fingerprint"][k], v)
                  for k, v in ref_fingerprint.items()
                  if not s0["fingerprint"][k] == s1["fingerprint"][k] == v}
    if model_diff:
        fail(f"the ranks built other models than phase 8's: {model_diff}")
    steps = []
    for i, (ref, a, b) in enumerate(zip(reference, s0["steps"], s1["steps"])):
        cos = leaf_cosines(a["grads"], ref["grads"])
        replica_diff = [n for n in a["trainables"]
                        if not torch.equal(a["trainables"][n], b["trainables"][n])]
        replica_diff += [f"grad {n}" for n in a["grads"]
                         if not torch.equal(a["grads"][n], b["grads"][n])]
        differ = torch.nonzero(a["expert_indices"] != ref["expert_indices"]).flatten().tolist()
        listed = [{"prompt": j, "ranks": int(a["expert_indices"][j]),
                   "one_process": int(ref["expert_indices"][j]),
                   "sinkhorn_margin": float(ref["margins"][j])} for j in differ]
        one = leaf_cosines(a["grads"], ref["one_process_grads"])
        steps.append({"step": i + 1, "pretrain": i == 0, "min_cos": min(cos.values()),
                      "min_cos_leaf": min(cos, key=cos.get),
                      "rel_l2_max": max(leaf_rel_l2(a["grads"], ref["grads"]).values()),
                      "loss": a["metrics"]["loss"],
                      "against_the_one_process_b64_step": {
                          "min_cos": min(one.values()), "min_cos_leaf": min(one, key=one.get),
                          "rel_l2_max": max(leaf_rel_l2(a["grads"],
                                                        ref["one_process_grads"]).values())},
                      "expert_indices_differing": listed,
                      "expert_indices_equal": not differ,
                      "replicas_differ_at": replica_diff,
                      "seconds_rank0": a["seconds"], "seconds_rank1": b["seconds"]})
    fault = leaf_cosines(s0["fault_grads"], reference[0]["grads"])  # at step 1's trainables
    c0, c1 = got[0]["cli"], got[1]["cli"]
    saved = CheckpointManager(c0["prune_resume"]["run_dir"], create=False).restore(
        DP_CLI_STEPS[0])
    resume_diff = [state_equal(c["prune_resume"]["resumed_state"], saved) for c in (c0, c1)]
    params = c0["finetune"]["parameters"]
    row = {"phase": "dp_two_ranks", "backend": "gloo", "ranks": DP_WORLD,
           "rows_per_rank": DP_B, "global_batch": TRAIN_B, "limit": GRAD_COS,
           "steps": steps,
           "planted_fault_no_splice_min_cos": min(fault.values()),
           "planted_fault_leaf": min(fault, key=fault.get),
           "prune": {"resumed_step": [c["prune_resume"]["resumed_step"] for c in (c0, c1)],
                     "resumed_state_differs_at": resume_diff,
                     "global_step": [c["prune_resume"]["global_step"] for c in (c0, c1)],
                     "replicas_equal": c0["prune_resume"]["trainables"]
                     == c1["prune_resume"]["trainables"],
                     "checkpoints": CheckpointManager(c0["prune_resume"]["run_dir"],
                                                      create=False).list_steps()},
           "finetune": {"optimizer": [c["finetune"]["optimizer"] for c in (c0, c1)],
                        "global_step": [c["finetune"]["global_step"] for c in (c0, c1)],
                        "replicas_equal": c0["finetune"]["masters"] == c1["finetune"]["masters"],
                        "losses": c0["finetune"]["losses"],
                        "checkpoints": CheckpointManager(c0["finetune"]["run_dir"],
                                                         create=False).list_steps()},
           "rank1_writes": c1["writes"][:8]}
    emit(row)
    moment_world1 = world1["stage2"]["moment_bytes_world1"]["zero1"]
    summary = {"phase": "dp_summary", "card_shared_by": DP_WORLD,
               "peak_memory_gib_by_rank": {
                   "stage1_steps": [g["steps"]["peak_memory_gib"] for g in got],
                   "prune_cli": [g["cli"]["prune"]["peak_memory_gib"] for g in got],
                   "finetune_cli_zero1": [g["cli"]["finetune"]["peak_memory_gib"] for g in got]},
               "finetune_parameters": params,
               "moment_bytes_by_rank_world2": [g["cli"]["finetune"]["moment_bytes"] for g in got],
               "moment_bytes_world1": 8 * params,
               "moment_bytes_world1_measured_expert_of_part1": moment_world1,
               "step_seconds_not_a_scaling_number": {
                   "note": "two processes share one card and gloo stages every all_reduce "
                           "through host memory (stage 2: 4 bytes a parameter each way)",
                   "stage1_b32_per_rank": [[s["seconds"] for s in g["steps"]["steps"]]
                                           for g in got],
                   "prune_cli": [g["cli"]["prune"]["step_seconds"]
                                 + g["cli"]["prune_resume"]["step_seconds"] for g in got],
                   "finetune_cli": [g["cli"]["finetune"]["step_seconds"] for g in got]},
               "seconds": {"ranks_wall": ranks_seconds,
                           "rank_steps": [g["steps_seconds"] for g in got],
                           "rank_cli": [g["cli_seconds"] for g in got]}}
    emit(summary)
    bad = [s for s in steps if not s["min_cos"] > GRAD_COS or s["replicas_differ_at"]
           or any(d["sinkhorn_margin"] >= DP_TIE_MARGIN for d in s["expert_indices_differing"])]
    if bad:
        fail(f"the two ranks' steps disagree with the one-process step: {bad}")
    if not row["planted_fault_no_splice_min_cos"] <= GRAD_COS:
        fail(f"the planted fault reads within the limit {GRAD_COS}: {row}")
    pr, fr = row["prune"], row["finetune"]
    if (pr["resumed_step"] != [DP_CLI_STEPS[0]] * 2 or any(resume_diff)
            or pr["global_step"] != [DP_CLI_STEPS[1]] * 2 or not pr["replicas_equal"]
            or pr["checkpoints"] != list(DP_CLI_STEPS)):
        fail(f"prune at world 2: {pr}")
    if (fr["optimizer"] != ["Zero1AdamW"] * 2 or fr["global_step"] != [DP_FT_STEPS] * 2
            or not fr["replicas_equal"] or fr["checkpoints"] != [DP_FT_STEPS]
            or not all(math.isfinite(v) for v in fr["losses"])):
        fail(f"finetune at world 2: {fr}")
    if c1["writes"]:
        fail(f"rank 1 wrote under the runs' folder: {c1['writes'][:8]}")
    per_rank = -(-params // DP_WORLD) * 8
    if summary["moment_bytes_by_rank_world2"] != [per_rank] * DP_WORLD:
        fail(f"ZeRO-1's moments are not {per_rank} bytes a rank: {summary}")
    return row, summary


def dp_launch_counts(world1_counts, got):
    """Phase 16's launches by kernel: this process's world-1 steps and both
    ranks' steps and entry-point runs."""
    out = collections.Counter(world1_counts)
    for g in got:
        out.update(g["steps"]["counts"])
        out.update(g["cli"]["counts"])
    return out


def data_parallel(mods, cfg, initial, stage1, device):
    """Phase 16: data parallel on the card (module docstring)."""
    import torch
    expert, _, _, plan, _ = pick_expert(stage1["run_dir"])
    for m in (mods.vae, mods.text_encoder):  # phase 8's precision (later phases turned them)
        m.to(torch.bfloat16)
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    reset_launch_counts()
    t0 = time.perf_counter()
    world1 = check_world1_nccl(mods, cfg, initial, stage1["weights"], plan, device)
    world1_counts = launch_counts()
    world1_seconds = time.perf_counter() - t0
    reference, ref_fp, got, ranks_seconds = check_two_ranks(
        mods, cfg, initial, stage1["weights"], stage1["run_dir"], expert, plan, device)
    row, summary = summarise_two_ranks(reference, ref_fp, got, world1, ranks_seconds)
    counts = dp_launch_counts(world1_counts, got)
    emit({"phase": "dp_seconds", "world1_nccl": world1_seconds, "two_ranks": ranks_seconds})
    return {"world1": world1, "two_ranks": row, "summary": summary}, counts


# ---------------------------------------------------------------- phase 17

EVAL_DIR = os.path.join(STAGE1_DIR, "eval")   # under phase 13's folder; removed with it
EVAL_PROMPTS = 16             # served prompts a call
EVAL_SERVE_B = 4              # the serve CLI's largest tier
EVAL_SERVE_WAVE = 8           # prompts a wave (two submits a call)
EVAL_SERVE_STEPS = 10         # DDIM steps a served request
EVAL_SERVE_TURNS = ("experts", "routed")  # once each; phase 19 has the turns
EVAL_RES = 256                # the images' side (the coco yaml's resolution)
EVAL_IMAGES = 8               # data.max_generated_samples of each generation CLI
EVAL_MIN_IMAGES = 4           # phase 14's expert generates when the router gives it this many
EVAL_GEN_STEPS = 25           # PNDM, the generation CLIs' default
EVAL_EMBED_IMAGES = 32        # images (and captions) a tower embeds when timed
FID_DIM = 2048                # the InceptionV3 pool features the stand-in's contract names
TOWER_COS = 0.999             # per-row cosine of the card's embeddings against the CPU's


def write_metric_towers(root, weights, device):
    """Seeded random metric towers in Hugging Face names: a ViT-B/32 CLIP
    folder (text and vision, config.json, projection and logit scale, phase
    15's SD-2.1 tokenizer files) for CLIP-score, a ViT-L/14-336 vision folder
    for CMMD, and a TorchScript stand-in of the InceptionV3 contract (N×3×H×W
    in 0-255 → N×2048) for FID. Returns their paths."""
    import shutil
    import torch
    import torch.nn.functional as F
    from diffusion_pruning_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder
    from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
    from diffusion_pruning_tpu_torch.utils.init_utils import random_init_
    from safetensors.torch import save_file

    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    clip_dir, cmmd_dir = os.path.join(root, "clip-vit-b32"), os.path.join(root, "clip-vit-l14-336")
    tcfg = CLIPTextConfig(vocab_size=CLIP_VOCAB, hidden_size=512, num_layers=12, num_heads=8,
                          intermediate_size=2048, hidden_act="quick_gelu")
    vcfg = CLIPVisionConfig.vit_b32()
    sd = {}
    for cls, cfg in ((CLIPTextEncoder, tcfg), (CLIPVisionEncoder, vcfg)):
        with torch.device(device):
            module = cls(cfg)
        random_init_(module, gen)
        sd.update({k: v.float().cpu() for k, v in module.state_dict().items()})
        del module
    sd["text_projection.weight"] = (torch.randn((512, 512), generator=gen, device=device)
                                    / 512 ** 0.5).cpu()
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07))
    os.makedirs(clip_dir, exist_ok=True)
    save_file({k: v.contiguous() for k, v in sd.items()}, os.path.join(clip_dir, "model.safetensors"))
    for name in ("vocab.json", "merges.txt", "special_tokens_map.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(weights, "tokenizer", name), clip_dir)
    with open(os.path.join(clip_dir, "config.json"), "w") as f:
        json.dump({"model_type": "clip", "projection_dim": 512,
                   "text_config": {"vocab_size": CLIP_VOCAB, "hidden_size": 512,
                                   "num_hidden_layers": 12, "num_attention_heads": 8,
                                   "intermediate_size": 2048, "max_position_embeddings": 77,
                                   "hidden_act": "quick_gelu"},
                   "vision_config": {"hidden_size": 768, "num_hidden_layers": 12,
                                     "num_attention_heads": 12, "intermediate_size": 3072,
                                     "image_size": 224, "patch_size": 32,
                                     "hidden_act": "quick_gelu"}}, f)
    with torch.device(device):
        module = CLIPVisionEncoder(CLIPVisionConfig.vit_l14_336())
    random_init_(module, gen)
    os.makedirs(cmmd_dir, exist_ok=True)
    save_file({k: v.bfloat16().contiguous() for k, v in module.state_dict().items()},
              os.path.join(cmmd_dir, "model.safetensors"))
    del module

    class InceptionStandIn(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.convs = torch.nn.ModuleList([
                torch.nn.Conv2d(3, 64, 3, stride=2), torch.nn.Conv2d(64, 192, 3, stride=2),
                torch.nn.Conv2d(192, 768, 3, stride=2), torch.nn.Conv2d(768, FID_DIM, 3,
                                                                       stride=2)])

        def forward(self, x):
            x = F.interpolate(x / 127.5 - 1.0, size=(299, 299), mode="bilinear",
                              align_corners=False)
            for conv in self.convs:
                x = torch.relu(conv(x))
            return x.mean(dim=(2, 3))

    standin = InceptionStandIn()
    cpu_gen = torch.Generator().manual_seed(SEED + 17)
    with torch.no_grad():
        for p in standin.parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 1
            p.copy_(torch.randn(p.shape, generator=cpu_gen) * (2.0 / fan_in) ** 0.5
                    if p.dim() > 1 else torch.zeros(p.shape))
    inception = os.path.join(root, "inception_standin.pt")
    torch.jit.trace(standin.eval(), torch.zeros(1, 3, 256, 256)).save(inception)
    torch.cuda.empty_cache()
    return {"clip": clip_dir, "cmmd": cmmd_dir, "inception": inception}


def row_cosines(a, b):
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def serve_cli_turns(config, weights, run_dir, ft_slot, expert14, prompts_file):
    """`cli.serve` in experts and routed modes in turns (EVAL_SERVE_TURNS):
    16 prompts a call in two waves of 8, tiers up to 4, DDIM-10, phase 14's
    stage-2 masters in that expert's slot. Each call's images, routes and
    launches are checked; returns (readings, launches of every call)."""
    import io
    import numpy as np
    from diffusion_pruning_tpu_torch.cli import serve

    total = collections.Counter()
    calls = []
    for turn, mode in enumerate(EVAL_SERVE_TURNS):
        out = os.path.join(EVAL_DIR, f"served_{turn}_{mode}")
        argv = ["--base_config_path", config, "--pretrained_model_name_or_path", weights,
                "--prompt_encoder_model_name_or_path", os.path.join(weights, "mpnet"),
                "--pruning_ckpt_dir", run_dir, "--finetuning_ckpt_dirs", ft_slot,
                "--prompts_file", prompts_file, "--batch_size", str(EVAL_SERVE_B),
                "--arrival_batch", str(EVAL_SERVE_WAVE),
                "--num_inference_steps", str(EVAL_SERVE_STEPS), "--mode", mode,
                "--out_dir", out, "--seed", str(SEED)]
        reset_launch_counts()
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr), contextlib.redirect_stderr(err):
            got = serve.main(argv)
        seconds = time.perf_counter() - t0
        sys.stderr.write(err.getvalue())
        counts = launch_counts()
        wrapper_counts(counts)  # the forward kernels' launches add up to their wrappers'
        add_counts(total, counts)
        files = sorted(os.listdir(out))
        arrays = [np.load(os.path.join(out, f)) for f in files]
        experts = sorted(set(got["experts"].values()))
        slot_line = f"expert {expert14}: fine-tuned weights from"
        if (got["images"] != EVAL_PROMPTS
                or files != [f"img_{i:05d}.npy" for i in range(EVAL_PROMPTS)]
                or any(a.dtype != np.uint8 or a.shape != (EVAL_RES, EVAL_RES, 3) for a in arrays)
                or sorted(got["experts"]) != list(range(EVAL_PROMPTS))
                or not all(0 <= e < CODEBOOK_SHAPE[0] for e in experts)
                or (mode == "experts") != (slot_line in err.getvalue())
                or (mode == "experts") != (len(got["macs_ratios"]) == CODEBOOK_SHAPE[0])
                or not (counts["kernel:gated_flash_fwd_wgmma"] > 0
                        and counts["kernel:gated_flash_fwd_small"] > 0)):
            fail(f"cli.serve --mode {mode}: {got['images']} images, files {files[:3]}..., "
                 f"experts {got['experts']}, MACs {got['macs_ratios']}, launches {counts}")
        calls.append({"mode": mode, "img_per_sec": got["img_per_sec"],
                      "serve_seconds": got["seconds"], "warmup_seconds": got["warmup_seconds"],
                      "call_seconds": seconds, "experts_used": experts,
                      "prompts_by_expert": np.bincount(list(got["experts"].values()),
                                                       minlength=CODEBOOK_SHAPE[0]).tolist(),
                      "macs_ratios": got["macs_ratios"],
                      "launches": {k: v for k, v in counts.items() if v}})
        emit({"phase": "serve_cli", "turn": turn, **calls[-1]})
    return calls, total


def timed_writer():
    """Wraps the generation CLIs' image writer to time its generation apart
    from the models' build: returns (restore, [(images, seconds)])."""
    import torch
    from diffusion_pruning_tpu_torch.cli import generate_fid_images as gfi
    real, record = gfi.write_images, []

    def write_images(pipe, tokenizer, captions, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        paths = real(pipe, tokenizer, captions, *a, **k)
        torch.cuda.synchronize()
        record.append((len(paths), time.perf_counter() - t))
        return paths

    gfi.write_images = write_images
    return (lambda: setattr(gfi, "write_images", real)), record


def check_generated(folder, n):
    import numpy as np
    files = sorted(os.listdir(folder))
    arrays = [np.load(os.path.join(folder, f)) for f in files]
    if (files != [f"{i:06d}.npy" for i in range(n)]
            or any(a.dtype != np.uint8 or a.shape != (EVAL_RES, EVAL_RES, 3) for a in arrays)):
        fail(f"{folder}: {files} ({[a.shape for a in arrays[:2]]})")


def tower_rates(towers, fid_model, images, captions, device):
    """Embeddings a second of each tower on the card at its CLI's batch
    (one warm call, then timed): CLIP ViT-B/32 images and text, ViT-L/14-336
    images (CMMD's 16), the FID stand-in (FID's 32)."""
    import numpy as np
    import torch
    from diffusion_pruning_tpu_torch.cli.cmmd import EMBED_BATCH
    from diffusion_pruning_tpu_torch.cli.fid import FID_BATCH

    def rate(fn, n):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t)

    bs = EVAL_EMBED_IMAGES  # cli.clip_score's default batch
    x = torch.from_numpy(np.stack(images[:FID_BATCH])).to(device).permute(0, 3, 1, 2).float()
    clip, vit_l = towers
    with torch.inference_mode():
        return {"clip_vit_b32_image": rate(lambda: clip.embed_images(images[:bs]), bs),
                "clip_vit_b32_text": rate(lambda: clip.embed_texts(captions[:bs]), bs),
                "clip_vit_l14_336_image": rate(
                    lambda: vit_l.embed_images(images[:EMBED_BATCH], unit=True), EMBED_BATCH),
                "fid_standin": rate(lambda: fid_model(x).float().cpu(), len(x))}


def eval_and_serve(stage1, device):
    """Phase 17: evaluation and serving through the entry points at SD-2.1
    width on phase 13's weights and stage-1 run, phase 14's expert and phase
    15's COCO folder (module docstring). Returns the summary and the
    launches by path ("serve_cli", "eval")."""
    import numpy as np
    import torch
    from diffusion_pruning_tpu_torch.cli import (clip_score, cmmd, fid, filter_dataset,
                                                 generate_fid_images, generate_images,
                                                 resize_and_save_images, save_captions)
    from diffusion_pruning_tpu_torch.data import get_dataset
    from diffusion_pruning_tpu_torch.metrics.towers import image_files, load_clip_towers, load_images
    from diffusion_pruning_tpu_torch.models.clip_vision import CLIPVisionConfig

    parts = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated() / 2 ** 30  # earlier phases' live tensors
    weights, run_dir = stage1["weights"], stage1["run_dir"]
    expert14 = pick_expert(run_dir)[0]
    ft_run = os.path.join(FT_DIR, "runs", "sd21_finetune", f"cli-expert{expert14}")
    os.makedirs(EVAL_DIR, exist_ok=True)
    config = stage1_yaml(os.path.join(EVAL_DIR, "sd21_eval.yaml"), **{
        "data.data_dir": DATA_DIR, "data.max_generated_samples": EVAL_IMAGES,
        "model.quantizer.quantizer_base": STAGE1_QUANTIZER_BASE,
        "training.num_inference_steps": EVAL_GEN_STEPS,
        "training.logging.logging_dir": EVAL_DIR})
    common = ["--base_config_path", config, "--pretrained_model_name_or_path", weights,
              "--prompt_encoder_model_name_or_path", os.path.join(weights, "mpnet"),
              "--seed", str(SEED)]
    val_caps = get_dataset(type("DataCfg", (), {"data_dir": DATA_DIR, "dataset_name": "coco",
                                                "year": 2014}))["validation"]["caption"]

    # phase 13's router on the folder's captions (the assignment generation reads)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        routed = filter_dataset.main([*common, "--pruning_ckpt_dir", run_dir])
    parts["routing"] = time.perf_counter() - t0
    val_counts = np.bincount(routed["validation"], minlength=CODEBOOK_SHAPE[0])

    # serving
    prompts_file = os.path.join(EVAL_DIR, "prompts.txt")
    with open(prompts_file, "w") as f:
        f.write("\n".join(val_caps[:EVAL_PROMPTS]) + "\n")
    t0 = time.perf_counter()
    serve_calls, serve_counts = serve_cli_turns(
        config, weights, run_dir, "," * expert14 + ft_run, expert14, prompts_file)
    parts["serve_cli"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # generation: phase 14's fine-tuned expert where the router gives it
    # captions enough, else the busiest expert's slices; the magnitude baseline
    gen_expert = (expert14 if val_counts[expert14] >= EVAL_MIN_IMAGES
                  else int(val_counts.argmax()))
    n_expert = int(min(EVAL_IMAGES, val_counts[gen_expert]))
    restore, written = timed_writer()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            expert_dir = generate_fid_images.main([
                *common, "--pruning_ckpt_dir", run_dir, "--expert_id", str(gen_expert),
                *(["--finetuning_ckpt_dir", ft_run] if gen_expert == expert14 else [])])
            parts["generate_fid_images"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            base_dir = generate_images.main([*common, "--pruning_type", "magnitude"])
            parts["generate_images_magnitude"] = time.perf_counter() - t0
    finally:
        restore()
    eval_counts = launch_counts()
    wrapper_counts(eval_counts)
    check_generated(expert_dir, n_expert)
    check_generated(base_dir, EVAL_IMAGES)
    if not (eval_counts["kernel:gated_flash_fwd_wgmma"] > 0
            and eval_counts["kernel:gated_flash_fwd_small"] > 0):
        fail(f"the generation entry points launched {dict(eval_counts)}")
    gen_rate = {"expert": written[0][0] / written[0][1], "magnitude": written[1][0] / written[1][1]}
    torch.cuda.empty_cache()

    # scoring
    t0 = time.perf_counter()
    towers = write_metric_towers(os.path.join(EVAL_DIR, "towers"), weights, device)
    parts["write_towers"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_dir = os.path.join(EVAL_DIR, "ref_npy")
    with contextlib.redirect_stdout(sys.stderr):
        n_ref = resize_and_save_images.main([os.path.join(DATA_DIR, "images", "val2014"),
                                             ref_dir, "--resolution", "256"])
        caps = {}
        for name, folder, argv in (
                ("expert", expert_dir, ["--pruning_ckpt_dir", run_dir, "--expert_id",
                                        str(gen_expert)]),
                ("magnitude", base_dir, [])):
            caps[name] = os.path.join(EVAL_DIR, f"captions_{name}.json")
            save_captions.main(["--base_config_path", config, *argv, "--out", caps[name]])
    parts["reference_and_captions"] = time.perf_counter() - t0
    scores, cpu_cos = {}, {}
    with contextlib.redirect_stdout(sys.stderr):
        for name, folder in (("expert", expert_dir), ("magnitude", base_dir)):
            t0 = time.perf_counter()
            card = clip_score.main([folder, "--captions", caps[name], "--clip_model",
                                    towers["clip"]])
            parts[f"clip_score_{name}"] = time.perf_counter() - t0
            scores[f"clip_score_{name}"] = card["score"]
            if name == "expert":
                t0 = time.perf_counter()
                cpu = clip_score.main([folder, "--captions", caps[name], "--clip_model",
                                       towers["clip"], "--device", "cpu"])
                parts["clip_score_cpu"] = time.perf_counter() - t0
                cpu_cos["clip_vit_b32_image"] = row_cosines(card["image_features"],
                                                            cpu["image_features"]).min()
                cpu_cos["clip_vit_b32_text"] = row_cosines(card["text_features"],
                                                           cpu["text_features"]).min()
        t0 = time.perf_counter()
        ref_emb = os.path.join(EVAL_DIR, "cmmd_ref.npy")
        card = cmmd.main([expert_dir, ref_dir, "--clip_model", towers["cmmd"],
                          "--save_ref_embeddings", ref_emb])
        parts["cmmd"] = time.perf_counter() - t0
        scores["cmmd_expert"] = card["cmmd"]
        t0 = time.perf_counter()
        cpu = cmmd.main([expert_dir, ref_emb, "--clip_model", towers["cmmd"], "--device", "cpu"])
        parts["cmmd_cpu"] = time.perf_counter() - t0
        cpu_cos["clip_vit_l14_336_image"] = row_cosines(card["gen"], cpu["gen"]).min()
        t0 = time.perf_counter()
        card = fid.main([expert_dir, "--ref_stats", ref_dir, "--inception", towers["inception"]])
        parts["fid"] = time.perf_counter() - t0
        scores["fid_expert"] = card["fid"]
        cpu_feats = fid.inception_features(expert_dir, towers["inception"], torch.device("cpu"))
        cpu_cos["fid_standin"] = row_cosines(card["features"], cpu_feats).min()
    cpu_cos = {k: float(v) for k, v in cpu_cos.items()}
    if not all(v >= TOWER_COS for v in cpu_cos.values()) or not all(
            math.isfinite(v) for v in scores.values()):
        fail(f"metric towers on the card against the CPU (min cosine a row, limit {TOWER_COS}): "
             f"{cpu_cos}; scores {scores}")

    # each tower's pace on the card
    t0 = time.perf_counter()
    ref_images = load_images(ref_dir, image_files(ref_dir)[:EVAL_EMBED_IMAGES])
    vit_b = load_clip_towers(towers["clip"], device)
    vit_l = load_clip_towers(towers["cmmd"], device, text=False,
                             vision_cfg=CLIPVisionConfig.vit_l14_336())
    fid_model = torch.jit.load(towers["inception"], map_location=device).eval()
    rates = tower_rates((vit_b, vit_l), fid_model, ref_images, list(val_caps), device)
    del vit_b, vit_l, fid_model
    parts["tower_rates"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    by_mode = {m: [c["img_per_sec"] for c in serve_calls if c["mode"] == m]
               for m in dict.fromkeys(EVAL_SERVE_TURNS)}
    summary = {"phase": "eval_serve_summary", "resolution": EVAL_RES, "prompts": EVAL_PROMPTS,
               "serve_steps": EVAL_SERVE_STEPS, "serve_batch_size": EVAL_SERVE_B,
               "serve_img_per_sec_by_mode": by_mode,
               "serve_warmup_seconds": [c["warmup_seconds"] for c in serve_calls
                                        if c["mode"] == "experts"],
               "finetuned_slot": expert14, "generation_expert": gen_expert,
               "generation_expert_is_finetuned": gen_expert == expert14,
               "validation_captions_by_expert": val_counts.tolist(),
               "generation_images": {"expert": n_expert, "magnitude": EVAL_IMAGES},
               "generation_steps": EVAL_GEN_STEPS,
               "generation_images_per_sec": gen_rate, "embeddings_per_sec": rates,
               "reference_images": n_ref,
               "metrics_of_random_weights": scores, "cpu_min_row_cosine": cpu_cos,
               "cpu_cosine_limit": TOWER_COS, "seconds_by_part": parts,
               "memory_at_start_gib": at_start, "peak_memory_gib": peak}
    emit(summary)
    counts = {"serve_cli": dict(serve_counts), "eval": dict(eval_counts)}
    return summary, counts


# ---------------------------------------------------------------- phase 18

TP_DIR = os.path.join(STAGE1_DIR, "tp")  # under phase 13's folder; removed with it
TP_MODEL = 2               # model ranks: parts 1-2 on a 1 × 2 mesh, part 3 on 2 × 2
TP_FT_WORLD = 4
TP_TIMED_FORWARDS = 3      # sharded and one-process forwards timed per rank, in turns
TP_DDIM = 4                # the sharded pipeline's and server's DDIM steps
# the experts the 8 prompts are steered to: tiers of 4 (expert 0), 2, 1 and 1
TP_EXPERTS = (0, 0, 0, 0, 1, 1, 2, 3)
TP_FT_B = 16               # part 3's global batch: 8 rows a data rank
TP_FT_STEPS = 2
# part 3 against the one-process run of the same config and draws: each
# step's loss within TP_LOSS_REL of it, and each leaf's update over the two
# steps at cosine >= TP_UPDATE_COS (bf16 partials round on each rank before
# the sum; Adam's early steps follow the gradients' signs); the planted fault,
# the one-process run with model rank 1's share of every row-parallel input
# zeroed (its partial dropped), must read beyond one of them (PERF.md)
TP_LOSS_REL = 1e-2
TP_UPDATE_COS = 0.9
TP_TIMEOUT = 600           # seconds the ranks of one part may take
ROW_BIASES = ("to_out.0.bias", "ff.net.2.bias", "conv2.bias")
TP_BIAS_STD = 0.05         # parts 1-2's row-parallel biases (the seeded init's are zero)


def run_ranks(world, args, tag, timeout=TP_TIMEOUT):
    """`world` ranks of this script (`python3 chip_smoke.py *args RANK` with
    torchrun's variables; logs in build/<tag>_rank<r>.log), sharing the card
    under gloo (phases 16 and 18); their exit codes checked. Returns the wall
    seconds."""
    port = free_port()
    procs, logs = [], []
    t0 = time.perf_counter()
    for rank in range(world):
        logs.append(os.path.join(HERE, "build", f"{tag}_rank{rank}.log"))  # ignored by git
        with torchrun_env(world, rank, port), open(logs[-1], "w") as log_file:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), *args, str(rank)], cwd=HERE,
                env=dict(os.environ), stdout=log_file, stderr=subprocess.STDOUT))
    try:
        deadline = time.perf_counter() + timeout
        codes = [p.wait(timeout=max(1.0, deadline - time.perf_counter())) for p in procs]
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    for rank, (log_path, code) in enumerate(zip(logs, codes)):
        if code != 0:
            with open(log_path) as f:
                fail(f"{tag} rank {rank} exited {code}: {f.read()[-3000:]}")
    return time.perf_counter() - t0


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def tp_requests(device, mpnet, pipe, codes):
    """8 prompts from the seed, steered to TP_EXPERTS, with their initial
    latents (`expert_requests`' recipe)."""
    import torch
    from diffusion_pruning_tpu_torch.models.text_encoders import mean_pool
    gen = torch.Generator(device=device).manual_seed(SEED + 50)
    n = len(TP_EXPERTS)
    ids = torch.randint(0, 49408, (n, 77), device=device, generator=gen)
    neg = torch.randint(0, 49408, (n, 77), device=device, generator=gen)
    mp_ids = torch.randint(0, 30527, (n, 128), device=device, generator=gen)
    mask = torch.ones(n, 128, dtype=torch.long, device=device)
    cfg = pipe.unet.cfg
    latents = torch.randn(n, cfg.sample_size, cfg.sample_size, cfg.in_channels, device=device,
                          generator=gen)
    with torch.inference_mode():
        feats = mean_pool(mpnet(mp_ids, mask), mask)
    experts = torch.as_tensor(TP_EXPERTS)
    return {"ids": ids, "neg": neg, "latents": latents,
            "kw": {"hyper_net_input": feats, "num_inference_steps": TP_DDIM,
                   "guidance_scale": GUIDANCE, "latents": latents,
                   "route_noise": steering_noise(pipe.quantizer, codes, experts)}}


def timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def tp_rank_serve(mesh, device):
    """Parts 1 and 2 on one rank of the 1 × 2 mesh: phase 4's U-Net and phase
    5's pipeline built from the seed, the U-Net's row-parallel biases drawn
    from it too (TP_BIAS_STD); the sharded U-Net (and its
    `fused_norm_conv` twin) on phase 4's inputs against the one-process
    forward, each forward's launches and reductions, the planted faults, the
    times in turns; then `shard_pipeline` and `ExpertServer.from_codebook` on
    it, serving 8 steered prompts (rank 0 first serves them one-process)."""
    import torch
    from diffusion_pruning_tpu_torch.models.unet import attention, blocks
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    from diffusion_pruning_tpu_torch.parallel import tp
    from diffusion_pruning_tpu_torch.parallel.mesh import barrier
    from diffusion_pruning_tpu_torch.pipelines.expert_server import ExpertServer
    gen = torch.Generator(device=device).manual_seed(SEED)
    unet = build_unet(UNetConfig.sd21(256), device, gen)
    pipe, mpnet = build_pipeline(unet, device, gen)
    bias_gen = torch.Generator(device=device).manual_seed(SEED + 51)
    with torch.no_grad():  # a bias added on both ranks must show
        for name, p in unet.named_parameters():
            if name.endswith(ROW_BIASES):
                p.copy_(TP_BIAS_STD * torch.randn(p.shape, generator=bias_gen, device=device))
    x, t, ehs, arch = unet_inputs(unet, device)
    twin = fused_twin(unet, fused_norm_conv=True)
    sharded, sharded_twin = tp.shard_unet(unet, mesh), tp.shard_unet(twin, mesh)
    real = tp.reduce_from_model
    faults = {  # emulated in the sharded forward itself
        "bias_on_both_ranks": lambda axis, p, b, like: real(
            axis, p, None if b is None else b * axis.world_size, like),
        "one_rank_partial_dropped": lambda axis, p, b, like: real(
            axis, p * 0 if axis.rank == 1 else p, b, like)}
    out = {"rank": mesh.rank}
    with torch.inference_mode():
        # the one-process forwards: bf16 (the kernels, as the sharded one) and
        # f32 (plain attention), the reference UNET_REL_L2 is defined against
        f32 = fused_twin(unet, use_flash_attention=False).float()
        ref32 = f32(x, t, ehs, arch=arch.float()).float()
        del f32
        ref, ref_twin = (m(x, t, ehs, arch=arch).float() for m in (unet, twin))
        forwards = {"one_process_rel_l2": rel_l2(ref, ref32),
                    "one_process_rel_l2_fused_norm_conv": rel_l2(ref_twin, ref32)}
        for name, model in (("plain", sharded), ("fused_norm_conv", sharded_twin)):
            torch.cuda.synchronize()
            reset_launch_counts()
            tp.reset_tp_stats()
            got = model(x, t, ehs, arch=arch).float()
            torch.cuda.synchronize()
            forwards[name] = {"rel_l2": rel_l2(got, ref32),
                              "rel_l2_to_one_process_bf16": rel_l2(
                                  got, ref if name == "plain" else ref_twin),
                              "finite": bool(torch.isfinite(got).all()),
                              "launches": launch_counts(), "reductions": tp.tp_stats["reductions"]}
        for name, fn in faults.items():
            with patched(attention, "reduce_from_model", fn), \
                    patched(blocks, "reduce_from_model", fn):
                forwards[f"fault_{name}"] = rel_l2(sharded(x, t, ehs, arch=arch), ref32)
        seconds = {"sharded": [], "one_process": []}
        tp.reset_tp_stats()
        for _ in range(TP_TIMED_FORWARDS):  # in turns
            seconds["sharded"].append(timed(lambda: sharded(x, t, ehs, arch=arch))[1])
            seconds["one_process"].append(timed(lambda: unet(x, t, ehs, arch=arch))[1])
        forwards["seconds"] = seconds
        forwards["reduce_seconds_per_forward"] = tp.tp_stats["reduce_seconds"] / TP_TIMED_FORWARDS
    out["forward"] = forwards
    del twin, sharded_twin, ref, ref_twin, ref32
    # part 2
    codes = expert_codebook(pipe.quantizer, unet.spec)
    req = tp_requests(device, mpnet, pipe, codes)
    serve_args = (req["ids"], req["neg"])
    server_kw = {k: v for k, v in req["kw"].items()}
    if mesh.rank == 0:
        images, indices, _ = pipe(*serve_args, **req["kw"])
        server = ExpertServer.from_codebook(pipe, unet.spec, unet.cfg, batch_size=4,
                                            param_dtype=torch.bfloat16)
        served, experts = server.generate(*serve_args, **server_kw)
        out["one_process"] = {"images": images.cpu(), "indices": indices.cpu(),
                              "served": served, "experts": experts}
        del server
        torch.cuda.empty_cache()
    barrier(mesh)
    sp = tp.shard_pipeline(pipe, mesh)
    reset_launch_counts()
    tp.reset_tp_stats()
    (images, indices, _), pipe_s = timed(lambda: sp(*serve_args, **req["kw"]))
    server, build_s = timed(lambda: ExpertServer.from_codebook(
        sp, unet.spec, unet.cfg, batch_size=4, param_dtype=torch.bfloat16))
    (served, experts), serve_s = timed(lambda: server.generate(*serve_args, **server_kw))
    out["sharded"] = {"images": images.cpu(), "indices": indices.cpu(), "served": served,
                      "experts": experts, "seconds": {"pipeline": pipe_s, "server_build": build_s,
                                                      "server_generate": serve_s},
                      "sharded_experts": all(m.shard is not None for m in server.expert_models),
                      "counts": launch_counts(), "reductions": tp.tp_stats["reductions"],
                      "reduce_seconds": tp.tp_stats["reduce_seconds"]}
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def tp_step_launches(cfg, plan, b, rank, n_model):
    """`finetune_step_launches` of one model rank of a 2-D step at local
    batch b: the teacher's lse-free forward at each dense site where the rank
    holds heads, the student's forward with lse and `backward_plan`'s
    kernels at each expert site where it holds heads, at its local heads (a
    rank holding none launches nothing there)."""
    from diffusion_pruning_tpu_torch.ops import flash_attention as fa
    from diffusion_pruning_tpu_torch.parallel.tp import unit_range
    out = collections.Counter()

    def local(h):
        lo, hi = unit_range(h, rank, n_model)
        return hi - lo

    for s_q, s_kv, h, sites in TRAIN_CASES:
        if local(h):
            out["gated_flash_fwd"] += sites
            out[f"kernel:{fa.forward_kernel(s_q, s_kv)}"] += sites
    for s_q, s_kv, h in expert_attention_sites(cfg, plan):
        if local(h):
            out["gated_flash_fwd_lse"] += 1
            out[f"kernel:{fa.forward_kernel(s_q, s_kv)}"] += 1
            for name, n in fa.backward_plan(b, local(h), s_q, s_kv).launches.items():
                out[name] += n
    return dict(out)


def tp_rank_finetune(mesh, job, device):
    """Part 3 on one rank of the 2 × 2 mesh: `cli.finetune` with
    `optim.tensor_parallel: 2` on phase 14's expert, each step's launches
    held against `tp_step_launches`."""
    import torch
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    from diffusion_pruning_tpu_torch.parallel import tp
    per_step = tp_step_launches(UNetConfig.sd21(256), job["plan"], TP_FT_B // 2,
                                mesh.model.rank, TP_MODEL)
    tp.reset_tp_stats()
    loop, parts, steps, _, _, counts, peak = run_finetune_in_process(
        finetune_argv(job["tp_yaml"], job["weights"], job["pruning_dir"], job["expert"]),
        per_step, gspmd=True)
    opt = loop.optimizer
    return {"rank": mesh.rank, "coords": (mesh.data.rank, mesh.model.rank),
            "mesh": loop.mesh.shape, "optimizer": type(opt).__name__, "run_dir": loop.run_dir,
            "global_step": loop.global_step, "parts": parts, "steps": steps,
            "counts": counts, "peak_memory_gib": peak, "tp_stats": dict(tp.tp_stats),
            "master_elements": sum(m.numel() for m in loop.masters.masters),
            "moment_bytes": sum(v.numel() * v.element_size() for st in opt.state.values()
                                for k, v in st.items() if k in ("mu", "nu"))}


def tp_worker(part, job_path, out_dir, rank):
    """One rank of phase 18, run as `python3 chip_smoke.py --tp-rank PART JOB
    OUT_DIR RANK` with torchrun's variables: the group (gloo: the ranks share
    the card), the mesh, then part "serve" (1 × 2) or "finetune" (2 × 2).
    Never on the CPU."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from diffusion_pruning_tpu_torch.ops import build
    from diffusion_pruning_tpu_torch.parallel.mesh import barrier
    from diffusion_pruning_tpu_torch.parallel.tp import dp_tp_mesh
    from diffusion_pruning_tpu_torch.utils.launch import init_distributed, world_size
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = init_distributed()
    mesh = dp_tp_mesh(world_size() // TP_MODEL, TP_MODEL, device)
    if device.type != "cuda" or mesh.backend != "gloo":
        fail(f"rank on {device} in {mesh}: ranks on one card run under gloo")
    build.build_kernels()  # this checkout's kernels, built by the script before it
    job = torch.load(job_path, weights_only=False)
    t0 = time.perf_counter()
    out = (tp_rank_serve(mesh, device) if part == "serve"
           else tp_rank_finetune(mesh, job, device))
    out["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(out_dir, f"{part}_rank{rank}.pt"))
    barrier(mesh)
    torch.distributed.destroy_process_group()


def drop_rank1_partials(mods, optimizer):
    """The planted fault of part 3, in one process: the input channels of
    model rank 1's units of every row-parallel weight (to_out.0, ff.net.2,
    conv2) zeroed in the student's masters (and so its compute copy) and in
    the teacher, as if that rank's partial never reached the sum."""
    import torch
    from diffusion_pruning_tpu_torch.parallel.tp import local_index, split_keys, tp_plan

    def zero(named, keys):
        for name, t in named:
            if name in keys and keys[name][1] == 1:  # a row-parallel weight
                site, dim, halves = keys[name]
                t.index_fill_(dim, local_index(site, 1, TP_MODEL, halves, t.device), 0.0)

    masters = optimizer.masters
    with torch.no_grad():
        zero(zip(masters.names, masters.masters), split_keys(tp_plan(mods.student)))
        masters.refresh()
        zero(mods.teacher.named_parameters(), split_keys(tp_plan(mods.teacher)))


def check_serve_ranks(got):
    """Parts 1-2's readings of both ranks, checked."""
    ref = got[0]["one_process"]
    rows = []
    for g in got:
        f, s = g["forward"], g["sharded"]
        images = [rel_l2(a, b) for a, b in zip(s["images"], ref["images"])]
        served = [rel_l2(a, b) for a, b in zip(s["served"], ref["served"])]
        rows.append({
            "rank": g["rank"],
            "forward_rel_l2": f["plain"]["rel_l2"],
            "forward_rel_l2_fused_norm_conv": f["fused_norm_conv"]["rel_l2"],
            "one_process_rel_l2": f["one_process_rel_l2"],
            "one_process_rel_l2_fused_norm_conv": f["one_process_rel_l2_fused_norm_conv"],
            "forward_rel_l2_to_one_process_bf16": f["plain"]["rel_l2_to_one_process_bf16"],
            "forward_rel_l2_to_one_process_bf16_fused_norm_conv":
                f["fused_norm_conv"]["rel_l2_to_one_process_bf16"],
            "fault_rel_l2": {k[6:]: v for k, v in f.items() if k.startswith("fault_")},
            "launches_per_forward": {k: v for k, v in f["plain"]["launches"].items() if v},
            "launches_per_forward_fused_norm_conv": {
                k: v for k, v in f["fused_norm_conv"]["launches"].items() if v},
            "reductions_per_forward": f["plain"]["reductions"],
            "forward_seconds_sharded": f["seconds"]["sharded"],
            "forward_seconds_one_process": f["seconds"]["one_process"],
            "reduce_seconds_per_forward": f["reduce_seconds_per_forward"],
            "pipeline_images_rel_l2_max": max(images),
            "pipeline_indices_equal": torch_equal(s["indices"], ref["indices"]),
            "served_images_rel_l2_max": max(served),
            "served_experts_equal": torch_equal(s["experts"], ref["experts"]),
            "experts_sharded": s["sharded_experts"], "serving_seconds": s["seconds"],
            "serving_reductions": s["reductions"],
            "serving_reduce_seconds": s["reduce_seconds"],
            "peak_memory_gib": g["peak_memory_gib"], "seconds": g["seconds"]})
    row = {"phase": "tp_serve", "mesh": [1, TP_MODEL], "backend": "gloo", "b_eff": FUSED_B,
           "limit": UNET_REL_L2, "served_limit": SERVED_REL_L2, "ranks": rows,
           "experts_steered": list(TP_EXPERTS), "one_process_indices": ref["indices"].tolist()}
    emit(row)
    for r, g in zip(rows, got):
        f = g["forward"]
        bad = [k for k in ("plain", "fused_norm_conv")
               if not (f[k]["finite"] and f[k]["rel_l2"] <= UNET_REL_L2)]
        if bad:
            fail(f"rank {r['rank']}: the sharded U-Net disagrees with the f32 one-process U-Net "
                 f"({bad}): {r}")
        if not min(r["fault_rel_l2"].values()) > UNET_REL_L2:
            fail(f"a planted fault reads within {UNET_REL_L2}: {r}")
        want = {"gated_flash_fwd": 32, "kernel:gated_flash_fwd_wgmma": 20,
                "kernel:gated_flash_fwd_small": 12}
        if r["launches_per_forward"] != want or r["reductions_per_forward"] != 70:
            fail(f"rank {r['rank']}: expected {want} launches and 70 reductions a forward: {r}")
        fused = r["launches_per_forward_fused_norm_conv"]
        if (fused.get("norm_conv3x3") != 45 or fused.get("norm_linear") != 16
                or fused.get("gated_flash_fwd") != 32):
            fail(f"rank {r['rank']}: expected 45 norm_conv3x3, 16 norm_linear and 32 attention "
                 f"launches a fused forward: {fused}")
        if not (r["pipeline_indices_equal"] and r["served_experts_equal"]
                and r["pipeline_images_rel_l2_max"] <= SERVED_REL_L2
                and r["served_images_rel_l2_max"] <= SERVED_REL_L2 and r["experts_sharded"]):
            fail(f"rank {r['rank']}: the sharded pipeline or server disagrees with one "
                 f"process: {r}")
    return row


def torch_equal(a, b):
    import torch
    return bool(torch.equal(torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()))


def leaf_update_cosines(after, before, want_after):
    """Per leaf, the cosine of (after − before) with (want_after − before);
    leaves neither run moved are left out."""
    import torch
    out = {}
    for name, b in before.items():
        u, w = (after[name] - b).double().flatten(), (want_after[name] - b).double().flatten()
        if u.norm() == 0 and w.norm() == 0:
            continue
        out[name] = float(torch.nn.functional.cosine_similarity(u, w, dim=0))
    return out


def tensor_parallel(stage1, device):
    """Phase 18: tensor parallelism on the card (module docstring)."""
    import torch
    os.makedirs(TP_DIR, exist_ok=True)
    parts = {}
    expert, macs, _, plan, _ = pick_expert(stage1["run_dir"])
    common = {"training.max_train_steps": TP_FT_STEPS,
              "training.validation_steps": TP_FT_STEPS + 1,
              "training.logging.logging_dir": os.path.join(TP_DIR, "runs")}
    job = {"weights": stage1["weights"], "pruning_dir": stage1["run_dir"], "expert": expert,
           "plan": plan,
           "tp_yaml": finetune_yaml(os.path.join(TP_DIR, "tp", "sd21_tp.yaml"), **common, **{
               "training.optim.tensor_parallel": TP_MODEL,
               "data.dataloader.train_batch_size": TP_FT_B // (TP_FT_WORLD // TP_MODEL)}),
           "one_yaml": finetune_yaml(os.path.join(TP_DIR, "one", "sd21_one.yaml"), **common, **{
               "data.dataloader.train_batch_size": TP_FT_B})}
    job_path = os.path.join(TP_DIR, "job.pt")
    torch.save(job, job_path)
    torch.cuda.empty_cache()
    # parts 1-2: two ranks, a 1 × 2 mesh
    parts["serve_ranks"] = run_ranks(TP_MODEL, ["--tp-rank", "serve", job_path, TP_DIR],
                                     "tp_serve")
    got = [torch.load(os.path.join(TP_DIR, f"serve_rank{r}.pt"), weights_only=False)
           for r in range(TP_MODEL)]
    serve_row = check_serve_ranks(got)
    # part 3: four ranks, a 2 × 2 mesh, then the one-process run and its fault
    parts["finetune_ranks"] = run_ranks(TP_FT_WORLD,
                                        ["--tp-rank", "finetune", job_path, TP_DIR], "tp_ft")
    ranks = [torch.load(os.path.join(TP_DIR, f"finetune_rank{r}.pt"), weights_only=False)
             for r in range(TP_FT_WORLD)]
    ft_row = check_finetune_ranks(job, ranks, macs, parts)
    counts = collections.Counter()
    for g in got:
        counts.update(g["sharded"]["counts"])
        counts.update(g["forward"]["plain"]["launches"])
        counts.update(g["forward"]["fused_norm_conv"]["launches"])
    for r in ranks:
        counts.update(r["counts"])
    return {"serve": serve_row, "finetune": ft_row}, counts


def check_finetune_ranks(job, ranks, macs, parts):
    """Part 3's readings: the ranks' checkpoint against the one-process run
    of the same config and draws and against the planted fault, both run in
    this process; checked."""
    import torch
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    from diffusion_pruning_tpu_torch.utils.checkpoint import CheckpointManager
    expert, plan = job["expert"], job["plan"]
    t0 = time.perf_counter()
    saved = CheckpointManager(ranks[0]["run_dir"], create=False)
    tp_state = saved.restore(TP_FT_STEPS)
    parts["restore_tp_checkpoint"] = time.perf_counter() - t0
    cfg256 = UNetConfig.sd21(256)
    runs = {}
    for name, tamper in (("one_process", None), ("fault_rank1_partial_dropped", drop_rank1_partials)):
        t0 = time.perf_counter()
        loop, _, steps, _, held, _, peak = run_finetune_in_process(
            finetune_argv(job["one_yaml"], job["weights"], job["pruning_dir"], expert),
            finetune_step_launches(cfg256, plan, TP_FT_B, 1), tamper=tamper, save=False,
            keep_masters=True)
        runs[name] = {"steps": steps, "before": held["masters"],
                      "after": to_host(loop.masters.state_dict()), "peak_memory_gib": peak}
        del loop, held
        torch.cuda.empty_cache()
        parts[name] = time.perf_counter() - t0
    before = runs["one_process"]["before"]
    cos = leaf_update_cosines(tp_state["student"], before, runs["one_process"]["after"])
    cos_fault = leaf_update_cosines(runs["fault_rank1_partial_dropped"]["after"], before,
                                    tp_state["student"])
    losses = [s["loss"] for s in ranks[0]["steps"]]
    ref_losses = [s["loss"] for s in runs["one_process"]["steps"]]
    fault_losses = [s["loss"] for s in runs["fault_rank1_partial_dropped"]["steps"]]

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]

    ft_row = {"phase": "tp_finetune", "mesh": [TP_FT_WORLD // TP_MODEL, TP_MODEL],
              "backend": "gloo", "expert": expert, "macs_ratio": macs, "global_batch": TP_FT_B,
              "steps": TP_FT_STEPS, "losses": losses, "one_process_losses": ref_losses,
              "loss_rel_diff": rel(losses, ref_losses), "loss_limit": TP_LOSS_REL,
              "update_cos_min": min(cos.values()), "update_cos_min_leaf": min(cos, key=cos.get),
              "update_cos_median": statistics.median(cos.values()),
              "leaves_compared": len(cos), "update_cos_limit": TP_UPDATE_COS,
              "fault_loss_rel_diff": rel(fault_losses, losses),
              "fault_update_cos_min": min(cos_fault.values()),
              "fault_update_cos_median": statistics.median(cos_fault.values()),
              "checkpoint_keys_equal": sorted(tp_state["student"]) == sorted(before),
              "checkpoint_shapes_equal": all(tp_state["student"][k].shape == v.shape
                                             for k, v in before.items()),
              "ranks": [{k: r[k] for k in ("rank", "coords", "mesh", "optimizer", "global_step",
                                           "parts", "peak_memory_gib", "tp_stats",
                                           "master_elements", "moment_bytes", "seconds")}
                        | {"step_seconds": [s["seconds"] for s in r["steps"]],
                           "losses": [s["loss"] for s in r["steps"]]} for r in ranks],
              "one_process_step_seconds": [s["seconds"] for s in runs["one_process"]["steps"]],
              "one_process_peak_memory_gib": runs["one_process"]["peak_memory_gib"],
              "seconds_by_part": parts}
    emit(ft_row)
    if [r["mesh"] for r in ranks] != [{"data": 2, "model": 2}] * TP_FT_WORLD or any(
            r["optimizer"] != "AdamW" or r["global_step"] != TP_FT_STEPS for r in ranks):
        fail(f"the 2 × 2 finetune ranks: {ft_row['ranks']}")
    if any(r["losses"] != losses for r in ft_row["ranks"]):
        fail(f"the ranks logged different losses: {ft_row['ranks']}")
    if not (ft_row["checkpoint_keys_equal"] and ft_row["checkpoint_shapes_equal"]):
        fail("the tensor-parallel checkpoint has other keys or shapes than the one-process "
             "run's masters")
    if not (max(ft_row["loss_rel_diff"]) <= TP_LOSS_REL and ft_row["update_cos_min"]
            >= TP_UPDATE_COS):
        fail(f"the 2 × 2 run disagrees with the one-process run: {ft_row}")
    if not (max(ft_row["fault_loss_rel_diff"]) > TP_LOSS_REL
            or ft_row["fault_update_cos_min"] < TP_UPDATE_COS):
        fail(f"the planted fault reads within both limits: {ft_row}")
    return ft_row


# ---------------------------------------------------------------- phase 19

GRAPH_TURNS = 3             # eager and captured turns of each cell, in one process
GRAPH_PROMPTS = 8           # the routed pipeline's request of sd21-256-graphs
GRAPH_FALLBACK_ATOL = 1e-3  # images in [0, 1] where a library op takes another algorithm
GRAPH_TRACE_DIR = os.path.join(HERE, "build", "graph_trace")  # ignored by git; removed after
CONVERGENCE_DIR = os.path.join(STAGE1_DIR, "convergence")  # under phase 13's folder
CONVERGENCE_ARGS = ("--steps", "60", "--pretrain_steps", "20", "--ft_steps", "10", "--batch",
                    "8", "--ft_experts", "1")   # the JAX script's docstring smoke schedule
REPLAY_DIR = os.path.join(STAGE1_DIR, "replay")
REPLAY_ARGS = ("--experts", "1", "--steps", "2", "--ft_steps", "2", "--infer_steps", "2")
REPLAY_TIMEOUT = 600


def graph_request(pipe, mpnet, device):
    """GRAPH_PROMPTS prompts from the seed: CLIP ids, negative ids, MPNet
    features, zero routing noise and initial latents; a second set of
    latents for the aliasing check."""
    import torch
    from diffusion_pruning_tpu_torch.models.text_encoders import mean_pool
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    b, cfg = GRAPH_PROMPTS, pipe.unet.cfg
    ids = torch.randint(0, 49408, (b, 77), device=device, generator=gen)
    neg = torch.randint(0, 49408, (b, 77), device=device, generator=gen)
    mp_ids = torch.randint(0, 30527, (b, 128), device=device, generator=gen)
    mask = torch.ones(b, 128, dtype=torch.long, device=device)
    shape = (b, cfg.sample_size, cfg.sample_size, cfg.in_channels)
    with torch.inference_mode():
        feats = mean_pool(mpnet(mp_ids, mask), mask)
    return {"ids": ids, "neg": neg, "feats": feats,
            "noise": torch.zeros(b, pipe.unet.spec.vq_dim, device=device),
            "latents": torch.randn(shape, device=device, generator=gen),
            "latents2": torch.randn(shape, device=device, generator=gen)}


def routed_call(pipe, req):
    """One routed request: (images, expert indices, seconds, launches)."""
    import torch
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images, indices, _ = pipe(req["ids"], req["neg"], hyper_net_input=req["feats"],
                              num_inference_steps=STEPS, guidance_scale=GUIDANCE,
                              latents=req["latents"], route_noise=req["noise"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return images, indices, seconds, {k: v - before[k] for k, v in launch_counts().items()}


def programs_of(caches):
    """The prepared programs of every dispatch table in `caches`."""
    from diffusion_pruning_tpu_torch.pipelines import aot
    return [p for cache in caches for d in cache.values() if isinstance(d, aot.ShapeDispatch)
            for p in d.programs]


def replays(programs):
    from diffusion_pruning_tpu_torch.pipelines import aot
    return sum(p.replays for p in programs if isinstance(p, aot.CapturedProgram))


def same_bits(name, eager, captured):
    """{bit_equal, max_abs}; fails unless the captured images equal the eager
    ones bit for bit or, where a library op took another algorithm under
    capture, within GRAPH_FALLBACK_ATOL."""
    max_abs = float((eager.float() - captured.float()).abs().max())
    out = {"bit_equal": bool(eager.shape == captured.shape and (eager == captured).all()),
           "max_abs": max_abs}
    if not out["bit_equal"] and not max_abs <= GRAPH_FALLBACK_ATOL:
        fail(f"{name}: captured images differ from the eager ones by {max_abs}")
    return out


def graph_pipeline_cell(pipe, mpnet, eager_busy_share, device):
    """The routed pipeline, eager and captured in turns: bits, launches,
    img/s, capture seconds, peak memory, aliasing, one profiled captured
    request. Returns the row, the routed arch and the launches of the
    captured calls."""
    import torch
    from diffusion_pruning_tpu_torch.utils.profiling import trace
    req = graph_request(pipe, mpnet, device)
    eager, graph = pipe.with_unet(pipe.unet), pipe.with_unet(pipe.unet)
    with torch.inference_mode():
        arch, _ = pipe.route(pipe.encode_prompt(req["ids"][:1]), req["feats"][:1],
                             req["noise"][:1])
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    graph.prepare_denoise(STEPS, GUIDANCE, (GRAPH_PROMPTS,), arch=arch)
    capture_s = time.perf_counter() - t0
    pool_bytes = torch.cuda.memory_allocated() - held
    programs = programs_of([graph._denoise_cache])
    seconds = {"eager": [], "captured": []}
    peaks, bits, counts_differ = {}, [], []
    captured_counts = collections.Counter()
    for turn in range(GRAPH_TURNS):
        got = {}
        for mode, p in (("eager", eager), ("captured", graph)):
            torch.cuda.reset_peak_memory_stats()
            images, indices, s, counts = routed_call(p, req)
            peaks[mode] = max(peaks.get(mode, 0), torch.cuda.max_memory_allocated())
            seconds[mode].append(s)
            got[mode] = (images, indices, counts)
        bits.append(same_bits("routed pipeline", got["eager"][0], got["captured"][0]))
        captured_counts.update(got["captured"][2])
        if not torch.equal(got["eager"][1], got["captured"][1]):
            fail(f"captured routing differs: {got['eager'][1]} against {got['captured'][1]}")
        if wrapper_counts(got["eager"][2]) != wrapper_counts(got["captured"][2]):
            counts_differ.append([got["eager"][2], got["captured"][2]])
    if counts_differ:
        fail(f"replayed launch counts differ from the eager ones: {counts_differ[0]}")
    if replays(programs) != GRAPH_TURNS:
        fail(f"{GRAPH_TURNS} captured requests replayed {replays(programs)} graphs")
    # two back-to-back calls on different inputs do not alias
    with torch.inference_mode():
        pe, ne = graph.encode_prompt(req["ids"]), graph.encode_prompt(req["neg"])
        rows = arch.repeat(GRAPH_PROMPTS, 1)
        before = launch_counts()
        first = graph.denoise(None, pe, ne, rows, STEPS, GUIDANCE, latents=req["latents"])
        kept = first.clone()
        second = graph.denoise(None, pe, ne, rows, STEPS, GUIDANCE, latents=req["latents2"])
        captured_counts.update({k: v - before[k] for k, v in launch_counts().items()})
        want = eager.denoise(None, pe, ne, rows, STEPS, GUIDANCE, latents=req["latents2"])
    aliasing = {"first_unchanged": bool(torch.equal(first, kept)),
                "outputs_differ": not bool(torch.equal(first, second)),
                "second_vs_eager": same_bits("second call", want, second)}
    if not (aliasing["first_unchanged"] and aliasing["outputs_differ"]):
        fail(f"back-to-back captured calls alias: {aliasing}")
    # one captured request under the profiler (utils.profiling.trace)
    t_trace = time.perf_counter()
    with trace(GRAPH_TRACE_DIR) as prof:
        t0 = time.perf_counter()
        captured_counts.update(routed_call(graph, req)[3])
        wall_ms = (time.perf_counter() - t0) * 1e3
    profiled = device_kernel_times(prof, wall_ms)
    import shutil
    shutil.rmtree(GRAPH_TRACE_DIR, ignore_errors=True)
    trace_s = time.perf_counter() - t_trace
    row = {"phase": "graphs_pipeline", "prompts": GRAPH_PROMPTS, "resolution": 256,
           "steps": STEPS, "guidance": GUIDANCE, "graphs": len(programs),
           "capture_seconds": capture_s, "graph_pool_bytes": pool_bytes,
           "seconds": seconds,
           "img_per_sec": {k: GRAPH_PROMPTS / statistics.median(v) for k, v in seconds.items()},
           "peak_memory_gib": {k: v / 2 ** 30 for k, v in peaks.items()},
           "bits": bits, "aliasing": aliasing,
           "captured_request_profile": {"wall_ms": wall_ms, "seconds_with_trace": trace_s,
                                        "device_kernel_ms": profiled["device_kernel_ms"],
                                        "device_busy_share": profiled["device_busy_share"],
                                        "kernel_ms_by_category": profiled[
                                            "kernel_ms_by_category"]},
           "eager_request_busy_share_phase6": eager_busy_share}
    emit(row)
    return row, arch, captured_counts


def server_programs(server):
    """{(owner, tier): program} of every program the server's warm-up
    prepared: owner an expert's index as a string, or "pooled" for the gated
    U-Net's (hybrid's pooled remainders), as `tier_plans` names them. A
    dispatch holds its programs in the order of `batch_shapes`."""
    from diffusion_pruning_tpu_torch.pipelines import aot
    caches = {**{str(e): c for e, c in server._expert_caches.items()},
              "pooled": server.base_pipeline._denoise_cache}
    return {(owner, tier): p for owner, cache in caches.items() for d in cache.values()
            if isinstance(d, aot.ShapeDispatch) for tier, p in zip(server.batch_shapes,
                                                                    d.programs)}


def graph_server_cell(server, requests, warm):
    """Phase 12's server and the graphs its warm-up captured (`warm`: the
    warm-up's result, seconds and pool bytes): its 16 steered prompts eager
    and captured in turns, in experts and hybrid modes. A captured turn
    replays each program as often as its tier plan runs it, and no other.
    Returns the row and the launches of the captured turns."""
    import torch
    from diffusion_pruning_tpu_torch.pipelines import aot
    programs = server_programs(server)
    n_graphs = sum(isinstance(p, aot.CapturedProgram) for p in programs.values())
    if n_graphs != warm["built"] or len(programs) != warm["built"]:
        fail(f"warmup built {warm['built']} programs, {n_graphs} of them graphs")
    seconds = {f"{m}_{k}": [] for m in ("experts", "hybrid") for k in ("eager", "captured")}
    peaks, bits = {}, {"experts": [], "hybrid": []}
    captured_counts = collections.Counter()
    t0 = time.perf_counter()
    for turn in range(GRAPH_TURNS):
        for mode, hybrid in (("experts", False), ("hybrid", True)):
            got = {}
            for kind in ("eager", "captured"):
                before = launch_counts()
                torch.cuda.reset_peak_memory_stats()
                played = {k: p.replays for k, p in programs.items()}
                if kind == "eager":
                    with eager_programs(server):
                        row, images = serve_queue(server, requests, hybrid, "graphs_server_turn")
                else:
                    row, images = serve_queue(server, requests, hybrid, "graphs_server_turn")
                peaks[kind] = max(peaks.get(kind, 0), torch.cuda.max_memory_allocated())
                ran = {f"{o}@{t}": p.replays - played[(o, t)] for (o, t), p in programs.items()
                       if p.replays != played[(o, t)]}
                want = {} if kind == "eager" else dict(collections.Counter(
                    f"{o}@{t}" for o, plan in row["tiers"].items() for t, _ in plan))
                if ran != want:
                    fail(f"{mode} {kind}: replays by (owner, tier) {ran}, its tier plans "
                         f"{want}")
                seconds[f"{mode}_{kind}"].append(row["seconds"])
                delta = {k: v - before[k] for k, v in launch_counts().items()}
                if kind == "captured":
                    captured_counts.update(delta)
                got[kind] = (row, images, delta)
            bits[mode].append(same_bits(f"served {mode}", got["eager"][1], got["captured"][1]))
            if got["eager"][0]["routes"] != got["captured"][0]["routes"]:
                fail(f"captured serving routed otherwise: {got['eager'][0]['routes']} against "
                     f"{got['captured'][0]['routes']}")
            if wrapper_counts(got["eager"][2]) != wrapper_counts(got["captured"][2]):
                fail(f"replayed launch counts differ from the eager ones ({mode}): "
                     f"{got['eager'][2]} against {got['captured'][2]}")
    turns_s = time.perf_counter() - t0
    row = {"phase": "graphs_server", "prompts": EXPERT_PROMPTS, "resolution": 256,
           "steps": STEPS, "guidance": GUIDANCE,
           "warmup": {k: warm[k] for k in ("loaded", "built")},
           "warmup_seconds_phase12": warm["seconds"],
           "graphs": n_graphs, "graph_pool_bytes": warm["graph_pool_bytes"],
           "turns_seconds": turns_s,
           "seconds": seconds,
           "img_per_sec": {k: EXPERT_PROMPTS / statistics.median(v) for k, v in seconds.items()},
           "peak_memory_gib": {k: v / 2 ** 30 for k, v in peaks.items()}, "bits": bits}
    emit(row)
    return row, captured_counts


def graph_variants_cell(pipe, mpnet, twins, arch, device):
    """One captured request under `fused_norm_conv`, one under `fused_norms`,
    and one each under PNDM and DPM++ (whose history and per-step floats are
    host state at capture), each against the eager request on the same
    inputs. Returns the readings and the launches of the captured
    requests."""
    req = graph_request(pipe, mpnet, device)
    out, captured_counts = {}, collections.Counter()
    for flag in ("fused_norm_conv", "fused_norms", "pndm", "dpm++"):
        if flag in twins:
            eager = fused_pipeline(pipe, twins[flag], device)
        else:
            eager = pipe.with_unet(pipe.unet)
            eager.sampler = flag
        graph = eager.with_unet(eager.unet)
        graph.prepare_denoise(STEPS, GUIDANCE, (GRAPH_PROMPTS,), arch=arch)
        e_img, _, e_s, e_counts = routed_call(eager, req)
        c_img, _, c_s, c_counts = routed_call(graph, req)
        if wrapper_counts(e_counts) != wrapper_counts(c_counts):
            fail(f"replayed launch counts differ under {flag}: {e_counts} against {c_counts}")
        captured_counts.update(c_counts)
        out[flag] = {"seconds": {"eager": e_s, "captured": c_s},
                     "bits": same_bits(f"routed pipeline under {flag}", e_img, c_img),
                     "launches_a_request": {k: v for k, v in c_counts.items() if v}}
    emit({"phase": "graphs_variants", **out})
    return out, captured_counts


def graph_serving(pipe, mpnet, server, requests, warm, twins, eager_busy_share, device):
    """Phase 19, cell sd21-256-graphs (run after phase 12, on its server and
    the graphs its warm-up captured, `warm`): the routed pipeline and the
    expert server eager and through captured CUDA graphs in turns, and one
    captured request under each fused flag. Returns the summary and the
    launches of the captured calls (the graphs' replays) alone."""
    import torch
    torch.backends.cudnn.allow_tf32 = True  # serving as phase 5 serves
    t0 = time.perf_counter()
    pipe_row, arch, counts = graph_pipeline_cell(pipe, mpnet, eager_busy_share, device)
    parts = {"pipeline": time.perf_counter() - t0}
    t0 = time.perf_counter()
    server_row, server_counts = graph_server_cell(server, requests, warm)
    parts["server"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    variants, variant_counts = graph_variants_cell(pipe, mpnet, twins, arch, device)
    parts["variants"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = counts + server_counts + variant_counts
    server.base_pipeline._denoise_cache.clear()  # the gated graphs; later phases run eager
    torch.backends.cudnn.allow_tf32 = False
    summary = {"phase": "graphs_summary", "seconds_by_part": parts,
               "pipeline_img_per_sec": pipe_row["img_per_sec"],
               "server_img_per_sec": server_row["img_per_sec"],
               "warmup_seconds_phase12": warm["seconds"], "graphs": server_row["graphs"],
               "busy_share": {"captured": pipe_row["captured_request_profile"][
                   "device_busy_share"], "eager_phase6": eager_busy_share},
               "all_bit_equal": all(b["bit_equal"] for b in (
                   *pipe_row["bits"], *server_row["bits"]["experts"],
                   *server_row["bits"]["hybrid"], *(v["bits"] for v in variants.values()))),
               "captured_launches": {k: v for k, v in counts.items() if v}}
    emit(summary)
    return summary, counts


def convergence_cell(device):
    """Phase 19, cell sd21-256-convergence: `cli.convergence_run` at SD-2.1
    width on the JAX docstring's smoke schedule, in this process; C1-C5
    are readings. Returns the row and its launches."""
    import torch
    from diffusion_pruning_tpu_torch.cli import convergence_run
    reset_launch_counts()
    t0 = time.perf_counter()
    summary = convergence_run.run([*CONVERGENCE_ARGS, "--run_dir", CONVERGENCE_DIR])
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = launch_counts()
    torch.cuda.empty_cache()
    for name in ("CONVERGENCE_SUMMARY.json", "metrics.jsonl"):
        if not os.path.exists(os.path.join(CONVERGENCE_DIR, name)):
            fail(f"the convergence run wrote no {name}")
    steps, vals = metrics_lines(CONVERGENCE_DIR)
    losses = [r["loss"] for r in steps] + [r["val_loss"] for r in vals]
    if not losses or not all(math.isfinite(v) for v in losses):
        fail(f"the convergence run logged no loss or a non-finite one: {losses}")
    training = ("gated_flash_fwd_lse", "gated_flash_bwd_fused", "gated_flash_bwd_dq",
                "gated_flash_bwd_dkv")
    if not all(counts[k] > 0 for k in training):
        fail(f"the convergence run launched no training kernel: {counts}")
    row = {"phase": "convergence_run", "args": list(CONVERGENCE_ARGS), "seconds": seconds,
           "criteria": {k: v["pass"] for k, v in summary["checks"].items()},
           "all_pass": summary["all_pass"], "p_actual": summary["p_actual"],
           "resource_ratio": summary["checks"]["C1_resource_ratio_converges"],
           "pool_assignment": summary["pool_assignment"],
           "stage1_samples_per_sec": summary["samples_per_sec"],
           "expert_finetune": summary["checks"]["C5_expert_finetune_distill_decreases"],
           "launches": {k: v for k, v in counts.items() if v}}
    emit(row)
    return row, counts


def replay_cell(stage1):
    """Phase 19, cell sd21-256-replay: `cli.replay_chain` on phase 13's
    SD-2.1-width folders and phase 15's tokenizer files, each link a
    subprocess of the port's entry points on the card: every link exits 0
    and the metric values are finite. Returns the row."""
    weights = stage1["weights"]
    out_json = os.path.join(REPLAY_DIR, "REPLAY_RESULTS.json")
    cmd = [sys.executable, "-m", "diffusion_pruning_tpu_torch.cli.replay_chain",
           "--workspace", REPLAY_DIR, *REPLAY_ARGS, "--device", "cuda",
           "--pretrained_model_name_or_path", weights,
           "--prompt_encoder_model_name_or_path", os.path.join(weights, "mpnet"),
           "--out_json", out_json]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=REPLAY_TIMEOUT)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"the replay chain exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-6000:]}")
    with open(out_json) as f:
        results = json.load(f)
    values = [r.get(k) for r in results["per_expert"].values()
              for k in ("fid_stub", "clip_score_tiny", "cmmd_tiny")]
    if not values or not all(isinstance(v, float) and math.isfinite(v) for v in values):
        fail(f"the replay chain's metric values are not finite: {results['per_expert']}")
    row = {"phase": "replay_chain", "args": list(REPLAY_ARGS), "seconds": seconds,
           "links": len(results["chain"]),
           "seconds_by_link": {t["step"]: t["seconds"] for t in results["chain"]},
           "train_counts": results["train_counts"], "val_counts": results["val_counts"],
           "per_expert": results["per_expert"]}
    emit(row)
    return row


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
    took("phase 2", t0)

    # 3. kernel vs plain version
    t0 = time.perf_counter()
    rows, worst = check_attention_kernel(device)
    emit({"phase": "kernel_check_summary", "limit": REL_L2, **worst})
    took("phase 3", t0)

    # 4. U-Net at full width, kernel vs plain attention
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    unet = build_unet(UNetConfig.sd21(256), device, gen)
    check_unet(unet, device)
    took("phase 4", t0)

    # 5. routed serving (TF32 back to PyTorch's defaults)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    log("phase 5 runs with PyTorch's TF32 defaults (cuDNN on, matmul off)")
    t0 = time.perf_counter()
    pipe, mpnet = build_pipeline(unet, device, gen)
    calls, serve_counts = serve(pipe, mpnet, device)
    launches = serve_counts["gated_flash_fwd"]
    took("phase 5", t0)
    s256 = sorted(c["seconds"] for c in calls[1:4])
    emit({"phase": "serving_summary", "img_per_sec_256px_median": 8 / s256[1],
          "seconds_256px_min_median_max": s256, "seconds_512px": calls[5]["seconds"]})

    # 6. one more call under the profiler
    t0 = time.perf_counter()
    eager_profile = profile_call(pipe, mpnet, device)
    took("phase 6", t0)

    # 7. training kernels vs their plain versions (TF32 off for the references)
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    train_rows, train_check = check_training_kernels(device)
    emit({"phase": "training_kernel_check_summary", **train_check})
    emit(backward_summary(train_rows))
    emit(small_forward_summary(train_rows))
    took("phase 7", t0)

    # 8. the stage-1 train step at full width
    t0 = time.perf_counter()
    mods, cfg, opt = build_trainer(pipe, device, gen)
    initial = trainable_state(mods)  # phase 16 starts from these trainables
    batch, train_summary = train(mods, cfg, opt, device)
    check_train_grads(mods, cfg, batch, device)
    profile_train_step(mods, cfg, opt, batch, device)
    took("phase 8", t0)

    # 9. fused-norm kernels vs their plain versions (TF32 stays off for matmuls
    # and cuDNN: the f32 references of phases 9-10 run in full f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    fused_checks = check_fused_kernels(unet, device)
    check_expert_channels(device)
    check_poisoned_workspaces(device)
    took("phase 9", t0)

    # 10. the U-Net under each fused flag
    t0 = time.perf_counter()
    twins, _ = check_fused_unet(unet, device)
    took("phase 10", t0)

    # 11. serving and two train steps under the fused flags; the VAE and CLIP,
    # which phase 8 turned to bf16, serve in f32 again as in phase 5
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    pipe.vae.float()
    pipe.text_encoder.float()
    fused_serving, counts_gn, counts_nc = serve_fused(pipe, mpnet, twins, device)
    torch.backends.cudnn.allow_tf32 = False
    fused_train = train_fused(pipe, twins, device, gen)
    took("phase 11", t0)

    # 12. expert serving: the VAE and CLIP, which phase 11's train steps turned
    # to bf16, serve in f32 again
    t0 = time.perf_counter()
    pipe.vae.float()
    pipe.text_encoder.float()
    expert_serving, expert_counts, expert_check, server, requests = serve_experts(
        pipe, mpnet, unet, device)
    took("phase 12", t0)

    # 19, cell sd21-256-graphs (here, on phase 12's server while it is held):
    # the routed pipeline and the server eager and through CUDA graphs in turns
    t0 = time.perf_counter()
    graphs, graph_counts = graph_serving(pipe, mpnet, server, requests, expert_serving["warmup"],
                                         twins, eager_profile["device_busy_share"], device)
    del server, requests
    torch.cuda.empty_cache()
    graph_seconds = time.perf_counter() - t0
    took("phase 19 (sd21-256-graphs)", t0)

    # 13. stage 1 as a program (the prune entry point twice, from checkpoint
    # folders at full width) and the rest of the pipeline
    import shutil
    try:
        t0 = time.perf_counter()
        stage1, cli_counts = stage1_program(pipe, mpnet, device)
        took("phase 13", t0)

        # 14. stage 2 as a program: the finetune entry point twice at full
        # width from phase 13's stage-1 run, and the magnitude baseline
        t0 = time.perf_counter()
        stage2, ft_counts = check_finetune_runs(stage1["weights"], stage1["run_dir"], device)
        took("phase 14", t0)

        # 15. the pipeline on a dataset folder: stage 1, routing, the latent
        # cache and stage 2 through the entry points on phase 13's weights
        t0 = time.perf_counter()
        data, data_counts = data_path(stage1["weights"], device)
        took("phase 15", t0)

        # 16. data parallel: world 1 under NCCL, two ranks sharing the card
        # under gloo, the entry points at world 2, on phase 8's models and
        # phase 13's and 14's weights, run and expert
        t0 = time.perf_counter()
        dp, dp_counts = data_parallel(mods, cfg, initial, stage1, device)
        took("phase 16", t0)

        # 17. evaluation and serving through the entry points: cli.serve in
        # turns, the generation CLIs, the metric CLIs on random towers
        t0 = time.perf_counter()
        evaluation, eval_counts = eval_and_serve(stage1, device)
        took("phase 17", t0)

        # 18. tensor parallel: the sharded U-Net, pipeline and expert server on
        # a 1 × 2 mesh and cli.finetune on a 2 × 2 one, ranks sharing the card
        t0 = time.perf_counter()
        tensor_par, tp_counts = tensor_parallel(stage1, device)
        took("phase 18", t0)

        # 19, cells sd21-256-convergence and sd21-256-replay: the convergence
        # run in this process, the replay chain's links as subprocesses
        t0 = time.perf_counter()
        convergence, convergence_counts = convergence_cell(device)
        took("phase 19 (sd21-256-convergence)", t0)
        t1 = time.perf_counter()
        replay = replay_cell(stage1)
        took("phase 19 (sd21-256-replay)", t1)
        graph_seconds += time.perf_counter() - t0
        log(f"phase 19 took {graph_seconds:.1f}s in all")
    finally:
        shutil.rmtree(STAGE1_DIR, ignore_errors=True)

    # kernels line: inference times summed over the sites of one 256px
    # forward (B_eff 16) that each forward kernel serves (`forward_plan`),
    # training times over the sites of one student pass of the train step
    # (B = 64)
    train_launches = train_summary["launches"]
    ft_totals = {b: r["totals_over_sites"] for b, r in stage2["kernels_at_expert_shapes"].items()}
    forward_entries = [
        forward_entry(name, rows, train_rows, worst, train_check, serve_counts, train_launches,
                      expert_counts, expert_check, cli_counts, ft_counts, ft_totals, data_counts,
                      dp_counts, eval_counts, tp_counts)
        for name in ("gated_flash_fwd_wgmma", "gated_flash_fwd_small")]
    kernels = [*forward_entries,
               *backward_entries(train_rows, train_check, train_launches, cli_counts, ft_counts,
                                 ft_totals, data_counts, dp_counts, tp_counts),
               fused_kernel_entry(
        fused_checks["group_norm_silu"], "group_norm_silu",
        "diffusion_pruning_tpu_torch/csrc/group_norm.cu",
        "diffusion_pruning_tpu/ops/group_norm.py:26", [], "F.group_norm, then F.silu",
        {"serving_fused_norms": counts_gn["group_norm_silu"], "dp": dp_counts["group_norm_silu"],
         "tp": tp_counts["group_norm_silu"]},
        expert_check["fused_kernel_device_ms_mean"]["fused_norms"]),
        fused_kernel_entry(
        fused_checks["norm_conv3x3"], "norm_conv3x3",
        "diffusion_pruning_tpu_torch/csrc/norm_conv.cu",
        "diffusion_pruning_tpu/ops/norm_conv.py:98",
        ["diffusion_pruning_tpu/ops/norm_conv.py:140"],
        "gate multiply, F.group_norm, F.silu, F.conv2d (channels_last, bf16)",
        {"serving_fused_norm_conv": counts_nc["norm_conv3x3"],
         "train_fused_norm_conv": fused_train["launches"]["norm_conv3x3"],
         "dp": dp_counts["norm_conv3x3"], "tp": tp_counts["norm_conv3x3"]},
        expert_check["fused_kernel_device_ms_mean"]["fused_norm_conv"]),
        fused_kernel_entry(
        fused_checks["norm_linear"], "norm_linear",
        "diffusion_pruning_tpu_torch/csrc/norm_conv.cu",
        "diffusion_pruning_tpu/ops/norm_conv.py:279", [], "F.group_norm, then F.linear",
        {"serving_fused_norm_conv": counts_nc["norm_linear"],
         "train_fused_norm_conv": fused_train["launches"]["norm_linear"],
         "dp": dp_counts["norm_linear"], "tp": tp_counts["norm_linear"]},
        expert_check["fused_kernel_device_ms_mean"]["fused_norm_conv"]),
        {"name": "conv_split_reduce", "route": "cuda",
         "source": "diffusion_pruning_tpu_torch/csrc/norm_conv.cu",
         "replaces": "diffusion_pruning_tpu/ops/norm_conv.py:98",
         "role": "the fixed-order sum of the K slices of norm_conv3x3 and norm_linear where "
                 "their plans split K (a split linear site's ms includes it)",
         "launches": (counts_nc["conv_split_reduce"]
                      + fused_train["launches"]["conv_split_reduce"]
                      + dp_counts["conv_split_reduce"] + tp_counts["conv_split_reduce"]),
         "launches_by_path": {"serving_fused_norm_conv": counts_nc["conv_split_reduce"],
                              "train_fused_norm_conv":
                                  fused_train["launches"]["conv_split_reduce"],
                              "dp": dp_counts["conv_split_reduce"],
                              "tp": tp_counts["conv_split_reduce"]},
         **split_reduce_entry(fused_checks["norm_conv3x3"]),
         "expert_path": expert_path_entry(
             expert_check["fused_kernel_device_ms_mean"]["fused_norm_conv"], "conv_split_reduce"),
         "shapes": "the split conv sites of one SD-2.1 U-Net forward at 256px, B_eff 16"},
    ]
    for k in kernels:  # phase 19: the graphs' replays, and the convergence run
        key = f"kernel:{k['name']}" if k["name"].startswith("gated_flash_fwd_") else k["name"]
        for path, counts in (("graphs", graph_counts), ("convergence", convergence_counts)):
            k["launches_by_path"][path] = counts.get(key, 0)
            k["launches"] += counts.get(key, 0)
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
        f"{stage1['cli_steps_per_sec']}; finetune step (B = {FT_B}, expert "
        f"{stage2['expert']}, MACs {stage2['macs_ratio']:.3f}; median of "
        f"{stage2['warm_steps']} warm steps) "
        f"{stage2['seconds_per_step_median_warm']:.4f} s ({stage2['samples_per_sec']:.2f} "
        f"samples/s), CLI steps/s {stage2['cli_steps_per_sec']}; on the dataset folder "
        f"(decoder {data['decoder']}) the loader "
        f"{ {k: round(v['batches_per_sec'], 3) for k, v in data['loader'].items()} } batches/s "
        f"at B = {TRAIN_B}, stage-1 CLI steps/s {data['stage1_cli_steps_per_sec']} against "
        f"the step's {data['stage1_step_steps_per_sec']}; data parallel (two ranks sharing "
        f"the card, gloo) stage-1 grads min cosine "
        f"{min(st['min_cos'] for st in dp['two_ranks']['steps']):.6f}, ZeRO-1 moments a rank "
        f"{dp['summary']['moment_bytes_by_rank_world2']} bytes against "
        f"{dp['summary']['moment_bytes_world1']} at world 1; cli.serve img/s by mode "
        f"{evaluation['serve_img_per_sec_by_mode']}, generation images/s "
        f"{evaluation['generation_images_per_sec']}; tensor parallel (ranks sharing the card, "
        f"gloo) forward rel L2 "
        f"{max(r['forward_rel_l2'] for r in tensor_par['serve']['ranks']):.5f}, 2 × 2 finetune "
        f"update min cosine {tensor_par['finetune']['update_cos_min']:.5f}; CUDA graphs: "
        f"pipeline img/s {graphs['pipeline_img_per_sec']}, server img/s "
        f"{graphs['server_img_per_sec']}, {graphs['graphs']} graphs warmed in "
        f"{graphs['warmup_seconds_phase12']:.1f} s, bit-equal {graphs['all_bit_equal']}; convergence "
        f"criteria {convergence['criteria']}; replay chain {replay['links']} links in "
        f"{replay['seconds']:.1f} s")
    # last line
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_worker(*sys.argv[2:5])
    elif sys.argv[1:2] == ["--tp-rank"]:
        tp_worker(*sys.argv[2:6])
    else:
        main()
