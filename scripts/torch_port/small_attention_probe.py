#!/usr/bin/env python3
"""Where the time of the gated flash forward at S_q <= 64 goes, on one CUDA
card, from the root of a checkout:

    python3 scripts/torch_port/small_attention_probe.py [--package-root DIR]

It times, through the port's own wrappers:

* the forward (`gated_flash_attention`) at S_q in {16, 64}, S_kv in
  {16, 64, 77}, B_eff in {4, 16, 64}, 20 heads, soft gates: the device time
  (a CUDA graph of back-to-back launches on one input, `device_ms` of
  chip_smoke.py), the cold time (`cold_device_ms`: the operands cycled
  through more than twice the L2), the eager time (`time_ms`), the host's
  time per call (the median over five runs of 2,000 calls issued back to
  back, wall clock to a synchronise: the card finishes each launch before
  the host has issued the next, so the reading is the wrapper's own cost),
  the byte bound, and the relative L2 per (batch, head) against the f32
  plain version; the training forward with lse (`gated_flash_forward_lse`)
  at B = 64;
* the sums over the 12 sites of one 256px U-Net forward at B_eff 16 (5 at
  64/64, 5 at 64/77, 1 at 16/16, 1 at 16/77), and the same with lse at B = 64;
* two floors in graph replay at every shape: an empty kernel (one block a
  b·h item, as the forward's grid) and a copy kernel that reads q, k and v
  and writes o with 16-byte loads and stores, built from the source below
  with the port's nvcc flags into `build/probe/`;
* where the package has `forward_plan` (this tree), the S_q <= 64 kernel
  under other plan choices than the plan's: kv tile (16, 64, 80, whichever
  holds S_kv) and grids of two blocks per SM, one, or fewer.

`--package-root DIR` imports `diffusion_pruning_tpu_torch` from another
checkout (an unpacked parent commit), so that its kernels are timed by the
same script in the same call; the plan section then runs only if that
package has the plan.

`--host-cost DIR` measures only the host's cost of the forward wrapper, this
checkout's package against DIR's (an unpacked parent commit), both loaded in
one process: `--turns` groups of four turns, DIR, this, this, DIR in even
groups and the reverse in odd ones; each turn sums over the 12 sites at
B_eff 16 the host µs a call (as above, 2,000 calls, median of three runs),
the eager time (`time_ms` over 200 calls), and the host's µs to issue one
call (400 calls timed to the last issue, median of nine runs) of the
wrapper, of `build.launch` with the wrapper's arguments and of the bare C
entry point; then the medians of each arm, each group's difference, and the
host's cost of one `cuTensorMapEncodeTiled` call (a 4-D map of the shape of
q at 64/77, encoded 100,000 times in a loop in C).

One JSON object a line on stdout; the card's name and power limit come
first. Exits non-zero without a CUDA card."""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = [(s_q, s_kv, b) for b in (4, 16, 64) for s_q in (16, 64) for s_kv in (16, 64, 77)]
SITES_256 = {(64, 64): 5, (64, 77): 5, (16, 16): 1, (16, 77): 1}  # at B_eff 16, 20 heads
HEADS = 20

FLOOR_SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_common.cuh"

__global__ void empty_kernel() {}

// o[b, s, h, :] = q[b, s, h, :] + k[b, 0, h, :] + v[b, 0, h, :], one block a
// (b, h), every row of q, k and v read once with 16-byte loads
__global__ void copy_kernel(const uint4* q, const uint4* k, const uint4* v, uint4* o, int H,
                            int Sq, int Skv) {
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  uint4 acc = make_uint4(0, 0, 0, 0);
  for (int c = threadIdx.x; c < Skv * 8; c += blockDim.x) {
    const long off = (((long)b * Skv + c / 8) * H + h) * 8 + c % 8;
    const uint4 x = k[off], y = v[off];
    acc.x ^= x.x ^ y.x;
    acc.y ^= x.y ^ y.y;
    acc.z ^= x.z ^ y.z;
    acc.w ^= x.w ^ y.w;
  }
  for (int c = threadIdx.x; c < Sq * 8; c += blockDim.x) {
    const long off = (((long)b * Sq + c / 8) * H + h) * 8 + c % 8;
    uint4 x = q[off];
    x.x ^= acc.x & 1u;  // keeps the kv reads live; o equals q unless a kv word is odd
    o[off] = x;
  }
}

// encodes the 4-D map of a (B, S, H, 64) bf16 tensor `n` times; 0 if every
// encoding succeeded
extern "C" int floor_encode(const void* t, int B, int S, int H, int rows, int n) {
  CUtensorMap map;
  int failed = 0;
  for (int i = 0; i < n; ++i) failed |= !sm90::bshd_map(&map, t, B, S, H, rows);
  return failed;
}

extern "C" int floor_empty(int blocks, void* stream) {
  empty_kernel<<<blocks, 384, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int floor_copy(const void* q, const void* k, const void* v, void* o, int B, int H,
                          int Sq, int Skv, void* stream) {
  copy_kernel<<<B * H, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(q), static_cast<const uint4*>(k), static_cast<const uint4*>(v),
      static_cast<uint4*>(o), H, Sq, Skv);
  return static_cast<int>(cudaGetLastError());
}
"""


def build_floors(build):
    """The floor kernels, compiled with the port's nvcc and flags."""
    out_dir = os.path.join(ROOT, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "floors.cu")
    lib = os.path.join(out_dir, "libfloors.so")
    with open(src, "w") as f:
        f.write(FLOOR_SOURCE)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", lib,
                           src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the floor kernels:\n{proc.stdout}")
    dll = ctypes.CDLL(lib)
    dll.floor_empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    dll.floor_copy.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    dll.floor_encode.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5
    return dll


def load_package(root):
    """(build, flash_attention) of the `diffusion_pruning_tpu_torch` under
    `root`, imported afresh: the modules of an earlier import stay bound to
    whoever already holds them."""
    for name in [m for m in sys.modules if m.startswith("diffusion_pruning_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(root))
    try:
        from diffusion_pruning_tpu_torch.ops import build
        from diffusion_pruning_tpu_torch.ops import flash_attention as fa
    finally:
        sys.path.pop(0)
    return build, fa


def host_us(fn, calls=2000, runs=5, to_issue=False):
    """Median over `runs` of the wall µs a call of `fn`, `calls` issued back to
    back, then a synchronise: timed to the synchronise, or with `to_issue` to
    the last issue (then keep `calls` below what the launch queue holds, so
    that the card never holds the host back)."""
    import torch
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        if not to_issue:
            torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def host_cost(cs, emit, parent_root, turns):
    """The `--host-cost` mode (module docstring)."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    arms = {"parent": load_package(parent_root), "new": load_package(ROOT)}
    for build, _ in arms.values():
        build.build_kernels()
    floors = build_floors(arms["new"][0])
    shapes = []
    for (s_q, s_kv), sites in SITES_256.items():
        q, k, v = (torch.randn(16, s, HEADS, 64, device=dev, generator=gen).bfloat16()
                   for s in (s_q, s_kv, s_kv))
        shapes.append((sites, q, k, v, torch.rand(16, HEADS, device=dev, generator=gen)))

    def launches(arm):
        """Each shape's (kernel, arguments) as the arm's wrapper launches it,
        recorded by standing in for `build.launch` once."""
        build, fa = arms[arm]
        real, out = build.launch, []
        build.launch = lambda name, device, *args: out.append((name, args))
        try:
            for _, q, k, v, gate in shapes:
                fa.gated_flash_attention(q, k, v, gate)
        finally:
            build.launch = real
        return out

    recorded = {arm: launches(arm) for arm in arms}
    stream = torch.cuda.current_stream().cuda_stream

    def turn(arm):
        """The arm's costs summed over the 12 sites: the wrapper (host µs a
        call with the card's time overlapped, as in the shape rows; the
        eager time; the host µs to issue it), `build.launch` with the
        wrapper's arguments, and the bare C entry point."""
        build, fa = arms[arm]
        row = {"probe": "host_turn", "arm": arm, "host_us_12_sites": 0.0,
               "eager_ms_12_sites": 0.0, "wrapper_issue_us_12_sites": 0.0,
               "launch_issue_us_12_sites": 0.0, "c_issue_us_12_sites": 0.0}
        for (sites, q, k, v, gate), (name, args) in zip(shapes, recorded[arm]):
            fn = build._fn(name)

            def call(q=q, k=k, v=v, gate=gate):
                return fa.gated_flash_attention(q, k, v, gate)
            row["host_us_12_sites"] += sites * host_us(call, runs=3)
            row["eager_ms_12_sites"] += sites * cs.time_ms(call, 200)
            issue = dict(calls=400, runs=9, to_issue=True)
            row["wrapper_issue_us_12_sites"] += sites * host_us(call, **issue)
            row["launch_issue_us_12_sites"] += sites * host_us(
                lambda name=name, args=args: build.launch(name, dev, *args), **issue)
            row["c_issue_us_12_sites"] += sites * host_us(
                lambda fn=fn, args=args: fn(*args, stream), **issue)
        return row

    keys = ("host_us_12_sites", "eager_ms_12_sites", "wrapper_issue_us_12_sites",
            "launch_issue_us_12_sites", "c_issue_us_12_sites")
    for arm in arms:  # warms both before the first timed turn
        turn(arm)
    every = {arm: [] for arm in arms}
    differences = []
    for g in range(turns):
        # parent, new, new, parent in even groups and the reverse in odd ones,
        # so that each arm takes each position equally often
        order = ("parent", "new", "new", "parent") if g % 2 == 0 else ("new", "parent",
                                                                         "parent", "new")
        group = {arm: [] for arm in arms}
        for arm in order:
            row = turn(arm)
            emit({**row, "group": g})
            group[arm].append(row)
            every[arm].append(row)
        differences.append({key: statistics.mean(r[key] for r in group["new"])
                            - statistics.mean(r[key] for r in group["parent"]) for key in keys})
    n = 100000
    q = shapes[1][1]  # q of 64/77
    t0 = time.perf_counter()
    failed = floors.floor_encode(q.data_ptr(), 16, 64, HEADS, 64, n)
    encode_us = (time.perf_counter() - t0) / n * 1e6
    emit({"probe": "host_cost", "groups": turns, "encode_failed": bool(failed),
          "encode_us_per_map": encode_us,
          **{f"{key}_median_{arm}": statistics.median(r[key] for r in rows)
             for arm, rows in every.items() for key in keys},
          **{f"{key}_difference_median": statistics.median(d[key] for d in differences)
             for key in keys},
          **{f"{key}_groups_new_above_parent": sum(d[key] > 0 for d in differences)
             for key in keys},
          "differences_new_minus_parent": differences})


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--package-root", default=ROOT,
                        help="checkout whose diffusion_pruning_tpu_torch is timed")
    parser.add_argument("--host-cost", metavar="DIR",
                        help="time only the wrapper's host cost, against DIR's package")
    parser.add_argument("--turns", type=int, default=10,
                        help="groups of four turns of --host-cost")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("small_attention_probe: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import chip_smoke as cs

    def emit(row):
        print(json.dumps(row), flush=True)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    package = args.host_cost or args.package_root
    emit({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "package": os.path.relpath(os.path.abspath(package), ROOT)})
    if args.host_cost:
        host_cost(cs, emit, args.host_cost, args.turns)
        return
    build, fa = load_package(args.package_root)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    build.build_kernels()
    floors = build_floors(build)
    has_plan = hasattr(fa, "forward_plan")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def inputs(b, s_q, s_kv):
        q, k, v = (torch.randn(b, s, HEADS, 64, device=dev, generator=gen).bfloat16()
                   for s in (s_q, s_kv, s_kv))
        gate = torch.rand(b, HEADS, device=dev, generator=gen)
        return q, k, v, gate

    def rel_l2(out, q, k, v, gate):
        return cs.per_head_rel_l2(out, cs.reference_f32(q, k, v, gate)).max().item()

    totals = {"ms": 0.0, "cold_ms": 0.0, "eager_ms": 0.0, "host_us": 0.0, "bound_ms": 0.0,
              "lse_ms": 0.0, "lse_cold_ms": 0.0, "lse_bound_ms": 0.0}
    for s_q, s_kv, b in SHAPES:
        q, k, v, gate = inputs(b, s_q, s_kv)
        o = torch.empty_like(q)

        def kernel():
            return fa.gated_flash_attention(q, k, v, gate)

        row = {"probe": "shape", "b": b, "s_q": s_q, "s_kv": s_kv, "h": HEADS,
               "kernel": fa.forward_plan(b, HEADS, s_q, s_kv).kernel if has_plan
               else fa.forward_kernel(s_q),
               "rel_l2_worst_head": rel_l2(kernel(), q, k, v, gate),
               "ms": cs.device_ms(kernel, 20),
               "cold_ms": cs.cold_device_ms(fa.gated_flash_attention, (q, k, v, gate),
                                            q.numel() * 2),
               "eager_ms": cs.time_ms(kernel, 20),
               "host_us": host_us(kernel),
               "bound_ms": cs.attention_bytes(b, HEADS, s_q, s_kv, 2) / cs.PEAK_BYTES * 1e3,
               "floor_empty_ms": cs.device_ms(lambda: floors.floor_empty(b * HEADS, stream()), 20),
               "floor_copy_ms": cs.device_ms(
                   lambda: floors.floor_copy(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             o.data_ptr(), b, HEADS, s_q, s_kv, stream()), 20)}
        if b == 64:
            def with_lse():
                return fa.gated_flash_forward_lse(q, k, v, gate)
            o_l, lse = with_lse()
            _, lse_r = fa.gated_attention_reference_lse(q.float(), k.float(), v.float(), gate)
            row.update(lse_max_abs=(lse - lse_r).abs().max().item(),
                       lse_rel_l2_worst_head=rel_l2(o_l, q, k, v, gate),
                       lse_ms=cs.device_ms(with_lse, 20),
                       lse_cold_ms=cs.cold_device_ms(fa.gated_flash_forward_lse,
                                                     (q, k, v, gate), q.numel() * 2),
                       lse_bound_ms=(cs.attention_bytes(b, HEADS, s_q, s_kv, 2)
                                     + 4.0 * b * HEADS * s_q) / cs.PEAK_BYTES * 1e3)
        sites = SITES_256.get((s_q, s_kv), 0)
        if b == 16:
            for key in ("ms", "cold_ms", "eager_ms", "host_us", "bound_ms"):
                totals[key] += sites * row[key]
        if b == 64:
            for key in ("lse_ms", "lse_cold_ms", "lse_bound_ms"):
                totals[key] += sites * row[key]
        emit(row)

        if not has_plan or s_q > fa.SMALL_Q_ROWS:
            continue
        plan = fa.forward_plan(b, HEADS, s_q, s_kv)
        if plan.kernel != "gated_flash_fwd_small":
            continue
        grids = sorted({plan.grid, min(plan.items, fa.SM_COUNT), -(-plan.items // 2),
                        -(-plan.items // 3)} & set(range(1, plan.items + 1)))
        choices = [(tile, grid) for tile in (16, 64, 80) if s_kv <= tile for grid in grids]
        for tile, grid in choices:
            def run(tile=tile, grid=grid):
                build.launch("gated_flash_fwd_small", dev, q.data_ptr(), k.data_ptr(),
                             v.data_ptr(), gate.data_ptr(), o.data_ptr(), None, b, HEADS, s_q,
                             s_kv, tile, grid, 0.125 * 1.4426950408889634)
                return o
            emit({"probe": "plan_choice", "b": b, "s_q": s_q, "s_kv": s_kv,
                  "kv_tile": tile, "grid": grid,
                  "is_plan": (tile, grid) == (plan.kv_tile, plan.grid),
                  "rel_l2_worst_head": rel_l2(run(), q, k, v, gate),
                  "ms": cs.device_ms(run, 20)})
        del q, k, v, o
        torch.cuda.empty_cache()
    emit({"probe": "unet_12_sites", "b_eff": 16, "lse_b": 64, **totals})


if __name__ == "__main__":
    main()
