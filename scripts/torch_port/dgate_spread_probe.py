#!/usr/bin/env python3
"""How far the backward kernels' gate gradient lies from its plain versions,
on one CUDA card, from the root of a checkout:

    python3 scripts/torch_port/dgate_spread_probe.py [--gradients 300]

`tests/test_torch_port_cuda.py::test_cuda_training_kernels_match_plain_versions`
draws its output gradient from the unseeded global generator. For each shape
of that test (its q, k, v and gate, from its seeds), this draws `--gradients`
seeded output gradients and reads max over (batch, head) of
|dgate − reference| / RMS (the head's RMS f32 dgate over the batch) for

* `kernel_vs_f32`: the kernels (`gated_flash_backward` on the forward's own
  o and lse) against the f32 plain backward;
* `bf16_vs_f32`: the plain backward with P and dS rounded to bf16 before
  their products, as the kernels round them (`bf16_products=True`), against
  the f32 one: what a sound bf16 implementation reads;
* `kernel_vs_bf16`: the kernels against that rounded plain backward, the
  test's metric (limit DGATE_BF16_REL there).

One JSON line a shape: the median, 99th percentile and maximum of each, and
how many gradients read above `--limit` (default: the test's). Imports only
torch and the port.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

# the card test's shapes (S_q, S_kv, heads) at B = 4
SHAPES = ((1024, 1024, 5), (1024, 77, 5), (256, 256, 10), (256, 77, 10), (64, 64, 20),
          (64, 77, 20), (16, 16, 20), (16, 77, 20), (100, 77, 3), (200, 200, 3), (100, 80, 3),
          (100, 81, 3), (100, 128, 3), (100, 129, 3), (40, 50, 3))


def test_inputs(b, s_q, s_kv, h, seed):
    """The card test's q, k, v and gate (`_inputs` there)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, 64, device="cuda", generator=g).bfloat16()
               for s in (s_q, s_kv, s_kv))
    gate = torch.rand(b, h, device="cuda", generator=g)
    gate[0, 0] = 0.0
    return q, k, v, gate


def spread(readings, limit):
    r = sorted(readings)
    return {"median": r[len(r) // 2], "p99": r[min(len(r) - 1, int(0.99 * len(r)))],
            "max": r[-1], "above_limit": sum(x > limit for x in r)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gradients", type=int, default=300)
    ap.add_argument("--limit", type=float, default=1e-2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, os.getcwd())
    from diffusion_pruning_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    b = 4
    for s_q, s_kv, h in SHAPES:
        q, k, v, gate = test_inputs(b, s_q, s_kv, h, seed=s_q * h + s_kv)
        qf, kf, vf = q.float(), k.float(), v.float()
        o, lse = fa.gated_flash_forward_lse(q, k, v, gate)
        gen = torch.Generator(device="cuda").manual_seed(1)
        readings = {"kernel_vs_f32": [], "bf16_vs_f32": [], "kernel_vs_bf16": []}
        for _ in range(args.gradients):
            do = torch.randn(q.shape, device="cuda", generator=gen).bfloat16()
            dgate = fa.gated_flash_backward(q, k, v, gate, o, lse, do)[3]
            ref, bf16 = (fa.gated_flash_backward_reference(qf, kf, vf, gate, o.float(), lse,
                                                           do.float(), bf16_products=r)[3]
                         for r in (False, True))
            rms = ref.square().mean(dim=0).sqrt()
            for key, (a, r) in (("kernel_vs_f32", (dgate, ref)), ("bf16_vs_f32", (bf16, ref)),
                                ("kernel_vs_bf16", (dgate, bf16))):
                readings[key].append(((a - r).abs() / rms).max().item())
        print(json.dumps({"b": b, "s_q": s_q, "s_kv": s_kv, "h": h,
                          "gradients": args.gradients, "limit": args.limit,
                          **{k: spread(v, args.limit) for k, v in readings.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
