#!/usr/bin/env python3
"""Where the time of the two fused-norm kernels goes, on one CUDA card, from
the root of a checkout:

    python3 scripts/torch_port/fused_norm_probe.py

It times, through the port's own wrappers and under their plans:

* `norm_linear` against C_in at a fixed M and N (B = 16, S = 1024,
  C_out = 320): time against the number of 64-channel K chunks;
* `norm_linear` with one block alone (M = 128, C_out = 64, so one output
  tile): the time of one block's K loop, no other block to hide it;
* `norm_linear` at the four proj_in shapes of the 256px U-Net (B_eff 16);
* `group_norm_silu` against C/G at a fixed HW (32×32, B = 16, 32 groups):
  achieved bytes/s against the memory rate;
* `group_norm_silu` at a fixed slab size against C/G (the bytes of a slab
  held at 80 KB);
* the 512px slab of 960 channels at 64×64 (B_eff 4), and B = 64 at 32×32;
* `group_norm_silu` at seven shapes under other plans than `group_norm_plan`
  gives (windows of more groups, other cluster sizes, 256 or 512 threads,
  the slab read by TMA or by 16-byte loads), and `norm_linear` under each
  split over K at its short-grid shapes (chip_smoke.py's sweep).

Each row gives the device time (a CUDA graph of back-to-back launches on one
input, `device_ms` of chip_smoke.py), the cold time (`cold_device_ms`: the
operands cycled through more than twice the L2) and the bound from bytes.
One JSON object a line on stdout; the card's name and power limit come
first. Exits non-zero without a CUDA card."""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

LINEAR_CIN = (64, 128, 256, 320, 640, 1280, 2560)
LINEAR_SITES = ((1024, 320), (256, 640), (64, 1280), (16, 1280))
GN_CG = ((320, 10), (640, 20), (960, 30), (1280, 40), (1920, 60), (2560, 80))


def main() -> None:
    if not torch.cuda.is_available():
        print("fused_norm_probe: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from diffusion_pruning_tpu_torch.ops import group_norm as gn
    from diffusion_pruning_tpu_torch.ops import norm_conv as nc

    def emit(row):
        print(json.dumps(row), flush=True)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    emit({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def linear_row(kind, b, s, cin, cout):
        x = torch.randn(b, s, cin, device=dev, generator=gen).bfloat16()
        a = 1.0 + 0.1 * torch.randn(b, cin, device=dev, generator=gen)
        sh = 0.1 * torch.randn(b, cin, device=dev, generator=gen)
        w = (torch.randn(cout, cin, device=dev, generator=gen) * cin ** -0.5).bfloat16()
        bias = torch.zeros(cout, device=dev)
        out = nc.norm_linear(x, a, sh, w, bias)
        ref = nc.norm_linear_plain(x.float(), a, sh, w.float(), bias)
        m = b * s
        nbytes = 2.0 * (m * cin + cin * cout + m * cout) + 8.0 * b * cin + 4.0 * cout
        row = {"probe": kind, "b": b, "s": s, "c_in": cin, "c_out": cout,
               "k_chunks": -(-cin // 64),
               "rel_l2": cs.per_sample_rel_l2(out, ref).max().item(),
               "ms": cs.device_ms(lambda: nc.norm_linear(x, a, sh, w, bias), 20),
               "cold_ms": cs.cold_device_ms(lambda *t: nc.norm_linear(*t, bias), (x, a, sh, w),
                                            2.0 * m * cout)}
        row["bound_ms"], row["bound_by"] = cs.bound_ms(2.0 * m * cin * cout, cs.PEAK_BF16_FLOPS,
                                                      nbytes)
        plan = getattr(nc, "linear_plan", None)
        if plan is not None:
            p = plan(b, s, cin, cout)
            row["plan"] = {"bn": p.bn, "split": p.split, "blocks": p.blocks}
        row["gb_per_s"] = nbytes / row["ms"] / 1e6
        emit(row)

    for cin in LINEAR_CIN:
        linear_row("linear_vs_c_in", 16, 1024, cin, 320)
    for cin in (320, 1280, 2560):
        linear_row("linear_one_block", 1, 128, cin, 64)
    for s, c in LINEAR_SITES:
        linear_row("linear_site_256px", 16, s, c, c)
    for s, c in LINEAR_SITES:
        linear_row("linear_site_b64", 64, s, c, c)

    def gn_row(kind, b, c, h, w, silu=True):
        x = torch.randn(b, c, h, w, device=dev, generator=gen).bfloat16()
        x = x.contiguous(memory_format=torch.channels_last)
        scale = 1.0 + 0.1 * torch.randn(c, device=dev, generator=gen)
        bias = 0.1 * torch.randn(c, device=dev, generator=gen)
        out = gn.group_norm_silu_forward(x, scale, bias, 32, 1e-5, silu)
        ref = gn.group_norm_silu_plain(x.float(), scale, bias, 32, 1e-5, silu)
        nbytes = 4.0 * x.numel() + 8.0 * c
        row = {"probe": kind, "b": b, "c": c, "c_per_group": c // 32, "h": h, "w": w,
               "silu": silu,
               "slab_bytes": 2 * h * w * c // 32,
               "rel_l2": cs.per_sample_rel_l2(out, ref).max().item(),
               "ms": cs.device_ms(
                   lambda: gn.group_norm_silu_forward(x, scale, bias, 32, 1e-5, silu), 20),
               "cold_ms": cs.cold_device_ms(
                   lambda t: gn.group_norm_silu_forward(t, scale, bias, 32, 1e-5, silu), (x,),
                   2.0 * x.numel())}
        row["bound_ms"], row["bound_by"] = cs.bound_ms(10.0 * x.numel(), cs.PEAK_F32_FLOPS,
                                                      nbytes)
        plan = getattr(gn, "group_norm_plan", None)
        if plan is not None:
            p = plan(b, h * w, c, 32)
            row["plan"] = {"window": p.window, "cluster": p.cluster, "rows": p.rows,
                           "one_read": p.one_read, "tma": p.tma, "ctas": p.ctas,
                           "threads": p.threads}
        row["gb_per_s"] = nbytes / row["ms"] / 1e6
        row["cold_gb_per_s"] = nbytes / row["cold_ms"] / 1e6
        emit(row)

    for c, _ in GN_CG:
        gn_row("gn_vs_cg_32x32", 16, c, 32, 32)
    for c, cg in GN_CG:  # a slab of 80 KB at every C/G: HW = 40960 / cg
        side = int(round((40960 / cg) ** 0.5))
        gn_row("gn_vs_cg_fixed_slab", 16, c, side, side)
    for c in (320, 1280):  # the identity: what SiLU's arithmetic costs
        gn_row("gn_identity_32x32", 16, c, 32, 32, silu=False)
    gn_row("gn_512px_slab", 4, 960, 64, 64)
    for c, h in ((320, 32), (640, 16), (1280, 8), (2560, 8), (960, 32)):
        gn_row("gn_b64", 64, c, h, h)

    from diffusion_pruning_tpu_torch.ops import build
    for b, c, side in ((16, 1280, 32), (16, 320, 32), (16, 960, 32), (16, 640, 16),
                       (64, 1280, 8), (4, 960, 64), (4, 320, 64)):
        x = torch.randn(b, c, side, side, device=dev, generator=gen).bfloat16()
        x = x.contiguous(memory_format=torch.channels_last)
        scale = torch.ones(c, device=dev)
        bias = torch.zeros(c, device=dev)
        out = torch.empty_like(x)
        base = gn.group_norm_plan(b, side * side, c, 32)
        times = {}
        for mult in (1, 2, 4):
            window = base.window * mult
            if window > 256 or c % window:
                continue
            for cluster in gn.GN_CLUSTERS:
                rows, box_rows = gn._rows(side * side, cluster)
                for threads in (256, 512):
                    if gn.gn_smem_bytes(window, rows, box_rows, True, threads) > gn.GN_SMEM_LIMIT:
                        continue
                    for stash, how in ((gn.STASH_TMA, "tma"), (gn.STASH_LOADS, "loads")):

                        def run():
                            build.launch("group_norm_silu", dev, x.data_ptr(), scale.data_ptr(),
                                         bias.data_ptr(), out.data_ptr(), b, side * side, c, 32,
                                         1e-5, 1, window, cluster, rows, box_rows, stash, threads)

                        times[f"w{window}_c{cluster}_t{threads}_{how}"] = cs.device_ms(run, 20)
        best = min(times, key=times.get)
        emit({"probe": "gn_plan_sweep", "b": b, "c": c, "h": side, "w": side,
              "plan": {"window": base.window, "cluster": base.cluster, "threads": base.threads,
                       "tma": base.tma},
              "best": best, "best_ms": times[best], "ms_by_plan": times})
    cs.sweep_linear_splits(dev)


if __name__ == "__main__":
    main()
