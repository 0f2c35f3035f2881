"""What decides `correct` in a serving cell: every request due in the window
answered, each request's route, and a sample of the served images against
the plain reference (`portbench/reference/sd.py`).

The reference rebuilds every weight from the seed (`weights.seeded_init_`,
rounded through the dtype the program serves it in) and computes in float32
with TF32 off, after the program's state is freed, in blocks of
`REFERENCE_BLOCK` requests. `control=True` computes the same in the
precision control (`reference.sd.to_fp8_`), which a limit has to fail.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import torch

from portbench.harness import weights as W
from portbench.harness.program import default_dtype, dtype_of
from portbench.reference import sd as ref

REFERENCE_BLOCK = 4
NO_READING = 1e9   # the reading of a comparison that found no served image to compare


def load_limits(root: str, workload: str) -> dict:
    with open(os.path.join(root, "portbench", "limits", f"{workload}.json")) as f:
        return json.load(f)


def reference_modules(config: dict, seed: int, device, control: bool = False):
    """The reference U-Net, CLIP text and VAE with the program's weights."""
    serving, te, vc = config["serving"], config["text_encoder"], config["vae"]
    out = []
    for tag, ctor, served in (("unet", lambda: ref.UNet(ref.unet_spec(config)),
                               serving["unet_dtype"]),
                              ("text_encoder", lambda: ref.CLIPText(te), te["torch_dtype"]),
                              ("vae", lambda: ref.VAE(vc), vc["torch_dtype"])):
        with torch.device("meta"), default_dtype(torch.float32):
            m = ctor()
        m = m.to_empty(device=device)
        W.seeded_init_(m, W.module_seed(seed, tag), device, round_to=dtype_of(served))
        m.eval().requires_grad_(False)
        out.append(ref.to_fp8_(m) if control else m)
    return out


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a.float() - b.float()).flatten())
                 / torch.linalg.vector_norm(b.float().flatten()).clamp_min(1e-30))


@torch.no_grad()
def reference_images(config: dict, seed: int, device, ids, neg, codes, latents,
                     control: bool = False) -> torch.Tensor:
    """Images (N, H, W, 3) on the host of the requests with CLIP ids
    (N, 77), one negative prompt, hard codes (N, vq_dim) and initial
    latents (N, h, w, C)."""
    unet, clip, vae = reference_modules(config, seed, device, control)
    out = []
    with ref.float32_matmuls():
        for lo in range(0, ids.shape[0], REFERENCE_BLOCK):
            sl = slice(lo, lo + REFERENCE_BLOCK)
            out.append(ref.serve(unet, clip, vae, ids[sl].to(device), neg.to(device),
                                 codes[sl].to(device), latents[sl].to(device), config).cpu())
    del unet, clip, vae
    return torch.cat(out)


def reference_routes(config: dict, codes: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    rc = config["router"]
    layout = ref.gate_layout(ref.unet_spec(config))
    return ref.route(noise, W.codebook_snapshot(codes.float()), layout, rc["quantizer_T"],
                     rc["quantizer_base"], rc["depth_order"])


def serving_checks(window, config: dict, seed: int, device, sample: List[int], inputs: Dict,
                   limits: dict, control: bool = False) -> Dict[str, dict]:
    """The numbers compared and their limits. `inputs`: the host copies of
    the pool the run sent (`clip_ids`, `neg`, `latents`), the codes (K,
    vq_dim) and the routing noise of each expert (K, vq_dim). `control`:
    also the precision control's reading of each sampled image against the
    reference (`_control_readings`), for setting the limit."""
    missing = window.attempted - len(window.done)
    bad_routes = sum(1 for rid, e in window.expert.items() if window.routes.get(rid) != e)
    # the reference's own route of each expert's noise must be that expert
    want = torch.arange(inputs["codes"].shape[0])
    bad_routes += int((reference_routes(config, inputs["codes"], inputs["noise"]) != want).sum())
    shape = (config["serving"]["resolution"],) * 2 + (3,)
    out_of_range = sum(1 for im in window.images.values()
                       if tuple(im.shape) != shape or not bool(torch.isfinite(im).all())
                       or float(im.min()) < 0.0 or float(im.max()) > 1.0)
    checks = {"failed": {"value": missing, "limit": 0},
              "route_mismatches": {"value": bad_routes, "limit": 0},
              "images_out_of_range": {"value": out_of_range, "limit": 0}}
    sample = [rid for rid in sample if rid in window.images]
    if not sample:
        checks["image_rel_l2_max"] = {"value": NO_READING, "limit": limits["image_rel_l2_max"]}
        return checks
    rows = torch.as_tensor([window.row[r] for r in sample])
    experts = torch.as_tensor([window.expert[r] for r in sample])
    want_images = reference_images(config, seed, device, inputs["clip_ids"][rows],
                                   inputs["neg"], inputs["codes"][experts],
                                   inputs["latents"][rows])
    readings = [rel_l2(window.images[r], want_images[i]) for i, r in enumerate(sample)]
    checks["image_rel_l2_max"] = {"value": max(readings), "limit": limits["image_rel_l2_max"]}
    checks["_readings"] = readings
    if control:
        got = reference_images(config, seed, device, inputs["clip_ids"][rows], inputs["neg"],
                               inputs["codes"][experts], inputs["latents"][rows], control=True)
        checks["_control_readings"] = [rel_l2(got[i], want_images[i]) for i in range(len(sample))]
        checks["_saturated"] = [float(((want_images[i] == 0) | (want_images[i] == 1)).float()
                                      .mean()) for i in range(len(sample))]
    return checks


def correct(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for k, c in checks.items() if not k.startswith("_"))
