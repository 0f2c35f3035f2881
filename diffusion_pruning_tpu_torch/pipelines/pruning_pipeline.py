"""Routed text-to-image pipeline.

encode prompt (CLIP) → route (hypernet → quantizer eval forward: cosine argmax
against the frozen codebook snapshot + hard-concrete) → CFG sampling loop
(`sampler`: "ddim", "pndm" or "dpm++") with the per-prompt arch fixed for the
whole trajectory → VAE decode.

The pipeline owns its modules and places them on `device`: the CUDA card
unless the caller passes `device="cpu"`. Randomness comes from explicit
`torch.Generator`s (or explicit latents). Images come back NHWC in [0, 1].

Besides `__call__`: `generate_samples` (a fixed or absent architecture),
`quantizer_samples` (each codebook entry's), `sample_progressive` (routed
DDIM with a decoded snapshot every few steps) and `depth_analysis_arch`.
With a `safety_checker` (`models/safety.SafetyChecker`), `__call__` screens
the decoded images: flagged ones come back black, and the flags are a fourth
return value.
"""
from __future__ import annotations

import copy
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn

from diffusion_pruning_tpu_torch.core.estimators import hard_concrete
from diffusion_pruning_tpu_torch.core.resource import ResourceModel
from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextEncoder
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL
from diffusion_pruning_tpu_torch.schedulers import (
    DDIMSampler,
    DiffusionSchedule,
    DPMSolverPPSampler,
    PNDMSampler,
)
from diffusion_pruning_tpu_torch.utils.device import resolve_device


SAMPLERS = {"ddim": DDIMSampler, "pndm": PNDMSampler, "dpm++": DPMSolverPPSampler}


class PruningPipeline:
    def __init__(self, unet: GatedUNet, vae: AutoencoderKL, text_encoder: CLIPTextEncoder,
                 hypernet: Optional[HyperStructure] = None,
                 quantizer: Optional[StructureQuantizer] = None,
                 schedule: Optional[DiffusionSchedule] = None,
                 device: Optional[Union[str, torch.device]] = None, sampler: str = "ddim",
                 safety_checker=None):
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {sorted(SAMPLERS)}, got {sampler!r}")
        self.device = resolve_device(device)
        self.unet = self._place(unet)
        self.vae = self._place(vae)
        self.text_encoder = self._place(text_encoder)
        self.hypernet = self._place(hypernet)
        self.quantizer = self._place(quantizer)
        self.schedule = schedule or DiffusionSchedule()
        self.sampler = sampler
        self.safety_checker = self._place(safety_checker)

    def _place(self, module: Optional[nn.Module]) -> Optional[nn.Module]:
        return None if module is None else module.to(self.device).eval()

    def _sampler(self):
        """The sampler object `self.sampler` names, on this pipeline's schedule."""
        return SAMPLERS[self.sampler](self.schedule)

    def with_unet(self, unet: GatedUNet) -> "PruningPipeline":
        """A pipeline that shares this one's text encoder, VAE, router,
        schedule and sampler and denoises with `unet` (an expert U-Net)."""
        pipe = copy.copy(self)
        pipe.unet = self._place(unet)
        return pipe

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def encode_prompt(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_encoder(input_ids.to(self.device))

    @torch.inference_mode()
    def route(self, prompt_embeds: torch.Tensor, hyper_net_input: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None):
        """Hypernet + quantizer eval routing → (arch (B, vq_dim) hard gates,
        expert indices (B,)). `noise`: the quantizer's gumbel noise (default:
        the fixed generator)."""
        feats = hyper_net_input if hyper_net_input is not None else prompt_embeds.mean(dim=1)
        logits = self.hypernet(feats.to(self.device).float())
        return self.quantizer.forward_eval(logits, noise)

    def _initial_latents(self, generator: Optional[torch.Generator], b: int,
                         latents: Optional[torch.Tensor], height: Optional[int] = None,
                         width: Optional[int] = None) -> torch.Tensor:
        """`latents` if given, else standard normals from `generator` (f32, NHWC)."""
        if latents is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or the initial latents")
            cfg, vs = self.unet.cfg, self.vae.cfg.spatial_scale
            h = (height or cfg.sample_size * vs) // vs
            w = (width or cfg.sample_size * vs) // vs
            latents = torch.randn((b, h, w, cfg.in_channels), generator=generator,
                                  device=generator.device)
        return latents.to(self.device, torch.float32)

    def _model_fn(self, prompt_embeds, neg_embeds, arch, guidance_scale: float):
        """The CFG U-Net call model_fn(x, t) of one trajectory."""
        do_cfg = guidance_scale > 1.0
        ehs = torch.cat([neg_embeds, prompt_embeds]) if do_cfg else prompt_embeds

        def model_fn(x, t):
            if do_cfg:
                out = self.unet(torch.cat([x, x]), torch.cat([t, t]), ehs, arch=arch)
                uncond, cond = out.chunk(2)
                return uncond + guidance_scale * (cond - uncond)
            return self.unet(x, t, ehs, arch=arch)

        return model_fn

    @torch.inference_mode()
    def denoise(self, generator: Optional[torch.Generator], prompt_embeds: torch.Tensor,
                neg_embeds: torch.Tensor, arch: Optional[torch.Tensor],
                num_inference_steps: int = 50, guidance_scale: float = 7.5,
                height: Optional[int] = None, width: Optional[int] = None,
                latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """CFG trajectory of `self.sampler`. Initial latents are `latents` if
        given, else standard normals from `generator` (f32, NHWC)."""
        latents = self._initial_latents(generator, prompt_embeds.shape[0], latents, height,
                                        width)
        model_fn = self._model_fn(prompt_embeds, neg_embeds, arch, guidance_scale)
        return self._sampler().sample(model_fn, latents, num_inference_steps)

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents → images in [0, 1], NHWC, float32."""
        return torch.clamp(self.vae.decode(latents).float() / 2 + 0.5, 0.0, 1.0)

    # ------------------------------------------------------------------

    def __call__(self, input_ids: torch.Tensor, neg_input_ids: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 hyper_net_input: Optional[torch.Tensor] = None,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 output_type: str = "pil", height: Optional[int] = None,
                 width: Optional[int] = None, latents: Optional[torch.Tensor] = None,
                 route_noise: Optional[torch.Tensor] = None):
        """Routed generation → (images, expert_indices, resource_ratios), and
        the safety checker's flags (B,) fourth when one is set (flagged
        images black)."""
        prompt_embeds = self.encode_prompt(input_ids)
        neg_embeds = self.encode_prompt(neg_input_ids)
        arch, indices = self.route(prompt_embeds, hyper_net_input, route_noise)
        out = self.denoise(generator, prompt_embeds, neg_embeds, arch, num_inference_steps,
                           guidance_scale, height, width, latents)
        ratios = ResourceModel(self.unet.spec).resource_ratio(arch)
        images = self.decode(out) if output_type != "latent" else out
        if self.safety_checker is not None and output_type != "latent":
            images, nsfw = self.safety_checker(images)
            return images, indices, ratios, nsfw
        return images, indices, ratios

    def generate_samples(self, input_ids, neg_input_ids, generator=None, arch=None,
                         num_inference_steps=50, guidance_scale=7.5, latents=None):
        """Plain SD loop with a fixed (or absent) architecture."""
        prompt_embeds = self.encode_prompt(input_ids)
        neg_embeds = self.encode_prompt(neg_input_ids)
        if arch is not None:
            arch = arch.to(self.device)
        out = self.denoise(generator, prompt_embeds, neg_embeds, arch, num_inference_steps,
                           guidance_scale, latents=latents)
        return self.decode(out)

    def quantizer_samples(self, input_ids, neg_input_ids, generator=None,
                          expert_ids: Sequence[int] = (0,), num_inference_steps=50,
                          guidance_scale=7.5, latents=None):
        """Generate with each requested codebook entry's architecture, taken
        from the `embedding_gs` snapshot eval routing uses."""
        codes = hard_concrete(self.quantizer.embedding_gs.float())
        arch = codes[torch.as_tensor(list(expert_ids), device=self.device)]
        return self.generate_samples(input_ids, neg_input_ids, generator, arch,
                                     num_inference_steps, guidance_scale, latents)

    def sample_progressive(self, input_ids, neg_input_ids, generator=None,
                           hyper_net_input=None, num_inference_steps=50, guidance_scale=7.5,
                           snapshot_every=10, latents=None, route_noise=None):
        """Routed DDIM generation that decodes the latents every
        `snapshot_every` steps → (snapshots: a list of (B, H, W, 3) images,
        the last after the final step; expert indices). The trajectory is
        `__call__`'s under DDIM, run in chunks."""
        prompt_embeds = self.encode_prompt(input_ids)
        neg_embeds = self.encode_prompt(neg_input_ids)
        arch, indices = self.route(prompt_embeds, hyper_net_input, route_noise)
        x = self._initial_latents(generator, prompt_embeds.shape[0], latents)
        model_fn = self._model_fn(prompt_embeds, neg_embeds, arch, guidance_scale)
        sampler = DDIMSampler(self.schedule)
        ts = sampler.timesteps(num_inference_steps).tolist()
        snaps = []
        with torch.inference_mode():
            for start in range(0, num_inference_steps, snapshot_every):
                x = sampler.run(model_fn, x, ts[start:start + snapshot_every],
                                num_inference_steps)
                snaps.append(self.decode(x))
        return snaps, indices

    def depth_analysis_arch(self, depth_indices: Sequence[int], batch: int = 1) -> torch.Tensor:
        """All-ones arch (batch, vq_dim) with the given depth gates zeroed."""
        spec = self.unet.spec
        arch = torch.ones(batch, spec.vq_dim, device=self.device)
        for d in depth_indices:
            arch[:, spec.num_width + d] = 0.0
        return arch
