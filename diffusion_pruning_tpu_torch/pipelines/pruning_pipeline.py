"""Routed text-to-image pipeline.

encode prompt (CLIP) → route (hypernet → quantizer eval forward: cosine argmax
against the frozen codebook snapshot + hard-concrete) → CFG DDIM loop with
the per-prompt arch fixed for the whole trajectory → VAE decode.

The pipeline owns its modules and places them on `device`: the CUDA card
unless the caller passes `device="cpu"`. Randomness comes from explicit
`torch.Generator`s (or explicit latents). Images come back NHWC in [0, 1].
"""
from __future__ import annotations

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
from diffusion_pruning_tpu_torch.schedulers.ddim import DDIMSampler
from diffusion_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule
from diffusion_pruning_tpu_torch.utils.device import resolve_device


class PruningPipeline:
    def __init__(self, unet: GatedUNet, vae: AutoencoderKL, text_encoder: CLIPTextEncoder,
                 hypernet: Optional[HyperStructure] = None,
                 quantizer: Optional[StructureQuantizer] = None,
                 schedule: Optional[DiffusionSchedule] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.unet = self._place(unet)
        self.vae = self._place(vae)
        self.text_encoder = self._place(text_encoder)
        self.hypernet = self._place(hypernet)
        self.quantizer = self._place(quantizer)
        self.schedule = schedule or DiffusionSchedule()
        self.sampler = DDIMSampler(self.schedule)

    def _place(self, module: Optional[nn.Module]) -> Optional[nn.Module]:
        return None if module is None else module.to(self.device).eval()

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

    @torch.inference_mode()
    def denoise(self, generator: Optional[torch.Generator], prompt_embeds: torch.Tensor,
                neg_embeds: torch.Tensor, arch: Optional[torch.Tensor],
                num_inference_steps: int = 50, guidance_scale: float = 7.5,
                height: Optional[int] = None, width: Optional[int] = None,
                latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """CFG DDIM trajectory. Initial latents are `latents` if given, else
        standard normals from `generator` (f32, NHWC)."""
        cfg = self.unet.cfg
        vs = self.vae.cfg.spatial_scale
        b = prompt_embeds.shape[0]
        if latents is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or the initial latents")
            h = (height or cfg.sample_size * vs) // vs
            w = (width or cfg.sample_size * vs) // vs
            latents = torch.randn((b, h, w, cfg.in_channels), generator=generator,
                                  device=generator.device)
        latents = latents.to(self.device, torch.float32)
        do_cfg = guidance_scale > 1.0
        ehs = torch.cat([neg_embeds, prompt_embeds]) if do_cfg else prompt_embeds

        def model_fn(x, t):
            if do_cfg:
                out = self.unet(torch.cat([x, x]), torch.cat([t, t]), ehs, arch=arch)
                uncond, cond = out.chunk(2)
                return uncond + guidance_scale * (cond - uncond)
            return self.unet(x, t, ehs, arch=arch)

        return self.sampler.sample(model_fn, latents, num_inference_steps)

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
        """Routed generation → (images, expert_indices, resource_ratios)."""
        prompt_embeds = self.encode_prompt(input_ids)
        neg_embeds = self.encode_prompt(neg_input_ids)
        arch, indices = self.route(prompt_embeds, hyper_net_input, route_noise)
        out = self.denoise(generator, prompt_embeds, neg_embeds, arch, num_inference_steps,
                           guidance_scale, height, width, latents)
        ratios = ResourceModel(self.unet.spec).resource_ratio(arch)
        images = self.decode(out) if output_type != "latent" else out
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
