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

The CFG trajectory of each (steps, guidance scale, gated, sampler) is one
cached program `run(unet, ehs, arch, latents)` (`_denoise_fn`, the JAX
pipeline's `_denoise_cache`): the eager sampler loop, or, once
`prepare_denoise` (or `ExpertServer.warmup`) has prepared it, an
`aot.ShapeDispatch` of captured CUDA graphs by operand signature. `denoise`
draws the initial latents outside the program, so a generator's stream is
the same either way.

With a `mesh` (a `parallel.tp.DpTpMesh`, set by `parallel.tp.shard_pipeline`
with the U-Net sharded on its model axis), encoding and routing run whole on
every rank; the denoise and the decode take this rank's rows on the data
axis when the batch divides over it (else every row, as the JAX pipeline
keeps a (1, 77) negative prompt whole), and the rows are gathered back, so
every rank returns the full batch.
"""
from __future__ import annotations

import copy
import threading
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
from diffusion_pruning_tpu_torch.ops.gates import match_batch
from diffusion_pruning_tpu_torch.parallel.mesh import all_gather, rank_slice
from diffusion_pruning_tpu_torch.pipelines import aot
from diffusion_pruning_tpu_torch.schedulers import (
    DDIMSampler,
    DiffusionSchedule,
    DPMSolverPPSampler,
    PNDMSampler,
)
from diffusion_pruning_tpu_torch.utils.device import resolve_device


SAMPLERS = {"ddim": DDIMSampler, "pndm": PNDMSampler, "dpm++": DPMSolverPPSampler}


def cfg_model_fn(unet: GatedUNet, ehs: torch.Tensor, arch: Optional[torch.Tensor],
                 guidance_scale: float):
    """The CFG U-Net call model_fn(x, t) of one trajectory; `ehs` holds the
    negative rows, then the prompt rows, when guidance_scale > 1."""
    do_cfg = guidance_scale > 1.0

    def model_fn(x, t):
        if do_cfg:
            out = unet(torch.cat([x, x]), torch.cat([t, t]), ehs, arch=arch)
            uncond, cond = out.chunk(2)
            return uncond + guidance_scale * (cond - uncond)
        return unet(x, t, ehs, arch=arch)

    return model_fn


def cfg_states(prompt_embeds: torch.Tensor, neg_embeds: torch.Tensor,
               guidance_scale: float) -> torch.Tensor:
    """The U-Net's text states of a CFG batch: [negative, prompt] rows."""
    return torch.cat([neg_embeds, prompt_embeds]) if guidance_scale > 1.0 else prompt_embeds


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
        self.mesh = None  # a `parallel.tp.DpTpMesh` once `shard_pipeline` sets one
        # (steps, guidance scale, gated, sampler) -> run(unet, ehs, arch, latents)
        self._denoise_cache = {}

    def _place(self, module: Optional[nn.Module]) -> Optional[nn.Module]:
        return None if module is None else module.to(self.device).eval()

    def _sampler(self):
        """The sampler object `self.sampler` names, on this pipeline's schedule."""
        return SAMPLERS[self.sampler](self.schedule)

    def with_unet(self, unet: GatedUNet) -> "PruningPipeline":
        """A pipeline that shares this one's text encoder, VAE, router,
        schedule and sampler and denoises with `unet` (an expert U-Net), with
        a denoise cache of its own."""
        pipe = copy.copy(self)
        pipe.unet = self._place(unet)
        pipe._denoise_cache = {}
        return pipe

    def _splits(self, n: int) -> bool:
        return self.mesh is not None and n % self.mesh.data.world_size == 0

    def _data_shard(self, x: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
        """This rank's rows on the data axis of a batch of n rows (x with n
        rows; x with one row, None, or a batch that does not divide, whole)."""
        if x is None or x.shape[0] == 1 or not self._splits(n):
            return x
        return match_batch(x, n)[rank_slice(self.mesh.data, n)]

    def _data_gather(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """The n rows of a batch every data rank holds its rows of."""
        return all_gather(self.mesh.data, x) if self._splits(n) else x

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

    def _denoise_fn(self, num_inference_steps: int, guidance_scale: float, gated: bool):
        """The CFG trajectory run(unet, ehs, arch, latents) of `self.sampler`,
        cached per (steps, scale, gated, sampler): the eager loop, or the
        `aot.ShapeDispatch` that `prepare_denoise` installed."""
        key = (num_inference_steps, guidance_scale, gated, self.sampler)
        if key not in self._denoise_cache:
            sampler = self._sampler()

            def run(unet, ehs, arch, latents):
                return sampler.sample(cfg_model_fn(unet, ehs, arch, guidance_scale), latents,
                                      num_inference_steps)

            self._denoise_cache[key] = run
        return self._denoise_cache[key]

    @torch.inference_mode()
    def prepare_denoise(self, num_inference_steps: int, guidance_scale: float,
                        batch_sizes: Sequence[int], arch: Optional[torch.Tensor] = None,
                        pool=None, lock: Optional[threading.Lock] = None) -> int:
        """Prepare the trajectory of (steps, scale, gated = arch given,
        sampler) for each batch size in `batch_sizes` and install an
        `aot.ShapeDispatch` of them in the denoise cache: a CUDA graph each
        (`aot.capture`, sharing `pool` and `lock` where given); the eager
        loop on the CPU or under a mesh (its gloo reductions stage through
        host memory, which a graph cannot hold).
        Either way one CFG U-Net forward at the operands runs first (it
        builds the kernels and packs the fused ops' weights; a graph is
        captured after it). `arch`: one row (1, vq_dim), tiled to each batch;
        the graphs take each call's arch rows as operands. Other batches,
        shapes and dtypes run the eager loop. Returns the programs prepared."""
        run = self._denoise_fn(num_inference_steps, guidance_scale, arch is not None)
        if not isinstance(run, aot.ShapeDispatch):
            run = aot.ShapeDispatch(run)
            key = (num_inference_steps, guidance_scale, arch is not None, self.sampler)
            self._denoise_cache[key] = run
        graphs = self.device.type == "cuda" and self.mesh is None
        cfg, dev = self.unet.cfg, self.device
        factor = 2 if guidance_scale > 1.0 else 1
        ids = torch.zeros((1, cfg.max_text_len), dtype=torch.long, device=dev)
        text_dtype = self.encode_prompt(ids).dtype
        for b in batch_sizes:
            ehs = torch.zeros((factor * b, cfg.max_text_len, cfg.cross_attention_dim),
                              dtype=text_dtype, device=dev)
            rows = None if arch is None else arch.to(dev).float().repeat(b, 1)
            latents = torch.zeros((b, cfg.sample_size, cfg.sample_size, cfg.in_channels),
                                  device=dev)
            args = (self.unet, ehs, rows, latents)
            t = torch.ones((b,), dtype=torch.long, device=dev)

            def one_step(unet, ehs, arch, latents):
                return cfg_model_fn(unet, ehs, arch, guidance_scale)(latents, t)

            if graphs:
                program = aot.capture(run.fallback, args, pool=pool, lock=lock, warm=one_step)
            else:
                one_step(*args)
                program = run.fallback
            run.add(args, program)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return len(batch_sizes)

    @torch.inference_mode()
    def denoise(self, generator: Optional[torch.Generator], prompt_embeds: torch.Tensor,
                neg_embeds: torch.Tensor, arch: Optional[torch.Tensor],
                num_inference_steps: int = 50, guidance_scale: float = 7.5,
                height: Optional[int] = None, width: Optional[int] = None,
                latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """CFG trajectory of `self.sampler` through the cached program
        (`_denoise_fn`). Initial latents are `latents` if given, else standard
        normals from `generator` (f32, NHWC), drawn here, outside the
        program. Under a mesh, of this rank's rows, gathered."""
        n = prompt_embeds.shape[0]
        latents = self._initial_latents(generator, n, latents, height, width)
        pe, ne, arch, latents = (self._data_shard(x, n)
                                 for x in (prompt_embeds, neg_embeds, arch, latents))
        run = self._denoise_fn(num_inference_steps, guidance_scale, arch is not None)
        out = run(self.unet, cfg_states(pe, ne, guidance_scale), arch, latents)
        return self._data_gather(out, n)

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents → images in [0, 1], NHWC, float32 (under a mesh, of this
        rank's rows, gathered)."""
        n = latents.shape[0]
        images = self.vae.decode(self._data_shard(latents, n))
        return self._data_gather(torch.clamp(images.float() / 2 + 0.5, 0.0, 1.0), n)

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
        model_fn = cfg_model_fn(self.unet, cfg_states(prompt_embeds, neg_embeds, guidance_scale),
                                arch, guidance_scale)
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
