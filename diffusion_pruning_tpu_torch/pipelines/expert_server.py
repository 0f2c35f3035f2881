"""Expert-dispatch serving: route prompts to physically pruned experts.

The port's copy of the JAX package's `pipelines/expert_server.py`. The router
assigns each prompt to a codebook expert, prompts are grouped per expert, and
each group runs through that expert's materialised U-Net
(`models/unet/pruned.py`), which computes only the kept channels, heads and
units instead of masking them.

Tiered batching: an expert runs one of a few power-of-two batch shapes (1, 2,
…, batch_size); a group of n prompts is covered by the largest tiers <= n and
one padded tail tier, so padding stays below the smallest tier that covers
the tail. `ServingQueue` adds continuous batching across `submit()` calls:
pending prompts accumulate per expert and `flush()` drains them at the tier
shapes. Hybrid dispatch sends only full largest-tier batches through experts
and pools every remainder into one gated batch with per-prompt archs; a
server with no experts (the routed baseline) pools every prompt into it.

On a pipeline that carries a tensor-parallel mesh (`parallel.tp.
shard_pipeline`), every expert is cut from the gathered dense weights and
sharded on the mesh's model axis by the same rules at its kept widths, and
the expert pipelines inherit the mesh.

Layout (`build_expert`, `nhwc_route`): an expert whose weights are all bf16
on a CUDA card, with no mesh and no `fused_norm_conv`, is served NHWC: its
conv weights channels_last, its activations channels_last from `conv_in` to
`conv_out`, every GroupNorm (+SiLU) on the hand-written `group_norm_silu`,
so that no convolution converts a layout. Any other expert keeps the
layout its config gives.

`warmup` prepares the serving programs before traffic arrives: on the card
one CUDA graph of the denoise trajectory per (expert, tier), and under
`hybrid` per tier of the gated U-Net (`pipelines/aot.py`), dispatched by
operand signature from each expert pipe's own denoise cache.

Randomness: routing takes the quantizer's gumbel noise (`route_noise`, as
`PruningPipeline.route` does), and initial latents are either given per
prompt row or drawn from one `torch.Generator`, tier by tier in dispatch
order.

Spans (`utils/profiling.span`, recorded only while a recording is on):

- `submit`: one `ServingQueue.submit`, on the caller's thread. Its
  children, in `encode_route` (also under `generate`): `encode_prompt`
  (CLIP text of the prompts; SDXL's two towers each in a `clip_l` and a
  `clip_bigg` span, with their stream time), `encode_negative` (CLIP text
  of the negative prompt; SDXL's empty negative is zeros and opens no tower
  span), `route` (hypernet and quantizer, launched) and `route_to_host`
  (the expert indices copied to the host: the host waits for the stream).
- `flush` (`flush`: the queue's flush index; `rids`: the requests it
  answers, which ties each request to the flush that served it): one
  flush, on the thread that runs it. Its children: `flush_lock` (the wait
  for the previous flush to leave the device), `join` (the pending
  submits' embeddings and latents concatenated, the rows grouped by
  expert), then for each expert `expert_pipe` (its pipeline built with its
  U-Net, `with_unet`) and one `tier` per tier batch (`expert`: its index,
  or `gated` for the pooled batch; `tier`; `rows`: the real rows, so that
  a tier's padding and its own time read together; `layout`: "nhwc" or
  "nchw", the U-Net's `layout`), then `to_host`
  (`_materialise`: each tier's images copied to the host, which waits for
  the device's work).
- each `tier`'s children: `latents` (the tier's rows gathered: initial
  latents and both embeddings), `denoise` (the trajectory; stream time
  between CUDA events) and `decode` (the VAE decode; stream time between
  CUDA events, which the host's launches pace where they fall behind).
  Whether a tier ran a prepared program is counted by `aot.ShapeDispatch`
  (`hits`, `misses`), and the tiers of each layout by
  `utils.profiling.tiers_served`.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from diffusion_pruning_tpu_torch.core.estimators import hard_concrete
from diffusion_pruning_tpu_torch.core.structure import StructureSpec
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.unet.pruned import (
    ExpertPlan,
    expert_macs_ratio,
    make_expert_plan,
    slice_expert_params,
)
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.pipelines.pruning_pipeline import (
    PruningPipeline,
    cond_rows,
    map_cond,
)
from diffusion_pruning_tpu_torch.utils.profiling import count_tier, recording, span

# the two warm-up options of the JAX server the port refuses, and why
AOT_DIR_REFUSED = ("a CUDA graph holds this process's device addresses and cannot be saved to "
                   "disk; what a restart keeps is the kernel libraries, cached in "
                   "build/torch_kernels/ by source hash")
PARALLEL_REFUSED = ("capture is host Python under the GIL, so warm-up threads have no compile "
                    "wait to overlap; nvcc already builds the kernel sources in parallel, one "
                    "process each")

# (tier size, padded rows) -> the tier's initial latents
LatentSource = Callable[[int, np.ndarray], torch.Tensor]


def nhwc_route(cfg: UNetConfig, leaves: Set[Tuple[torch.dtype, str]], mesh=None) -> bool:
    """Whether `build_expert` serves the expert NHWC. `leaves`: the (dtype,
    device type) pairs of its state dict's floating tensors. The route is
    taken where they are all bf16 on a CUDA device (what the hand-written
    kernels take), there is no tensor-parallel `mesh`, and the config does
    not set `fused_norm_conv` (whose kernels fold the norms, and which
    wins)."""
    return mesh is None and not cfg.fused_norm_conv and leaves == {(torch.bfloat16, "cuda")}


def channels_last_convs(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`state_dict` with every 4-D (conv) weight in `torch.channels_last`:
    a copy where the layout changes (made outside `torch.inference_mode`, so
    it keeps a version counter), the tensor itself where it does not (a 1×1
    weight) and for every other leaf."""
    with torch.inference_mode(False):
        return {k: v.contiguous(memory_format=torch.channels_last) if v.dim() == 4 else v
                for k, v in state_dict.items()}


def build_expert(cfg: UNetConfig, plan: ExpertPlan, state_dict: Dict[str, torch.Tensor],
                 mesh=None) -> GatedUNet:
    """The expert U-Net of `plan` holding the tensors of `state_dict` (no
    random init: the modules are built on the meta device and the tensors
    assigned), in eval mode. Where `nhwc_route` holds (served bf16 CUDA
    experts; `mesh`: the mesh the expert will be sharded on) it runs
    `fused_norms`'s channels_last path with channels_last conv weights
    (`channels_last_convs`: the 3×3 ones are copies, every other leaf is
    assigned as given); else every leaf is assigned as given."""
    leaves = {(v.dtype, v.device.type) for v in state_dict.values() if v.is_floating_point()}
    if nhwc_route(cfg, leaves, mesh):
        cfg = dataclasses.replace(cfg, fused_norms=True)
        state_dict = channels_last_convs(state_dict)
    with torch.device("meta"):
        model = GatedUNet(cfg, plan=plan)
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model.eval().requires_grad_(False)


@dataclasses.dataclass
class ExpertServer:
    """K materialised experts and the router, behind one `generate()` call."""
    base_pipeline: PruningPipeline          # router, VAE, text encoder, gated U-Net
    expert_models: List[GatedUNet]
    expert_ratios: List[float]
    batch_size: int = 4
    # expert -> its pipes' denoise cache (the JAX server's `_expert_caches`)
    _expert_caches: Dict[int, dict] = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def from_codebook(cls, pipeline: PruningPipeline, spec: StructureSpec, cfg: UNetConfig,
                      expert_weights: Optional[Sequence[Optional[Dict[str, torch.Tensor]]]] = None,
                      batch_size: int = 4, param_dtype: Optional[torch.dtype] = None
                      ) -> "ExpertServer":
        """Materialise every codebook entry as a pruned expert, cut from the
        `embedding_gs` snapshot at >= 0.5 (the realisation the router assigns
        against). Weights are slices of the pipeline's dense U-Net, or the
        per-expert state dicts of `expert_weights` (the stage-2 output) where
        given; `param_dtype` casts each expert once (outside
        `torch.inference_mode`, so the copies keep their version counters). A
        leaf an expert does not cut shares the dense U-Net's storage when the
        dtype is unchanged. On a pipeline with a mesh, the dense weights are
        gathered from the model axis first (a collective) and each expert is
        sharded on it (`parallel.tp.shard_unet`). Served bf16 CUDA experts
        without a mesh take `build_expert`'s NHWC route: their 3×3 conv
        weights are channels_last copies, also where uncut (conv_in,
        conv_out, the resamplers); their other uncut leaves share."""
        from diffusion_pruning_tpu_torch.parallel.tp import gather_state, shard_unet
        codes = (pipeline.quantizer.embedding_gs.float() >= 0.5).float().cpu().numpy()
        mesh = pipeline.mesh
        dense = pipeline.unet.state_dict()
        if mesh is not None:
            dense = gather_state(mesh.model, dense, pipeline.unet.shard.plan)
        models, ratios = [], []
        for e in range(codes.shape[0]):
            plan = make_expert_plan(spec, codes[e])
            if expert_weights is not None and expert_weights[e] is not None:
                sd = dict(expert_weights[e])
            else:
                sd = slice_expert_params(dense, plan)
            with torch.inference_mode(False):
                sd = {k: v.to(pipeline.device, param_dtype) for k, v in sd.items()}
            expert = build_expert(cfg, plan, sd, mesh)
            models.append(expert if mesh is None else shard_unet(expert, mesh))
            ratios.append(expert_macs_ratio(spec, plan))
        return cls(pipeline, models, ratios, batch_size)

    # ------------------------------------------------------------------

    @property
    def batch_shapes(self) -> Tuple[int, ...]:
        """Power-of-two tier sizes up to batch_size (ascending)."""
        shapes, s = [], 1
        while s < self.batch_size:
            shapes.append(s)
            s *= 2
        shapes.append(self.batch_size)
        return tuple(shapes)

    @staticmethod
    def plan_batches(n: int, shapes: Sequence[int]) -> List[Tuple[int, int]]:
        """Cover n prompts with tier batches: greedy largest-tier-first, then
        one padded tail tier. Returns [(tier_size, real_count), ...] with
        sum(real_count) == n."""
        plan: List[Tuple[int, int]] = []
        biggest = shapes[-1]
        while n >= biggest:
            plan.append((biggest, biggest))
            n -= biggest
        if n > 0:
            plan.append((next(s for s in shapes if s >= n), n))
        return plan

    def expert_pipe(self, e: int) -> PruningPipeline:
        """The base pipeline with expert e's U-Net in place of the gated one,
        with expert e's denoise cache (its prepared programs)."""
        pipe = self.base_pipeline.with_unet(self.expert_models[e])
        pipe._denoise_cache = self._expert_caches.setdefault(int(e), {})
        return pipe

    def _latent_shape(self) -> Tuple[int, int, int]:
        cfg = self.base_pipeline.unet.cfg
        return cfg.sample_size, cfg.sample_size, cfg.in_channels

    @torch.inference_mode()
    def warmup(self, num_inference_steps: int = 25, guidance_scale: float = 7.5,
               hybrid: bool = False, aot_dir: Optional[str] = None, decode: bool = True,
               parallel: int = 1) -> dict:
        """Prepare every (expert, tier) denoise program, and under `hybrid`
        the gated U-Net's program per tier (code 0's row as the warm-up arch;
        each call copies its rows' archs in as operands), then run one VAE
        decode per tier, before traffic arrives
        (`PruningPipeline.prepare_denoise`: one eager CFG U-Net forward at
        each program's operands first). On the card each program is a CUDA
        graph of the whole trajectory, all of them in one memory pool with
        replays serialised on one lock; on the CPU, and on a pipeline with a
        tensor-parallel mesh (whose gloo reductions stage through host
        memory, which a graph cannot hold), the eager loop is installed in
        the same dispatch table. Requests of other shapes run the eager
        loop. Returns {"loaded": 0, "built": n}, n the (U-Net program,
        tier) pairs.

        `aot_dir` raises (`AOT_DIR_REFUSED`): a graph cannot be saved, and
        a restart keeps only the built kernel libraries. `parallel` > 1
        raises (`PARALLEL_REFUSED`): capture is host Python under the GIL,
        with no compile wait for threads to overlap."""
        if aot_dir is not None:
            raise NotImplementedError(f"warmup(aot_dir=...): {AOT_DIR_REFUSED}")
        if parallel > 1:
            raise NotImplementedError(f"warmup(parallel > 1): {PARALLEL_REFUSED}")
        base = self.base_pipeline
        graphs = base.device.type == "cuda" and base.mesh is None
        pool = torch.cuda.graph_pool_handle() if graphs else None
        lock = threading.Lock()
        tiers = self.batch_shapes
        built = 0
        for e in range(len(self.expert_models)):
            built += self.expert_pipe(e).prepare_denoise(
                num_inference_steps, guidance_scale, tiers, pool=pool, lock=lock)
        if hybrid:
            codes = hard_concrete(base.quantizer.embedding_gs.float())
            built += base.prepare_denoise(num_inference_steps, guidance_scale, tiers,
                                          arch=codes[:1], pool=pool, lock=lock)
        if decode:
            for t in tiers:
                base.decode(torch.zeros((t, *self._latent_shape()), device=base.device))
        if base.device.type == "cuda":
            torch.cuda.synchronize(base.device)
        return {"loaded": 0, "built": built}

    def route(self, input_ids: torch.Tensor, hyper_net_input: Optional[torch.Tensor] = None,
              route_noise: Optional[torch.Tensor] = None) -> np.ndarray:
        prompt_embeds = self.base_pipeline.encode_prompt(input_ids)
        _, indices = self.base_pipeline.route(prompt_embeds, hyper_net_input, route_noise)
        return indices.cpu().numpy()

    def encode_route(self, input_ids: torch.Tensor, neg_input_ids: torch.Tensor,
                     hyper_net_input: Optional[torch.Tensor] = None,
                     route_noise: Optional[torch.Tensor] = None):
        """Encode the prompts once and route them: (prompt_embeds (N, 77, D),
        neg_embeds (N, 77, D), expert indices (N,) on the host); under SDXL
        each embedding is a `TextTimeConditioning`. Tiers gather their rows
        out of these embeddings."""
        base = self.base_pipeline
        with span("encode_prompt"):
            pe = base.encode_prompt(input_ids)
        with span("encode_negative"):
            ne = base.encode_negative(neg_input_ids)
            if cond_rows(ne) == 1:
                n = cond_rows(pe)
                ne = map_cond(lambda x: x.expand(n, *x.shape[1:]), ne)
        with span("route"):
            _, indices = base.route(pe, hyper_net_input, route_noise)
        with span("route_to_host"):
            indices = indices.cpu().numpy()
        return pe, ne, indices

    def _latent_source(self, latents: Optional[torch.Tensor],
                       generator: Optional[torch.Generator]) -> LatentSource:
        """Each tier's initial latents: the rows of `latents` (the pooled
        prompt rows) where given, else standard normals from `generator`,
        drawn tier by tier in dispatch order."""
        if latents is not None:
            return lambda tier, rows: latents[torch.as_tensor(rows, device=latents.device)]
        if generator is None:
            raise ValueError("pass a torch.Generator or the initial latents")
        return lambda tier, rows: torch.randn((tier, *self._latent_shape()),
                                              generator=generator, device=generator.device)

    def _run_tiers(self, owner, pipe: PruningPipeline, rows: np.ndarray, pe, ne,
                   experts: Optional[np.ndarray], arch_table: Optional[torch.Tensor],
                   take: LatentSource, num_inference_steps: int, guidance_scale: float,
                   out_images: dict) -> int:
        """Generate `rows` through `pipe` in tier-planned batches; with
        `experts` (each row's expert) the gated U-Net runs each row's arch,
        the expert's row of `arch_table`. Images stay on the device:
        out_images[row] = (tier images, index in the tier). Returns the
        slots used. `owner` (the expert, or "gated") names the tier spans."""
        used = lo = 0
        layout = pipe.unet.layout
        for tier, real in self.plan_batches(len(rows), self.batch_shapes):
            count_tier(layout)
            ids = ({"expert": owner, "tier": tier, "rows": real, "layout": layout}
                   if recording() else None)
            with span("tier", ids=ids):
                with span("latents"):
                    chunk = rows[lo: lo + real]
                    padded = np.concatenate([chunk, np.repeat(chunk[-1:], tier - real)])
                    sel = torch.as_tensor(padded, device=pipe.device)
                    arch = None
                    if experts is not None:
                        echunk = experts[lo: lo + real]
                        epad = np.concatenate([echunk, np.repeat(echunk[-1:], tier - real)])
                        arch = arch_table[torch.as_tensor(epad, device=arch_table.device)]
                    tier_pe, tier_ne = (map_cond(lambda x: x[sel], c) for c in (pe, ne))
                    initial = take(tier, padded)
                lo += real
                with span("denoise", device=True):
                    latents = pipe.denoise(None, tier_pe, tier_ne, arch, num_inference_steps,
                                           guidance_scale, latents=initial)
                with span("decode", device=True):
                    imgs = pipe.decode(latents)
                for j, r in enumerate(chunk):
                    out_images[int(r)] = (imgs, j)
                used += tier
        return used

    def _run_expert(self, e: int, rows: np.ndarray, pe, ne, take: LatentSource,
                    num_inference_steps: int, guidance_scale: float, out_images: dict) -> int:
        """Generate `rows` through expert e in tier-planned batches."""
        with span("expert_pipe"):
            pipe = self.expert_pipe(e)
        return self._run_tiers(int(e), pipe, rows, pe, ne, None, None, take,
                               num_inference_steps, guidance_scale, out_images)

    def _run_gated_leftovers(self, entries: List[Tuple[int, int]], pe, ne, take: LatentSource,
                             num_inference_steps: int, guidance_scale: float,
                             out_images: dict) -> int:
        """One pooled gated batch (per-prompt archs: each row's code,
        hard_concrete of `embedding_gs`) for the remainders of every expert
        group (hybrid dispatch). `entries`: (row, expert) pairs."""
        base = self.base_pipeline
        rows = np.asarray([r for r, _ in entries])
        experts = np.asarray([e for _, e in entries])
        codes = hard_concrete(base.quantizer.embedding_gs.float())
        return self._run_tiers("gated", base, rows, pe, ne, experts, codes, take,
                               num_inference_steps, guidance_scale, out_images)

    def _dispatch_groups(self, groups: Dict[int, np.ndarray], pe, ne, take: LatentSource,
                         num_inference_steps: int, guidance_scale: float, out_images: dict,
                         hybrid: bool) -> int:
        """groups: {expert: rows}. hybrid=True sends only full largest-tier
        batches through the experts; every remainder joins one pooled gated
        batch. A server with no experts (the routed baseline, `cli/serve.py
        --mode routed`) pools every row into the gated batch. Returns the
        slots used."""
        slots = 0
        leftovers: List[Tuple[int, int]] = []
        routed = not self.expert_models
        for e, rows in groups.items():
            full_rows = rows
            if hybrid or routed:
                n_full = 0 if routed else (len(rows) // self.batch_size) * self.batch_size
                full_rows = rows[:n_full]
                leftovers.extend((int(r), int(e)) for r in rows[n_full:])
            if len(full_rows):
                slots += self._run_expert(e, full_rows, pe, ne, take, num_inference_steps,
                                          guidance_scale, out_images)
        if leftovers:
            slots += self._run_gated_leftovers(leftovers, pe, ne, take, num_inference_steps,
                                               guidance_scale, out_images)
        return slots

    @staticmethod
    def _materialise(out_images: dict) -> Dict[int, torch.Tensor]:
        """Copy each tier's images to the host once, then index rows there."""
        fetched: Dict[int, torch.Tensor] = {}
        res: Dict[int, torch.Tensor] = {}
        with span("to_host"):
            for r, (arr, j) in out_images.items():
                if id(arr) not in fetched:
                    fetched[id(arr)] = arr.cpu()
                res[r] = fetched[id(arr)][j]
        return res

    def generate(self, input_ids: torch.Tensor, neg_input_ids: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 hyper_net_input: Optional[torch.Tensor] = None, num_inference_steps: int = 25,
                 guidance_scale: float = 7.5, hybrid: bool = False,
                 route_noise: Optional[torch.Tensor] = None,
                 latents: Optional[torch.Tensor] = None):
        """(images (N, H, W, 3) on the host, expert indices (N,)): each prompt
        generated by its assigned expert (hybrid=True: full tiers by the
        experts, the remainders in one pooled gated batch). `latents`: the
        initial latents per prompt row (N, h, w, C), else drawn from
        `generator`."""
        n = input_ids.shape[0]
        pe, ne, indices = self.encode_route(input_ids, neg_input_ids, hyper_net_input,
                                            route_noise)
        if latents is not None:
            latents = latents.to(self.base_pipeline.device, torch.float32)
        out_images: dict = {}
        groups = {int(e): np.nonzero(indices == e)[0] for e in np.unique(indices)}
        self.last_slots_used = self._dispatch_groups(
            groups, pe, ne, self._latent_source(latents, generator), num_inference_steps,
            guidance_scale, out_images, hybrid)
        res = self._materialise(out_images)
        return torch.stack([res[i] for i in range(n)]), torch.from_numpy(indices)


@dataclasses.dataclass
class ServingQueue:
    """Continuous batching across requests: `submit()` encodes, routes and
    enqueues prompts; `flush()` drains every expert's pending set at the tier
    shapes, so requests of different submits share batches. `routes` maps
    every submitted request id to its expert."""
    server: ExpertServer
    num_inference_steps: int = 25
    guidance_scale: float = 7.5
    hybrid: bool = False

    def __post_init__(self):
        # pending entry: (request id, submit batch index, row in batch, expert)
        self._pending: List[Tuple[int, int, int, int]] = []
        # per submit: (prompt_embeds, neg_embeds, initial latents or None), on
        # the device until flushed
        self._embeds: Dict[int, tuple] = {}
        self.routes: Dict[int, int] = {}         # request id -> its expert
        self._next_id = 0
        self._next_batch = 0
        self.last_slots_used = 0
        self._flush_index = itertools.count()    # the `flush` span's index
        self._lock = threading.Lock()            # guards _pending and _embeds
        self._dispatch_lock = threading.Lock()   # one flush on the device at a time

    def submit(self, input_ids: torch.Tensor, neg_input_ids: torch.Tensor,
               hyper_net_input: Optional[torch.Tensor] = None,
               route_noise: Optional[torch.Tensor] = None,
               latents: Optional[torch.Tensor] = None) -> List[int]:
        """Encode, route and enqueue prompts; returns their request ids.
        `latents`: their initial latents (N, h, w, C); a flush takes either
        every pending submit's latents or none (then its generator's)."""
        n = input_ids.shape[0]
        with span("submit"):
            pe, ne, experts = self.server.encode_route(input_ids, neg_input_ids,
                                                       hyper_net_input, route_noise)
            if latents is not None:
                latents = latents.to(self.server.base_pipeline.device, torch.float32)
            with self._lock:
                bi = self._next_batch
                self._next_batch += 1
                self._embeds[bi] = (pe, ne, latents)
                ids = list(range(self._next_id, self._next_id + n))
                self._next_id += n
                self._pending.extend((rid, bi, r, int(experts[r])) for r, rid in enumerate(ids))
                self.routes.update((rid, int(experts[r])) for r, rid in enumerate(ids))
        return ids

    def pending_per_expert(self) -> Dict[int, int]:
        with self._lock:
            experts = [e for _, _, _, e in self._pending]
        out: Dict[int, int] = {}
        for e in experts:
            out[e] = out.get(e, 0) + 1
        return out

    def _take_pending(self):
        with self._lock:
            pending, self._pending = self._pending, []
            embeds = {bi: self._embeds.pop(bi) for bi in {bi for _, bi, _, _ in pending}}
        return pending, embeds

    def _flush_entries(self, pending, embeds, generator) -> Dict[int, torch.Tensor]:
        if not pending:
            self.last_slots_used = 0
            return {}
        with span("join"):
            batches = sorted(embeds)
            offset, off = {}, 0
            for bi in batches:
                offset[bi] = off
                off += cond_rows(embeds[bi][0])
            pe, ne = (map_cond(lambda *xs: torch.cat(xs), *[embeds[bi][k] for bi in batches])
                      for k in (0, 1))
            given = [embeds[bi][2] is not None for bi in batches]
            if any(given) and not all(given):
                raise ValueError("a flush takes the initial latents of every pending submit "
                                 "or of none")
            latents = torch.cat([embeds[bi][2] for bi in batches]) if all(given) else None
            rows = np.asarray([offset[bi] + r for _, bi, r, _ in pending])
            experts = np.asarray([e for _, _, _, e in pending])
            groups = {int(e): rows[experts == e] for e in np.unique(experts)}
        out: dict = {}
        server = self.server
        self.last_slots_used = server._dispatch_groups(
            groups, pe, ne, server._latent_source(latents, generator), self.num_inference_steps,
            self.guidance_scale, out, self.hybrid)
        res = server._materialise(out)
        return {pending[j][0]: res[int(rows[j])] for j in range(len(pending))}

    def _flush(self, index: int, pending, embeds, generator) -> Dict[int, torch.Tensor]:
        """One taken pending set on the device, once the flush before it has
        left (`_dispatch_lock`)."""
        ids = ({"flush": index, "rids": [rid for rid, _, _, _ in pending]} if recording()
               else None)
        with span("flush", ids=ids):
            with span("flush_lock"):
                self._dispatch_lock.acquire()
            try:
                return self._flush_entries(pending, embeds, generator)
            finally:
                self._dispatch_lock.release()

    def flush(self, generator: Optional[torch.Generator] = None) -> Dict[int, torch.Tensor]:
        """Run everything pending; returns {request_id: image} of this flush."""
        return self._flush(next(self._flush_index), *self._take_pending(), generator)

    def flush_async(self, generator: Optional[torch.Generator] = None) -> Future:
        """Run the pending set in a background thread; returns a Future of
        {request_id: image}. The caller may keep submitting meanwhile;
        flushes serialise on a lock."""
        taken = (next(self._flush_index), *self._take_pending())
        fut: Future = Future()

        def work():
            try:
                fut.set_result(self._flush(*taken, generator))
            except Exception as e:  # surfaced by fut.result()
                fut.set_exception(e)

        threading.Thread(target=work, daemon=True).start()
        return fut
