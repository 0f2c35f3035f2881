"""The program under test, built from a configuration file and the seed.

Every module is made on the card from the seed (`weights.seeded_init_`), in
the dtype `cli/serve.py` serves it in: the U-Net, the VAE and CLIP text in
bfloat16, MPNet, the hypernet and the quantizer in float32. The U-Net, its
text encoders, the VAE and the pipeline over them are the configuration's
model family's (`programs/<family>.py`); the router, the codes and the
expert server are shared. The quantizer's codebook snapshot is the
configuration's seeded rule, and the experts are
`ExpertServer.from_codebook(..., param_dtype=bfloat16)` of it, as in
`cli/serve.py --mode experts`.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from portbench.harness import family
from portbench.harness import weights as W


@contextlib.contextmanager
def default_dtype(dtype):
    saved = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(saved)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def materialise(ctor, device, dtype, seed: int, tag: str, frozen: bool = True):
    """`ctor()` built on the meta device in `dtype`, given storage on
    `device`, filled from the seed, in eval mode; `frozen`: without
    gradients."""
    with torch.device("meta"), default_dtype(dtype):
        module = ctor()
    module = module.to_empty(device=device)
    W.seeded_init_(module, W.module_seed(seed, tag), device)
    return module.eval().requires_grad_(not frozen)


def check_layout(port_spec, layout) -> None:
    """The program's gate layout is the reference's, site for site."""
    mine = [(sb.name, sb.depth_index, tuple((s.kind, s.start, s.width) for s in sb.sites))
            for sb in port_spec.subblocks]
    theirs = [(sb.name, sb.depth_index, tuple((s.kind, s.start, s.width) for s in sb.sites))
              for sb in layout.subblocks]
    if mine != theirs or port_spec.num_depth != layout.num_depth:
        raise RuntimeError("the program's gate layout differs from the benchmark's")


def schedule(config: dict):
    from diffusion_pruning_tpu_torch.schedulers import DiffusionSchedule
    sched = config["scheduler"]
    return DiffusionSchedule(num_train_timesteps=sched["num_train_timesteps"],
                             beta_start=sched["beta_start"], beta_end=sched["beta_end"],
                             beta_schedule=sched["beta_schedule"],
                             prediction_type=sched["prediction_type"])


@dataclasses.dataclass
class Program:
    pipe: object
    server: object
    mpnet: object
    codes: torch.Tensor         # (K, vq_dim) hard codes, on the device
    layout: object               # the reference's gate layout
    spec: object                 # the reference's UNetSpec
    router: dict                 # the configuration's router settings
    warmup: dict


def router_modules(config: dict, spec, seed: int, device):
    """(hypernet, quantizer) of a configuration from the seed, float32."""
    from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
    from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
    rc = config["router"]
    hypernet = materialise(lambda: HyperStructure(spec, input_dim=rc["hypernet_input_dim"]),
                           device, dtype_of(rc["torch_dtype"]), seed, "hypernet", frozen=False)
    with torch.device(device):
        quantizer = StructureQuantizer(spec, n_e=rc["num_experts"],
                                       temperature=rc["quantizer_T"], base=rc["quantizer_base"],
                                       depth_order=tuple(rc["depth_order"]))
    W.seeded_init_(quantizer, W.module_seed(seed, "quantizer"), device)
    return hypernet, quantizer


def build(config: dict, seed: int, device, warm: bool = True) -> Program:
    from diffusion_pruning_tpu_torch.models.text_encoders import MPNetConfig, MPNetEncoder
    from diffusion_pruning_tpu_torch.pipelines.expert_server import ExpertServer

    serving, mc, rc = config["serving"], config["mpnet"], config["router"]
    ref, programs = family.reference(config), family.program(config)
    spec = ref.unet_spec(config)
    layout = ref.gate_layout(spec)
    frozen = programs.frozen_models(config, seed, device)
    ucfg, unet = frozen[:2]
    mpnet = materialise(lambda: MPNetEncoder(MPNetConfig(
        vocab_size=mc["vocab_size"], hidden_size=mc["hidden_size"],
        num_layers=mc["num_hidden_layers"], num_heads=mc["num_attention_heads"],
        intermediate_size=mc["intermediate_size"], max_positions=mc["max_position_embeddings"])),
        device, dtype_of(mc["torch_dtype"]), seed, "mpnet")
    hypernet, quantizer = router_modules(config, unet.spec, seed, device)
    codes = W.expert_codes(layout, rc["num_experts"], config["codebook"]).to(device)
    quantizer.embedding_gs.copy_(W.codebook_snapshot(codes))
    pipe = programs.pipeline(config, frozen, hypernet, quantizer.eval(), device)
    server = ExpertServer.from_codebook(pipe, unet.spec, ucfg, batch_size=serving["batch_size"],
                                        param_dtype=dtype_of(serving["unet_dtype"]))
    stats = {}
    if warm:
        stats = server.warmup(num_inference_steps=serving["num_inference_steps"],
                              guidance_scale=serving["guidance_scale"])
    return Program(pipe, server, mpnet, codes, layout, spec, rc, stats)
