"""The program under test, built from a configuration file and the seed.

Every module is made on the card from the seed (`weights.seeded_init_`), in
the dtype `cli/serve.py` serves it in: the U-Net, the VAE and CLIP text in
bfloat16, MPNet, the hypernet and the quantizer in float32. The quantizer's
codebook snapshot is the configuration's seeded rule, and the experts are
`ExpertServer.from_codebook(..., param_dtype=bfloat16)` of it, as in
`cli/serve.py --mode experts`.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from portbench.harness import weights as W
from portbench.reference import sd as ref


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


def unet_config(config: dict):
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    spec = ref.unet_spec(config)
    g = config["aptp_gating"]
    return UNetConfig(
        sample_size=spec.sample_size, in_channels=spec.in_channels,
        out_channels=spec.out_channels, down_block_types=spec.down_block_types,
        mid_block_type=g["mid_block_type"], up_block_types=spec.up_block_types,
        block_out_channels=spec.block_out_channels, layers_per_block=spec.layers_per_block,
        attention_head_dim=spec.attention_head_dim,
        cross_attention_dim=spec.cross_attention_dim, norm_num_groups=spec.norm_num_groups,
        norm_eps=spec.norm_eps, use_linear_projection=config["use_linear_projection"],
        max_text_len=spec.max_text_len, freq_shift=spec.freq_shift,
        flip_sin_to_cos=spec.flip_sin_to_cos, gated_ff=True, ff_gate_width=spec.ff_gate_width,
        use_flash_attention=True)


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


def frozen_models(config: dict, seed: int, device):
    """(U-Net config, U-Net, CLIP text, VAE) of a configuration, made from
    the seed in their served dtypes; the U-Net's gate layout checked
    against the reference's."""
    from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    serving, te, vc = config["serving"], config["text_encoder"], config["vae"]
    ucfg = unet_config(config)
    unet = materialise(lambda: GatedUNet(ucfg), device, dtype_of(serving["unet_dtype"]), seed,
                       "unet")
    check_layout(unet.spec, ref.gate_layout(ref.unet_spec(config)))
    clip = materialise(lambda: CLIPTextEncoder(CLIPTextConfig(
        vocab_size=te["vocab_size"], hidden_size=te["hidden_size"],
        num_layers=te["num_hidden_layers"], num_heads=te["num_attention_heads"],
        intermediate_size=te["intermediate_size"], max_positions=te["max_position_embeddings"],
        layer_norm_eps=te["layer_norm_eps"], hidden_act=te["hidden_act"])),
        device, dtype_of(te["torch_dtype"]), seed, "text_encoder")
    vae = materialise(lambda: AutoencoderKL(VAEConfig(
        latent_channels=vc["latent_channels"], block_out_channels=tuple(vc["block_out_channels"]),
        layers_per_block=vc["layers_per_block"], norm_num_groups=vc["norm_num_groups"],
        scaling_factor=vc["scaling_factor"])), device, dtype_of(vc["torch_dtype"]), seed, "vae")
    return ucfg, unet, clip, vae


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
    from diffusion_pruning_tpu_torch.pipelines.pruning_pipeline import PruningPipeline

    serving, mc, rc = config["serving"], config["mpnet"], config["router"]
    spec = ref.unet_spec(config)
    layout = ref.gate_layout(spec)
    ucfg, unet, clip, vae = frozen_models(config, seed, device)
    mpnet = materialise(lambda: MPNetEncoder(MPNetConfig(
        vocab_size=mc["vocab_size"], hidden_size=mc["hidden_size"],
        num_layers=mc["num_hidden_layers"], num_heads=mc["num_attention_heads"],
        intermediate_size=mc["intermediate_size"], max_positions=mc["max_position_embeddings"])),
        device, dtype_of(mc["torch_dtype"]), seed, "mpnet")
    hypernet, quantizer = router_modules(config, unet.spec, seed, device)
    codes = W.expert_codes(layout, rc["num_experts"], config["codebook"]).to(device)
    quantizer.embedding_gs.copy_(W.codebook_snapshot(codes))
    pipe = PruningPipeline(unet, vae, clip, hypernet, quantizer.eval(), schedule(config),
                           device=device, sampler=serving["sampler"])
    server = ExpertServer.from_codebook(pipe, unet.spec, ucfg, batch_size=serving["batch_size"],
                                        param_dtype=dtype_of(serving["unet_dtype"]))
    stats = {}
    if warm:
        stats = server.warmup(num_inference_steps=serving["num_inference_steps"],
                              guidance_scale=serving["guidance_scale"])
    return Program(pipe, server, mpnet, codes, layout, spec, rc, stats)
