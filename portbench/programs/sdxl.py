"""The program of the SDXL U-Net family (`reference/sdxl.py`): the port's
gated SDXL U-Net (stacked transformer layers, "text_time" conditioning),
its two CLIP text towers and the VAE, made from the seed in their served
dtypes, and the `PruningPipeline` over them, which encodes each prompt with
both towers and, for an empty negative prompt, takes zeros.
"""
from __future__ import annotations

from portbench.harness import family
from portbench.harness.program import check_layout, dtype_of, materialise, schedule


def unet_config(config: dict):
    """The port's `UNetConfig` of the configuration's U-Net."""
    from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
    spec = family.reference(config).unet_spec(config)
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
        use_flash_attention=True,
        transformer_layers_per_block=spec.transformer_layers_per_block,
        addition_embed_type=config["addition_embed_type"],
        addition_time_embed_dim=spec.addition_time_embed_dim,
        projection_class_embeddings_input_dim=spec.projection_class_embeddings_input_dim)


def _tower(config: dict, te: dict):
    from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
    te = family.reference(config).tower(te)
    return CLIPTextEncoder(CLIPTextConfig(
        vocab_size=te["vocab_size"], hidden_size=te["hidden_size"],
        num_layers=te["num_hidden_layers"], num_heads=te["num_attention_heads"],
        intermediate_size=te["intermediate_size"], max_positions=te["max_position_embeddings"],
        layer_norm_eps=te["layer_norm_eps"], hidden_act=te["hidden_act"],
        projection_dim=te.get("projection_dim")))


def frozen_models(config: dict, seed: int, device):
    """(U-Net config, U-Net, CLIP-L, bigG, VAE) of a configuration, made from
    the seed in their served dtypes; the U-Net's gate layout checked
    against the reference's. The harness reads the first two."""
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    serving, vc = config["serving"], config["vae"]
    ucfg = unet_config(config)
    unet = materialise(lambda: GatedUNet(ucfg), device, dtype_of(serving["unet_dtype"]), seed,
                       "unet")
    ref = family.reference(config)
    check_layout(unet.spec, ref.gate_layout(ref.unet_spec(config)))
    towers = [materialise(lambda te=config[key]: _tower(config, te), device,
                          dtype_of(config[key]["torch_dtype"]), seed, key)
              for key in ("text_encoder", "text_encoder_2")]
    vae = materialise(lambda: AutoencoderKL(VAEConfig(
        latent_channels=vc["latent_channels"], block_out_channels=tuple(vc["block_out_channels"]),
        layers_per_block=vc["layers_per_block"], norm_num_groups=vc["norm_num_groups"],
        scaling_factor=vc["scaling_factor"])), device, dtype_of(vc["torch_dtype"]), seed, "vae")
    return (ucfg, unet, *towers, vae)


def pipeline(config: dict, frozen, hypernet, quantizer, device):
    """The routed pipeline over `frozen_models`' modules and the router; an
    empty configured negative prompt encodes to zeros."""
    from diffusion_pruning_tpu_torch.pipelines.pruning_pipeline import PruningPipeline
    _, unet, clip_l, clip_g, vae = frozen
    serving = config["serving"]
    return PruningPipeline(unet, vae, clip_l, hypernet, quantizer, schedule(config), device=device,
                           sampler=serving["sampler"], text_encoder_2=clip_g,
                           zero_negative=serving["negative_prompt"] == "")
