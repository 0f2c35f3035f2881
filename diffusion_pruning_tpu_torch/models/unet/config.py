"""Static configuration of the gated U-Net.

The same configuration surface as the JAX package's `UNetConfig` (block-type
lists, channel plan, head counts), as a frozen dataclass: the gate layout
(`core.structure.StructureSpec`) and the MAC table are derived from it alone.

Following the diffusers naming quirk, `attention_head_dim` holds the *number
of heads* per level (5/10/20/20 for SD-2.1, head size 64).

SDXL's U-Net adds two keys of diffusers' `UNet2DConditionModel`:
`transformer_layers_per_block`, the transformer layers stacked in each
`Transformer2D` of a level (1, 2, 10 for SDXL; the mid block takes the last
level's count, the up blocks the reversed counts), and `addition_embed_type`
"text_time", a pooled text embedding and six sinusoidal size and crop ids
fed through `add_embedding` into the time embedding. With every count 1 and
no added embedding the U-Net is SD-2.x's, state dict and gate layout alike.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

DOWN_BLOCK_TYPES = (
    "CrossAttnDownBlock2D",
    "CrossAttnDownBlock2DGated",
    "CrossAttnDownBlock2DHalfGated",
    "DownBlock2D",
    "DownBlock2DGated",
    "DownBlock2DHalfGated",
)
UP_BLOCK_TYPES = (
    "CrossAttnUpBlock2D",
    "CrossAttnUpBlock2DGated",
    "CrossAttnUpBlock2DHalfGated",
    "UpBlock2D",
    "UpBlock2DGated",
    "UpBlock2DHalfGated",
)
MID_BLOCK_TYPES = ("UNetMidBlock2DCrossAttn", "UNetMidBlock2DCrossAttnWidthGated")


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 32                # latent spatial size (256px / 8)
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2DHalfGated",
        "CrossAttnDownBlock2DHalfGated",
        "CrossAttnDownBlock2DHalfGated",
        "DownBlock2DHalfGated",
    )
    mid_block_type: str = "UNetMidBlock2DCrossAttnWidthGated"
    up_block_types: Tuple[str, ...] = (
        "UpBlock2DHalfGated",
        "CrossAttnUpBlock2DHalfGated",
        "CrossAttnUpBlock2DHalfGated",
        "CrossAttnUpBlock2DHalfGated",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # number of heads per level (diffusers naming quirk preserved)
    attention_head_dim: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    # linear proj_in/proj_out (SD-2.x); False = 1×1 convs (SD-1.x)
    use_linear_projection: bool = True
    max_text_len: int = 77
    freq_shift: int = 0
    flip_sin_to_cos: bool = True
    gated_ff: bool = True
    ff_gate_width: int = 32
    ff_mult: int = 4
    # route attention on CUDA tensors through the hand-written gated flash
    # forward (ops/flash_attention.py); False = plain masked attention
    use_flash_attention: bool = False
    # recompute each resnet and transformer subblock in the backward pass
    # (torch.utils.checkpoint), trading step time for activation memory; the
    # original APTP code's `gradient_checkpointing`
    remat: bool = False
    # route every resnet norm (+SiLU) and transformer norm through the
    # one-pass GroupNorm kernel (ops/group_norm.py), on channels_last
    # activations; `pipelines/expert_server.build_expert` sets it for served
    # bf16 CUDA experts, whose conv weights it makes channels_last too (the
    # NHWC route: no convolution converts a layout, and the output head's
    # norm takes the kernel as well)
    fused_norms: bool = False
    # fold GroupNorm(+gate)+SiLU into the input read of the consumer product
    # (ops/norm_conv.py): the resnets' norm→conv3x3 pairs, conv_norm_out→
    # conv_out and the transformers' norm→proj_in (a linear proj_in only;
    # a 1×1 conv proj_in keeps its norm unfused); wins over `fused_norms`
    # wherever it applies. Both flags keep the unfused state dict
    fused_norm_conv: bool = False
    # transformer layers per `Transformer2D`, per level (None: one each)
    transformer_layers_per_block: Optional[Tuple[int, ...]] = None
    # None, or "text_time" (SDXL): `add_embedding` of [pooled text embedding,
    # sinusoidal features of the six time ids] added to the time embedding
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816

    def __post_init__(self):
        if self.addition_embed_type not in (None, "text_time"):
            raise ValueError(f"addition_embed_type {self.addition_embed_type!r}: the U-Net "
                             "takes None or 'text_time'")
        layers = self.transformer_layers_per_block
        if layers is not None and len(layers) != len(self.block_out_channels):
            raise ValueError("transformer_layers_per_block needs one count per level")

    @property
    def num_levels(self) -> int:
        return len(self.block_out_channels)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def heads_at(self, level: int) -> int:
        return self.attention_head_dim[level]

    def transformer_layers_at(self, level: int) -> int:
        """Transformer layers stacked in each `Transformer2D` of `level` (an up
        block at level L-1-i takes level L-1-i's count, the mid block the
        last level's)."""
        layers = self.transformer_layers_per_block
        return 1 if layers is None else layers[level]

    @classmethod
    def sd21(cls, resolution: int = 256, **overrides) -> "UNetConfig":
        """Stable Diffusion 2.1 U-Net at a given pixel resolution, with the
        gated flash attention kernel on."""
        overrides.setdefault("use_flash_attention", True)
        return cls(sample_size=resolution // 8, **overrides)

    @classmethod
    def tiny(cls, **overrides) -> "UNetConfig":
        """Small config with the SD topology, for tests."""
        defaults = dict(
            sample_size=8,
            block_out_channels=(32, 64),
            layers_per_block=2,
            attention_head_dim=(2, 4),
            cross_attention_dim=32,
            norm_num_groups=8,
            ff_gate_width=4,
            down_block_types=("CrossAttnDownBlock2DHalfGated", "DownBlock2DHalfGated"),
            up_block_types=("UpBlock2DHalfGated", "CrossAttnUpBlock2DHalfGated"),
        )
        defaults.update(overrides)
        return cls(**defaults)

    @classmethod
    def sdxl(cls, resolution: int = 1024, **overrides) -> "UNetConfig":
        """Stable Diffusion XL base 1.0's U-Net (`unet/config.json`) with the
        APTP gated block types, at a given pixel resolution, with the gated
        flash attention kernel on."""
        defaults = dict(
            sample_size=resolution // 8,
            down_block_types=("DownBlock2DHalfGated", "CrossAttnDownBlock2DHalfGated",
                              "CrossAttnDownBlock2DHalfGated"),
            up_block_types=("CrossAttnUpBlock2DHalfGated", "CrossAttnUpBlock2DHalfGated",
                            "UpBlock2DHalfGated"),
            block_out_channels=(320, 640, 1280),
            attention_head_dim=(5, 10, 20),
            cross_attention_dim=2048,
            transformer_layers_per_block=(1, 2, 10),
            addition_embed_type="text_time",
            use_flash_attention=True,
        )
        defaults.update(overrides)
        return cls(**defaults)
