"""Static configuration of the gated U-Net.

The same configuration surface as the JAX package's `UNetConfig` (block-type
lists, channel plan, head counts), as a frozen dataclass: the gate layout
(`core.structure.StructureSpec`) and the MAC table are derived from it alone.

Following the diffusers naming quirk, `attention_head_dim` holds the *number
of heads* per level (5/10/20/20 for SD-2.1, head size 64).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

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

    @property
    def num_levels(self) -> int:
        return len(self.block_out_channels)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def heads_at(self, level: int) -> int:
        return self.attention_head_dim[level]

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
