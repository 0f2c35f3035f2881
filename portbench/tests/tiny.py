"""A tiny configuration and mix of the serving cells, for the CPU tests:
the SD topology at small widths, 4 experts, DDIM-3."""
import copy
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tiny_config() -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", "aptp-sd21-256.json")) as f:
        c = json.load(f)
    c = copy.deepcopy(c)
    c.update(block_out_channels=[32, 64], attention_head_dim=[2, 4], cross_attention_dim=32,
             norm_num_groups=8, layers_per_block=2)
    c["aptp_gating"].update(down_block_types=["CrossAttnDownBlock2DHalfGated",
                                              "DownBlock2DHalfGated"],
                            up_block_types=["UpBlock2DHalfGated", "CrossAttnUpBlock2DHalfGated"],
                            ff_gate_width=4)
    c["text_encoder"].update(hidden_size=32, intermediate_size=64, num_attention_heads=2,
                             num_hidden_layers=2, torch_dtype="float32")
    c["vae"].update(block_out_channels=[8, 8, 16, 16], layers_per_block=1, norm_num_groups=4,
                    torch_dtype="float32")
    c["mpnet"].update(hidden_size=32, intermediate_size=64, num_attention_heads=2,
                      num_hidden_layers=2, max_position_embeddings=140)
    c["router"].update(hypernet_input_dim=32, num_experts=4, depth_order=[-1, -2, 0, 1, -3, 2])
    c["codebook"].update(depth_closed_min=1, depth_closed_max=2)
    c["serving"].update(resolution=64, num_inference_steps=3, batch_size=4,
                        unet_dtype="float32")
    c["training"].update(train_batch_size=6, lr_warmup_steps=2)
    return c


def tiny_train_mix() -> dict:
    return {"loop": "train", "prompt_tokens": [3, 5, 8], "reference_steps": 3,
            "trace": {"last_s": 1.0}}


def tiny_mix(loop: str = "open") -> dict:
    mix = {"loop": loop, "entry": "experts",
           "expert_popularity": {"law": "zipf", "s": 1.0},
           "prompt_tokens": [3, 5, 8], "reference_sample": 4,
           "trace": {"last_s": 1.0}}
    if loop == "open":
        mix["rate_per_s"] = 4.0
    else:
        mix["clients"] = 4
    return mix
