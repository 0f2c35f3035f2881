"""The model family `sdxl` and the routed entry point on the CPU: the
family's three files (`reference/sdxl.py`, `counts/sdxl.py`,
`programs/sdxl.py`) run a tiny SDXL-shaped cell through the harness, traced,
and the reference agrees with the program; the program's and the
reference's modules take the same weights from the seed at full size; the
`encode_ms_p50.xl` reader on planted spans; and a tiny routed cell
(`entries/routed.py`) served by the gated U-Net alone."""
import copy
import dataclasses
import json
import os
import time

import pytest
import torch

from portbench.harness import cell, check, family, named
from portbench.harness import weights as W
from portbench.harness.trace import Timeline
from portbench.tests.tiny import ROOT, tiny_config, tiny_mix

XL = "sdxl-base-1024-experts-closed16"
ROUTED = "aptp256-routed-poisson"


def sdxl_config() -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", "sdxl-base-1024.json")) as f:
        return json.load(f)


def tiny_sdxl_config() -> dict:
    """SDXL's topology at small widths: three levels, no attention at level
    0, stacks of 1 and 3 layers, text_time, two tiny towers; 4 experts,
    DDIM-3 at 64 px, all in float32."""
    c = copy.deepcopy(sdxl_config())
    c.update(block_out_channels=[16, 32, 64], attention_head_dim=[1, 2, 4],
             transformer_layers_per_block=[1, 1, 3], cross_attention_dim=16 + 32,
             norm_num_groups=8, addition_time_embed_dim=8,
             projection_class_embeddings_input_dim=24 + 6 * 8)
    c["aptp_gating"].update(ff_gate_width=4)
    c["text_encoder"].update(hidden_size=16, intermediate_size=32, num_attention_heads=2,
                             num_hidden_layers=3, projection_dim=16, torch_dtype="float32")
    c["text_encoder_2"].update(hidden_size=32, intermediate_size=64, num_attention_heads=2,
                               num_hidden_layers=3, projection_dim=24, torch_dtype="float32")
    c["vae"].update(block_out_channels=[8, 8, 16, 16], layers_per_block=1, norm_num_groups=4,
                    torch_dtype="float32")
    c["mpnet"].update(hidden_size=32, intermediate_size=64, num_attention_heads=2,
                      num_hidden_layers=2, max_position_embeddings=140)
    c["router"].update(hypernet_input_dim=32, num_experts=4)
    c["codebook"].update(depth_closed_min=1, depth_closed_max=2)
    c["serving"].update(resolution=64, num_inference_steps=3, batch_size=4,
                        unet_dtype="float32")
    return c


def per_layer(workload: str) -> list:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [m for m in json.load(f)["per_layer"] if workload in m.get("workloads", [])]


def captured(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def wrapper(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)
    monkeypatch.setattr(module, name, wrapper)
    return calls


# A traced slice holding an attention forward, so that the readers of the
# counts find something to count.
SLICE = Timeline(1.0, [("gated_flash_fwd_small", 0, 10 ** 6)], [])


def test_the_sdxl_family_serves_a_tiny_cell_through_the_harness(monkeypatch):
    """A closed-loop tiny SDXL cell, traced, on the CPU: every request
    answered and routed to its expert, the images equal the reference's to
    float32 rounding, the span and counter readers of the cell read, and
    the counts' readers count on a planted slice."""
    contexts = captured(monkeypatch, cell, "read_metrics")
    fields, checks = cell.run(ROOT, {"name": XL}, per_layer(XL), tiny_sdxl_config(),
                              dict(tiny_mix("closed"), trace={"last_s": 1.0}), 2 ** 31 + 29,
                              1.5, True, torch.device("cpu"), time.perf_counter())
    assert check.correct({k: v for k, v in checks.items() if not k.startswith("_")}), checks
    assert fields["attempted"] > 0 and fields["failed"] == 0
    assert checks["image_rel_l2_max"]["value"] < 1e-4
    assert {"tier_fill.serve", "program_hit.serve"} <= set(fields["metrics"])
    ctx = contexts[0][0][2]
    ctx.timeline = SLICE
    for name in ("mfu.serve", "attn_fwd_roofline.serve"):
        assert named.load("metrics", name).read(ctx) > 0, name


def test_program_and_reference_take_the_same_weights_at_full_size():
    """Every module the SDXL reference rebuilds has the program's state-dict
    names, shapes and kinds of leaf at the published widths, so the seed
    gives both the same values; CLIP-L has no projection, bigG has one."""
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    from portbench.programs import sdxl as programs
    config = sdxl_config()
    ref = family.reference(config)
    with torch.device("meta"):
        mine = {"unet": GatedUNet(programs.unet_config(config)),
                "text_encoder": programs._tower(config, config["text_encoder"]),
                "text_encoder_2": programs._tower(config, config["text_encoder_2"])}
        theirs = {tag: ctor(config) for tag, ctor, _ in ref.MODULES}
    for tag, module in mine.items():
        got = [(n, tuple(p.shape), kind) for n, p, kind, _ in W.leaves(module)]
        want = [(n, tuple(p.shape), kind) for n, p, kind, _ in W.leaves(theirs[tag])]
        assert got == want, tag
    assert not hasattr(mine["text_encoder"], "text_projection")
    assert mine["text_encoder_2"].text_projection.weight.shape == (1280, 1280)
    assert sum(p.numel() for p in mine["unet"].parameters()) == 2_567_463_684


def test_sdxl_counts_at_full_size():
    """The dense U-Net forward at 1024 px: 6.7-6.8 TFLOP an image, over 8×
    the SD-2.1-base U-Net's at 512 px; the stacked layers' attention calls
    (self and cross, each of 70 layers) and an expert's fewer products."""
    config = sdxl_config()
    ref, counts = family.reference(config), family.counts(config)
    spec = ref.unet_spec(config)
    layout = ref.gate_layout(spec)
    dense = counts.unet_forward_flops(spec, layout, None, 1)
    assert 6.7e12 < dense < 6.8e12
    assert len(counts.attention_calls(spec, layout, None, 1)) == 140
    code = W.expert_codes(layout, 8, config["codebook"])[1]
    assert counts.unet_forward_flops(spec, layout, code, 1) < 0.8 * dense
    flops = counts.request_flops(config, spec, layout, None, 25)
    assert flops[0] == 25 * 2 * dense and len(flops) == 3
    with pytest.raises(ValueError, match="no stage-1"):
        counts.stage1_step_flops(config, spec, layout, 8)


@dataclasses.dataclass
class _Span:
    id: int
    name: str
    parent: object
    device_ms: object = None
    end_ns: int = 1


def test_encode_ms_reader_sums_both_towers_per_submit():
    """`encode_ms_p50.xl`: clip_l + clip_bigg stream ms under each submit
    (under encode_prompt or encode_negative), the median over submits; spans
    outside a submit and spans with no device time are not read."""
    spans = [_Span(1, "submit", None), _Span(2, "encode_prompt", 1),
             _Span(3, "clip_l", 2, 1.0), _Span(4, "clip_bigg", 2, 4.0),
             _Span(5, "submit", None), _Span(6, "encode_prompt", 5),
             _Span(7, "clip_l", 6, 2.0), _Span(8, "clip_bigg", 6, 6.0),
             _Span(9, "encode_negative", 5), _Span(10, "clip_l", 9, 1.0),
             _Span(11, "submit", None), _Span(12, "encode_prompt", 11),
             _Span(13, "clip_l", 12, 3.0), _Span(14, "clip_bigg", 12, 20.0),
             _Span(15, "clip_l", None, 99.0), _Span(16, "clip_bigg", 12, None)]
    reader = named.load("metrics", "encode_ms_p50.xl")
    ctx = dataclasses.make_dataclass("Ctx", ["program"])(spans)
    assert reader.read(ctx) == 9.0
    assert reader.read(ctx.__class__([])) is None


def test_routed_entry_serves_every_request_on_the_gated_unet():
    """The routed cell at the tiny SD size: no experts; every request of the
    open loop is denoised in the pooled gated batch and equals the reference
    (the dense U-Net under its routed code)."""
    from diffusion_pruning_tpu_torch.utils import profiling
    before = dict(profiling.tiers_served())
    mix = dict(tiny_mix("open"), entry="routed")
    fields, checks = cell.run(ROOT, {"name": ROUTED}, [], tiny_config(), mix, 2 ** 31 + 31, 1.5,
                              False, torch.device("cpu"), time.perf_counter())
    assert check.correct(checks), checks
    assert fields["attempted"] > 0 and fields["failed"] == 0
    assert checks["image_rel_l2_max"]["value"] < 1e-4
    prog = named.load("entries", "routed").build(tiny_config(), 3, torch.device("cpu"),
                                                warm=False)
    assert prog.server.expert_models == []
    assert sum(profiling.tiers_served().values()) > sum(before.values())
