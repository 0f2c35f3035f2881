"""The port's SDXL path on the CPU, held to the plain float32 reference
`tests/sdxl_reference.py` (no JAX: the JAX package has no SDXL).

A tiny SDXL-shaped model: three levels, no attention at level 0, stacks of
1 and 3 transformer layers (the mid block and the first up block take the
3), the "text_time" added condition, and two tiny CLIP towers (a quick-GELU
one re-padded with EOS, and a projected exact-GELU one) whose penultimate
states concatenate to the cross-attention width. Seeded weights, with
random norm affines and biases so that no parameter hides at 1 or 0.

Tolerances: both sides compute in float32 on the CPU and differ only by the
order of their sums, so every relative L2 reads about 1e-7 to 1e-6; each
limit is 1e-5 (1e-4 for the whole trajectory, whose three steps and decode
compound it), which a bfloat16 computation, at about 4e-3 a product, fails
(`test_bf16_in_place_of_f32_fails_the_tolerance`).

One test pins the SD-2.x U-Net: with every stack of depth 1 and no added
embedding its gate layout, MAC table and state dict are the ones the port
had before stacks and added embeddings existed (digests of them).
"""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch
import torch.nn as nn

import sdxl_reference as R
from diffusion_pruning_tpu_torch.core.structure import build_structure
from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.unet.pruned import make_expert_plan, slice_expert_params
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from diffusion_pruning_tpu_torch.pipelines import PruningPipeline
from diffusion_pruning_tpu_torch.pipelines.pruning_pipeline import TextTimeConditioning
from diffusion_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule

torch.set_num_threads(2)
TOL = 1e-5         # one float32 forward against another (read ~1e-6)
TOL_TRAJ = 1e-4    # three CFG DDIM steps and the decode (read ~1e-6)
RES = 64           # pixels: 8×8 latents
STEPS = 3
GUIDANCE = 5.0
CLIP_L = dict(vocab_size=49408, hidden_size=16, num_hidden_layers=3, num_attention_heads=2,
              intermediate_size=32, max_position_embeddings=77, hidden_act="quick_gelu")
CLIP_G = dict(vocab_size=49408, hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
              intermediate_size=64, max_position_embeddings=77, hidden_act="gelu",
              projection_dim=24)
VAE = dict(block_out_channels=(8, 8, 16, 16), latent_channels=4, layers_per_block=1,
           norm_num_groups=4, scaling_factor=0.13025)
SCHED = dict(num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012,
             beta_schedule="scaled_linear", prediction_type="epsilon", steps_offset=1)


@pytest.fixture(autouse=True)
def float32_products():
    """Every comparison in float32 with TF32 off, as the reference asks."""
    with R.float32_matmuls():
        yield


def tiny_sdxl_config(**overrides) -> UNetConfig:
    return UNetConfig.sdxl(
        resolution=RES, block_out_channels=(16, 32, 64), attention_head_dim=(1, 2, 4),
        transformer_layers_per_block=(1, 1, 3), cross_attention_dim=16 + 32,
        norm_num_groups=8, ff_gate_width=4, addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=24 + 6 * 8, use_flash_attention=False,
        **overrides)


def reference_spec(cfg: UNetConfig) -> R.SDXLSpec:
    return R.SDXLSpec(
        sample_size=cfg.sample_size, block_out_channels=cfg.block_out_channels,
        attention_head_dim=cfg.attention_head_dim,
        transformer_layers_per_block=cfg.transformer_layers_per_block,
        cross_attention_dim=cfg.cross_attention_dim, norm_num_groups=cfg.norm_num_groups,
        down_block_types=cfg.down_block_types, up_block_types=cfg.up_block_types,
        ff_gate_width=cfg.ff_gate_width, addition_time_embed_dim=cfg.addition_time_embed_dim,
        projection_class_embeddings_input_dim=cfg.projection_class_embeddings_input_dim)


def seeded_(module: nn.Module, seed: int) -> nn.Module:
    """Every parameter from one generator: matrices normal / sqrt(fan-in),
    norm scales 1 + 0.1·normal, every other vector 0.1·normal."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                r = torch.randn(p.shape, generator=gen)
                if p.dim() <= 1:
                    base = 1.0 if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)) and \
                        name == "weight" else 0.0
                    p.copy_(base + 0.1 * r)
                else:
                    fan = p.shape[0] if isinstance(mod, nn.Embedding) else p[0].numel()
                    p.copy_(r / fan ** 0.5)
    return module.eval()


def clip_config(c: dict) -> CLIPTextConfig:
    return CLIPTextConfig(vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
                          num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
                          intermediate_size=c["intermediate_size"],
                          max_positions=c["max_position_embeddings"],
                          hidden_act=c["hidden_act"], projection_dim=c.get("projection_dim"))


def tiny_sdxl_modules(seed: int = 0):
    """(U-Net config, gated U-Net, CLIP-L, bigG, VAE) of the tiny SDXL, seeded;
    the resnets' norm2 biases zero, as in the benchmark's seeded weights: a
    closed width unit of the gated U-Net is a norm2 group of zeros, which
    its norm maps to the group's bias where an expert has no such group, so
    only with that bias zero do the two compute the same (a property of
    APTP's gates, not of SDXL)."""
    cfg = tiny_sdxl_config()
    unet = seeded_(GatedUNet(cfg), seed)
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if ".resnets." in name and name.endswith("norm2.bias"):
                p.zero_()
    clip_l = seeded_(CLIPTextEncoder(clip_config(CLIP_L)), seed + 1)
    clip_g = seeded_(CLIPTextEncoder(clip_config(CLIP_G)), seed + 2)
    vae = seeded_(AutoencoderKL(VAEConfig(**VAE)), seed + 3)
    return cfg, unet, clip_l, clip_g, vae


def tiny_sdxl_pipeline(seed: int = 0, hypernet=None, quantizer=None) -> PruningPipeline:
    _, unet, clip_l, clip_g, vae = tiny_sdxl_modules(seed)
    schedule = DiffusionSchedule(prediction_type="epsilon")
    return PruningPipeline(unet, vae, clip_l, hypernet, quantizer, schedule,
                           device="cpu", text_encoder_2=clip_g, zero_negative=True)


def reference_unet(unet: GatedUNet) -> R.UNet:
    ref = R.UNet(reference_spec(unet.cfg))
    ref.load_state_dict(unet.state_dict(), strict=True)
    return ref.eval()


def reference_tower(port: CLIPTextEncoder, cfg: dict) -> R.CLIPText:
    ref = R.CLIPText(cfg)
    ref.load_state_dict(port.state_dict(), strict=True)
    return ref.eval()


def reference_vae(vae: AutoencoderKL) -> R.VAE:
    ref = R.VAE(dict(VAE, in_channels=3))
    ref.load_state_dict(vae.state_dict(), strict=True)
    return ref.eval()


def prompt_ids(n: int, seed: int = 5) -> torch.Tensor:
    """CLIP ids (n, 77): BOS, tokens, EOS, then 0 (bigG's padding)."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.zeros((n, 77), dtype=torch.long)
    for i in range(n):
        k = 3 + 4 * i
        ids[i, 0] = 49406
        ids[i, 1:k + 1] = torch.randint(1, 49406, (k,), generator=gen)
        ids[i, k + 1] = R.CLIP_EOS
    return ids


def random_code(layout, seed: int) -> torch.Tensor:
    """A hard code: each width unit kept with p = 0.6 (a site's first always),
    every other depth gate closed."""
    rng = np.random.default_rng(seed)
    code = (rng.random(layout.vq_dim) < 0.6).astype(np.float32)
    for sb in layout.subblocks:
        for s in sb.sites:
            code[s.start] = 1.0
    code[layout.num_width:] = 1.0
    code[layout.num_width::2] = 0.0
    return torch.from_numpy(code)


def rel(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).norm() / b.detach().float().norm())


def unet_inputs(cfg: UNetConfig, b: int, seed: int = 3):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, cfg.sample_size, cfg.sample_size, 4), generator=gen)
    t = torch.tensor([999, 501, 20][:b])
    ehs = torch.randn((b, 77, cfg.cross_attention_dim), generator=gen)
    pooled = torch.randn((b, cfg.projection_class_embeddings_input_dim
                          - 6 * cfg.addition_time_embed_dim), generator=gen)
    tids = R.time_ids(RES, b, "cpu")
    return x, t, ehs, pooled, tids


# ---------------------------------------------------------------- the layout

def test_gate_layout_has_sites_per_stacked_layer():
    """The port's gate layout is the reference's, site for site: a stack of
    3 holds three (attn1, attn2, ff) groups under one depth gate, level 0
    holds resnets alone, and the SDXL-size layout has 10 depth gates."""
    cfg = tiny_sdxl_config()
    port, ref = build_structure(cfg), R.gate_layout(reference_spec(cfg))
    mine = [(sb.name, sb.depth_index, tuple((s.kind, s.start, s.width) for s in sb.sites))
            for sb in port.subblocks]
    theirs = [(sb.name, sb.depth_index, tuple((s.kind, s.start, s.width) for s in sb.sites))
              for sb in ref.subblocks]
    assert mine == theirs
    assert (port.num_width, port.num_depth) == (ref.num_width, ref.num_depth)
    mid = {sb.name: sb for sb in port.subblocks}["mid.attn.0"]
    assert [s.kind for s in mid.sites] == ["attn1", "attn2", "ff"] * 3
    assert not any(sb.name.startswith("down.0.attn") for sb in port.subblocks)
    full = build_structure(UNetConfig.sdxl())
    assert full.num_depth == 10 and sum(sb.kind == "transformer" for sb in full.subblocks) == 11
    layers = sum(len(sb.sites) // 3 for sb in full.subblocks if sb.kind == "transformer")
    assert layers == 70


def test_stacks_of_one_and_no_added_embedding_leave_sd2_unchanged():
    """SD-2.1 at 256 and 512 px and the tiny SD topology: the gate layout and
    MAC table (the StructureSpec's repr) and the state dict's keys and
    shapes are the ones the port had before stacked layers and added
    embeddings (digests of them), with the new keys at their defaults or
    set to one layer a level."""
    def digest(cfg):
        spec = build_structure(cfg)
        with torch.device("meta"):
            unet = GatedUNet(cfg)
        keys = [(k, tuple(v.shape)) for k, v in unet.state_dict().items()]
        return (hashlib.sha256(repr(spec).encode()).hexdigest()[:16],
                hashlib.sha256(repr(keys).encode()).hexdigest()[:16], spec.total_macs)

    want = {256: ("d324a67f86a7e63c", "3178a5b486e4b293", 94029923456.0),
            512: ("cce09c01e2ef3534", "3178a5b486e4b293", 462720162944.0)}
    for res, d in want.items():
        cfg = UNetConfig.sd21(res)
        assert digest(cfg) == d
        assert digest(dataclasses.replace(cfg, transformer_layers_per_block=(1, 1, 1, 1))) == d
    assert digest(UNetConfig.tiny()) == ("4e6cdbb11297c309", "e37a02c701abfb48", 33248960.0)


# ---------------------------------------------------------------- the U-Net

@pytest.mark.parametrize("coded", [False, True])
def test_gated_unet_matches_reference(coded):
    """The port's gated SDXL U-Net (stacks, text_time) equals the reference,
    dense and under a hard code (width gates per stacked layer, depth gates
    closed)."""
    cfg, unet, *_ = tiny_sdxl_modules()
    ref = reference_unet(unet)
    x, t, ehs, pooled, tids = unet_inputs(cfg, 3)
    arch = random_code(R.gate_layout(reference_spec(cfg)), 7).repeat(3, 1) if coded else None
    with torch.no_grad():
        got = unet(x, t, ehs, arch=arch, added_cond=(pooled, tids))
        want = ref(x.permute(0, 3, 1, 2), t, ehs, pooled, tids, arch).permute(0, 2, 3, 1)
    assert rel(got, want) < TOL


def test_added_condition_moves_the_output():
    """The pooled embedding and the time ids reach the output (through
    add_embedding), and a "text_time" U-Net refuses to run without them."""
    cfg, unet, *_ = tiny_sdxl_modules()
    x, t, ehs, pooled, tids = unet_inputs(cfg, 2)
    with torch.no_grad():
        base = unet(x, t, ehs, added_cond=(pooled, tids))
        assert rel(unet(x, t, ehs, added_cond=(pooled * 0, tids)), base) > 1e-3
        assert rel(unet(x, t, ehs, added_cond=(pooled, tids * 0.5)), base) > 1e-3
        with pytest.raises(ValueError, match="text_time"):
            unet(x, t, ehs)


def test_expert_cut_matches_gated_unet_under_its_code():
    """An expert cut at its code's kept widths, each stacked layer at its
    own heads and units, computes what the gated U-Net computes under the
    code."""
    cfg, unet, *_ = tiny_sdxl_modules()
    code = random_code(build_structure(cfg), 11)
    plan = make_expert_plan(unet.spec, code)
    expert = GatedUNet(cfg, plan=plan)
    expert.load_state_dict(slice_expert_params(unet.state_dict(), plan), strict=True)
    tb = expert.mid_block.attentions[0].transformer_blocks
    kept = [len(s.kept) for s in plan.get("mid.attn.0").sites if s.kind == "attn1"]
    assert [b.attn1.heads for b in tb] == kept and len(tb) == 3
    x, t, ehs, pooled, tids = unet_inputs(cfg, 3)
    with torch.no_grad():
        got = expert.eval()(x, t, ehs, added_cond=(pooled, tids))
        want = unet(x, t, ehs, arch=code[None].repeat(3, 1), added_cond=(pooled, tids))
    assert rel(got, want) < TOL


# ---------------------------------------------------------------- the towers

def test_two_towers_and_pooled_feature_match_reference():
    """`encode_prompt` concatenates CLIP-L's penultimate states on the
    EOS-padded ids with bigG's on the ids as given, and carries bigG's
    pooled, projected feature and the time ids; the empty negative is
    zeros for both, with the same time ids."""
    pipe = tiny_sdxl_pipeline()
    ref_l = reference_tower(pipe.text_encoder, CLIP_L)
    ref_g = reference_tower(pipe.text_encoder_2, CLIP_G)
    ids = prompt_ids(3)
    cond = pipe.encode_prompt(ids)
    assert isinstance(cond, TextTimeConditioning)
    states, pooled = R.encode(ref_l, ref_g, ids)
    assert cond.states.shape == (3, 77, 48) and cond.text_embeds.shape == (3, 24)
    assert rel(cond.states, states) < TOL and rel(cond.text_embeds, pooled) < TOL
    assert torch.equal(cond.time_ids, R.time_ids(RES, 3, "cpu"))
    # CLIP-L's padding matters: the same ids padded with 0 give other states
    unpadded = ref_l.hidden_states(ids)[-2]
    assert rel(cond.states[..., :16], unpadded) > 1e-2
    neg = pipe.encode_negative(prompt_ids(1))
    assert not neg.states.any() and not neg.text_embeds.any()
    assert neg.states.shape == (1, 77, 48) and torch.equal(neg.time_ids, cond.time_ids[:1])


# ---------------------------------------------------------------- a trajectory

def test_pipeline_trajectory_matches_reference():
    """Three CFG DDIM steps (guidance 5) of the gated U-Net under a code,
    with the zero negative, and the decode: the pipeline's images equal the
    reference's."""
    pipe = tiny_sdxl_pipeline()
    cfg = pipe.unet.cfg
    layout = R.gate_layout(reference_spec(cfg))
    codes = torch.stack([random_code(layout, 13), random_code(layout, 14)])
    ids = prompt_ids(2)
    latents = torch.randn((2, cfg.sample_size, cfg.sample_size, 4),
                          generator=torch.Generator().manual_seed(4))
    got = pipe.generate_samples(ids, prompt_ids(1).repeat(2, 1), arch=codes, num_inference_steps=STEPS,
                                guidance_scale=GUIDANCE, latents=latents)
    want = R.serve(reference_unet(pipe.unet), reference_tower(pipe.text_encoder, CLIP_L),
                   reference_tower(pipe.text_encoder_2, CLIP_G), reference_vae(pipe.vae),
                   ids, codes, latents, SCHED, STEPS, GUIDANCE, RES)
    assert got.shape == (2, RES, RES, 3)
    assert rel(got, want) < TOL_TRAJ


def test_expert_server_serves_sdxl_through_tiers():
    """`ServingQueue` over an SDXL `ExpertServer` (two experts, tiers 1 and
    2): the conditioning rides through submit, join and the tier rows, and
    each request's image equals the reference's under its expert's code."""
    from diffusion_pruning_tpu_torch.pipelines.expert_server import ExpertServer, ServingQueue
    cfg = tiny_sdxl_config()
    spec = build_structure(cfg)
    hypernet = seeded_(HyperStructure(spec, input_dim=8), 9)
    quantizer = StructureQuantizer(spec, n_e=2, base=0.0)
    codes = torch.stack([random_code(spec, 21), random_code(spec, 22)])
    with torch.no_grad():
        quantizer.embedding_gs.copy_(torch.where(codes >= 0.5, 0.8, 0.2))
    pipe = tiny_sdxl_pipeline(hypernet=hypernet, quantizer=quantizer.eval())
    server = ExpertServer.from_codebook(pipe, spec, cfg, batch_size=2)
    queue = ServingQueue(server, num_inference_steps=STEPS, guidance_scale=GUIDANCE)
    ids = prompt_ids(3)
    latents = torch.randn((3, cfg.sample_size, cfg.sample_size, 4),
                          generator=torch.Generator().manual_seed(6))
    experts = [0, 1, 0]
    rids = []
    for i, e in enumerate(experts):
        noise = 1e3 * (2 * codes[e:e + 1] - 1)
        rids += queue.submit(ids[i:i + 1], prompt_ids(1), hyper_net_input=torch.zeros(1, 8),
                             route_noise=noise, latents=latents[i:i + 1])
    images = queue.flush()
    assert [queue.routes[r] for r in rids] == experts
    want = R.serve(reference_unet(pipe.unet), reference_tower(pipe.text_encoder, CLIP_L),
                   reference_tower(pipe.text_encoder_2, CLIP_G), reference_vae(pipe.vae),
                   ids, codes[experts], latents, SCHED, STEPS, GUIDANCE, RES)
    got = torch.stack([images[r] for r in rids])
    assert rel(got, want) < TOL_TRAJ


def test_bf16_in_place_of_f32_fails_the_tolerance():
    """The U-Net's limit is tight enough to refuse bfloat16: the same U-Net
    with its weights and inputs rounded through bfloat16 reads above it."""
    cfg, unet, *_ = tiny_sdxl_modules()
    ref = reference_unet(unet)
    x, t, ehs, pooled, tids = unet_inputs(cfg, 3)
    rounded = GatedUNet(cfg).eval()
    with torch.no_grad():
        rounded.load_state_dict({k: v.bfloat16().float() for k, v in unet.state_dict().items()})
        got = rounded(x.bfloat16().float(), t, ehs.bfloat16().float(),
                      added_cond=(pooled.bfloat16().float(), tids))
        want = ref(x.permute(0, 3, 1, 2), t, ehs, pooled, tids).permute(0, 2, 3, 1)
    assert rel(got, want) > TOL
