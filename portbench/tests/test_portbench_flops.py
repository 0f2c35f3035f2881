"""The benchmark's operation and byte arithmetic against counts taken from
the models themselves (`torch.utils.flop_counter` on the meta device) and
against hand counts."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import family, flops
from portbench.harness import weights as W
from portbench.reference import sd as ref
from portbench.tests.tiny import tiny_config


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def configs():
    tiny = tiny_config()
    bigger = tiny_config()
    bigger.update(block_out_channels=[64, 128], attention_head_dim=[2, 4])
    bigger["serving"]["resolution"] = 128
    return [tiny, bigger]


@pytest.mark.parametrize("config", configs(), ids=["tiny", "wider-128px"])
def test_dense_unet_forward_matches_the_counted_model(config):
    spec = ref.unet_spec(config)
    with torch.device("meta"):
        unet = ref.UNet(spec)
        b, s = 3, spec.sample_size
        x = torch.zeros(b, spec.in_channels, s, s)
        t = torch.zeros(b, dtype=torch.long)
        ehs = torch.zeros(b, spec.max_text_len, spec.cross_attention_dim)
        got = counted(lambda: unet(x, t, ehs))
    assert family.counts(config).unet_forward_flops(spec, unet.layout, None, b) == got


@pytest.mark.parametrize("config", configs(), ids=["tiny", "wider-128px"])
def test_expert_unet_forward_matches_the_programs_expert(config):
    """The expert's count at its kept widths against the program's own
    physically pruned expert U-Net, for every code of the seeded codebook."""
    from diffusion_pruning_tpu_torch.models.unet.pruned import make_expert_plan
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    spec = ref.unet_spec(config)
    layout = ref.gate_layout(spec)
    codes = W.expert_codes(layout, 4, config["codebook"])
    ucfg = family.program(config).unet_config(config)
    ucfg = type(ucfg)(**{**ucfg.__dict__, "use_flash_attention": False})
    port_spec = GatedUNet(ucfg).spec
    assert (codes[1::2, layout.num_width:] == 0).any(), "no code closes a depth gate"
    for code in codes:
        with torch.device("meta"):
            expert = GatedUNet(ucfg, plan=make_expert_plan(port_spec, code.numpy()))
            b, s = 2, spec.sample_size
            x = torch.zeros(b, s, s, spec.in_channels)
            t = torch.zeros(b, dtype=torch.long)
            ehs = torch.zeros(b, spec.max_text_len, spec.cross_attention_dim)
            got = counted(lambda: expert(x, t, ehs))
        assert family.counts(config).unet_forward_flops(spec, layout, code, b) == got


@pytest.mark.parametrize("config", configs(), ids=["tiny", "wider-128px"])
def test_vae_decode_and_clip_text_match_the_counted_models(config):
    spec = ref.unet_spec(config)
    with torch.device("meta"):
        vae = ref.VAE(config["vae"])
        z = torch.zeros(2, config["vae"]["latent_channels"], spec.sample_size, spec.sample_size)
        assert flops.vae_decode_flops(config["vae"], spec.sample_size, 2) == \
            counted(lambda: vae.decode(z))
        clip = ref.CLIPText(config["text_encoder"])
        ids = torch.zeros(3, 77, dtype=torch.long)
        assert flops.clip_text_flops(config["text_encoder"], 3) == counted(lambda: clip(ids))


@pytest.mark.parametrize("b,h,s_q,s_kv", [(16, 5, 1024, 77), (16, 10, 4096, 4096)])
def test_attention_counts_by_hand(b, h, s_q, s_kv):
    # QKᵀ and PV: 2 products of s_q × s_kv × 64 multiply-adds per (row, head)
    assert flops.attention_flops(b, h, s_q, s_kv) == 2 * 2 * b * h * s_q * s_kv * 64
    # bf16 q and o (s_q rows), k and v (s_kv rows), 64 wide, once each
    assert flops.attention_bytes(b, h, s_q, s_kv) == b * h * 64 * 2 * (2 * s_q + 2 * s_kv)
    bound = flops.attention_bound_s(b, h, s_q, s_kv)
    assert bound == max(flops.attention_flops(b, h, s_q, s_kv) / 989e12,
                        flops.attention_bytes(b, h, s_q, s_kv) / 3.35e12)


def test_attention_calls_follow_the_kept_heads():
    config = tiny_config()
    spec = ref.unet_spec(config)
    layout = ref.gate_layout(spec)
    code = torch.ones(layout.vq_dim)
    calls = family.counts(config).attention_calls(spec, layout, code, 4)
    sites = [sb for sb in layout.subblocks if sb.kind == "transformer"]
    assert len(calls) == 2 * len(sites)
    first = sites[0]
    code[first.sites[0].start] = 0.0        # one head of the first self-attention off
    calls2 = family.counts(config).attention_calls(spec, layout, code, 4)
    assert calls2[0][1] == calls[0][1] - 1 and calls2[1:] == calls[1:]


@pytest.mark.parametrize("config", configs(), ids=["tiny", "wider-128px"])
def test_vae_encode_matches_the_counted_model(config):
    res = config["serving"]["resolution"]
    with torch.device("meta"):
        vae = ref.VAE(config["vae"])
        x = torch.zeros(2, 3, res, res)
        eps = torch.zeros(2, config["vae"]["latent_channels"], res // 8, res // 8)
        assert flops.vae_encode_flops(config["vae"], res, 2) == counted(lambda: vae.encode(x, eps))
