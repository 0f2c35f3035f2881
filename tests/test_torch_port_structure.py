"""The PyTorch port's gate layout, gate functions, resource model, import
isolation and device rules, held against the JAX package on the CPU."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pruning_tpu.core.resource import ResourceModel as JaxResourceModel
from diffusion_pruning_tpu.core.structure import build_structure as jax_build_structure
from diffusion_pruning_tpu.models.unet.config import UNetConfig as JaxUNetConfig
from diffusion_pruning_tpu.ops import gates as jax_gates
from diffusion_pruning_tpu_torch.core.estimators import hard_concrete
from diffusion_pruning_tpu_torch.core.resource import ResourceModel
from diffusion_pruning_tpu_torch.core.structure import build_structure
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.ops import build
from diffusion_pruning_tpu_torch.ops import flash_attention as fa
from diffusion_pruning_tpu_torch.ops import gates
from diffusion_pruning_tpu_torch.ops import group_norm as gn
from diffusion_pruning_tpu_torch.ops import norm_conv as nc

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["sd21", "tiny"])
def test_structure_spec_matches_jax_site_by_site(name):
    ours = build_structure(getattr(UNetConfig, name)())
    ref = jax_build_structure(getattr(JaxUNetConfig, name)())
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.vq_dim == ref.vq_dim
    if name == "sd21":
        assert (ours.num_width, ours.num_depth, ours.vq_dim) == (1606, 14, 1620)


@pytest.mark.parametrize("b", [1, 2])
def test_gate_functions_match_jax(b):
    rng = np.random.default_rng(b)
    gate = rng.random((b, 4), dtype=np.float32)
    x = rng.standard_normal((2 * b, 3, 5, 8), dtype=np.float32)
    heads = rng.standard_normal((2 * b, 6, 4, 3), dtype=np.float32)
    d = rng.random((b,), dtype=np.float32)
    ident = rng.standard_normal(x.shape, dtype=np.float32)
    t = torch.from_numpy
    pairs = [
        (gates.match_batch(t(gate), 2 * b), jax_gates.match_batch(jnp.asarray(gate), 2 * b)),
        (gates.channel_mask(t(gate), 8, 2 * b),
         jax_gates.channel_mask(jnp.asarray(gate), 8, 2 * b)),
        (gates.channel_gate(t(x), t(gate)), jax_gates.channel_gate(jnp.asarray(x),
                                                                   jnp.asarray(gate))),
        (gates.head_gate(t(heads), t(gate)), jax_gates.head_gate(jnp.asarray(heads),
                                                                 jnp.asarray(gate))),
        (gates.depth_lerp(t(d), t(ident), t(x)),
         jax_gates.depth_lerp(jnp.asarray(d), jnp.asarray(ident), jnp.asarray(x))),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cfg_rows_tile_and_channels_repeat():
    g = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    # CFG [uncond, cond]: rows tile, never interleave
    assert gates.match_batch(g, 4).tolist() == [[1, 0], [0, 1], [1, 0], [0, 1]]
    # a gate unit covers a contiguous channel slab
    assert gates.channel_mask(g, 4, 2).tolist() == [[1, 1, 0, 0], [0, 0, 1, 1]]


@pytest.mark.parametrize("name", ["sd21", "tiny"])
def test_resource_ratio_matches_jax(name):
    ours = ResourceModel(build_structure(getattr(UNetConfig, name)()))
    ref = JaxResourceModel(jax_build_structure(getattr(JaxUNetConfig, name)()))
    arch = np.random.default_rng(0).random((3, ours.spec.vq_dim), dtype=np.float32)
    np.testing.assert_allclose(ours.resource_ratio(torch.from_numpy(arch)).numpy(),
                               np.asarray(ref.resource_ratio(jnp.asarray(arch))), rtol=1e-5)
    assert float(ours.resource_ratio(torch.ones(1, ours.spec.vq_dim))) == pytest.approx(1.0)


def test_hard_concrete_threshold_and_straight_through():
    x = torch.tensor([0.2, 0.5, 0.7], requires_grad=True)
    y = hard_concrete(x)
    assert y.tolist() == [0.0, 1.0, 1.0]
    y.sum().backward()
    assert x.grad.tolist() == [1.0, 1.0, 1.0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import diffusion_pruning_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "transformers", "yaml",
                                            "PIL", "safetensors", "wandb")
                     or m == "diffusion_pruning_tpu"
                     or m.startswith("diffusion_pruning_tpu."))
        serving_modules = {"diffusion_pruning_tpu_torch.models.unet.pruned",
                   "diffusion_pruning_tpu_torch.pipelines.expert_server",
                   "diffusion_pruning_tpu_torch.schedulers.pndm",
                   "diffusion_pruning_tpu_torch.schedulers.dpm",
                   "diffusion_pruning_tpu_torch.cli.prune",
                   "diffusion_pruning_tpu_torch.training.loop",
                   "diffusion_pruning_tpu_torch.training.factory",
                   "diffusion_pruning_tpu_torch.models.clip_vision",
                   "diffusion_pruning_tpu_torch.models.safety",
                   *("diffusion_pruning_tpu_torch.utils." + m for m in (
                       "config", "arg_utils", "logging_utils", "checkpoint", "export"))}
        print(len(names), bad, sorted(serving_modules - set(names)))
        sys.exit(1 if bad or len(names) < 20 or not serving_modules <= set(names) else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_a_device(monkeypatch):
    from diffusion_pruning_tpu_torch.pipelines import PruningPipeline
    from diffusion_pruning_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PruningPipeline(unet=None, vae=None, text_encoder=None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrapper_routes_cpu_tensors_to_plain_version_without_building(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build or load the CUDA kernel")

    monkeypatch.setattr(build, "build_kernels", no_build)
    monkeypatch.setattr(build, "_fn", no_build)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 16, 3, 64, generator=g) for _ in range(3))
    gate = torch.rand(2, 3, generator=g)
    before = fa.gated_flash_attention.launches
    out = fa.gated_flash_attention(q, k, v, gate)
    assert fa.gated_flash_attention.launches == before
    torch.testing.assert_close(out, fa.gated_attention_reference(q, k, v, gate),
                               rtol=0, atol=0)
    # the fused-norm wrappers likewise
    x = torch.randn(2, 16, 4, 4, generator=g)
    scale, bias = torch.rand(16, generator=g) + 0.5, torch.randn(16, generator=g)
    a, b = torch.rand(2, 16, generator=g), torch.randn(2, 16, generator=g)
    packed, w = torch.randn(8, 3, 3, 16, generator=g), torch.randn(8, 16, generator=g)
    cb = torch.randn(8, generator=g)
    wrappers = (gn.group_norm_silu_forward, nc.norm_conv3x3, nc.norm_linear)
    before = [f.launches for f in wrappers]
    torch.testing.assert_close(gn.group_norm_silu_forward(x, scale, bias, 4, 1e-5, True),
                               gn.group_norm_silu_plain(x, scale, bias, 4, 1e-5, True),
                               rtol=0, atol=0)
    torch.testing.assert_close(nc.norm_conv3x3(x, a, b, packed, cb, True),
                               nc.norm_conv3x3_plain(x, a, b, packed, cb, True), rtol=0, atol=0)
    tokens = x.flatten(2).transpose(1, 2).contiguous()
    torch.testing.assert_close(nc.norm_linear(tokens, a, b, w, cb),
                               nc.norm_linear_plain(tokens, a, b, w, cb), rtol=0, atol=0)
    assert [f.launches for f in wrappers] == before


@pytest.mark.parametrize("fails", [False, True])
def test_kernel_build_runs_nvcc_per_source_and_caches_by_content(tmp_path, monkeypatch, fails):
    """The build drives nvcc (here a stand-in script) on each kernel source
    into the build directory, keeps its report, reuses an up-to-date library,
    and raises with the compiler's output when a compile fails."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'ptxas info    : Used 1 registers'\n"
                    + ("echo 'error: boom'; exit 2\n" if fails else
                       'while [ "$1" != "-o" ]; do shift; done; echo lib > "$2"\n'))
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    if fails:
        with pytest.raises(RuntimeError, match="boom"):
            build.build_kernels()
        assert not any(build._library_path(s).exists() for s in build.SOURCES)
        return
    seconds = build.build_kernels()
    assert sorted(seconds) == ["gated_flash_bwd", "gated_flash_fwd", "group_norm", "norm_conv"]
    assert all(t >= 0.0 for t in seconds.values())
    for source in build.SOURCES:
        lib = build._library_path(source)
        assert lib.parent == tmp_path / "build" and lib.read_text() == "lib\n"
        assert "registers" in (tmp_path / "build" / f"{source.stem}.ptxas.txt").read_text()
    assert all(t is None for t in build.build_kernels().values())
    # every C entry point names a source of the build, and every header exists
    assert {stem for stem, _ in build.SIGNATURES.values()} == set(seconds)
    assert all(h.exists() for h in build.HEADERS)


def test_kernel_wrapper_rejects_other_devices():
    q = torch.empty(1, 4, 1, 64, device="meta")
    lse = torch.empty(1, 4, device="meta")
    for call in (lambda: fa.gated_flash_attention(q, q, q),
                 lambda: fa.gated_flash_forward_lse(q, q, q),
                 lambda: fa.gated_flash_bwd_dq(q, q, q, None, q, lse, q),
                 lambda: fa.gated_flash_bwd_dkv(q, q, q, None, lse, q),
                 lambda: fa.gated_flash_bwd_fused(q, q, q, None, q, lse, q),
                 lambda: fa.gated_flash_bwd_reduce(lse, q, q),
                 lambda: gn.group_norm_silu_forward(q, lse, lse, 1, 1e-5, True),
                 lambda: gn.group_norm_silu(q, lse, lse, 1),
                 lambda: nc.norm_conv3x3(q, lse, lse, q, lse, True),
                 lambda: nc.norm_linear(lse, lse, lse, lse, lse)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


@pytest.mark.parametrize("override", [dict(use_linear_projection=False)])
def test_unported_config_options_are_refused(override):
    """No option of the JAX package's UNetConfig is refused any more: the
    last one, `use_linear_projection=False` (1×1-conv proj_in/proj_out),
    builds with the diffusers conv weights (C, C, 1, 1)."""
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    sd = GatedUNet(UNetConfig.tiny(**override)).state_dict()
    assert sd["down_blocks.0.attentions.0.proj_in.weight"].shape == (32, 32, 1, 1)
    assert sd["mid_block.attentions.0.proj_out.weight"].shape == (64, 64, 1, 1)


@pytest.mark.parametrize("override", [dict(fused_norms=True), dict(fused_norm_conv=True),
                                      dict(fused_norms=True, fused_norm_conv=True)])
def test_fused_norm_flags_build_and_keep_the_state_dict(override):
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    plain = GatedUNet(UNetConfig.tiny())
    fused = GatedUNet(UNetConfig.tiny(**override))
    assert ({k: v.shape for k, v in fused.state_dict().items()}
            == {k: v.shape for k, v in plain.state_dict().items()})
