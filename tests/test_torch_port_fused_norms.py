"""The port's fused-norm ops (`ops/group_norm.py`, `ops/norm_conv.py`) and the
U-Net configurations that run them (`fused_norms`, `fused_norm_conv`), held
against the JAX package on the CPU. The JAX ops run their Pallas kernels in
interpret mode; the port's ops run their kernels' plain versions, because the
tensors lie on the CPU. Inputs are made with numpy from a seed and handed to
both sides.

Tolerances: f32 forward rtol/atol 2e-5 (as tests/test_norm_conv.py), bf16
3e-2, gradients 1e-4, whole U-Nets as tests/test_torch_port_unet.py."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import diffusion_pruning_tpu.ops.norm_conv as jax_nc
from diffusion_pruning_tpu.models.unet.config import UNetConfig as JaxUNetConfig
from diffusion_pruning_tpu.models.unet.unet import GatedUNet as JaxGatedUNet
from diffusion_pruning_tpu.ops.group_norm import group_norm_silu as jax_group_norm_silu
from diffusion_pruning_tpu.training import pruner as jax_pruner
from diffusion_pruning_tpu_torch.models.convert import params_from_jax
from diffusion_pruning_tpu_torch.models.unet.blocks import GatedResnetBlock
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.ops import group_norm as gn
from diffusion_pruning_tpu_torch.ops import norm_conv as nc
from diffusion_pruning_tpu_torch.training import PrunerConfig, make_optimizer, make_pruner_step
from diffusion_pruning_tpu_torch.training.pruner import LOSS_TERMS

import test_torch_port_training as tt
from torch_port_common import numpy_params

torch.set_num_threads(1)
F32_TOL = 2e-5
BF16_TOL = 3e-2
GRAD_TOL = 1e-4
UNET_RTOL, UNET_ATOL = 1e-4, 5e-4  # as tests/test_torch_port_unet.py
FLAGS = ("fused_norms", "fused_norm_conv")


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a, dtype=np.float32))
    return t if dtype is None else t.to(dtype)


def _nchw(a, dtype=None):
    """An NHWC array as the logical (B, C, H, W) channels_last tensor the
    port's ops take: the same memory."""
    return _t(a, dtype).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _conv_args(seed, b, h, w, c, cout, gate=None, closed=False):
    rng = np.random.default_rng(seed)
    args = {"x": rng.standard_normal((b, h, w, c), dtype=np.float32),
            "scale": 1.0 + 0.1 * rng.standard_normal(c, dtype=np.float32),
            "bias": 0.1 * rng.standard_normal(c, dtype=np.float32),
            "kernel": 0.1 * rng.standard_normal((3, 3, c, cout), dtype=np.float32),
            "cbias": 0.1 * rng.standard_normal(cout, dtype=np.float32),
            "gate_c": None}
    if gate == "cfg":  # made for b/2 prompts, tiled over the CFG-doubled batch
        half = 1.0 / (1.0 + np.exp(-rng.standard_normal((b // 2, c), dtype=np.float32)))
        args["gate_c"] = np.tile(half, (2, 1))
    elif gate == "soft":
        args["gate_c"] = rng.random((b, c), dtype=np.float32)
    if closed:  # a hard-closed gate unit: the first group's channels of row 0
        args["gate_c"][0, : c // 4] = 0.0
    return args


def _torch_conv(a, groups, eps, silu, dtype=None):
    """The port's op on the CPU (phase 1 + the kernel's plain version)."""
    return nc.group_norm_silu_conv3x3(
        _nchw(a["x"], dtype), _t(a["scale"]), _t(a["bias"]),
        _t(a["kernel"], dtype).permute(3, 2, 0, 1), _t(a["cbias"]),
        None if a["gate_c"] is None else _t(a["gate_c"]), groups, eps, silu,
        packed=nc.PackedWeight())


def _jax_conv(a, groups, eps, silu, dtype=jnp.float32):
    gate = None if a["gate_c"] is None else jnp.asarray(a["gate_c"])
    return jax_nc.group_norm_silu_conv3x3(
        jnp.asarray(a["x"], dtype), jnp.asarray(a["scale"]), jnp.asarray(a["bias"]),
        jnp.asarray(a["kernel"], dtype), jnp.asarray(a["cbias"]), gate, groups, eps, silu, True)


# ---------------------------------------------------------------- (a) forwards

@pytest.mark.parametrize("b,h,w,c,cout,groups,gate,closed,silu", [
    (2, 8, 8, 32, 48, 8, None, False, True),
    (1, 4, 4, 40, 16, 8, None, False, True),      # C/G = 5
    (3, 5, 7, 16, 16, 4, None, False, True),      # odd H and W
    (4, 6, 6, 24, 32, 6, "cfg", False, True),     # the CFG-tiled gate
    (2, 6, 6, 16, 24, 4, "soft", True, True),     # a closed group
    (2, 6, 6, 16, 24, 4, "soft", False, False),   # SiLU off
], ids=["plain", "cg5", "odd_hw", "cfg_gate", "closed_group", "no_silu"])
def test_norm_conv_matches_jax_kernel(b, h, w, c, cout, groups, gate, closed, silu):
    a = _conv_args(0, b, h, w, c, cout, gate, closed)
    want = np.asarray(_jax_conv(a, groups, 1e-5, silu))
    got = _torch_conv(a, groups, 1e-5, silu)
    assert got.shape == (b, cout, h, w) and np.isfinite(want).all()
    np.testing.assert_allclose(_nhwc(got), want, rtol=F32_TOL, atol=F32_TOL)


def test_norm_conv_matches_jax_row_tiled_kernel(monkeypatch):
    """The JAX op forced onto `_nc_kernel_ht` (rows tiled with halo reads, its
    512px path): the port has one kernel for both bodies."""
    b, h, w, c, cout, groups = 2, 32, 8, 16, 16, 4
    a = _conv_args(5, b, h, w, c, cout, "soft")
    monkeypatch.setattr(jax_nc, "_pick_tiles", lambda *args: (8, cout))
    want = np.asarray(_jax_conv(a, groups, 1e-5, True))
    np.testing.assert_allclose(_nhwc(_torch_conv(a, groups, 1e-5, True)), want,
                               rtol=F32_TOL, atol=F32_TOL)


def test_norm_conv_bf16_matches_jax_kernel():
    a = _conv_args(2, 2, 8, 8, 32, 32)
    want = _jax_conv(a, 8, 1e-5, True, jnp.bfloat16)
    got = _torch_conv(a, 8, 1e-5, True, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_nhwc(got), np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_norm_conv_pads_in_y_space():
    """A tap outside the image contributes 0, not act(b): with x = 0 and a
    nonzero norm bias every y is act(bias), and the border outputs sum fewer
    taps than the interior's."""
    c, cout = 8, 4
    x = torch.zeros(1, c, 5, 5)
    scale, bias = torch.ones(c), torch.full((c,), 0.7)
    weight, cbias = torch.ones(cout, c, 3, 3), torch.zeros(cout)
    out = nc.group_norm_silu_conv3x3(x, scale, bias, weight, cbias, None, 2, 1e-5, True,
                                     packed=nc.PackedWeight())
    y = 0.7 * torch.sigmoid(torch.tensor(0.7))
    torch.testing.assert_close(out[0, 0, 2, 2], 9 * c * y)
    torch.testing.assert_close(out[0, 0, 0, 0], 4 * c * y)
    torch.testing.assert_close(out[0, 0, 0, 2], 6 * c * y)


@pytest.mark.parametrize("b,h,w,c,groups,silu,eps,closed", [
    (2, 8, 8, 32, 8, True, 1e-5, False),
    (1, 4, 4, 40, 8, True, 1e-5, False),          # C/G = 5
    (3, 5, 7, 16, 4, False, 1e-6, False),         # the transformer's norm
    (2, 6, 6, 16, 4, True, 1e-5, True),           # a zeroed group: SiLU(bias)
], ids=["plain", "cg5", "no_silu_odd_hw", "closed_group"])
def test_group_norm_silu_matches_jax_kernel(b, h, w, c, groups, silu, eps, closed):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, h, w, c), dtype=np.float32)
    scale = 1.0 + 0.1 * rng.standard_normal(c, dtype=np.float32)
    bias = 0.1 * rng.standard_normal(c, dtype=np.float32)
    if closed:
        x[0, :, :, : c // groups] = 0.0
    want = np.asarray(jax_group_norm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                          groups, eps, silu, True))
    got = gn.group_norm_silu(_nchw(x), _t(scale), _t(bias), groups, eps, silu)
    np.testing.assert_allclose(_nhwc(got), want, rtol=F32_TOL, atol=F32_TOL)
    if closed:  # variance 0: finite, act(bias)
        bt = _t(bias[: c // groups])
        torch.testing.assert_close(got[0, : c // groups, 0, 0], bt * torch.sigmoid(bt))


def _linear_args(seed, b, s, c, cout, gated):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((b, s, c), dtype=np.float32),
            "scale": 1.0 + 0.1 * rng.standard_normal(c, dtype=np.float32),
            "bias": 0.1 * rng.standard_normal(c, dtype=np.float32),
            "kernel": 0.1 * rng.standard_normal((c, cout), dtype=np.float32),
            "lbias": 0.1 * rng.standard_normal(cout, dtype=np.float32),
            "gate_c": rng.random((b, c), dtype=np.float32) if gated else None}


@pytest.mark.parametrize("gated", [False, True])
def test_group_norm_linear_matches_jax_kernel(gated):
    b, s, c, cout, groups = 2, 16, 32, 48, 8
    a = _linear_args(11, b, s, c, cout, gated)
    gate = None if not gated else jnp.asarray(a["gate_c"])
    want = jax_nc.group_norm_linear(jnp.asarray(a["x"]), jnp.asarray(a["scale"]),
                                    jnp.asarray(a["bias"]), jnp.asarray(a["kernel"]),
                                    jnp.asarray(a["lbias"]), gate, groups, 1e-6, True)
    got = nc.group_norm_linear(_t(a["x"]), _t(a["scale"]), _t(a["bias"]), _t(a["kernel"]).T,
                               _t(a["lbias"]), None if not gated else _t(a["gate_c"]), groups,
                               1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


# An expert keeps whole groups of the full model's C/32 ∈ {10, 20, 40} channels:
# (C_in, groups) with C_in no multiple of 8 (31 of 10, 31 of 20, 9 of 10),
# and 31 of 40 (aligned: the control that is not padded)
EXPERT_CHANNELS = [(310, 31), (620, 31), (90, 9), (1240, 31)]


@pytest.mark.parametrize("op", ["conv", "linear"])
@pytest.mark.parametrize("c,groups", EXPERT_CHANNELS, ids=lambda v: str(v))
def test_expert_channel_widths_pad_to_the_kernels_alignment(op, c, groups):
    """At an expert's channel widths the fused ops match the JAX ops (Pallas
    interpret mode), and the zero padding the card path applies
    (`pad_conv_operands`, `pad_linear_operands`: C_in, and the linear's
    C_out, up to a multiple of 8) leaves the kernels' plain versions
    unchanged bit for bit; an aligned width is not copied."""
    aligned = nc.aligned_channels(c)
    # f32 sums of 9·C_in products (up to 11,160) in XLA's and oneDNN's
    # orders: the rounding grows as the square root of the terms, from the
    # file's F32_TOL at the 864 of its other conv tests
    atol = F32_TOL * max(1.0, (9 * c / 864) ** 0.5)
    assert aligned % 8 == 0 and 0 <= aligned - c < 8 and (aligned == c) == (c % 8 == 0)
    if op == "conv":
        a = _conv_args(c, 2, 4, 4, c, c, "soft")
        want = np.asarray(_jax_conv(a, groups, 1e-5, True))
        np.testing.assert_allclose(_nhwc(_torch_conv(a, groups, 1e-5, True)), want,
                                   rtol=F32_TOL, atol=atol)
        x = _nchw(a["x"], torch.bfloat16)
        ab = nc.affine_coeffs(x, _t(a["scale"]), _t(a["bias"]), groups, 1e-5, _t(a["gate_c"]))
        packed = nc.pack_conv_weight(_t(a["kernel"]).permute(3, 2, 0, 1), torch.bfloat16)
        cbias = _t(a["cbias"])
        operands = (x, *ab, packed)
        padded = nc.pad_conv_operands(*operands)
        assert padded[0].shape[1] == aligned and padded[3].shape[-1] == aligned
        assert padded[0].is_contiguous(memory_format=torch.channels_last)
        got = nc.norm_conv3x3_plain(*padded, cbias, True)
        ref = nc.norm_conv3x3_plain(*operands, cbias, True)
    else:
        a = _linear_args(c, 2, 8, c, c, True)
        args = (_t(a["scale"]), _t(a["bias"]))
        want = jax_nc.group_norm_linear(jnp.asarray(a["x"]), jnp.asarray(a["scale"]),
                                        jnp.asarray(a["bias"]), jnp.asarray(a["kernel"]),
                                        jnp.asarray(a["lbias"]), jnp.asarray(a["gate_c"]),
                                        groups, 1e-6, True)
        port = nc.group_norm_linear(_t(a["x"]), *args, _t(a["kernel"]).T, _t(a["lbias"]),
                                    _t(a["gate_c"]), groups, 1e-6)
        np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=F32_TOL, atol=atol)
        x = _t(a["x"], torch.bfloat16)
        ab = nc.affine_coeffs(x.transpose(1, 2), *args, groups, 1e-6, _t(a["gate_c"]))
        operands = (x, *ab, _t(a["kernel"], torch.bfloat16).T.contiguous(), _t(a["lbias"]))
        padded = nc.pad_linear_operands(*operands)
        assert padded[0].shape[-1] == aligned and padded[3].shape == (aligned, aligned)
        assert padded[4].shape == (aligned,) and padded[0].is_contiguous()
        got = nc.norm_linear_plain(*padded)[..., :c]
        ref = nc.norm_linear_plain(*operands)
    assert all((p is t) == (aligned == c) for p, t in zip(padded, operands))
    assert torch.equal(got, ref)


# ---------------------------------------------------------------- (b) gradients

def _leaves(*arrays):
    return [None if a is None else _t(a).requires_grad_() for a in arrays]


def test_norm_conv_function_grads_match_jax_grad():
    groups = 4
    a = _conv_args(3, 2, 5, 5, 16, 24, "soft")
    names = ("x", "scale", "bias", "kernel", "cbias", "gate_c")
    want = jax.grad(lambda *args: jnp.sum(jax_nc.group_norm_silu_conv3x3(
        *args, groups, 1e-5, True, True) ** 2), argnums=tuple(range(6)))(
        *(jnp.asarray(a[n]) for n in names))
    x, scale, bias, kernel, cbias, gate_c = _leaves(*(a[n] for n in names))
    out = nc.group_norm_silu_conv3x3(x.permute(0, 3, 1, 2), scale, bias,
                                     kernel.permute(3, 2, 0, 1), cbias, gate_c, groups, 1e-5,
                                     True, packed=nc.PackedWeight())
    out.square().sum().backward()
    for name, leaf, w in zip(names, (x, scale, bias, kernel, cbias, gate_c), want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def test_group_norm_linear_function_grads_match_jax_grad():
    groups = 8
    a = _linear_args(12, 2, 16, 32, 48, True)
    names = ("x", "scale", "bias", "kernel", "lbias", "gate_c")
    want = jax.grad(lambda *args: jnp.sum(jax_nc.group_norm_linear(
        *args, groups, 1e-6, True) ** 2), argnums=tuple(range(6)))(
        *(jnp.asarray(a[n]) for n in names))
    leaves = _leaves(*(a[n] for n in names))
    x, scale, bias, kernel, lbias, gate_c = leaves
    nc.group_norm_linear(x, scale, bias, kernel.T, lbias, gate_c, groups, 1e-6
                         ).square().sum().backward()
    for name, leaf, w in zip(names, leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("silu", [True, False])
def test_group_norm_silu_function_grads_match_jax_grad(silu):
    rng = np.random.default_rng(4)
    arrays = (rng.standard_normal((2, 5, 5, 16), dtype=np.float32),
              1.0 + 0.1 * rng.standard_normal(16, dtype=np.float32),
              0.1 * rng.standard_normal(16, dtype=np.float32))
    want = jax.grad(lambda *args: jnp.sum(jax_group_norm_silu(*args, 4, 1e-5, silu, True) ** 2),
                    argnums=(0, 1, 2))(*(jnp.asarray(v) for v in arrays))
    leaves = _leaves(*arrays)
    gn.group_norm_silu(leaves[0].permute(0, 3, 1, 2), leaves[1], leaves[2], 4, 1e-5, silu
                       ).square().sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


# ---------------------------------------------------------------- (c) the U-Net

@pytest.fixture(scope="module")
def jax_params():
    """Weights in the tree of a JAX U-Net built with a fused flag: it is the
    unfused tree, so `params_from_jax` needs no new rule."""
    shapes = {flag: jax.eval_shape(lambda: JaxGatedUNet(JaxUNetConfig.tiny(
        **{flag: True})).init_params(jax.random.PRNGKey(0))) for flag in FLAGS}
    plain = jax.eval_shape(lambda: JaxGatedUNet(JaxUNetConfig.tiny()).init_params(
        jax.random.PRNGKey(0)))
    for tree in shapes.values():
        assert jax.tree.structure(tree) == jax.tree.structure(plain)
        assert jax.tree.leaves(tree) == jax.tree.leaves(plain)
    return numpy_params(shapes["fused_norm_conv"])


def _arch(kind, spec, rng):
    if kind == "none":
        return None
    if kind == "soft":
        return rng.random((2, spec.vq_dim), dtype=np.float32)
    arch = (rng.random((2, spec.vq_dim)) < 0.7).astype(np.float32)
    arch[:, spec.num_width:] = 1.0
    arch[0, spec.num_width::2] = 0.0  # close every other depth gate of row 0
    arch[1, spec.num_width + 1::2] = 0.0
    return arch


@pytest.fixture(scope="module")
def jax_unet_outputs(jax_params):
    """The JAX U-Net under each fused flag (one compile per flag and arch
    presence) on the inputs of `_unet_case`."""
    cache = {}

    def run(flag, x, t, ehs, arch):
        key = (flag, arch is not None)
        if key not in cache:
            model = JaxGatedUNet(JaxUNetConfig.tiny(**{flag: True}))
            cache[key] = jax.jit(lambda p, *a, **k: model.apply({"params": p}, *a, **k))
        return np.asarray(cache[key](
            jax_params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs),
            **({} if arch is None else {"arch": jnp.asarray(arch)})))

    return run


@pytest.mark.parametrize("arch_kind", ["none", "soft", "hard_depth"])
@pytest.mark.parametrize("flag", FLAGS)
def test_fused_unet_matches_jax_and_the_unfused_port(jax_params, jax_unet_outputs, flag,
                                                     arch_kind):
    model = GatedUNet(UNetConfig.tiny(**{flag: True})).eval()
    state = params_from_jax(jax_params, model)  # the trees do not depend on the flags
    model.load_state_dict(state)
    unfused = GatedUNet(UNetConfig.tiny()).eval()
    unfused.load_state_dict(state)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 8, 8, 4), dtype=np.float32)  # batch 4, arch of 2: CFG tiling
    t = np.array([3, 747, 100, 999])
    ehs = rng.standard_normal((4, 77, 32), dtype=np.float32)
    arch = _arch(arch_kind, model.spec, rng)
    want = jax_unet_outputs(flag, x, t, ehs, arch)
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ehs))
    arch_t = None if arch is None else torch.from_numpy(arch)
    with torch.no_grad():
        got = model(*args, arch=arch_t)
        plain = unfused(*args, arch=arch_t)
    assert got.shape == (4, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=UNET_RTOL, atol=UNET_ATOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=UNET_RTOL, atol=UNET_ATOL)


def test_fused_unet_counts_the_sites_of_each_op(monkeypatch):
    """Which op runs where: per forward of the tiny U-Net (12 resnets, 6
    transformers), `fused_norms` takes 24 + 6 GroupNorms, `fused_norm_conv`
    24 + 1 convs (the output head too) and 6 linears, and wins when both are
    set."""
    counts = {}

    def counted(module, name):
        real = getattr(module, name)

        def wrapper(*args):
            counts[name] = counts.get(name, 0) + 1
            return real(*args)

        monkeypatch.setattr(module, name, wrapper)

    counted(gn, "group_norm_silu_forward")
    counted(nc, "norm_conv3x3")
    counted(nc, "norm_linear")
    x, t, ehs = torch.zeros(1, 8, 8, 4), torch.zeros(1), torch.zeros(1, 77, 32)
    expected = {(True, False): {"group_norm_silu_forward": 30},
                (False, True): {"norm_conv3x3": 25, "norm_linear": 6},
                (True, True): {"norm_conv3x3": 25, "norm_linear": 6}}
    for (norms, norm_conv), want in expected.items():
        counts.clear()
        model = GatedUNet(UNetConfig.tiny(fused_norms=norms, fused_norm_conv=norm_conv))
        with torch.no_grad():
            model(x, t, ehs)
        assert counts == want


@pytest.mark.parametrize("flag", FLAGS)
def test_fused_unet_hands_every_fused_op_its_layout(monkeypatch, flag):
    """The U-Net converts to channels_last once, after `conv_in`; every fused
    op then gets its activation in the layout its kernel reads (tokens
    contiguous for the linear form), so that the public ops' silent conversion
    never runs: it would be a hidden pass over the activation at that site."""
    from diffusion_pruning_tpu_torch.models.unet import blocks
    seen = []

    def watch(name, dense):
        real = getattr(blocks, name)

        def op(x, *args, **kwargs):
            seen.append((name, tuple(x.shape), dense(x)))
            return real(x, *args, **kwargs)

        monkeypatch.setattr(blocks, name, op)

    watch("group_norm_silu", lambda x: x.is_contiguous(memory_format=torch.channels_last))
    watch("group_norm_silu_conv3x3",
          lambda x: x.is_contiguous(memory_format=torch.channels_last))
    watch("group_norm_linear", torch.Tensor.is_contiguous)
    model = GatedUNet(UNetConfig.tiny(**{flag: True}))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 8, 8, 4), dtype=np.float32))
    ehs = torch.from_numpy(rng.standard_normal((4, 77, 32), dtype=np.float32))
    arch = torch.from_numpy(rng.random((2, model.spec.vq_dim), dtype=np.float32))
    out = model(x, torch.tensor([3, 747, 100, 999]), ehs, arch=arch)  # with autograd on
    assert out.shape == (4, 8, 8, 4)
    assert len(seen) == {"fused_norms": 30, "fused_norm_conv": 31}[flag]
    assert [site for site in seen if not site[2]] == []


# ---------------------------------------------------------------- (d) remat

@pytest.mark.parametrize("flag", FLAGS)
def test_fused_unet_remat_grads_equal_fused_without(jax_params, flag):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 4), dtype=np.float32))
    ehs = torch.from_numpy(rng.standard_normal((2, 77, 32), dtype=np.float32))
    t = torch.tensor([5, 900])
    results = []
    for remat in (False, True):
        model = GatedUNet(UNetConfig.tiny(remat=remat, **{flag: True}))
        model.load_state_dict(params_from_jax(jax_params, model))
        arch = torch.from_numpy(_arch("soft", model.spec, np.random.default_rng(3))
                                ).requires_grad_()
        out, feats = model(x, t, ehs, arch=arch, return_features=True)
        (out.square().mean() + sum(f.square().mean() for f in feats.values())).backward()
        results.append((arch.grad, model.conv_in.weight.grad,
                        model.mid_block.resnets[0].conv2.weight.grad))
    assert results[0][0].abs().sum() > 0
    for got, want in zip(results[1], results[0]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-8)


def test_fused_resnet_block_grads_under_checkpoint_match_the_unfused_block():
    """`torch.utils.checkpoint` around the fused block gives the unfused
    block's parameter and gate gradients (the JAX package pins remat around
    its custom_vjp the same way)."""
    from torch.utils.checkpoint import checkpoint
    g = torch.Generator().manual_seed(0)
    x, temb = torch.randn(2, 16, 6, 6, generator=g), torch.randn(2, 32, generator=g)
    dense = GatedResnetBlock(16, 24, 32, groups=4)
    fused = GatedResnetBlock(16, 24, 32, groups=4, fused_norm_conv=True)
    fused.load_state_dict(dense.state_dict())
    grads = []
    for block, run in ((dense, lambda b, *a: b(*a)),
                       (fused, lambda b, *a: checkpoint(b, *a, use_reentrant=False))):
        gate = torch.rand(2, 4, generator=torch.Generator().manual_seed(1)).requires_grad_()
        run(block, x, temb, gate).square().sum().backward()
        grads.append([gate.grad] + [p.grad for p in block.parameters()])
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)


# ---------------------------------------------------------------- (e) weight cache

def test_packed_weight_follows_the_parameter():
    torch.manual_seed(0)
    block = GatedResnetBlock(16, 16, 32, groups=4, fused_norm_conv=True).eval()
    x, temb = torch.randn(1, 16, 4, 4), torch.randn(1, 32)
    packed = block._packed[0]
    with torch.no_grad():
        first = block(x, temb)
        kept = packed.get(block.conv1.weight, x.dtype)
        assert block(x, temb).equal(first)
        assert packed.get(block.conv1.weight, x.dtype) is kept       # packed once
        torch.testing.assert_close(kept, block.conv1.weight.permute(0, 2, 3, 1))
        block.conv1.weight.mul_(2.0)                                  # an optimizer's step
        second = block(x, temb)
        assert not torch.allclose(second, first)
        torch.testing.assert_close(packed.get(block.conv1.weight, x.dtype),
                                   block.conv1.weight.permute(0, 2, 3, 1))
        state = {k: v.clone() for k, v in block.state_dict().items()}
        state["conv1.weight"] = state["conv1.weight"] / 2.0
        block.load_state_dict(state)
        torch.testing.assert_close(block(x, temb), first)
        block.to(torch.bfloat16)                                      # new storage
        assert block(x.bfloat16(), temb.bfloat16()).dtype == torch.bfloat16
        assert packed.get(block.conv1.weight, torch.bfloat16).dtype == torch.bfloat16
    assert "_packed" not in "".join(block.state_dict())


# ---------------------------------------------------------------- (f) the train step

def _world():
    """The JAX modules and numpy weights of tests/test_torch_port_training.py's
    `world`, with the U-Net under `fused_norm_conv`."""
    from diffusion_pruning_tpu.core.structure import build_structure
    from diffusion_pruning_tpu.models.hypernet import HyperStructure
    from diffusion_pruning_tpu.models.quantizer import StructureQuantizer
    from diffusion_pruning_tpu.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
    from diffusion_pruning_tpu.models.vae import AutoencoderKL, VAEConfig
    from diffusion_pruning_tpu.schedulers import DiffusionSchedule
    ucfg = JaxUNetConfig.tiny(cross_attention_dim=32, fused_norm_conv=True)
    spec = build_structure(ucfg)
    mods = jax_pruner.PrunerModules(
        unet=JaxGatedUNet(ucfg), vae=AutoencoderKL(VAEConfig.tiny()),
        text_encoder=CLIPTextEncoder(CLIPTextConfig.tiny()),
        hypernet=HyperStructure(spec, input_dim=24),
        quantizer=StructureQuantizer(spec, n_e=4, base=3.0), schedule=DiffusionSchedule())
    res = ucfg.sample_size * 8

    def init(module, *args):
        shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
        return numpy_params(shapes["params"], seed=len(jax.tree_util.tree_leaves(shapes)))

    frozen = {"unet": numpy_params(jax.eval_shape(
                  lambda: mods.unet.init_params(jax.random.PRNGKey(0))), seed=3),
              "vae": init(mods.vae, jnp.zeros((1, res, res, 3)), jax.random.PRNGKey(0)),
              "text": init(mods.text_encoder, jnp.zeros((1, 77), jnp.int32))}
    trainable = {"hypernet": init(mods.hypernet, jnp.zeros((1, 24))),
                 "quantizer": jax.jit(mods.quantizer.init_params)(jax.random.PRNGKey(1))}
    return mods, frozen, trainable


def test_fused_norm_conv_pruner_step_matches_jax():
    """One pretrain step on cached latents with `fused_norm_conv` on both
    sides: the loss terms and the hypernet and codebook grads (which reach the
    hypernet through the fused ops' gate gradient). Tolerances as
    tests/test_torch_port_training.py."""
    world = _world()
    jmods, frozen, trainable = world
    cfg = jax_pruner.PrunerConfig(lr_warmup_steps=0)
    opt = optax.chain(tt._capture_grads(), jax_pruner.make_optimizer(cfg, global_batch=tt.B))
    step = jax_pruner.make_pruner_step(jmods, cfg, opt, mesh=None, pretrain=True)
    batch = tt._batch(cached=True)
    key = jax.random.PRNGKey(20)
    _, opt_state, _, metrics, aux = step(trainable, frozen, opt.init(trainable),
                                         {k: jnp.asarray(v) for k, v in batch.items()}, key)

    mods = tt._port_modules(world)
    mods.unet = tt._unet(frozen["unet"], fused_norm_conv=True)
    pcfg = PrunerConfig(lr_warmup_steps=0)
    port_step = make_pruner_step(mods, pcfg, make_optimizer(pcfg, mods, tt.B), pretrain=True)
    got, got_aux = port_step(tt._port_batch(batch), tt._jax_draws(key, jmods.quantizer.spec, 4))
    assert not got["skipped"]
    for name in LOSS_TERMS:
        np.testing.assert_allclose(float(got[name]), float(metrics[name]), rtol=tt.LOSS_RTOL,
                                   atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(got_aux["expert_indices"].numpy(),
                                  np.asarray(aux["expert_indices"]))
    want_grads = tt._jax_trainables(opt_state[0], len(jmods.hypernet.spec.width_list) + 1)
    nw = jmods.quantizer.spec.num_width
    for name, g in tt._port_grads(mods).items():
        w = want_grads[name]
        atol = tt.GRAD_ATOL_FRAC * np.abs(w).max() + 1e-12
        if name == "codebook":  # the depth columns apart (see tt.DEPTH_GRAD_RTOL)
            np.testing.assert_allclose(g[:, nw:], w[:, nw:], rtol=tt.DEPTH_GRAD_RTOL, atol=atol)
            g, w = g[:, :nw], w[:, :nw]
        np.testing.assert_allclose(g, w, rtol=tt.GRAD_RTOL, atol=atol, err_msg=name)
