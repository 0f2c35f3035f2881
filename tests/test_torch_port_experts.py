"""The port's physically pruned experts and expert serving, held against the
JAX package on the CPU: the plan, the MACs ratio, the weight slices, the
expert forward (plain and flash attention, the fused flags, odd and even kept
head counts, dropped subblocks), the identity with the gated U-Net under the
hard arch, the tier planner, and `ServingQueue` in expert and hybrid mode
against the JAX expert pipes driven with the same routing noise and latents."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pruning_tpu.core.estimators import FIXED_KEY, sample_gumbel as jax_sample_gumbel
from diffusion_pruning_tpu.core.structure import build_structure as jax_build_structure
from diffusion_pruning_tpu.models import text_encoders as jax_te
from diffusion_pruning_tpu.models.hypernet import HyperStructure as JaxHyperStructure
from diffusion_pruning_tpu.models.quantizer import StructureQuantizer as JaxQuantizer
from diffusion_pruning_tpu.models.unet import pruned as jax_pruned
from diffusion_pruning_tpu.models.unet.config import UNetConfig as JaxUNetConfig
from diffusion_pruning_tpu.models.unet.unet import GatedUNet as JaxGatedUNet
from diffusion_pruning_tpu.models.vae import AutoencoderKL as JaxVAE
from diffusion_pruning_tpu.models.vae import VAEConfig as JaxVAEConfig
from diffusion_pruning_tpu.pipelines import PruningPipeline as JaxPipeline
from diffusion_pruning_tpu.pipelines.expert_server import ExpertServer as JaxExpertServer
from diffusion_pruning_tpu_torch.models import text_encoders as te
from diffusion_pruning_tpu_torch.models.convert import params_from_jax
from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.unet.pruned import (
    expert_cuts,
    expert_macs_ratio,
    make_expert_plan,
    module_name,
    slice_expert_params,
)
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from diffusion_pruning_tpu_torch.pipelines import PruningPipeline
from diffusion_pruning_tpu_torch.models.unet import blocks
from diffusion_pruning_tpu_torch.pipelines.expert_server import (
    ExpertServer,
    ServingQueue,
    build_expert,
    channels_last_convs,
    nhwc_route,
)

from torch_port_common import numpy_params

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 5e-4             # as tests/test_torch_port_unet.py
ID_RTOL, ID_ATOL = 1e-3, 2e-4       # expert vs gated, as tests/test_pruned_expert.py
IMAGE_ATOL = 1e-3                   # as tests/test_torch_port_pipeline.py
STEPS = 2
SPEC = jax_build_structure(JaxUNetConfig.tiny())


def _arch(kind: str) -> np.ndarray:
    """A hard (or raw) arch vector of the tiny U-Net, from a seed:
    * keep: units kept with p = 0.6, every depth gate open, the mid attention
      keeping 3 of 4 heads in attn1 and 2 in attn2 (odd and even counts);
    * drop: likewise, every other depth gate closed;
    * least: one unit a site, every depth gate closed;
    * raw: uniform values in [0, 1) thresholded by the plan (an empty site
      keeps unit 0)."""
    rng = np.random.default_rng({"keep": 1, "drop": 2, "least": 3, "raw": 4}[kind])
    if kind == "raw":
        arch = rng.random(SPEC.vq_dim, dtype=np.float32)
        site = SPEC.subblocks[0].sites[0]
        arch[site.start: site.start + site.width] = 0.2  # an empty site
        return arch
    arch = (rng.random(SPEC.vq_dim) < 0.6).astype(np.float32)
    for sb in SPEC.subblocks:
        for site in sb.sites:
            if kind == "least":
                arch[site.start: site.start + site.width] = 0.0
            arch[site.start] = 1.0
        if sb.name == "mid.attn.0" and kind != "least":
            a1, a2 = sb.sites[0], sb.sites[1]
            arch[a1.start: a1.start + a1.width] = (1, 1, 0, 1)
            arch[a2.start: a2.start + a2.width] = (0, 1, 1, 0)
    arch[SPEC.num_width:] = 1.0
    if kind == "drop":
        arch[SPEC.num_width::2] = 0.0
    if kind == "least":
        arch[SPEC.num_width:] = 0.0
    return arch


ARCHS = ("keep", "drop", "least", "raw")


@pytest.fixture(scope="module")
def dense():
    """JAX dense tiny U-Net weights (numpy) and the port's dense U-Net with them."""
    model = JaxGatedUNet(JaxUNetConfig.tiny())
    tree = numpy_params(jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0))))
    port = GatedUNet(UNetConfig.tiny()).eval()
    port.load_state_dict(params_from_jax(tree, port))
    return tree, port


def _plans(kind):
    arch = _arch(kind)
    return make_expert_plan(GatedUNet(UNetConfig.tiny()).spec, arch), \
        jax_pruned.make_expert_plan(SPEC, arch)


@pytest.mark.parametrize("kind", ARCHS)
def test_expert_plan_matches_jax_field_for_field(kind):
    plan, want = _plans(kind)
    assert dataclasses.asdict(plan) == dataclasses.asdict(want)
    dropped = sum(sb.dropped for sb in plan.subblocks)
    assert dropped == {"keep": 0, "drop": (SPEC.num_depth + 1) // 2, "least": SPEC.num_depth,
                       "raw": dropped}[kind]
    if kind == "raw":
        assert plan.subblocks[0].sites[0].kept == (0,)
    if kind in ("keep", "drop"):
        mid = plan.get("mid.attn.0")
        assert (len(mid.site("attn1").kept), len(mid.site("attn2").kept)) == (3, 2)


@pytest.mark.parametrize("kind", ARCHS)
def test_expert_macs_ratio_matches_jax(kind):
    plan, want = _plans(kind)
    spec = GatedUNet(UNetConfig.tiny()).spec
    ratio = expert_macs_ratio(spec, plan)
    assert ratio == pytest.approx(jax_pruned.expert_macs_ratio(SPEC, want), rel=1e-6)
    assert 0.0 < ratio < 1.0
    assert expert_macs_ratio(spec, make_expert_plan(spec, np.ones(spec.vq_dim))) \
        == pytest.approx(1.0, rel=1e-12)


@pytest.mark.parametrize("kind", ARCHS)
def test_slice_expert_params_matches_jax_bit_for_bit(dense, kind):
    tree, port = dense
    plan, jplan = _plans(kind)
    expert = GatedUNet(UNetConfig.tiny(), plan=plan)
    got = slice_expert_params(port.state_dict(), plan)
    want = params_from_jax(jax_pruned.slice_expert_params(tree, jplan), expert)
    assert set(got) == set(want) == set(expert.state_dict())
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    for sb in plan.subblocks:  # a dropped subblock keeps no key
        prefix = module_name(sb.name) + "."
        assert any(k.startswith(prefix) for k in got) == (not sb.dropped)


@pytest.fixture(scope="module")
def jax_expert_outputs(dense):
    """The JAX expert forward of an arch under a config (one compile each)."""
    tree = dense[0]

    def run(kind, flags, x, t, ehs):
        jplan = jax_pruned.make_expert_plan(SPEC, _arch(kind))
        model = JaxGatedUNet(JaxUNetConfig.tiny(**flags), plan=jplan)
        params = jax_pruned.slice_expert_params(tree, jplan)
        return np.asarray(jax.jit(lambda p, *a: model.apply({"params": p}, *a))(
            params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs)))

    return run


def _unet_inputs(seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 8, 8, 4), dtype=np.float32), np.array([3, 747, 100, 999]),
            rng.standard_normal((4, 77, 32), dtype=np.float32))


@pytest.mark.parametrize("kind,flags", [
    ("keep", {}), ("keep", {"use_flash_attention": True}), ("drop", {}),
    ("drop", {"use_flash_attention": True}), ("least", {}), ("keep", {"fused_norms": True}),
    ("drop", {"fused_norm_conv": True})])
def test_expert_forward_matches_jax(dense, jax_expert_outputs, kind, flags):
    _, port = dense
    plan, _ = _plans(kind)
    expert = GatedUNet(UNetConfig.tiny(**flags), plan=plan).eval()
    expert.load_state_dict(slice_expert_params(port.state_dict(), plan))
    x, t, ehs = _unet_inputs()
    want = jax_expert_outputs(kind, flags, x, t, ehs)
    with torch.no_grad():
        got = expert(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ehs))
    assert got.shape == (4, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_expert_refuses_an_arch(dense):
    plan, _ = _plans("keep")
    expert = GatedUNet(UNetConfig.tiny(), plan=plan)
    with pytest.raises(ValueError, match="without an arch"):
        expert(torch.zeros(1, 8, 8, 4), torch.zeros(1), torch.zeros(1, 77, 32),
               arch=torch.ones(1, SPEC.vq_dim))


@pytest.mark.parametrize("kind", ("keep", "drop", "least"))
@pytest.mark.parametrize("flags", [{}, {"fused_norms": True}, {"fused_norm_conv": True}])
def test_expert_equals_gated_unet_under_its_hard_arch(dense, kind, flags):
    """With every resnet norm2 bias zeroed, the expert computes exactly what
    the gated U-Net computes under the expert's hard arch: a closed head or
    GEGLU unit contributes 0, a closed resnet group (gated to zero) leaves
    norm2 only its bias."""
    _, port = dense
    state = {k: (torch.zeros_like(v) if k.endswith("norm2.bias") and ".resnets." in k else v)
             for k, v in port.state_dict().items()}
    gated = GatedUNet(UNetConfig.tiny(**flags)).eval()
    gated.load_state_dict(state)
    plan, _ = _plans(kind)
    expert = GatedUNet(UNetConfig.tiny(**flags), plan=plan).eval()
    expert.load_state_dict(slice_expert_params(state, plan))
    x, t, ehs = (torch.from_numpy(a) for a in _unet_inputs(seed=3))
    arch = torch.from_numpy(_arch(kind))[None]
    with torch.no_grad():
        want = gated(x, t, ehs, arch=arch)
        got = expert(x, t, ehs)
    torch.testing.assert_close(got, want, rtol=ID_RTOL, atol=ID_ATOL)


@pytest.mark.parametrize("n", range(1, 20))
@pytest.mark.parametrize("shapes", [(1, 2, 4), (1, 2, 4, 8), (1, 2, 3)])
def test_plan_batches_matches_jax(n, shapes):
    plan = ExpertServer.plan_batches(n, shapes)
    assert plan == JaxExpertServer.plan_batches(n, shapes)
    assert sum(real for _, real in plan) == n
    assert n <= sum(t for t, _ in plan) < n + shapes[0] + shapes[-1]


@pytest.mark.parametrize("batch_size", [1, 3, 4, 5, 8])
def test_batch_shapes_match_jax(batch_size):
    got = ExpertServer(None, [], [], batch_size).batch_shapes
    assert got == JaxExpertServer(None, [], [], [], batch_size).batch_shapes
    assert got[-1] == batch_size


def test_tier_planner_examples():
    """The examples of tests/test_expert_server_batching.py."""
    shapes = (1, 2, 4)
    assert ExpertServer.plan_batches(8, shapes) == [(4, 4), (4, 4)]
    assert ExpertServer.plan_batches(5, shapes) == [(4, 4), (1, 1)]
    assert ExpertServer.plan_batches(7, shapes) == [(4, 4), (4, 3)]
    assert ExpertServer.plan_batches(3, shapes) == [(4, 3)]
    counts = [9, 1, 1, 1]  # skewed: 4+4+1 and three 1s, no padded slot
    assert sum(sum(t for t, _ in ExpertServer.plan_batches(c, shapes)) for c in counts) == 12


# ---------------------------------------------------------------- serving

def _params(module, *args):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    return numpy_params(shapes["params"], seed=len(jax.tree_util.tree_leaves(shapes)))


K = 3


def _codebook_snapshot():
    """An `embedding_gs` snapshot of K random codes (units kept with
    p = 0.6; code 1 closes every other depth gate), as soft values on either
    side of 0.5. With this seed the requests of the serving tests route 5, 2
    and 2 prompts to codes 0, 1 and 2: a full tier and remainders."""
    rng = np.random.default_rng(21)
    codes = (rng.random((K, SPEC.vq_dim)) < 0.6).astype(np.float32)
    codes[:, SPEC.num_width:] = 1.0
    codes[1, SPEC.num_width::2] = 0.0
    return np.where(codes >= 0.5, 0.8, 0.2).astype(np.float32)


@pytest.fixture(scope="module")
def servers():
    """A tiny JAX pipeline with numpy weights and K = 3 codes, its
    ExpertServer, and the port's pipeline and server with the same weights."""
    ucfg = JaxUNetConfig.tiny(cross_attention_dim=32)
    spec = jax_build_structure(ucfg)
    unet = JaxGatedUNet(ucfg)
    text = jax_te.CLIPTextEncoder(jax_te.CLIPTextConfig.tiny())
    vae = JaxVAE(JaxVAEConfig.tiny())
    hypernet = JaxHyperStructure(spec, input_dim=32)
    quantizer = JaxQuantizer(spec, n_e=K, base=0.0)
    unet_p = numpy_params(jax.eval_shape(lambda: unet.init_params(jax.random.PRNGKey(0))))
    text_p = _params(text, jnp.zeros((1, 77), jnp.int32))
    vae_p = _params(vae, jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(0))
    hn_p = _params(hypernet, jnp.zeros((1, 32)))
    q_p = jax.jit(quantizer.init_params)(jax.random.PRNGKey(1))
    q_s = dict(jax.jit(quantizer.init_state)(q_p))
    q_s["embedding_gs"] = jnp.asarray(_codebook_snapshot())
    jax_pipe = JaxPipeline(unet=unet, unet_params=unet_p, vae=vae, vae_params=vae_p,
                           text_encoder=text, text_params=text_p, hypernet=hypernet,
                           hypernet_params=hn_p, quantizer=quantizer, quantizer_params=q_p,
                           quantizer_state=q_s)
    jax_server = JaxExpertServer.from_codebook(jax_pipe, unet_p, spec, ucfg, batch_size=4)

    pu = GatedUNet(UNetConfig.tiny(cross_attention_dim=32))
    pv, pt = AutoencoderKL(VAEConfig.tiny()), te.CLIPTextEncoder(te.CLIPTextConfig.tiny())
    ph = HyperStructure(pu.spec, input_dim=32)
    pq = StructureQuantizer(pu.spec, n_e=K, base=0.0)
    for mod, tree in ((pu, unet_p), (pv, vae_p), (pt, text_p), (ph, hn_p),
                      (pq, {"embedding": np.asarray(q_p["embedding"]),
                            "embedding_gs": _codebook_snapshot()})):
        mod.load_state_dict(params_from_jax(tree, mod))
    port_pipe = PruningPipeline(pu, pv, pt, ph, pq, device="cpu")
    server = ExpertServer.from_codebook(port_pipe, pu.spec, pu.cfg, batch_size=4)
    return jax_pipe, jax_server, port_pipe, server


def _request(seed, n):
    """Token ids, the JAX routing noise of a batch of n (what the JAX route
    draws from its fixed key), and initial latents."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (n, 77)).astype(np.int64)
    kw, kd = jax.random.split(FIXED_KEY)
    noise = np.concatenate([np.asarray(jax_sample_gumbel(kw, (n, SPEC.num_width))),
                            np.asarray(jax_sample_gumbel(kd, (n, SPEC.num_depth)))], axis=1)
    return (torch.from_numpy(ids), torch.from_numpy(noise),
            torch.from_numpy(rng.standard_normal((n, 8, 8, 4), dtype=np.float32)))


@pytest.fixture(scope="module")
def jax_reference(servers):
    """Images of the JAX expert pipes (or, under hybrid, the gated pipe with
    the row's code) for given rows, one row a batch (one compile per pipe)."""
    jax_pipe, jax_server, _, _ = servers
    codes = jax.numpy.asarray((np.asarray(_codebook_snapshot()) >= 0.5).astype(np.float32))

    def run(ids, neg, latents, expert, gated):
        pe = jax_pipe.encode_prompt(jnp.asarray(ids.numpy().astype(np.int32)))
        ne = jax_pipe.encode_prompt(jnp.asarray(neg.numpy().astype(np.int32)))
        ehs = jnp.concatenate([ne, pe])
        x = jnp.asarray(latents.numpy())
        if gated:
            out = jax_pipe._denoise_fn(STEPS, 7.5, True)(jax_pipe.unet_params, ehs,
                                                         codes[expert][None], x)
            return np.asarray(jax_pipe.decode(out))
        pipe = jax_server._expert_pipe(expert)
        out = pipe._denoise_fn(STEPS, 7.5, False)(jax_server.expert_params[expert], ehs,
                                                  None, x)
        return np.asarray(pipe.decode(out))

    return run


@pytest.mark.parametrize("mode", ["expert", "hybrid_async"])
def test_serving_queue_matches_jax_expert_pipes(servers, jax_reference, mode):
    jax_pipe, _, port_pipe, server = servers
    hybrid = mode == "hybrid_async"
    queue = ServingQueue(server, num_inference_steps=STEPS, hybrid=hybrid)
    neg = torch.zeros(1, 77, dtype=torch.long)
    requests = [_request(11, 3), _request(12, 6)]
    ids_all = []
    for ids, noise, latents in requests:
        ids_all.append(queue.submit(ids, neg, route_noise=noise, latents=latents))
    assert ids_all == [[0, 1, 2], [3, 4, 5, 6, 7, 8]]
    pend = queue.pending_per_expert()
    assert sum(pend.values()) == 9
    results = queue.flush_async().result(timeout=600) if hybrid else queue.flush()
    assert sorted(results) == list(range(9)) and queue.pending_per_expert() == {}
    shapes = server.batch_shapes
    if hybrid:
        full = sum((c // 4) * 4 for c in pend.values())
        rest = sum(c % 4 for c in pend.values())
        want_slots = full + (sum(t for t, _ in ExpertServer.plan_batches(rest, shapes))
                             if rest else 0)
    else:
        want_slots = sum(sum(t for t, _ in ExpertServer.plan_batches(c, shapes))
                         for c in pend.values())
    assert queue.last_slots_used == want_slots
    # the same routing as the JAX package's, then each image against the JAX pipe;
    # under hybrid the rows past an expert's full tiers ran the gated U-Net
    routed = []
    for ids, noise, _ in requests:
        _, jax_idx = jax_pipe.route(jax_pipe.encode_prompt(jnp.asarray(ids.numpy(), jnp.int32)))
        idx = server.route(ids, route_noise=noise)
        np.testing.assert_array_equal(idx, np.asarray(jax_idx))
        routed.append(idx)
    experts = np.concatenate(routed)
    assert {int(e): int((experts == e).sum()) for e in np.unique(experts)} == pend
    assert pend == {0: 5, 1: 2, 2: 2}  # a full tier and remainders
    ids = torch.cat([r[0] for r in requests])
    latents = torch.cat([r[2] for r in requests])
    for row, e in enumerate(experts.tolist()):
        rank = int((experts[:row] == e).sum())
        gated = hybrid and rank >= pend[e] // 4 * 4
        want = jax_reference(ids[row: row + 1], neg, latents[row: row + 1], e, gated)[0]
        got = results[row]
        assert got.shape == (16, 16, 3) and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, atol=IMAGE_ATOL)


def test_experts_share_uncut_leaves_and_never_write_through_them(servers):
    """An expert's uncut tensors are the dense U-Net's own storage (buffer
    sharing, as the JAX server's); its cut tensors are copies. Building,
    warming up and serving leave every dense weight as it was."""
    _, _, port_pipe, server = servers
    dense = port_pipe.unet.state_dict()
    before = {k: v.clone() for k, v in dense.items()}
    storages = {v.untyped_storage().data_ptr() for v in dense.values()}
    # a server of its own: the other tests' queues run meanwhile on the shared one
    own = ExpertServer.from_codebook(port_pipe, port_pipe.unet.spec, port_pipe.unet.cfg,
                                     batch_size=2)
    assert own.warmup(STEPS, 7.5, hybrid=True) == {"loaded": 0,
                                                    "built": (K + 1) * len(own.batch_shapes)}
    ids, noise, latents = _request(13, 3)
    images, idx = own.generate(ids, torch.zeros(1, 77, dtype=torch.long),
                               num_inference_steps=STEPS, hybrid=True, route_noise=noise,
                               latents=latents)
    assert images.shape == (3, 16, 16, 3) and torch.isfinite(images).all()
    assert own.last_slots_used >= 3
    for model in own.expert_models:
        cut = expert_cuts(model.plan)
        shared = 0
        for key, value in model.state_dict().items():
            if key in cut:
                assert value.untyped_storage().data_ptr() not in storages, key
            else:
                assert value.data_ptr() == dense[key].data_ptr(), key
                shared += 1
        assert cut and shared
    for key, value in port_pipe.unet.state_dict().items():
        assert torch.equal(value, before[key]), key


def test_bf16_experts_and_given_weights(servers):
    """`param_dtype` casts each expert once (no leaf shared with the f32
    dense U-Net); `expert_weights` (stage-2 state dicts) replace the slices."""
    _, _, port_pipe, _ = servers
    spec, cfg = port_pipe.unet.spec, port_pipe.unet.cfg
    dense = port_pipe.unet.state_dict()
    cast = ExpertServer.from_codebook(port_pipe, spec, cfg, param_dtype=torch.bfloat16)
    tuned = [{k: v * 2.0 for k, v in m.state_dict().items()} for m in cast.expert_models]
    given = ExpertServer.from_codebook(port_pipe, spec, cfg, expert_weights=tuned)
    for e, model in enumerate(cast.expert_models):
        want = slice_expert_params(dense, model.plan)
        for key, value in model.state_dict().items():
            assert value.dtype == torch.bfloat16
            assert torch.equal(value, want[key].bfloat16()), key
        for key, value in given.expert_models[e].state_dict().items():
            assert torch.equal(value, tuned[e][key]), key


def test_warmup_refuses_what_is_not_ported(servers):
    """Persisted programs and parallel warm-up raise with their reasons: a
    CUDA graph cannot be saved, and capture has no wait to overlap."""
    server = servers[3]
    with pytest.raises(NotImplementedError, match="cannot be saved to disk"):
        server.warmup(aot_dir="programs")
    with pytest.raises(NotImplementedError, match="under the GIL"):
        server.warmup(parallel=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_build_expert_assigns_without_copying(dense, dtype):
    """A CPU expert, f32 or bf16, keeps the config's route: built with the
    given config (layout "nchw", norms as the config says) and holding
    every leaf as given."""
    _, port = dense
    plan, _ = _plans("drop")
    state = {k: v.to(dtype) for k, v in slice_expert_params(port.state_dict(), plan).items()}
    expert = build_expert(UNetConfig.tiny(), plan, state)
    assert not expert.training
    assert expert.layout == "nchw" and not expert.cfg.fused_norms
    for key, value in expert.state_dict().items():
        assert value.data_ptr() == state[key].data_ptr() and not value.requires_grad, key


BF16_CUDA = (torch.bfloat16, "cuda")


@pytest.mark.parametrize("leaves,mesh,flags,route", [
    ({BF16_CUDA}, None, {}, True),
    ({BF16_CUDA}, None, {"fused_norms": True}, True),
    ({(torch.bfloat16, "cpu")}, None, {}, False),
    ({(torch.float32, "cpu")}, None, {}, False),
    ({(torch.float32, "cuda")}, None, {}, False),
    ({BF16_CUDA, (torch.float32, "cuda")}, None, {}, False),
    (set(), None, {}, False),
    ({BF16_CUDA}, "mesh", {}, False),
    ({BF16_CUDA}, None, {"fused_norm_conv": True}, False),
])
def test_nhwc_route_takes_only_bf16_cuda_experts_without_mesh_or_fused_conv(leaves, mesh, flags,
                                                                             route):
    """The route rule is a function of what `build_expert` observes: the
    (dtype, device type) pairs of the floating leaves, the mesh and the
    config. CPU tensors, f32 or mixed CUDA weights, a mesh and
    `fused_norm_conv` keep the config's route."""
    assert nhwc_route(UNetConfig.tiny(**flags), leaves, mesh) is route


def test_nhwc_route_copies_only_conv_weights(dense):
    """Which leaves are copies on the NHWC route (`channels_last_convs`, what
    `build_expert` assigns where `nhwc_route` holds): the 4-D conv weights
    whose layout changes, the 3×3 ones; a 1×1 shortcut is channels_last as
    it is and shares, as does every leaf of fewer dimensions. The uncut 3×3
    leaves (conv_in, conv_out, the resamplers) are among the copies."""
    _, port = dense
    assert nhwc_route(UNetConfig.tiny(), {BF16_CUDA})
    dense_sd = port.state_dict()
    for kind in ARCHS:
        plan, _ = _plans(kind)
        state = slice_expert_params(dense_sd, plan)
        nhwc = channels_last_convs(state)
        assert set(nhwc) == set(state)
        copied = {k for k, v in nhwc.items() if v.data_ptr() != state[k].data_ptr()}
        assert copied == {k for k, v in state.items() if v.dim() == 4 and v.shape[2:] == (3, 3)}
        for key, value in nhwc.items():
            assert torch.equal(value, state[key]), key
            if value.dim() == 4:
                assert value.is_contiguous(memory_format=torch.channels_last), key
            else:
                assert value is state[key], key
        uncut = {"conv_in.weight", "conv_out.weight", "down_blocks.0.downsamplers.0.conv.weight",
                 "up_blocks.0.upsamplers.0.conv.weight"}
        assert uncut <= copied and not uncut & set(expert_cuts(plan))
        assert all(state[k].data_ptr() == dense_sd[k].data_ptr() for k in uncut)
        assert any(k.endswith("conv_shortcut.weight") for k in set(nhwc) - copied)


@pytest.mark.parametrize("kind", ("keep", "drop", "least"))
def test_nhwc_layout_expert_matches_jax_and_never_converts(dense, jax_expert_outputs,
                                                           monkeypatch, kind):
    """The NHWC route's U-Net, run on the CPU with the plain versions: the
    leaves `channels_last_convs` gives under `fused_norms` make its layout
    "nhwc"; every convolution and every norm, the output head's included, is
    handed a channels_last activation (so none converts it); and its output
    matches the JAX expert under `fused_norms`."""
    _, port = dense
    plan, _ = _plans(kind)
    cfg = UNetConfig.tiny(fused_norms=True)
    with torch.device("meta"):
        expert = GatedUNet(cfg, plan=plan)
    expert.load_state_dict(channels_last_convs(slice_expert_params(port.state_dict(), plan)),
                           assign=True)
    expert.eval()
    assert expert.layout == "nhwc"
    seen = []

    def check(name, x):
        seen.append(name)
        assert x.is_contiguous(memory_format=torch.channels_last), name

    for name, mod in expert.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.register_forward_pre_hook(lambda m, args, name=name: check(name, args[0]))
    real = blocks.group_norm_silu

    def watched(x, *args):
        check("group_norm_silu", x)
        return real(x, *args)

    monkeypatch.setattr(blocks, "group_norm_silu", watched)
    x, t, ehs = _unet_inputs()
    with torch.no_grad():
        got = expert(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ehs))
    kept_res = sum(1 for sb in plan.subblocks if sb.kind == "resnet" and not sb.dropped)
    kept_tf = sum(1 for sb in plan.subblocks if sb.kind == "transformer" and not sb.dropped)
    assert seen.count("group_norm_silu") == 2 * kept_res + kept_tf + 1
    assert "conv_in" in seen and "conv_out" in seen
    assert got.shape == (4, 8, 8, 4) and got.is_contiguous()
    want = jax_expert_outputs(kind, {"fused_norms": True}, x, t, ehs)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_experts_cut_under_inference_mode_run_the_fused_ops(servers):
    """An expert cut under `torch.inference_mode` runs under
    `fused_norm_conv`, whose packed conv weights are keyed by the weight's
    version counter: the slicer makes its copies outside inference mode, so
    they are normal tensors, and the expert matches the same expert cut
    outside."""
    _, _, port_pipe, _ = servers
    cfg = UNetConfig.tiny(cross_attention_dim=32, fused_norm_conv=True)
    plan = make_expert_plan(port_pipe.unet.spec, _codebook_snapshot()[1] >= 0.5)
    x, t, ehs = (torch.from_numpy(a) for a in _unet_inputs(seed=5))
    ehs = ehs[..., :32]
    with torch.no_grad():
        want = build_expert(cfg, plan, slice_expert_params(port_pipe.unet.state_dict(),
                                                          plan))(x, t, ehs)
    with torch.inference_mode():
        state = slice_expert_params(port_pipe.unet.state_dict(), plan)
        assert not any(v.is_inference() for k, v in state.items() if k in expert_cuts(plan))
        got = build_expert(cfg, plan, state)(x, t, ehs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_experts_materialised_under_inference_mode_hold_normal_tensors(servers):
    """`from_codebook` called under `torch.inference_mode` casts and cuts
    outside it: no expert tensor is an inference tensor (each keeps the
    version counter the fused conv's packed-weight cache reads)."""
    _, _, port_pipe, _ = servers
    spec, cfg = port_pipe.unet.spec, port_pipe.unet.cfg
    with torch.inference_mode():
        server = ExpertServer.from_codebook(port_pipe, spec, cfg, param_dtype=torch.bfloat16)
    for model in server.expert_models:
        assert not any(v.is_inference() for v in model.state_dict().values())


class _EchoServer:
    """A stand-in for ExpertServer in the queue's stress test: routes each
    prompt by its first token and 'generates' the token itself, so a result
    shows which prompt it came from."""
    batch_size = 4

    def encode_route(self, input_ids, neg_input_ids, hyper_net_input=None, route_noise=None):
        pe = input_ids[:, :1].float()
        return pe, pe, (input_ids[:, 0] % 3).numpy()

    def _latent_source(self, latents, generator):
        return None

    def _dispatch_groups(self, groups, pe, ne, take, steps, scale, out, hybrid):
        for rows in groups.values():
            for r in rows:
                out[int(r)] = (pe, int(r))
        return sum(len(rows) for rows in groups.values())

    _materialise = staticmethod(ExpertServer._materialise)


def test_serving_queue_under_concurrent_submits_and_async_flushes():
    """Eight threads submit while the main thread keeps flushing in the
    background: every request id is given once, and every prompt's result
    comes back once, under its own id."""
    import sys
    import threading
    queue = ServingQueue(_EchoServer())
    submitted, lock = {}, threading.Lock()

    def client(c):
        for k in range(25):
            tokens = torch.tensor([[1000 * c + 10 * k + j] for j in range(3)])
            ids = queue.submit(tokens, tokens)
            with lock:
                submitted.update(zip(ids, tokens[:, 0].tolist()))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for th in threads:
            th.start()
        futures = []
        while any(th.is_alive() for th in threads):
            futures.append(queue.flush_async())
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        futures.append(queue.flush_async())
        results = {}
        for fut in futures:
            part = fut.result(timeout=60)
            assert not set(part) & set(results)
            results.update(part)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(submitted) == list(range(8 * 25 * 3))
    assert sorted(results) == sorted(submitted)
    assert all(float(results[rid]) == tok for rid, tok in submitted.items())
    assert queue.pending_per_expert() == {}
