"""The port's stage-1 training path on the CPU, each piece held against the
JAX package's function on the same inputs: gate estimators, Sinkhorn, the
four losses, the DDPM training targets, the quantizer's training forward,
the VAE encoder, the U-Net's block features and its remat option, and whole
train steps (`make_pruner_step`, single device, f32) in both phases with the
same weights (carried by `params_from_jax`) and the same random draws (made
from the JAX keys exactly as the JAX step splits them)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_pruning_tpu import losses as jax_losses
from diffusion_pruning_tpu.core import estimators as jax_est
from diffusion_pruning_tpu.core.sinkhorn import sinkhorn as jax_sinkhorn
from diffusion_pruning_tpu.core.sinkhorn import sinkhorn_assign as jax_sinkhorn_assign
from diffusion_pruning_tpu.core.resource import ResourceModel as JaxResourceModel
from diffusion_pruning_tpu.core.structure import build_structure as jax_build_structure
from diffusion_pruning_tpu.models.hypernet import HyperStructure as JaxHyperStructure
from diffusion_pruning_tpu.models.quantizer import StructureQuantizer as JaxQuantizer
from diffusion_pruning_tpu.models.text_encoders import CLIPTextConfig as JaxCLIPConfig
from diffusion_pruning_tpu.models.text_encoders import CLIPTextEncoder as JaxCLIP
from diffusion_pruning_tpu.models.unet.config import UNetConfig as JaxUNetConfig
from diffusion_pruning_tpu.models.unet.unet import GatedUNet as JaxGatedUNet
from diffusion_pruning_tpu.models.vae import AutoencoderKL as JaxVAE
from diffusion_pruning_tpu.models.vae import VAEConfig as JaxVAEConfig
from diffusion_pruning_tpu.schedulers import DiffusionSchedule as JaxSchedule
from diffusion_pruning_tpu.training import pruner as jax_pruner
from diffusion_pruning_tpu_torch import losses
from diffusion_pruning_tpu_torch.core import estimators, sinkhorn
from diffusion_pruning_tpu_torch.core.resource import ResourceModel
from diffusion_pruning_tpu_torch.models.convert import params_from_jax
from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from diffusion_pruning_tpu_torch.schedulers import DiffusionSchedule
from diffusion_pruning_tpu_torch.training import (
    PrunerConfig,
    PrunerModules,
    make_optimizer,
    make_pruner_step,
    make_validation_step,
)
from diffusion_pruning_tpu_torch.training.pruner import LOSS_TERMS, _applied_updates

from torch_port_common import numpy_params

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5  # f32 on both sides, op order differs
# whole-step tolerances, set from readings (see the step test)
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-3, 1e-4  # atol = fraction of the leaf's largest |grad|
# The codebook's depth columns: the first importance pre-activation is
# log(c + 1e-6) − log1p(−(c − 1e-6)) at c = Σ softmax = 1, whose slope is
# ~1e6, so the f32 rounding of Σ softmax comes back magnified ~1e6 and the
# softmax backward spreads it over every depth column of the row. They read
# 1.9e-3 relative between the packages.
DEPTH_GRAD_RTOL = 1e-2
# Adam divides each gradient by its own running RMS (+ 1e-8), so an entry
# whose gradient sits near the rounding floor still takes a step of a size
# set by its rounding: after two steps the codebook reads 2.8e-6 (peak LR
# 4e-4), the hypernet 6e-8.
PARAM_ATOL = 1e-5
B = 4


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- small pieces

def test_force_first_nonzero_and_gumbel_sigmoid_sample_match_jax():
    rng = np.random.default_rng(0)
    y = rng.random((5, 6), dtype=np.float32) * 0.6
    y[1] = 0.1   # all dead: slot 0 is bumped
    y[3] = 0.49
    np.testing.assert_array_equal(estimators._force_first_nonzero(_t(y)).numpy(),
                                  np.asarray(jax_est._force_first_nonzero(jnp.asarray(y))))
    logits = rng.standard_normal((5, 6), dtype=np.float32) - 2.0
    key = jax.random.PRNGKey(3)
    noise = jax_est.sample_gumbel(key, logits.shape)
    for force in (False, True):
        want = jax_est.gumbel_sigmoid_sample(jnp.asarray(logits), key, 0.4, 3.0, force)
        got = estimators.gumbel_sigmoid_sample(_t(logits), _t(noise), 0.4, 3.0, force)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("iterations", [1, 3])
def test_sinkhorn_matches_jax(iterations):
    scores = np.random.default_rng(iterations).uniform(-1, 1, (7, 4)).astype(np.float32)
    want = jax_sinkhorn(jnp.asarray(scores), 0.05, iterations)
    np.testing.assert_allclose(sinkhorn.sinkhorn(_t(scores), 0.05, iterations).numpy(),
                               np.asarray(want), rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(
        sinkhorn.sinkhorn_assign(_t(scores), 0.05, iterations).numpy(),
        np.asarray(jax_sinkhorn_assign(jnp.asarray(scores), 0.05, iterations)))


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    for kind in ("log", "mae", "mse"):
        np.testing.assert_allclose(
            float(losses.resource_loss(torch.tensor(0.45), 0.6, kind)),
            float(jax_losses.resource_loss(jnp.float32(0.45), 0.6, kind)), rtol=1e-6)
    text = rng.standard_normal((6, 24), dtype=np.float32)
    arch = rng.random((6, 40), dtype=np.float32)
    want, want_sim = jax_losses.contrastive_loss(jnp.asarray(text), jnp.asarray(arch))
    want_grad = jax.grad(lambda a: jax_losses.contrastive_loss(jnp.asarray(text), a)[0])(
        jnp.asarray(arch))
    a = _t(arch).requires_grad_()
    got, got_sim = losses.contrastive_loss(_t(text), a)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    np.testing.assert_allclose(got_sim.detach().numpy(), np.asarray(want_sim), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want_grad), rtol=1e-3, atol=1e-6)
    sched = JaxSchedule()
    t = np.array([0, 10, 500, 999])
    for gamma, ptype in ((5.0, "v_prediction"), (5.0, "epsilon"), (None, "v_prediction")):
        np.testing.assert_allclose(
            losses.snr_weights(DiffusionSchedule().alphas_cumprod, _t(t), gamma, ptype).numpy(),
            np.asarray(jax_losses.snr_weights(sched.alphas_cumprod, jnp.asarray(t), gamma, ptype)),
            rtol=1e-6)
    pred, target = (rng.standard_normal((4, 3, 3, 2), dtype=np.float32) for _ in range(2))
    w = rng.random(4, dtype=np.float32)
    np.testing.assert_allclose(
        float(losses.diffusion_loss(_t(pred), _t(target), _t(w))),
        float(jax_losses.diffusion_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(w))),
        rtol=1e-6)


@pytest.mark.parametrize("prediction_type", ["v_prediction", "epsilon"])
def test_add_noise_and_target_match_jax(prediction_type):
    rng = np.random.default_rng(2)
    x, eps = (rng.standard_normal((3, 4, 4, 4), dtype=np.float32) for _ in range(2))
    t = np.array([1, 400, 999])
    sched, jsched = (DiffusionSchedule(prediction_type=prediction_type),
                     JaxSchedule(prediction_type=prediction_type))
    args = (jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t))
    np.testing.assert_allclose(sched.add_noise(_t(x), _t(eps), _t(t)).numpy(),
                               np.asarray(jsched.add_noise(*args)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sched.target(_t(x), _t(eps), _t(t)).numpy(),
                               np.asarray(jsched.target(*args)), rtol=1e-6, atol=1e-6)


def test_resource_targets_match_jax():
    ours = ResourceModel(GatedUNet(UNetConfig.tiny()).spec)
    ref = JaxResourceModel(jax_build_structure(JaxUNetConfig.tiny()))
    assert ours.actual_pruning_target(0.6) == pytest.approx(ref.actual_pruning_target(0.6))
    np.testing.assert_array_equal(ours.prunable_macs_template(), ref.prunable_macs_template())
    arch = torch.rand(3, ours.spec.vq_dim, generator=torch.Generator().manual_seed(0),
                      requires_grad=True)
    ours.resource_ratio(arch).sum().backward()
    assert arch.grad is not None and arch.grad.abs().sum() > 0


def _jax_gumbel(key, rows, spec):
    """The gumbel noise `gumbel_sigmoid_trick(z, key)` draws: width columns
    from the first half of the key's split, depth columns from the second."""
    kw, kd = jax.random.split(key)
    return np.concatenate([np.asarray(jax_est.sample_gumbel(kw, (rows, spec.num_width))),
                           np.asarray(jax_est.sample_gumbel(kd, (rows, spec.num_depth)))], 1)


def test_quantizer_forward_train_matches_jax():
    jspec = jax_build_structure(JaxUNetConfig.tiny())
    nd = jspec.num_depth
    order = tuple(v - nd if j % 2 else v for j, v in enumerate(reversed(range(nd))))
    jq = JaxQuantizer(jspec, n_e=4, base=3.0, depth_order=order)
    params = jax.jit(jq.init_params)(jax.random.PRNGKey(5))
    q = StructureQuantizer(GatedUNet(UNetConfig.tiny()).spec, n_e=4, base=3.0, depth_order=order)
    q.load_state_dict(params_from_jax({"embedding": np.asarray(params["embedding"]),
                                       "embedding_gs": np.zeros((4, jspec.vq_dim))}, q))
    rng = np.random.default_rng(6)
    z = (np.asarray(params["embedding"])[rng.integers(0, 4, 6)]
         + 0.5 * rng.standard_normal((6, jspec.vq_dim))).astype(np.float32)
    w = rng.standard_normal((6, jspec.vq_dim)).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def jax_fn(emb):
        z_q, idx, state = jq.forward_train({"embedding": emb}, jnp.asarray(z), key)
        return (z_q * w).sum(), (z_q, idx, state["embedding_gs"])

    want_grad, (want_zq, want_idx, want_gs) = jax.grad(jax_fn, has_aux=True)(params["embedding"])
    k1, k2 = jax.random.split(key)
    z_q, idx, gs = q.forward_train(_t(z), _t(_jax_gumbel(k1, 4, jspec)),
                                   _t(_jax_gumbel(k2, 6, jspec)))
    (z_q * _t(w)).sum().backward()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(z_q.detach().numpy(), np.asarray(want_zq), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gs.numpy(), np.asarray(want_gs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(q.embedding.weight.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-4, atol=1e-6)
    for hard in (False, True):  # the codebook rows as gates, with the same noise
        want = jq.codebook_gates(params, k1, hard)
        got = q.codebook_gates(_t(_jax_gumbel(k1, 4, jspec)), hard)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # orthogonal init: orthonormal codebook rows
    q.init_params(torch.Generator().manual_seed(0))
    e = q.embedding.weight.detach()
    torch.testing.assert_close(e @ e.T, torch.eye(4), atol=1e-5, rtol=0)


def test_vae_encode_matches_jax():
    jvae = JaxVAE(JaxVAEConfig.tiny())
    vae = AutoencoderKL(VAEConfig.tiny()).eval()
    params = numpy_params(jax.eval_shape(lambda: jvae.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(0)))["params"])
    vae.load_state_dict(params_from_jax(params, vae))
    x = np.random.default_rng(8).standard_normal((2, 16, 16, 3), dtype=np.float32)
    key = jax.random.PRNGKey(9)
    mean, logvar = jax.jit(lambda p, x: jvae.apply({"params": p}, x, method=JaxVAE.encode_moments))(
        params, jnp.asarray(x))
    sample = jax.jit(lambda p, x: jvae.apply({"params": p}, x, key, method=JaxVAE.encode))(
        params, jnp.asarray(x))
    eps = jax.random.normal(key, mean.shape, mean.dtype)
    with torch.no_grad():
        got_mean, got_logvar = vae.encode_moments(_t(x))
        got = vae.encode(_t(x), _t(eps))
    for g, w in ((got_mean, mean), (got_logvar, logvar), (got, sample)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-4)


# ---------------------------------------------------------------- U-Net

@pytest.fixture(scope="module")
def unet_params():
    model = JaxGatedUNet(JaxUNetConfig.tiny(cross_attention_dim=32))
    return numpy_params(jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0))), seed=3)


def _unet(params, **overrides):
    model = GatedUNet(UNetConfig.tiny(cross_attention_dim=32, **overrides))
    model.load_state_dict(params_from_jax(params, model))
    return model.requires_grad_(False)


def _unet_inputs(spec, seed=10):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 8, 8, 4), dtype=np.float32), np.array([5, 900]),
            rng.standard_normal((2, 77, 32), dtype=np.float32),
            rng.random((2, spec.vq_dim), dtype=np.float32))


def test_unet_return_features_match_jax_site_by_site(unet_params):
    model = _unet(unet_params)
    x, t, ehs, arch = _unet_inputs(model.spec)
    jmodel = JaxGatedUNet(JaxUNetConfig.tiny(cross_attention_dim=32))
    want, want_feats = jax.jit(lambda p, x, t, e, a: jmodel.apply(
        {"params": p}, x, t, e, arch=a, return_features=True))(
        unet_params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs), jnp.asarray(arch))
    with torch.no_grad():
        got, feats = model(_t(x), _t(t), _t(ehs), arch=_t(arch), return_features=True)
    assert sorted(feats) == sorted(want_feats) == ["d0", "d1", "m", "u0", "u1"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=5e-4)
    for name in feats:
        np.testing.assert_allclose(feats[name].numpy(), np.asarray(want_feats[name]),
                                   rtol=RTOL, atol=5e-4, err_msg=name)


def test_unet_remat_matches_plain_loss_and_grads(unet_params):
    x, t, ehs, arch = _unet_inputs(_unet(unet_params).spec, seed=11)
    results = []
    for remat in (False, True):
        model = _unet(unet_params, remat=remat)
        a = _t(arch).requires_grad_()
        out, feats = model(_t(x), _t(t), _t(ehs), arch=a, return_features=True)
        loss = out.square().mean() + sum(f.square().mean() for f in feats.values())
        loss.backward()
        results.append((loss.detach(), a.grad))
    torch.testing.assert_close(results[1][0], results[0][0], rtol=1e-6, atol=0)
    torch.testing.assert_close(results[1][1], results[0][1], rtol=1e-5, atol=1e-9)
    assert results[0][1].abs().sum() > 0


# ---------------------------------------------------------------- the train step

@pytest.fixture(scope="module")
def world(unet_params):
    """JAX modules and weights of tests/test_pruner_step.py's setup, with
    numpy weights from a seed."""
    ucfg = JaxUNetConfig.tiny(cross_attention_dim=32)
    spec = jax_build_structure(ucfg)
    mods = jax_pruner.PrunerModules(
        unet=JaxGatedUNet(ucfg), vae=JaxVAE(JaxVAEConfig.tiny()),
        text_encoder=JaxCLIP(JaxCLIPConfig.tiny()),
        hypernet=JaxHyperStructure(spec, input_dim=24),
        quantizer=JaxQuantizer(spec, n_e=4, base=3.0), schedule=JaxSchedule())
    res = ucfg.sample_size * 8

    def init(module, *args):
        shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
        return numpy_params(shapes["params"], seed=len(jax.tree_util.tree_leaves(shapes)))

    frozen = {"unet": unet_params,
              "vae": init(mods.vae, jnp.zeros((1, res, res, 3)), jax.random.PRNGKey(0)),
              "text": init(mods.text_encoder, jnp.zeros((1, 77), jnp.int32))}
    trainable = {"hypernet": init(mods.hypernet, jnp.zeros((1, 24))),
                 "quantizer": jax.jit(mods.quantizer.init_params)(jax.random.PRNGKey(1))}
    return mods, frozen, trainable


def _port_modules(world):
    jmods, frozen, trainable = world
    unet = _unet(frozen["unet"])
    vae = AutoencoderKL(VAEConfig.tiny())
    text = CLIPTextEncoder(CLIPTextConfig.tiny())
    hypernet = HyperStructure(unet.spec, input_dim=24)
    quantizer = StructureQuantizer(unet.spec, n_e=4, base=3.0)
    emb = np.asarray(trainable["quantizer"]["embedding"])
    gs = np.asarray(jmods.quantizer.init_state(trainable["quantizer"])["embedding_gs"])
    for mod, tree in ((vae, frozen["vae"]), (text, frozen["text"]),
                      (hypernet, trainable["hypernet"]),
                      (quantizer, {"embedding": emb, "embedding_gs": gs})):
        mod.load_state_dict(params_from_jax(tree, mod))
    return PrunerModules(unet, vae, text, hypernet, quantizer, DiffusionSchedule())


def _batch(cached: bool, seed=12):
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(0, 128, (B, 77)).astype(np.int32),
             "mpnet_embeddings": rng.standard_normal((B, 24), dtype=np.float32)}
    if cached:
        batch["latent_mean"] = rng.standard_normal((B, 8, 8, 4), dtype=np.float32)
        batch["latent_logvar"] = np.full((B, 8, 8, 4), -6.0, np.float32)
    else:
        # the tiny VAE downsamples by 2: 8×8 latents, the tiny U-Net's size
        batch["pixel_values"] = 0.5 * rng.standard_normal((B, 16, 16, 3), dtype=np.float32)
    return batch


def _port_batch(batch):
    return {k: _t(v).long() if k == "input_ids" else _t(v) for k, v in batch.items()}


def _jax_draws(key, spec, n_e):
    """The step's randomness, split from `key` exactly as the JAX step splits
    it on one device (pruner.py:141, 306; quantizer.py:115, 195)."""
    shared_key, key = jax.random.split(key)
    k_vae, k_noise, k_t, k_g, _, _ = jax.random.split(key, 6)
    k1, k2 = jax.random.split(shared_key)
    lat = (B, 8, 8, 4)
    return {"vae_eps": _t(jax.random.normal(k_vae, lat)),
            "noise": _t(jax.random.normal(k_noise, lat)),
            "timesteps": _t(jax.random.randint(k_t, (B,), 0, 1000)).long(),
            "gumbel": _t(_jax_gumbel(k_g, B, spec)),
            "codebook_gumbel": _t(_jax_gumbel(k1, n_e, spec)),
            "gates_gumbel": _t(_jax_gumbel(k2, B, spec))}


def _capture_grads():
    """An optax stage that passes the gradients on and keeps them as its state."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, state, params=None: (g, g))


def _port_trainables(mods):
    """{hypernet: (kernel (in, vq), bias), codebook} as arrays, flax layout."""
    fcs = mods.hypernet.mh_fc
    return {"kernel": torch.cat([fc.weight for fc in fcs]).T.detach().numpy(),
            "bias": torch.cat([fc.bias for fc in fcs]).detach().numpy(),
            "codebook": mods.quantizer.embedding.weight.detach().numpy()}


def _port_grads(mods):
    fcs = mods.hypernet.mh_fc
    return {"kernel": torch.cat([fc.weight.grad for fc in fcs]).T.numpy(),
            "bias": torch.cat([fc.bias.grad for fc in fcs]).numpy(),
            "codebook": mods.quantizer.embedding.weight.grad.numpy()}


def _jax_trainables(tree, n_heads):
    hn = tree["hypernet"]
    return {"kernel": np.concatenate([np.asarray(hn[f"head_{i}_kernel"])
                                      for i in range(n_heads)], 1),
            "bias": np.concatenate([np.asarray(hn[f"head_{i}_bias"]) for i in range(n_heads)]),
            "codebook": np.asarray(tree["quantizer"]["embedding"])}


@pytest.mark.parametrize("pretrain,cached", [(True, True), (False, False)],
                         ids=["pretrain_cached_latents", "codebook_pixels"])
def test_pruner_step_matches_jax_two_steps(world, pretrain, cached):
    """Two steps of each phase: the seven loss terms, the expert indices and
    the hypernet and codebook grads of each step, and the parameters after
    both steps. Readings (f32, CPU): losses within 3e-6 relative; grads
    within 4e-5 relative except the codebook's depth columns (1.9e-3, see
    DEPTH_GRAD_RTOL); parameters as PARAM_ATOL says."""
    jmods, frozen, trainable = world
    cfg = jax_pruner.PrunerConfig(lr_warmup_steps=0)
    opt = optax.chain(_capture_grads(), jax_pruner.make_optimizer(cfg, global_batch=B))
    step = jax_pruner.make_pruner_step(jmods, cfg, opt, mesh=None, pretrain=pretrain)
    batch = _batch(cached)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    n_heads = len(jmods.hypernet.spec.width_list) + 1

    mods = _port_modules(world)
    pcfg = PrunerConfig(lr_warmup_steps=0)
    port_step = make_pruner_step(mods, pcfg, make_optimizer(pcfg, mods, B), pretrain=pretrain)
    tr, opt_state = trainable, opt.init(trainable)
    for i, key in enumerate((jax.random.PRNGKey(20), jax.random.PRNGKey(21))):
        tr, opt_state, q_state, metrics, aux = step(tr, frozen, opt_state, jbatch, key)
        got, got_aux = port_step(_port_batch(batch), _jax_draws(key, jmods.quantizer.spec, 4))
        assert not got["skipped"]
        for name in LOSS_TERMS:
            np.testing.assert_allclose(float(got[name]), float(metrics[name]), rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=f"step {i} {name}")
        np.testing.assert_array_equal(got_aux["expert_indices"].numpy(),
                                      np.asarray(aux["expert_indices"]))
        np.testing.assert_allclose(got_aux["batch_resource_ratios"].numpy(),
                                   np.asarray(aux["batch_resource_ratios"]), rtol=1e-5)
        np.testing.assert_allclose(mods.quantizer.embedding_gs.numpy(),
                                   np.asarray(q_state["embedding_gs"]), rtol=1e-5, atol=1e-6)
        want_grads = _jax_trainables(opt_state[0], n_heads)
        nw = jmods.quantizer.spec.num_width
        for name, g in _port_grads(mods).items():
            w = want_grads[name]
            atol = GRAD_ATOL_FRAC * np.abs(w).max() + 1e-12
            if name == "codebook":  # the depth columns apart (DEPTH_GRAD_RTOL)
                np.testing.assert_allclose(g[:, nw:], w[:, nw:], rtol=DEPTH_GRAD_RTOL, atol=atol,
                                           err_msg=f"step {i} grad codebook depth columns")
                g, w = g[:, :nw], w[:, :nw]
            np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=atol,
                                       err_msg=f"step {i} grad {name}")
    want_params = _jax_trainables(tr, n_heads)
    for name, p in _port_trainables(mods).items():
        np.testing.assert_allclose(p, want_params[name], rtol=0, atol=PARAM_ATOL, err_msg=name)


def test_flash_attention_step_matches_plain_attention_step_on_cpu(world):
    """The U-Net's gated attention through `GatedFlashAttention` (the plain
    versions of the training kernels on the CPU) gives the step the same
    losses and grads as plain masked attention under autograd."""
    jmods = world[0]
    draws = _jax_draws(jax.random.PRNGKey(30), jmods.quantizer.spec, 4)
    batch = _port_batch(_batch(cached=True))
    results = []
    for flash in (False, True):
        mods = _port_modules(world)
        mods.unet.cfg = UNetConfig.tiny(cross_attention_dim=32, use_flash_attention=flash)
        for m in mods.unet.modules():
            if hasattr(m, "use_flash"):
                m.use_flash = flash
        cfg = PrunerConfig()
        metrics, _ = make_pruner_step(mods, cfg, make_optimizer(cfg, mods, B))(batch, draws)
        results.append((metrics, _port_grads(mods)))
    (m0, g0), (m1, g1) = results
    for name in LOSS_TERMS:
        np.testing.assert_allclose(float(m1[name]), float(m0[name]), rtol=1e-5, err_msg=name)
    for name in g0:
        np.testing.assert_allclose(g1[name], g0[name], rtol=1e-4,
                                   atol=1e-5 * np.abs(g0[name]).max(), err_msg=name)


def test_validation_step_gives_the_step_losses_without_updating(world):
    jmods = world[0]
    mods = _port_modules(world)
    cfg = PrunerConfig()
    batch = _port_batch(_batch(cached=True))
    draws = _jax_draws(jax.random.PRNGKey(31), jmods.quantizer.spec, 4)
    before = _port_trainables(mods)
    val = make_validation_step(mods, cfg)(batch, draws)
    after = _port_trainables(mods)
    for name in before:
        np.testing.assert_array_equal(after[name], before[name])
    metrics, _ = make_pruner_step(mods, cfg, make_optimizer(cfg, mods, B))(batch, draws)
    for name in LOSS_TERMS:
        np.testing.assert_allclose(float(val[name]), float(metrics[name]), rtol=1e-6)


def test_bad_step_is_skipped_and_warmup_does_not_advance(world):
    """A NaN in the batch: no parameter or optimizer state changes and the
    warmup count stays; the next good update starts the warmup at lr 0, as
    optax's schedule count does. Draws missing from `draws` come from the
    generator."""
    mods = _port_modules(world)
    cfg = PrunerConfig(lr_warmup_steps=4)
    opt = make_optimizer(cfg, mods, B)
    assert [g["peak_lr"] for g in opt.param_groups] == pytest.approx([2e-4 * B ** 0.5] * 2)
    step = make_pruner_step(mods, cfg, opt, pretrain=False)
    gen = torch.Generator().manual_seed(0)
    batch = _port_batch(_batch(cached=True))
    bad = dict(batch, mpnet_embeddings=batch["mpnet_embeddings"].clone())
    bad["mpnet_embeddings"][0, 0] = float("nan")
    before = _port_trainables(mods)
    metrics, _ = step(bad, generator=gen)
    assert metrics["skipped"] and not opt.state
    for name, p in _port_trainables(mods).items():
        np.testing.assert_array_equal(p, before[name])
    metrics, _ = step(batch, generator=gen)
    assert not metrics["skipped"]
    assert [_applied_updates(opt, g) for g in opt.param_groups] == [1, 1]
    assert [g["lr"] for g in opt.param_groups] == [0.0, 0.0]
    step(batch, generator=gen)
    assert [g["lr"] for g in opt.param_groups] == pytest.approx([2e-4 * B ** 0.5 / 4] * 2)
    with pytest.raises(ValueError, match="draws lack"):
        step(batch)
