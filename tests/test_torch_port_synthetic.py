"""The port's planted redundancy (`utils/synthetic.py`) against the JAX
package's on the tiny U-Net, and the contract that keeps the synthetic
recipe out of real training (tests/test_synthetic_contract.py for the port):
`self_distill_target` defaults to False in both configs, no YAML names it,
and no entry point of the port (`cli/`) but `cli/convergence_run.py` passes
it, and that one only behind `--real_target`."""
import os

import jax
import numpy as np
import pytest
import torch

from diffusion_pruning_tpu.core.structure import build_structure as jax_build_structure
from diffusion_pruning_tpu.models.unet.config import UNetConfig as JaxUNetConfig
from diffusion_pruning_tpu.models.unet.unet import GatedUNet as JaxGatedUNet
from diffusion_pruning_tpu.utils.synthetic import plant_redundancy as jax_plant_redundancy
from diffusion_pruning_tpu_torch.models.convert import params_from_jax
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.training import FineTuneConfig, PrunerConfig
from diffusion_pruning_tpu_torch.utils.synthetic import plant_redundancy

from torch_port_common import numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dense():
    """The tiny JAX U-Net's numpy weights and the port's state dict of them."""
    ucfg = JaxUNetConfig.tiny(cross_attention_dim=32)
    tree = numpy_params(jax.eval_shape(lambda: JaxGatedUNet(ucfg).init_params(
        jax.random.PRNGKey(0), batch=1)))
    model = GatedUNet(UNetConfig.tiny(cross_attention_dim=32))
    return jax_build_structure(ucfg), tree, model, params_from_jax(tree, model)


@pytest.mark.parametrize("keep, eps, seed", [(0.5, 0.02, 123), (0.3, 0.25, 7), (0.0, 0.0, 5)])
def test_plant_redundancy_equals_the_jax_one_bit_for_bit(dense, keep, eps, seed):
    """The same units damped by the same factor: the JAX function's damped
    tree carried across equals the port's damped state dict exactly (f32),
    and the planted fraction is the same number."""
    jspec, tree, model, sd = dense
    want_tree, want_planted = jax_plant_redundancy(jspec, tree, keep=keep, eps=eps, seed=seed)
    want = params_from_jax(jax.tree.map(np.asarray, want_tree), model)
    got, planted = plant_redundancy(model.spec, sd, keep=keep, eps=eps, seed=seed)
    assert planted == want_planted
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_plant_redundancy_invariants(dense):
    """The JAX test's invariants on the port: only norm2 scales, to_v rows and
    GEGLU projection rows change, each changed entry is the original times
    eps, the input is left as it was, and with keep = 0 every site keeps
    exactly its first unit."""
    _, _, model, sd = dense
    before = {k: v.clone() for k, v in sd.items()}
    eps = 0.25
    damped, planted = plant_redundancy(model.spec, sd, keep=0.5, eps=eps, seed=7)
    assert 0.5 <= planted <= 0.75, planted
    touched = 0
    for key, a in sd.items():
        assert torch.equal(a, before[key]), key
        b = damped[key]
        if torch.equal(a, b):
            assert b is a, key  # untouched tensors are shared, not copied
            continue
        touched += 1
        assert key.endswith(("norm2.weight", "to_v.weight", "ff.net.0.proj.weight")), key
        changed = a != b
        torch.testing.assert_close(b[changed], a[changed] * eps, rtol=1e-6, atol=0)
    assert touched > 0
    spec = model.spec
    _, planted0 = plant_redundancy(spec, sd, keep=0.0, eps=0.0, seed=7)
    n_sites = sum(len(sb.sites) for sb in spec.subblocks)
    assert np.isclose(planted0, n_sites / spec.num_width, atol=1e-6)


def test_self_distill_target_defaults_to_false():
    assert PrunerConfig().self_distill_target is False
    assert FineTuneConfig().self_distill_target is False


def test_no_config_or_entry_point_but_the_convergence_run_passes_it():
    for root, _, files in os.walk(os.path.join(REPO, "configs")):
        for f in files:
            if f.endswith((".yaml", ".yml")):
                with open(os.path.join(root, f)) as fh:
                    assert "self_distill" not in fh.read(), f
    cli = os.path.join(REPO, "diffusion_pruning_tpu_torch", "cli")
    for f in sorted(os.listdir(cli)):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(cli, f)) as fh:
            text = fh.read()
        if f == "convergence_run.py":
            assert text.count("self_distill_target=not args.real_target") == 2
        else:
            assert "self_distill" not in text, f
