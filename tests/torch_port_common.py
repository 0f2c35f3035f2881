"""Helpers shared by the PyTorch port's parity tests (not a test module)."""
import jax
import numpy as np


def numpy_params(shapes, seed=0):
    """Random flax parameters made with numpy from a shape tree (no JAX init
    compile): fan-in-scaled kernels, norm scales near 1, small nonzero
    biases."""
    rng = np.random.default_rng(seed)
    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, leaf in paths:
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "scale":
            leaves.append(1.0 + 0.1 * rng.standard_normal(shape, dtype=np.float32))
        elif len(shape) <= 1:
            leaves.append(0.1 * rng.standard_normal(shape, dtype=np.float32))
        else:
            fan_in = float(np.prod(shape[:-1]))
            leaves.append(rng.standard_normal(shape, dtype=np.float32) / np.sqrt(fan_in))
    return jax.tree_util.tree_unflatten(treedef, leaves)
