"""Shared helpers of the tests that hold side_tpu_torch against side_tpu.

Weights and inputs are made with numpy from a seed and handed to both
packages.  The JAX parameter tree comes from `jax.eval_shape` of the model's
init (no compile); every leaf is then filled with random values: offset/mask
convs large enough that offsets reach beyond +-1 (their init is zero, which
would exercise neither the sampling nor the clamp), BN statistics with
mean != 0 and var != 1.
"""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(2)

H_IN, W_IN = 128, 256


def _fill(path: str, shape, rng: np.random.RandomState) -> np.ndarray:
    leaf = path.rsplit("/", 1)[-1]
    if "offset_mask" in path:
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) * 1.5 / np.sqrt(fan_in)).astype(
                np.float32)
        return (rng.randn(*shape) * 0.5).astype(np.float32)
    if leaf == "kernel":
        if "/up_" in path:   # BilinearUp: bilinear plus noise
            return (0.25 + 0.1 * rng.randn(*shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
    if leaf == "scale":
        return rng.uniform(0.6, 1.4, shape).astype(np.float32)
    if leaf == "bias":
        return (rng.randn(*shape) * 0.1).astype(np.float32)
    if leaf == "mean":
        return (rng.randn(*shape) * 0.2).astype(np.float32)
    if leaf == "var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    raise ValueError(path)


def random_variables(shapes, seed: int):
    """Fill a tree of ShapeDtypeStructs (from jax.eval_shape) with seeded
    numpy values; returns a tree of numpy arrays."""
    rng = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, s in flat:
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        leaves.append(_fill(name, s.shape, rng))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def stereo_variables(model, seed: int, h: int = H_IN, w: int = W_IN):
    """Random variables of a JAX StereoNet at input (h, w)."""
    from side_tpu.models.stereo_net import init_stereo_net
    shapes = jax.eval_shape(lambda k: init_stereo_net(model, k, h, w),
                            jax.random.PRNGKey(0))
    return random_variables(shapes, seed)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def load_port(model: torch.nn.Module, variables) -> torch.nn.Module:
    """Copy JAX variables (numpy trees) into a port model via from_flax."""
    from side_tpu_torch.weights import from_flax
    sd = from_flax(variables["params"], variables.get("batch_stats", {}))
    missing, unexpected = model.load_state_dict(sd, strict=True), None
    del missing, unexpected
    return model.eval()


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()
