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


def spread_detector(cfg, seed: int):
    """A port Detector on the CPU whose decode order is stable: the
    well-conditioned seeded weights of `interior_init`, with the heatmap
    head's last conv scaled by 50 so that neighbouring scores lie ~1e-3
    apart (float noise between batch sizes is ~1e-6).  Port-only tests use
    it to compare routes that must keep the same top-K order."""
    from side_tpu_torch.runtime.detector import Detector
    from side_tpu_torch.runtime.synthetic import interior_init
    det = Detector(cfg, device="cpu", seed=seed)
    interior_init(det.model, seed=seed + 10)
    with torch.no_grad():
        det.model.hm.Conv_1.weight.mul_(50.0)
    return det


# ------------------------------------------------ gradients, offsets, dropout
def window_interior_offsets(tree, rng: np.random.RandomState) -> None:
    """In a JAX parameter tree (numpy leaves, changed in place), give every
    offset/mask conv a tiny kernel and dy/dx biases in (0.3, 0.7): each DCN
    then samples inside its window and away from the integer kinks of the
    bilinear derivative, where the windowed (R = 1) and the exact function
    are the same smooth function (channel order per tap [dy, dx, logit])."""
    for name, sub in tree.items():
        if not isinstance(sub, dict):
            continue
        if name == "offset_mask":
            sub["kernel"] = sub["kernel"] * 0.02
            bias = sub["bias"].copy()
            bias[0::3] = rng.uniform(0.3, 0.7, 9)
            bias[1::3] = rng.uniform(0.3, 0.7, 9)
            sub["bias"] = bias
        else:
            window_interior_offsets(sub, rng)


def gradient_errors(model: torch.nn.Module, grads, dead=()) -> dict:
    """Per parameter tensor of the port model: max |port - JAX| over max
    |JAX| (`grads`: the JAX gradient tree, numpy leaves), floored at 1e-4
    of the model's largest gradient.  The `dead` parameters (biases that
    feed a batch-statistics BatchNorm: their gradient is 0 up to float
    residue) must instead lie below 1e-5 of it in both packages."""
    from side_tpu_torch import weights
    flat = weights._flatten(grads)
    top = max(np.abs(v).max() for v in flat.values())
    errs = {}
    for key, p in model.named_parameters():
        ref = flat.pop(weights.flax_param_path(key, p.dim()))
        got = weights.param_to_flax(key, np.zeros(p.shape, np.float32)
                                    if p.grad is None else p.grad.numpy())
        if key in dead:
            assert max(np.abs(got).max(), np.abs(ref).max()) <= 1e-5 * top
            continue
        errs[key] = float(np.abs(got - ref).max() /
                          max(np.abs(ref).max(), 1e-4 * top))
    assert not flat, f"JAX gradients the port lacks: {sorted(flat)[:5]}"
    return errs


def dropout_interceptor(store: list):
    """A flax method interceptor that appends each nn.Dropout call's keep
    mask (where its output is not zero) to `store` through a host callback
    (works under jit; call jax.effects_barrier() before reading)."""
    from flax import linen as nn

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, nn.Dropout):
            jax.debug.callback(lambda k: store.append(np.asarray(k)),
                               (out != 0) | (args[0] == 0))
        return out
    return interceptor


# ----------------------------------------------------- the voxel variant's
VOXEL_H, VOXEL_W, VOXEL_K = 64, 128, 3


def voxel_geometry(batch: int):
    """Calibration of tests/test_voxel_net.py (f = 200 px, baseline 0.5 m)
    and the stride-4 affines: p2, p3, trans, trans_inv, fb per image."""
    f = 200.0
    p2 = np.array([[f, 0, VOXEL_W / 2, 0.0], [0, f, VOXEL_H / 2, 0.0],
                   [0, 0, 1, 0]], np.float32)
    p3 = p2.copy()
    p3[0, 3] = -f * 0.5
    return {"p2": np.tile(p2, (batch, 1, 1)),
            "p3": np.tile(p3, (batch, 1, 1)),
            "trans": np.tile(np.array([[0.25, 0, 0], [0, 0.25, 0]],
                                      np.float32), (batch, 1, 1)),
            "trans_inv": np.tile(np.array([[4.0, 0, 0], [0, 4.0, 0]],
                                          np.float32), (batch, 1, 1)),
            "fb": np.full((batch,), f * 0.5, np.float32)}


def voxel_boxes(rng: np.random.RandomState, batch: int):
    """Feature-res (bbox, bbox_right) of VOXEL_K objects per image whose
    disparity puts them 6-14 m away, so that most of their voxels project
    into the 16x32 map."""
    K = VOXEL_K
    cx = rng.uniform(8, 24, (batch, K))
    cy = rng.uniform(5, 11, (batch, K))
    disp4 = 100.0 / rng.uniform(6, 14, (batch, K)) / 4
    half = rng.uniform(1, 3, (batch, K, 2))
    bbox = np.stack([cx - half[..., 0], cy - half[..., 1],
                     cx + half[..., 0], cy + half[..., 1]], -1)
    bbox_r = bbox - np.stack([disp4, 0 * disp4, disp4, 0 * disp4], -1)
    return bbox.astype(np.float32), bbox_r.astype(np.float32)


def voxel_train_batch(seed: int, batch: int = 2):
    """A training batch (uint8 images, targets, geometry) whose GT boxes are
    `voxel_boxes`; the second image has all VOXEL_K slots valid, the first
    two."""
    rng = np.random.RandomState(seed)
    K = VOXEL_K
    Ho, Wo = VOXEL_H // 4, VOXEL_W // 4
    bbox, bbox_r = voxel_boxes(rng, batch)
    cx = (bbox[..., 0] + bbox[..., 2]) / 2
    cy = (bbox[..., 1] + bbox[..., 3]) / 2
    cx_r = (bbox_r[..., 0] + bbox_r[..., 2]) / 2
    xs, ys = np.floor(cx), np.floor(cy)
    ind = (ys * Wo + xs).astype(np.int64)
    mask = np.ones((batch, K), np.uint8)
    mask[0, K - 1] = 0
    reg = np.stack([cx - xs, cx_r - xs, cy - ys], -1).astype(np.float32)
    wh = np.stack([bbox[..., 2] - bbox[..., 0],
                   bbox_r[..., 2] - bbox_r[..., 0],
                   bbox[..., 3] - bbox[..., 1]], -1).astype(np.float32)
    return {
        "input": rng.randint(0, 256, (batch, VOXEL_H, VOXEL_W, 3)
                             ).astype(np.uint8),
        "input_right": rng.randint(0, 256, (batch, VOXEL_H, VOXEL_W, 3)
                                   ).astype(np.uint8),
        "hm": (rng.rand(batch, 3, Ho, Wo) * 0.5).astype(np.float32),
        "ind": ind, "ind_float": ind.astype(np.float32),
        "rot_mask": mask, "wh": wh * mask[..., None], "reg": reg,
        "dim": rng.rand(batch, K, 3).astype(np.float32) + 1.0,
        "orien": rng.rand(batch, K, 2).astype(np.float32),
        "depth": ((rng.rand(batch, K, 1) * 8 + 6) * mask[..., None]).astype(
            np.float32),
        "kept": (rng.rand(batch, K, 6) * 5).astype(np.float32),
        **voxel_geometry(batch),
    }
