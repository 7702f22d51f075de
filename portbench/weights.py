"""Seeded weights, drawn on the device by the benchmark's own rule.

Every random leaf comes from ONE normal draw of a `torch.Generator` on the
run's device, cut into leaves in the order of the state dict and scaled per
leaf: He-scaled conv and DCN kernels (N(0, 2 / fan_in)), dense layers
N(0, 1 / fan_in).  The offset/mask convs sample inside the window and off the grid, away from the
integer kinks of the bilinear derivative: kernels N(0, 9e-4 / fan_in), each
tap's dy and dx biases uniform in (0.3, 0.7) (the normal draw through its
CDF), mask-logit biases N(0, 0.25); offsets that spread over the kinks and
the clamp make the network amplify rounding some hundred times, so that a
bfloat16 program and its float32 reference would differ by chaos rather
than by precision.  The rest is constant: the heatmap head's last bias
(the leaves that `hm_bias` of the model's arch family names,
reference/arch_<family>.py) -2.1875 (see HM_BIAS: CenterNet's and the
port's own initial value, sigmoid 0.1, at the nearest bfloat16 value; the
heatmaps' scale varies from seed to seed, so that on some seeds part of
the top K passes the score filter and on others all of it), every other
bias 0, BatchNorm scale 0.1 (see BN_SCALE), shift 0, running mean 0 and
variance 0.01, the BilinearUp kernels bilinear.  The same dict is loaded, by
parameter name, into the program's model and into the reference's."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .reference import model as ref_model

# The heatmap head's last bias: CenterNet's -2.19 (sigmoid 0.1) moved to
# the nearest bfloat16 value, -2.1875, so that the program's bfloat16
# product does not round the bias itself: -2.19 stored as -2.1875 shifted
# every logit of the map by the same 0.0025 and the focal loss's 370,000
# background terms by ~0.5 % together (a first-step loss gap of 0.4-0.8 %
# on every seed; median 0.07 % at -2.1875).
HM_BIAS = -2.1875

# BatchNorm scale: a deep BatchNorm network at random init amplifies
# rounding in training mode (batch statistics); at a scale of 0.1 the
# residual and aggregation paths carry the signal and a bfloat16 step lies
# some ten times closer to its float32 reference than at 1.  The running
# variance is the scale squared, so that in evaluation mode every
# BatchNorm is the identity, as at scale 1 with variance 1.
BN_SCALE = 0.1


def bilinear_kernel(factor: int) -> np.ndarray:
    size = 2 * factor
    f = math.ceil(size / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    r = np.arange(size)
    k1 = 1 - np.abs(r / f - c)
    return np.outer(k1, k1).astype(np.float32)


def _rule(mod_type: str, mod_name: str, leaf: str, shape, hm_bias) -> tuple:
    """(kind, value): kind "normal" with value the standard deviation, or
    "const" with the value (a number or an array); `hm_bias(mod_name,
    leaf)` says whether the leaf takes the heatmap's initial bias."""
    if hm_bias(mod_name, leaf):
        return "const", HM_BIAS
    if mod_name.endswith("offset_mask"):
        if leaf == "weight":
            return "normal", 0.03 / math.sqrt(np.prod(shape[1:]))
        return "offset_bias", None
    if mod_type in ("FoldedBatchNorm", "BatchNorm"):
        return "const", {"weight": BN_SCALE, "bias": 0.0,
                         "running_mean": 0.0,
                         "running_var": BN_SCALE ** 2}[leaf]
    if mod_type == "BilinearUp":
        factor = shape[-1] // 2
        return "const", bilinear_kernel(factor)
    if mod_type == "DeformBlock":
        if leaf == "kernel":
            return "normal", math.sqrt(2.0 / (shape[0] * shape[1] * shape[2]))
        return "const", 0.0
    if mod_type in ("Conv2d", "Conv3d", "Dense"):
        if leaf == "bias":
            return "const", 0.0
        fan_in = int(np.prod(shape[1:]))
        gain = 1.0 if mod_type == "Dense" else 2.0
        return "normal", math.sqrt(gain / fan_in)
    raise ValueError(f"no weight rule for {mod_type} {mod_name}.{leaf}")


def leaf_rules(meta_model: torch.nn.Module) -> Dict[str, tuple]:
    """name -> (shape, kind, value) for every parameter and buffer."""
    hm_bias = ref_model.family_of(meta_model).hm_bias
    rules = {}
    for mod_name, mod in meta_model.named_modules():
        leaves = list(mod.named_parameters(recurse=False)) + \
            list(mod.named_buffers(recurse=False))
        for leaf, t in leaves:
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            rules[name] = (tuple(t.shape),) + _rule(
                type(mod).__name__, mod_name, leaf, tuple(t.shape), hm_bias)
    return rules


def draw(meta_model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of `meta_model`'s architecture for `seed`, f32 on
    `device`: one normal draw for all random leaves."""
    rules = leaf_rules(meta_model)
    n = sum(int(np.prod(s)) for s, kind, _ in rules.values()
            if kind in ("normal", "offset_bias"))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    pool = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, (shape, kind, value) in rules.items():
        size = int(np.prod(shape))
        if kind == "normal":
            out[name] = (pool[at:at + size] * value).reshape(shape)
            at += size
        elif kind == "offset_bias":
            z = pool[at:at + size].reshape(-1, 3)
            at += size
            out[name] = torch.cat([0.3 + 0.4 * torch.special.ndtr(z[:, :2]),
                                   0.5 * z[:, 2:]], dim=1).reshape(shape)
        elif isinstance(value, np.ndarray):
            out[name] = torch.as_tensor(value, device=device).expand(
                shape).clone()
        else:
            out[name] = torch.full(shape, float(value), device=device)
    return out
