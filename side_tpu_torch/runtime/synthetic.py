"""Seeded synthetic inputs for runs on random weights: a KITTI-style
calibration, random stereo frames at KITTI's raw size, a weight scale that
keeps activations from vanishing, and offset/mask weights that make the
deformable convs sample off the grid."""

from __future__ import annotations

import numpy as np
import torch

KITTI_H, KITTI_W = 375, 1242


def kitti_calib():
    """P0..P3 of a KITTI training sequence (image_2 / image_3 cameras)."""
    p2 = np.array([[721.5377, 0, 609.5593, 44.85728],
                   [0, 721.5377, 172.854, 0.2163791],
                   [0, 0, 1, 0.002745884]], np.float64)
    p3 = p2.copy()
    p3[:, 3] = [-339.5242, 2.199936, 0.002729905]
    p0 = p2.copy()
    p0[:, 3] = 0.0
    return [p0.tolist(), p0.tolist(), p2.tolist(), p3.tolist()]


def random_frame(rng: np.random.RandomState):
    """A random uint8 stereo pair: the right view is the left one shifted
    by 24 px plus noise."""
    left = rng.randint(0, 256, (KITTI_H, KITTI_W, 3), dtype=np.uint8)
    right = np.roll(left, -24, axis=1)
    right = np.clip(right.astype(np.int16) + rng.randint(
        -8, 9, right.shape), 0, 255).astype(np.uint8)
    return left, right


def he_scale(model: torch.nn.Module) -> None:
    """Scale every conv and DCN kernel of a freshly initialised model by
    sqrt(6), from the uniform 1/sqrt(fan_in) bound (variance 1/(3 fan_in))
    to He's variance 2/fan_in, so that activations keep their size through
    the depth of the trunk instead of vanishing (to ~1e-6 at the heads)."""
    from ..models.dla import Conv2d, Conv3d, DeformBlock
    gain = 6.0 ** 0.5
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (Conv2d, Conv3d)):
                mod.weight.mul_(gain)
            elif isinstance(mod, DeformBlock):
                mod.kernel.mul_(gain)


def interior_init(model: torch.nn.Module, seed: int) -> None:
    """Seeded random weights at which an f32 train step is well conditioned
    (the distributions of the port's train-step parity test): kernels
    N(0, 1/fan_in), BilinearUp kernels 0.25 + N(0, 0.01), BatchNorm scale
    U(0.6, 1.4), running mean N(0, 0.04) and variance U(0.5, 1.5), biases
    N(0, 0.01); offset/mask convs get kernels N(0, 9e-4/fan_in), mask-logit
    biases N(0, 0.25) and dy/dx biases U(0.3, 0.7), so that every DCN
    samples inside its window and away from the integer kinks of the
    bilinear derivative."""
    from ..models.dla import (BilinearUp, Conv2d, Conv3d, DeformBlock,
                              FoldedBatchNorm)
    gen = torch.Generator().manual_seed(seed)

    def randn(shape, std):
        return torch.randn(shape, generator=gen) * std

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen) * (hi - lo) + lo

    with torch.no_grad():
        for name, mod in model.named_modules():
            new = {}
            if name.endswith("offset_mask"):
                fan_in = mod.weight[0].numel()
                bias = randn(27, 0.5)
                bias[0::3] = uniform(9, 0.3, 0.7)
                bias[1::3] = uniform(9, 0.3, 0.7)
                new = {"weight": randn(mod.weight.shape, 0.03 / fan_in ** 0.5),
                       "bias": bias}
            elif isinstance(mod, FoldedBatchNorm):
                new = {"weight": uniform(mod.weight.shape, 0.6, 1.4),
                       "bias": randn(mod.bias.shape, 0.1),
                       "running_mean": randn(mod.running_mean.shape, 0.2),
                       "running_var": uniform(mod.running_var.shape, 0.5,
                                              1.5)}
            elif isinstance(mod, BilinearUp):
                new = {"weight": 0.25 + randn(mod.weight.shape, 0.1)}
            elif isinstance(mod, DeformBlock):
                fan_in = mod.kernel[..., 0].numel()
                new = {"kernel": randn(mod.kernel.shape, fan_in ** -0.5),
                       "bias": randn(mod.bias.shape, 0.1)}
            elif isinstance(mod, (Conv2d, Conv3d)):
                new = {"weight": randn(mod.weight.shape,
                                       mod.weight[0].numel() ** -0.5)}
                if mod.bias is not None:
                    new["bias"] = randn(mod.bias.shape, 0.1)
            for key, value in new.items():
                getattr(mod, key).copy_(value)


def perturb_offsets(model: torch.nn.Module, seed: int) -> None:
    """Give every offset/mask conv small seeded random weights, so that the
    DCNs sample at fractional and clamped offsets (their init is zero)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if name.endswith("offset_mask"):
                w = torch.randn(mod.weight.shape, generator=gen) * 0.02
                mod.weight.copy_(w.to(mod.weight.device))
