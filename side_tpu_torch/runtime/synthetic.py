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


def perturb_offsets(model: torch.nn.Module, seed: int) -> None:
    """Give every offset/mask conv small seeded random weights, so that the
    DCNs sample at fractional and clamped offsets (their init is zero)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if name.endswith("offset_mask"):
                w = torch.randn(mod.weight.shape, generator=gen) * 0.02
                mod.weight.copy_(w.to(mod.weight.device))
