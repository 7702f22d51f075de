"""Model factory (port of side_tpu/models/factory.py).

Arch strings follow the convention '<family>_<num_layers>':
    dla_34    DLA-34 + DCN + cost volume (the flagship, StereoNet), or with
              `--depth_variant voxel` the voxel + PointNet depth
              (StereoVoxelNet)
    resdcn_N  ResNet-N + DCN deconv stereo backbone (StereoResNet)
    dlaseg_34 DLA-34 heads without a depth output (StereoDLASeg)
    res_N     MSRA ResNet pose net (monocular legacy, MonoResNet)
    dlav0_34  vanilla-DLA pose net (monocular legacy, MonoDLA)
"""

from __future__ import annotations

import torch

from ..config import Config
from .stereo_net import StereoNet


def create_model(cfg: Config, seed: int = 0) -> torch.nn.Module:
    """Build the model for cfg.arch with seeded random weights."""
    family = cfg.arch.split("_")[0]
    num_layers = int(cfg.arch.split("_")[1]) if "_" in cfg.arch else 0
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32

    if family == "dla":
        if cfg.depth_variant == "voxel":
            from .voxel_net import StereoVoxelNet
            return StereoVoxelNet(heads=dict(cfg.heads), topk=cfg.K,
                                  down_ratio=cfg.down_ratio,
                                  input_w=cfg.input_w, input_h=cfg.input_h,
                                  dtype=dtype, seed=seed)
        return StereoNet(heads=dict(cfg.heads), roi_size=cfg.roi_size,
                         topk=cfg.K, down_ratio=cfg.down_ratio,
                         input_w=cfg.input_w, wh_scale=cfg.wh_scale,
                         dtype=dtype, cv_topk=cfg.cv_topk, remat=cfg.remat,
                         seed=seed)
    if family == "resdcn":
        from .resnet_dcn import StereoResNet
        return StereoResNet(heads=dict(cfg.heads), num_layers=num_layers,
                            head_conv=cfg.head_conv, dtype=dtype, seed=seed)
    if family == "dlaseg":
        from .dla_seg import StereoDLASeg
        return StereoDLASeg(heads=dict(cfg.heads),
                            down_ratio=cfg.down_ratio, dtype=dtype, seed=seed)
    if family == "res":
        from .legacy import MonoResNet
        return MonoResNet(heads=dict(cfg.heads), num_layers=num_layers,
                          head_conv=cfg.head_conv, dtype=dtype, seed=seed)
    if family == "dlav0":
        from .legacy import MonoDLA
        return MonoDLA(heads=dict(cfg.heads), head_conv=cfg.head_conv,
                       down_ratio=cfg.down_ratio, dtype=dtype, seed=seed)
    raise ValueError(f"unknown arch {cfg.arch!r}")


def check_stereo_model(model: torch.nn.Module, cfg: Config) -> None:
    """Refuse, with a message, what the JAX package's Trainer and Detector
    cannot run either: a single-image legacy net (it takes an image, not
    the stereo batch), or a family without a depth output while the depth
    path is on (there a KeyError on "depth")."""
    if getattr(model, "single_image", False):
        raise ValueError(
            f"arch {cfg.arch!r} is a single-image (monocular) net; the "
            "stereo Trainer and Detector do not run it")
    if cfg.cost_volume and not getattr(model, "has_depth", True):
        raise ValueError(
            f"arch {cfg.arch!r} has no depth output; run it with "
            "--not_cost_volume")
