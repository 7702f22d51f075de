"""The DLA family of the reference: `dla_34`, the flagship with the RoI
cost volume (StereoNet) or, with `depth_variant` voxel, the voxel grid and
PointNet depth (StereoVoxelNet).  What a family module provides:

- `build(cfg)`: the float32 model of `cfg` (model.build calls it under the
  device it was given);
- `MODELS`: the class names of the models it builds, which the program's
  models carry too: capture and the weights' rule find the family of a
  model by its class;
- `LAYERS`: the single layers judged (reference.layers), name -> module
  path, `stem` first; a path the model lacks is skipped;
- `hm_bias(module name, leaf)`: whether a leaf takes the heatmap's initial
  bias (weights.HM_BIAS)."""

from __future__ import annotations

import torch

from ..traffic.config import Config
from .stereo_net import StereoNet
from .voxel_net import StereoVoxelNet

MODELS = ("StereoNet", "StereoVoxelNet")

LAYERS = {
    "stem": "feature_extraction.base.ConvBN_0.Conv_0",
    "dcn": "feature_extraction.dla_up.ida_0.proj_1",
    "head": "hm.Conv_0",
    "depth3d": "depth_estimator.ConvBN3D_0.Conv_0",
    "pointnet": "pointNet.conv1",
}


def hm_bias(mod_name: str, leaf: str) -> bool:
    """Every bias under the heatmap head `hm` (its last conv's alone: the
    3x3 convs before it have none)."""
    return mod_name.split(".")[0] == "hm" and leaf == "bias"


def build(cfg: Config) -> torch.nn.Module:
    if cfg.arch != "dla_34":
        raise ValueError(f"the DLA family holds dla_34 only, not {cfg.arch!r}")
    if cfg.depth_variant == "voxel":
        return StereoVoxelNet(heads=dict(cfg.heads), topk=cfg.K,
                              down_ratio=cfg.down_ratio,
                              input_w=cfg.input_w, input_h=cfg.input_h,
                              dtype=torch.float32)
    return StereoNet(heads=dict(cfg.heads), roi_size=cfg.roi_size,
                     topk=cfg.K, down_ratio=cfg.down_ratio,
                     input_w=cfg.input_w, wh_scale=cfg.wh_scale,
                     dtype=torch.float32, cv_topk=cfg.cv_topk)
