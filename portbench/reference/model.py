"""The reference model: the frozen copies of the port's networks, built at
float32 from a configuration's keys and loaded with the benchmark's
weights."""

from __future__ import annotations

from typing import Dict

import torch

from ..traffic.config import Config
from .stereo_net import StereoNet
from .voxel_net import StereoVoxelNet


def build(cfg: Config, device="meta") -> torch.nn.Module:
    """The architecture of `cfg` at float32 on `device` (meta: shapes only,
    nothing allocated)."""
    if cfg.arch != "dla_34":
        raise ValueError(f"the reference holds dla_34 only, not {cfg.arch!r}")
    with torch.device(device):
        if cfg.depth_variant == "voxel":
            return StereoVoxelNet(heads=dict(cfg.heads), topk=cfg.K,
                                  down_ratio=cfg.down_ratio,
                                  input_w=cfg.input_w, input_h=cfg.input_h,
                                  dtype=torch.float32)
        return StereoNet(heads=dict(cfg.heads), roi_size=cfg.roi_size,
                         topk=cfg.K, down_ratio=cfg.down_ratio,
                         input_w=cfg.input_w, wh_scale=cfg.wh_scale,
                         dtype=torch.float32, cv_topk=cfg.cv_topk)


def loaded(cfg: Config, weights: Dict[str, torch.Tensor], device
           ) -> torch.nn.Module:
    """The reference model on `device` holding copies of `weights`."""
    model = build(cfg).to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model
