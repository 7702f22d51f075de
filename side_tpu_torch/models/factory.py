"""Model factory (port of side_tpu/models/factory.py): the flagship
`dla_34` with the cost-volume depth head."""

from __future__ import annotations

import torch

from ..config import Config
from .stereo_net import StereoNet


def create_model(cfg: Config, seed: int = 0) -> StereoNet:
    """Build the model for cfg.arch with seeded random weights."""
    family = cfg.arch.split("_")[0]
    if family != "dla" or cfg.depth_variant != "cost_volume" \
            or not cfg.cost_volume:
        raise NotImplementedError(
            f"arch {cfg.arch!r} / depth_variant {cfg.depth_variant!r} is not "
            "ported yet (ROADMAP.md, Queue 1: the off-path models)")
    if cfg.remat:
        raise NotImplementedError(
            "--remat (rematerialising the backbone in training) is not "
            "ported yet (ROADMAP.md, Queue 1 item 2)")
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32
    return StereoNet(heads=dict(cfg.heads), roi_size=cfg.roi_size,
                     topk=cfg.K, down_ratio=cfg.down_ratio,
                     input_w=cfg.input_w, wh_scale=cfg.wh_scale, dtype=dtype,
                     cv_topk=cfg.cv_topk, seed=seed)
