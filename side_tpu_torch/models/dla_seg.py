"""DLASeg-style stereo model (port of side_tpu/models/dla_seg.py, arch
`dlaseg_34`): the flagship's heads directly on the aggregated DLA-34
features, no depth output.  `hm` and `kept_type` read the left features
only, and only `kept_type` takes the deep 256-channel stack; every other
head reads the stereo channel concat."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from .dla import FeatureExtractor, init_weights
from .stereo_net import Head, nchw_input, set_hm_bias, stereo_features


class StereoDLASeg(nn.Module):
    LEFT_ONLY = ("hm", "kept_type")
    has_depth = False

    def __init__(self, heads: Dict[str, int], down_ratio: int = 4,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.heads, self.dtype = dict(heads), dtype
        self.feature_extraction = FeatureExtractor(down_ratio=down_ratio)
        for name, ch in self.heads.items():
            cin = 64 if name in self.LEFT_ONLY else 128
            setattr(self, name, Head(cin, ch, deep=(name == "kept_type")))
        init_weights(self, torch.Generator().manual_seed(seed))
        if "hm" in self.heads:
            set_hm_bias(getattr(self.hm, f"Conv_{self.hm.n_mid}"))

    def forward(self, batch: Dict[str, torch.Tensor], target=None,
                use_cost_volume: bool = False) -> Dict[str, torch.Tensor]:
        """NHWC float32 head maps; `target` and `use_cost_volume` are
        accepted and ignored, as in the JAX package."""
        left = nchw_input(batch["input"], self.dtype)
        right = nchw_input(batch["input_right"], self.dtype)
        f_left, f_right, _ = stereo_features(self.feature_extraction, left,
                                             right)
        f_stereo = torch.cat([f_left, f_right], dim=1)
        return {name: getattr(self, name)(
                    f_left if name in self.LEFT_ONLY else f_stereo
                ).permute(0, 2, 3, 1)
                for name in self.heads}
