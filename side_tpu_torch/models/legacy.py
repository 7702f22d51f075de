"""Monocular legacy CenterNet backbones, the 'res' and 'dlav0' families
(port of side_tpu/models/legacy.py).

`MonoResNet` (msra_resnet: ResNet trunk + three plain conv + bilinear-
initialised transpose-conv stages) and `MonoDLA` (vanilla DLA-34 with a
convolutional upsampling pyramid to 1/4).  Both are SINGLE-IMAGE nets,
forward only: they take an NHWC image batch, not the stereo batch dict, so
the stereo Trainer and Detector do not run them (nor does the JAX
package's).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from .dla import DLA, BilinearUp, ConvBN, init_weights
from .resnet_dcn import HeadConvs, ResNetTrunk
from .stereo_net import nchw_input


class _Heads(HeadConvs):
    """Every head reads the same `cin`-channel map."""

    def __init__(self, heads: Dict[str, int], head_conv: int, cin: int):
        super().__init__(heads, head_conv, lambda name: cin)

    def forward(self, x):
        return {name: self.head(name, x) for name in self.heads}


class MonoResNet(nn.Module):
    single_image = True

    def __init__(self, heads: Dict[str, int], num_layers: int = 18,
                 head_conv: int = 64, dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        super().__init__()
        self.dtype = dtype
        self.trunk = ResNetTrunk(num_layers)
        cin = self.trunk.out_channels
        for i in range(3):
            setattr(self, f"ConvBN_{i}", ConvBN(cin, 256, 3, 1))
            setattr(self, f"BilinearUp_{i}", BilinearUp(256, 2))
            cin = 256
        self._Heads_0 = _Heads(heads, head_conv, 256)
        init_weights(self, torch.Generator().manual_seed(seed))
        self._Heads_0.init_hm_bias()

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x (B, H, W, 3) normalised NHWC -> NHWC float32 head maps."""
        x = self.trunk(nchw_input(x, self.dtype))
        for i in range(3):
            x = getattr(self, f"BilinearUp_{i}")(getattr(self,
                                                         f"ConvBN_{i}")(x))
        return self._Heads_0(x)


class MonoDLA(nn.Module):
    """dlav0: each coarser DLA level is projected to 64 channels (1x1
    ConvBN), upsampled, added to the next finer level's projection and
    fused by a 3x3 ConvBN, down to 1/`down_ratio`."""
    single_image = True

    def __init__(self, heads: Dict[str, int], head_conv: int = 256,
                 down_ratio: int = 4, dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        super().__init__()
        self.dtype = dtype
        self.base = DLA()
        ch = (16, 32, 64, 128, 256, 512)
        self.levels = list(range(len(ch) - 2, int(np.log2(down_ratio)) - 1,
                                 -1))
        self.ConvBN_0 = ConvBN(ch[-1], 64, 1)
        for i, lvl in enumerate(self.levels):
            setattr(self, f"BilinearUp_{i}", BilinearUp(64, 2))
            setattr(self, f"ConvBN_{2 * i + 1}", ConvBN(ch[lvl], 64, 1))
            setattr(self, f"ConvBN_{2 * i + 2}", ConvBN(64, 64, 3))
        self._Heads_0 = _Heads(heads, head_conv, 64)
        init_weights(self, torch.Generator().manual_seed(seed))
        self._Heads_0.init_hm_bias()

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x (B, H, W, 3) normalised NHWC -> NHWC float32 head maps."""
        feats = self.base(nchw_input(x, self.dtype))
        y = self.ConvBN_0(feats[-1])
        for i, lvl in enumerate(self.levels):
            y = getattr(self, f"BilinearUp_{i}")(y)
            skip = getattr(self, f"ConvBN_{2 * i + 1}")(feats[lvl])
            y = getattr(self, f"ConvBN_{2 * i + 2}")(y + skip)
        return self._Heads_0(y)
