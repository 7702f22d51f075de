"""ResNet + DCN-deconv stereo backbone, the 'resdcn' family (port of
side_tpu/models/resnet_dcn.py).

A ResNet trunk to 1/32 runs on both views as one batch of 2B images, three
upsampling stages of (deformable 3x3 conv -> BN -> ReLU -> bilinear-
initialised transpose conv -> BN -> ReLU) with 256, 128 and 64 filters
bring it back to 1/4, and CenterNet heads (`{name}_conv` 3x3 with bias,
ReLU, `{name}_out` 1x1) read the left features (`LEFT_ONLY`) or the stereo
concat.  The three DeformBlocks run the DCN kernels (forward K1, backward
K2 and K3 on the card) at Cin 512 -> 256 at 1/32, 256 -> 128 at 1/16 and
128 -> 64 at 1/8 (Cin 2048 at the first stage from resdcn_50 on).  The
family has no depth output: train and detect it with `--not_cost_volume`.

Under torch.profiler a forward shows the spans (runtime/spans.py)
`net.trunk` (the ResNet trunk over the 2B images), `net.up` (the three
deconvolution stages) and `net.heads` (the heads), in turn; inside a
training step they lie within `train.forward`.  The backward runs on
autograd's thread and has no spans of its own.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .dla import (BatchNorm, BilinearUp, Conv2d, ConvBN, DeformBlock,
                  init_weights)
from ..runtime.spans import span
from .stereo_net import nchw_input, set_hm_bias

RESNET_SPEC = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def deform_shapes(num_layers: int = 18, input_h: int = 384,
                  input_w: int = 1280):
    """(Cin, H, W, Cout) per image of the three DeformBlocks, for an input
    whose sides are multiples of 32."""
    kind, _ = RESNET_SPEC[num_layers]
    cin = 512 if kind == "basic" else 2048
    h, w = input_h // 32, input_w // 32
    shapes = []
    for feat in (256, 128, 64):
        shapes.append((cin, h, w, feat))
        cin, h, w = feat, 2 * h, 2 * w
    return shapes


class ResBasic(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, features, 3, stride)
        self.ConvBN_1 = ConvBN(features, features, 3, 1, relu=False)
        self.project = stride != 1 or cin != features
        if self.project:
            self.ConvBN_2 = ConvBN(cin, features, 1, stride, relu=False)

    def forward(self, x):
        residual = self.ConvBN_2(x) if self.project else x
        return F.relu(self.ConvBN_1(self.ConvBN_0(x)) + residual)


class ResBottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, features, 1)
        self.ConvBN_1 = ConvBN(features, features, 3, stride)
        self.ConvBN_2 = ConvBN(features, features * 4, 1, relu=False)
        self.project = stride != 1 or cin != features * 4
        if self.project:
            self.ConvBN_3 = ConvBN(cin, features * 4, 1, stride, relu=False)

    def forward(self, x):
        residual = self.ConvBN_3(x) if self.project else x
        out = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        return F.relu(out + residual)


class ResNetTrunk(nn.Module):
    """7x7/2 stem, 3x3/2 max-pool, four stages of blocks (named as flax
    numbers them: ResBasic_0 .. or ResBottleneck_0 .. across the stages)."""

    def __init__(self, num_layers: int = 18):
        super().__init__()
        kind, blocks = RESNET_SPEC[num_layers]
        block = ResBasic if kind == "basic" else ResBottleneck
        self.ConvBN_0 = ConvBN(3, 64, 7, 2)
        self.names = []
        cin = 64
        for stage, (feat, n) in enumerate(zip((64, 128, 256, 512), blocks)):
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f"{block.__name__}_{len(self.names)}"
                setattr(self, name, block(cin, feat, stride))
                self.names.append(name)
                cin = feat * block.expansion
        self.out_channels = cin

    def forward(self, x):
        x = F.max_pool2d(self.ConvBN_0(x), 3, 2, padding=1)
        for name in self.names:
            x = getattr(self, name)(x)
        return x


class DeconvStage(nn.Module):
    """DCN 3x3 + BN + ReLU, then the bilinear-initialised transpose conv x2
    + BN (flax nn.BatchNorm, f32) + ReLU, cast back to the input's dtype."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.DeformBlock_0 = DeformBlock(cin, features)
        self.BilinearUp_0 = BilinearUp(features, 2)
        self.BatchNorm_0 = BatchNorm(features, channel_dim=1)

    def forward(self, x):
        y = self.BilinearUp_0(self.DeformBlock_0(x))
        return F.relu(self.BatchNorm_0(y)).to(x.dtype)


class HeadConvs(nn.Module):
    """Per head `{name}_conv` (3x3, bias, `head_conv` channels; none when
    head_conv <= 0) + ReLU and `{name}_out` (1x1, bias; the heatmap's
    starts at -2.19).  `cin(name)` gives a head's input channels.  Returns
    NHWC float32 maps."""

    def __init__(self, heads: Dict[str, int], head_conv: int, cin):
        super().__init__()
        self.heads, self.head_conv = dict(heads), head_conv
        for name, ch in self.heads.items():
            mid = cin(name)
            if head_conv > 0:
                setattr(self, f"{name}_conv",
                        Conv2d(mid, head_conv, 3, padding=1, bias=True))
                mid = head_conv
            setattr(self, f"{name}_out", Conv2d(mid, ch, 1, bias=True))

    def init_hm_bias(self) -> None:
        if "hm" in self.heads:
            set_hm_bias(self.hm_out)

    def head(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.head_conv > 0:
            x = F.relu(getattr(self, f"{name}_conv")(x))
        return getattr(self, f"{name}_out")(x).float().permute(0, 2, 3, 1)


class StereoResNet(HeadConvs):
    """resdcn_N: heads as `{name}_conv` / `{name}_out` on the trunk + deconv
    stages' 64-channel 1/4 map."""

    LEFT_ONLY = ("bored_offset", "kept_offset", "kept_type")
    has_depth = False

    def __init__(self, heads: Dict[str, int], num_layers: int = 18,
                 head_conv: int = 64, dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        super().__init__(heads, head_conv,
                         lambda n: 64 if n in self.LEFT_ONLY else 128)
        self.dtype = dtype
        self.trunk = ResNetTrunk(num_layers)
        cin = self.trunk.out_channels
        for i, feat in enumerate((256, 128, 64)):
            setattr(self, f"DeconvStage_{i}", DeconvStage(cin, feat))
            cin = feat
        init_weights(self, torch.Generator().manual_seed(seed))
        self.init_hm_bias()

    def forward(self, batch: Dict[str, torch.Tensor], target=None,
                use_cost_volume: bool = False) -> Dict[str, torch.Tensor]:
        """batch: input / input_right (B, H, W, 3); `target` and
        `use_cost_volume` are accepted and ignored, as in the JAX package
        (the family has no depth head)."""
        left = nchw_input(batch["input"], self.dtype)
        right = nchw_input(batch["input_right"], self.dtype)
        B = left.shape[0]
        with span("net.trunk"):
            x = self.trunk(torch.cat([left, right], dim=0))
        with span("net.up"):
            for i in range(3):
                x = getattr(self, f"DeconvStage_{i}")(x)
        with span("net.heads"):
            f_left = x[:B]
            f_stereo = torch.cat([f_left, x[B:]], dim=1)
            return {name: self.head(name, f_left if name in self.LEFT_ONLY
                                    else f_stereo)
                    for name in self.heads}
