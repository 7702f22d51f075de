# Frozen copy of side_tpu_torch/models/cost_volume.py at commit ca59ff401c87, kept with the benchmark
# so that later changes to the program do not move the yardstick.
"""Object-conditioned stereo cost volume and instance-depth estimator
(port of side_tpu/models/cost_volume.py).  In training mode the
BatchNorms of `CostVolumeNet` take their statistics over every RoI slot of
the batch, the invalid zero-box GT slots included, as the JAX package's do.

Volumes are NDHWC at the public functions, as in the JAX package:
`build_cost_volume` returns (N, D, R, R, 3C); `CostVolumeNet` takes it and
runs its 3D convs on NCDHW internally.  `build_cost_volume_gather` builds
the same volume with one gather RoIAlign per depth bin (the reference's
loop), and `HourglassVolume` is the encoder/decoder 3D CNN over a cost
volume; the models of the factory use neither.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .roi_align import pool_interp_matrix, roi_align
from .dla import Conv2d, Conv3d, FoldedBatchNorm, init_weights

DEPTH_MAX = 87.0


def proposal_shift(bbox: torch.Tensor, bbox_right: torch.Tensor,
                   fb: torch.Tensor, num_bins: int, feat_w: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Depth-hypothesis RoI shifts, batched.

    bbox, bbox_right: (B, K, 4) at feature resolution; fb: (B,).
    Returns rois_left, rois_right (B, K, D, 4) and depth_bin (B, K, D)."""
    B, K, _ = bbox.shape
    D = num_bins
    rate = torch.arange(D, dtype=torch.float32, device=bbox.device) / (D - 1)

    xmin = torch.minimum(bbox[..., 0], bbox_right[..., 0])
    ymin = torch.minimum(bbox[..., 1], bbox_right[..., 1])
    xmax = torch.maximum(bbox[..., 2], bbox_right[..., 2])
    ymax = torch.maximum(bbox[..., 3], bbox_right[..., 3])

    width = torch.clamp(xmax - xmin, min=1e-3)
    depth_min = torch.clamp(fb[:, None] / (width * 0.9 * 4.0), 1.0, DEPTH_MAX)
    depth_bin = DEPTH_MAX - (DEPTH_MAX - depth_min[..., None]) * rate
    disp_bin = fb[:, None, None] / depth_bin / 8.0

    xmin_l = torch.clamp(xmin[..., None] + disp_bin, max=feat_w - 1.0)
    xmax_l = torch.clamp(xmax[..., None] + disp_bin, max=feat_w - 1.0)
    xmin_r = torch.clamp(xmin[..., None] - disp_bin, min=0.0)
    xmax_r = torch.clamp(xmax[..., None] - disp_bin, min=0.0)

    ymin_d = ymin[..., None].expand(B, K, D)
    ymax_d = ymax[..., None].expand(B, K, D)
    rois_left = torch.stack([xmin_l, ymin_d, xmax_l, ymax_d], dim=-1)
    rois_right = torch.stack([xmin_r, ymin_d, xmax_r, ymax_d], dim=-1)
    return rois_left, rois_right, depth_bin


def build_cost_volume(feat_left: torch.Tensor, feat_right: torch.Tensor,
                      rois_left: torch.Tensor, rois_right: torch.Tensor,
                      roi_size: int) -> torch.Tensor:
    """RoIAlign both views over all depth hypotheses as two contractions.

    feat_*: (B, H, W, C) NHWC; rois_*: (B, K, D, 4).  The y extent is
    shared by both views and all D bins, so one y-contraction per RoI serves
    them all.  Returns (B*K, D, R, R, 3C) = cat(left, right, left - right)
    in feat_left's dtype."""
    B, K, D, _ = rois_left.shape
    R = roi_size
    H, W = feat_left.shape[1:3]
    Wy = pool_interp_matrix(rois_left[:, :, 0, 1], rois_left[:, :, 0, 3],
                            H, R, 2)                          # (B, K, R, H)
    Wxl = pool_interp_matrix(rois_left[..., 0], rois_left[..., 2], W, R, 2)
    Wxr = pool_interp_matrix(rois_right[..., 0], rois_right[..., 2], W, R, 2)

    fl = feat_left.float()
    fr = feat_right.float()
    yl = torch.einsum("bkph,bhwc->bkpwc", Wy, fl)
    yr = torch.einsum("bkph,bhwc->bkpwc", Wy, fr)
    pool_l = torch.einsum("bkdqw,bkpwc->bkdpqc", Wxl, yl)
    pool_r = torch.einsum("bkdqw,bkpwc->bkdpqc", Wxr, yr)
    cost = torch.cat([pool_l, pool_r, pool_l - pool_r], dim=-1)
    return cost.reshape(B * K, D, R, R, cost.shape[-1]).to(feat_left.dtype)


def build_cost_volume_gather(feat_left: torch.Tensor,
                             feat_right: torch.Tensor,
                             rois_left: torch.Tensor,
                             rois_right: torch.Tensor,
                             roi_size: int) -> torch.Tensor:
    """`build_cost_volume` by gather RoIAlign, one depth bin at a time (a
    working set of B*K RoIs instead of B*K*D).  Same arguments and result,
    in feat_left's dtype."""
    B, K, D, _ = rois_left.shape
    batch_idx = torch.arange(B, device=feat_left.device).repeat_interleave(K)
    bins = []
    for d in range(D):
        pl = roi_align(feat_left, rois_left[:, :, d].reshape(B * K, 4),
                       batch_idx, roi_size, 1.0, 2)
        pr = roi_align(feat_right, rois_right[:, :, d].reshape(B * K, 4),
                       batch_idx, roi_size, 1.0, 2)
        bins.append(torch.cat([pl, pr, pl - pr], dim=-1))
    return torch.stack(bins, dim=1)                  # (B*K, D, R, R, 3C)


class ConvTranspose3d(Conv3d):
    """flax `nn.ConvTranspose(kernel 3, stride 2, padding="SAME")` (no
    kernel flip, `transpose_kernel=False`): the input dilated by 2, padded
    by (2, 1) per spatial axis and correlated with the kernel, so each
    spatial size doubles.  The weight is stored as a Conv3d's (out, in, k,
    k, k), the flax kernel (k, k, k, in, out) transposed like any 3D conv
    kernel (weights.py); F.conv_transpose3d correlates with the flipped
    (in, out) weight and pads (2, 2), so the weight is flipped and the last
    output plane of each axis dropped."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, bias=False)
        self.lecun = True                  # flax's default kernel init

    def forward(self, x):
        w = self.weight.to(x.dtype).flip(2, 3, 4).transpose(0, 1)
        y = F.conv_transpose3d(x, w, None, stride=2)
        d, h, wd = (2 * n for n in x.shape[2:])
        return y[:, :, :d, :h, :wd]


class HourglassVolume(nn.Module):
    """Encoder/decoder 3D CNN over a cost volume (side_tpu HourglassVolume):
    two stride-2 conv stages, two transpose-conv stages and a skip from the
    first stage.  (N, D, H, W, in_channels) NDHWC -> (N, D', H', W', 64)
    in the input's dtype; D' = 2 * ceil(ceil(D / 2) / 2), which must equal
    2 * ceil(D / 2) for the skip to fit (likewise H, W)."""

    def __init__(self, in_channels: int, seed: int = 0):
        super().__init__()
        for name, cin, cout, stride in (("enc0", in_channels, 64, 1),
                                        ("enc1", 64, 128, 2),
                                        ("enc2", 128, 128, 2),
                                        ("enc3", 128, 128, 1)):
            conv = Conv3d(cin, cout, 3, stride, padding=1, bias=False)
            conv.msra = True
            setattr(self, name, conv)
            setattr(self, f"{name}_bn", FoldedBatchNorm(cout))
        self.dec0 = ConvTranspose3d(128, 128)
        self.dec0_bn = FoldedBatchNorm(128)
        self.dec1 = ConvTranspose3d(128, 64)
        self.dec1_bn = FoldedBatchNorm(64)
        init_weights(self, torch.Generator().manual_seed(seed))

    def forward(self, cost: torch.Tensor) -> torch.Tensor:
        def stage(name, x):
            return F.relu(getattr(self, f"{name}_bn")(getattr(self, name)(x)))

        x = stage("enc0", cost.permute(0, 4, 1, 2, 3))            # NCDHW
        cost0 = stage("enc1", x)
        x = stage("enc3", stage("enc2", cost0))
        x = self.dec0_bn(self.dec0(x)) + cost0
        x = self.dec1_bn(self.dec1(x))
        return x.permute(0, 2, 3, 4, 1)


class ConvBN3D(nn.Module):
    def __init__(self, cin: int, cout: int, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.Conv_0 = Conv3d(cin, cout, 3, padding=1, bias=False)
        self.Conv_0.msra = True
        self.BatchNorm_0 = FoldedBatchNorm(cout)

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.relu else x


class CostVolumeNet(nn.Module):
    """3D-CNN instance-depth head with the structure-aware attention module
    (side_tpu CostVolumeNet)."""

    def __init__(self, reduced_channels: int = 32):
        super().__init__()
        C = self.C = reduced_channels
        self.ConvBN3D_0 = ConvBN3D(3 * C, 64)
        self.ConvBN3D_1 = ConvBN3D(64, 64)
        self.strAM_conv = Conv2d(64, 64, 3, padding=1)
        self.strAM_conv.msra = True
        self.strAM_bn = FoldedBatchNorm(64)
        self.ConvBN3D_2 = ConvBN3D(64, 64)
        self.ConvBN3D_3 = ConvBN3D(64, 128)
        self.ConvBN3D_4 = ConvBN3D(128, 128)
        self.ConvBN3D_5 = ConvBN3D(128, 128)
        self.ConvBN3D_6 = ConvBN3D(128, 64)
        self.classify = Conv3d(64, 1, 3, padding=1, bias=False)
        self.classify.msra = True

    def forward(self, cost: torch.Tensor, depth_bin: torch.Tensor):
        """cost: (N, D, R, R, 3C) NDHWC; depth_bin: (N, D).
        Returns (depth (N,), logits (N, D)) in float32."""
        C = self.C
        l32 = cost[..., :C].float()
        r32 = cost[..., C:2 * C].float()
        l_norm = torch.sqrt((l32 * l32).sum(dim=(2, 3, 4)))
        r_norm = torch.sqrt((r32 * r32).sum(dim=(2, 3, 4)))
        x_cross = ((l32 * r32).sum(dim=(2, 3, 4)) /
                   torch.clamp(l_norm * r_norm, min=0.01))      # (N, D)
        cost = cost * x_cross[:, :, None, None, None].to(cost.dtype)

        x = cost.permute(0, 4, 1, 2, 3)                           # NCDHW
        x = self.ConvBN3D_1(self.ConvBN3D_0(x))
        # structure-aware attention: collapse the height, gate with a
        # sigmoid 2D conv over (depth, width)
        isp = self.strAM_bn(self.strAM_conv(x.mean(dim=3)))       # (N,C,D,W)
        x = x * torch.sigmoid(isp)[:, :, :, None].to(x.dtype)

        x = self.ConvBN3D_3(self.ConvBN3D_2(x))
        x = F.max_pool3d(x, (1, 2, 2), (1, 2, 2))
        x = self.ConvBN3D_5(self.ConvBN3D_4(x)) + x
        x = F.max_pool3d(x, (1, 2, 2), (1, 2, 2))
        x = self.classify(self.ConvBN3D_6(x))                     # (N,1,D,h,w)
        logits = x[:, 0].float().mean(dim=(2, 3))                 # (N, D)
        pred = torch.softmax(logits, dim=1)
        return (pred * depth_bin).sum(dim=1), logits
