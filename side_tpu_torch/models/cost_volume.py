"""Object-conditioned stereo cost volume and instance-depth estimator
(port of side_tpu/models/cost_volume.py for inference).

Volumes are NDHWC at the public functions, as in the JAX package:
`build_cost_volume` returns (N, D, R, R, 3C); `CostVolumeNet` takes it and
runs its 3D convs on NCDHW internally.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.roi_align import pool_interp_matrix
from .dla import Conv2d, Conv3d, FoldedBatchNorm

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
