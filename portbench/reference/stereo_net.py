# Frozen copy of side_tpu_torch/models/stereo_net.py at commit ca59ff401c87, kept with the benchmark
# so that later changes to the program do not move the yardstick.
"""SIDE's flagship stereo network (port of side_tpu/models/stereo_net.py).

Both views go through ONE DLA-34 pass at batch 2B; the `kept_type` head
reads left features through a deep 256-channel stack, every other head the
channel-concatenated stereo features.  At inference the RoIs of the top
`cv_topk` decoded slots feed the cost volume and the rest fall back to
disparity depth; in training (`target=` GT boxes) the cost volume runs on
every GT slot.  With `use_cost_volume=False` (`--not_cost_volume`) the
network stops after the heads.  With `remat` (`--remat`) the feature
extractor is a checkpointed segment in training: its activations are
recomputed in the backward instead of kept (side_tpu's `nn.remat`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import decode as dec
from .cost_volume import CostVolumeNet, build_cost_volume, proposal_shift
from .dla import (Conv2d, FeatureExtractor, FoldedBatchNorm,
                  frozen_statistics, init_weights)

HM_BIAS = -2.19


class Head(nn.Module):
    """conv3x3-256 (x5 when deep) + ReLU, then a 1x1 conv with bias;
    submodules Conv_0 .. Conv_n as flax names them."""

    def __init__(self, cin: int, out: int, deep: bool = False):
        super().__init__()
        self.n_mid = 5 if deep else 1
        for i in range(self.n_mid):
            setattr(self, f"Conv_{i}", Conv2d(cin if i == 0 else 256, 256, 3,
                                              padding=1, bias=False))
        setattr(self, f"Conv_{self.n_mid}", Conv2d(256, out, 1, bias=True))

    def forward(self, x):
        for i in range(self.n_mid):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        return getattr(self, f"Conv_{self.n_mid}")(x).float()


def set_hm_bias(conv: nn.Module) -> None:
    """The heatmap head's last conv starts at bias -2.19 (sigmoid 0.1)."""
    nn.init.constant_(conv.bias, HM_BIAS)


def nchw_input(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An NHWC image batch as an NCHW tensor in channels-last memory."""
    return t.to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def stereo_features(module: nn.Module, left: torch.Tensor,
                    right: torch.Tensor, remat: bool = False):
    """Both views through `module` as ONE batch of 2B images: (f_left,
    f_right, feats).  With `remat`, in training and under autograd, the pass
    is a checkpointed segment; its recompute in the backward runs with
    frozen BatchNorm statistics, so that they blend once per step."""
    both = torch.cat([left, right], dim=0)
    if remat and module.training and torch.is_grad_enabled():
        calls = []

        def run(x):
            with frozen_statistics(bool(calls)):
                calls.append(None)
                return module(x)
        feats = checkpoint(run, both, use_reentrant=False)
    else:
        feats = module(both)
    B = left.shape[0]
    return feats[:B], feats[B:], feats


class StereoNet(nn.Module):
    """heads: name -> channels; topk: decoded RoI slots per image."""

    LEFT_ONLY = ("kept_type",)

    def __init__(self, heads: Dict[str, int], roi_size: int = 16,
                 topk: int = 100, down_ratio: int = 4, input_w: int = 1280,
                 wh_scale: float = 1.0, dtype: torch.dtype = torch.float32,
                 cv_topk: int = 32, remat: bool = False, seed: int = 0):
        super().__init__()
        self.heads = dict(heads)
        self.roi_size, self.topk, self.cv_topk = roi_size, topk, cv_topk
        self.down_ratio, self.input_w, self.wh_scale = (down_ratio, input_w,
                                                        wh_scale)
        self.dtype, self.remat = dtype, remat
        self.feature_extraction = FeatureExtractor(down_ratio=down_ratio)
        for name, ch in self.heads.items():
            deep = name in self.LEFT_ONLY
            setattr(self, name, Head(64 if deep else 128, ch, deep=deep))
        self.feaReduce = Conv2d(64, 32, 1, bias=False)
        self.feaReduce_bn = FoldedBatchNorm(32)
        self.depth_estimator = CostVolumeNet(32)
        init_weights(self, torch.Generator().manual_seed(seed))
        if "hm" in self.heads:
            set_hm_bias(getattr(self.hm, f"Conv_{self.hm.n_mid}"))

    def forward(self, batch: Dict[str, torch.Tensor],
                target: Optional[Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]] = None,
                use_cost_volume: bool = True) -> Dict[str, torch.Tensor]:
        """batch: input / input_right (B, H, W, 3) normalised NHWC, fb (B,).
        target: GT (bbox, bbox_right, valid) of (B, K, 4), (B, K, 4), (B, K)
        at feature resolution, as ops/decode.boxes_from_targets gives them;
        None decodes the heads instead.  Returns NHWC float32 head maps plus
        depth (B, K, 1), depth_logits (B, kcv, D) and depth_bin (B, kcv, D),
        where kcv = K with a target and cv_topk without; without the cost
        volume only the head maps."""
        left = nchw_input(batch["input"], self.dtype)
        right = nchw_input(batch["input_right"], self.dtype)
        B = left.shape[0]
        f_left, f_right, feats = stereo_features(
            self.feature_extraction, left, right, self.remat)
        f_stereo = torch.cat([f_left, f_right], dim=1)

        out: Dict[str, torch.Tensor] = {}
        for name in self.heads:
            src = f_left if name in self.LEFT_ONLY else f_stereo
            out[name] = getattr(self, name)(src).permute(0, 2, 3, 1)
        if not use_cost_volume:
            return out

        red = F.relu(self.feaReduce_bn(self.feaReduce(feats)))
        red = red.permute(0, 2, 3, 1)                      # NHWC
        if target is not None:
            bbox, bbox_right, valid = target
            kcv = bbox.shape[1]                  # train: every GT slot
        else:
            bbox, bbox_right, valid = dec.bbox_decode(
                out["hm"], out["wh"] * self.wh_scale, out["reg"], K=self.topk)
            kcv = (min(self.cv_topk, self.topk) if self.cv_topk > 0
                   else self.topk)
        K = bbox.shape[1]
        fb = batch["fb"].reshape(B).float()
        rois_l, rois_r, depth_bin = proposal_shift(
            bbox[:, :kcv], bbox_right[:, :kcv], fb, self.roi_size,
            self.input_w // self.down_ratio)
        cost = build_cost_volume(red[:B], red[B:], rois_l, rois_r,
                                 self.roi_size)
        disp, logits = self.depth_estimator(
            cost, depth_bin.reshape(B * kcv, self.roi_size))
        depth = disp.reshape(B, kcv, 1)
        if kcv < K:
            # disparity fallback for the low-score tail
            cl = (bbox[..., 0] + bbox[..., 2]) / 2
            cr = (bbox_right[..., 0] + bbox_right[..., 2]) / 2
            disp_full = (cl - cr) * self.down_ratio
            d_disp = fb[:, None] / torch.where(
                disp_full.abs() < 1e-3, torch.full_like(disp_full, 1e-3),
                disp_full)
            depth = torch.cat([depth, d_disp[:, kcv:, None]], dim=1)
        # invalid slots report depth 0
        out["depth"] = depth * valid[..., None].to(depth.dtype)
        out["depth_logits"] = logits.reshape(B, kcv, self.roi_size)
        out["depth_bin"] = depth_bin
        return out
