# Frozen copy of side_tpu_torch/models/voxel_net.py at commit ca59ff401c87, kept with the benchmark
# so that later changes to the program do not move the yardstick.
# Edit: the four-corner gather is always the plain one (gather.py here).
"""Voxel + PointNet instance-depth variant (port of
side_tpu/models/voxel_net.py, `--depth_variant voxel`).

Each object gets a metric 10x10x10 voxel grid (0.5 m x/y-stride, 1 m
z-stride) centred on its coarse disparity-derived 3D centre; the voxels are
projected through P2/P3 into both 64-channel reduced feature maps and
sampled bilinearly (`grid_sample_feats`: the gather kernel K5 on the card,
csrc/gather_bilinear.cu), and a PointNet with a structure-aware attention
gate regresses a residual added to the disparity depth.  The whole path is
one (B, K, V, ...) tensor program with validity masks.

BatchNorms here are flax `nn.BatchNorm` (dla.BatchNorm: f32 apply, f32
result), Dense layers flax `nn.Dense` (dla.Dense, weight (out, in)).  The
sampled features are f32, as in the JAX package, where the bf16 rows are
promoted at the first weight: `pl - pr` is formed in f32 before
PointNetDepth casts to the compute dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import decode as dec
from .gather import gather_bilinear_plain
from .nomesh import active_mesh
from .dla import (BatchNorm, Conv2d, Dense, FeatureExtractor, init_weights)
from .stereo_net import Head, nchw_input, set_hm_bias, stereo_features

# 10 bins per axis: zs = arange(-5, 5, 1) + 0.5, xs/ys = arange(-2.5, 2.5,
# 0.5) + 0.25 (the reference's get_voxel)
VOXEL_RES = 10
DROPOUT_RATE = 0.3


def _apply_affine(pts: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B, ..., 2) points through per-image (B, 2, 3) affines."""
    B = pts.shape[0]
    flat = pts.reshape(B, -1, 2)
    out = flat @ t[:, :, :2].transpose(1, 2) + t[:, None, :, 2]
    return out.reshape(pts.shape)


def unwarp_centers(bbox: torch.Tensor, trans_inv: torch.Tensor
                   ) -> torch.Tensor:
    """Feature-res corner boxes (B, K, 4) -> original-pixel boxes."""
    return torch.cat([_apply_affine(bbox[..., 0:2], trans_inv),
                      _apply_affine(bbox[..., 2:4], trans_inv)], dim=-1)


def disparity_depth(bbox: torch.Tensor, bbox_right: torch.Tensor,
                    fb: torch.Tensor, trans_inv: torch.Tensor
                    ) -> torch.Tensor:
    """Coarse depth (B, K) from the un-warped centre disparity."""
    bl = unwarp_centers(bbox, trans_inv)
    br = unwarp_centers(bbox_right, trans_inv)
    disp = (bl[..., 0] + bl[..., 2]) / 2 - (br[..., 0] + br[..., 2]) / 2
    return fb[:, None] / torch.where(disp.abs() < 1e-3,
                                     torch.full_like(disp, 1e-3), disp)


def voxel_offsets(device=None) -> torch.Tensor:
    """(V, 3) metric offsets of the voxel centres, x-major then y then z
    (the JAX package's meshgrid(..., indexing="ij"))."""
    r = VOXEL_RES
    idx = torch.arange(r, dtype=torch.float32, device=device) - r / 2
    off_xy = idx * 0.5 + 0.25
    off_z = idx * 1.0 + 0.5
    ox, oy, oz = torch.meshgrid(off_xy, off_xy, off_z, indexing="ij")
    return torch.stack([ox, oy, oz], dim=-1).reshape(-1, 3)


def voxel_coords(bbox, bbox_right, fb, p2, p3, trans, trans_inv,
                 feat_w: int, feat_h: int):
    """Per-object voxel grids projected into both feature maps.

    Returns (coords_left, coords_right, valid_left, valid_right, depth_ori):
    coords (B, K, V, 2) feature-map pixel coordinates (V = VOXEL_RES**3),
    valid (B, K, V) in-map flags, depth_ori (B, K)."""
    depth_ori = disparity_depth(bbox, bbox_right, fb, trans_inv)
    bl = unwarp_centers(bbox, trans_inv)
    cx = (bl[..., 0] + bl[..., 2]) / 2
    cy = (bl[..., 1] + bl[..., 3]) / 2
    # back-project the coarse centre through P2
    z = depth_ori - p2[:, None, 2, 3]
    x = (cx * depth_ori - p2[:, None, 0, 3] - p2[:, None, 0, 2] * z) / \
        p2[:, None, 0, 0]
    y = (cy * depth_ori - p2[:, None, 1, 3] - p2[:, None, 1, 2] * z) / \
        p2[:, None, 1, 1]
    centers = torch.stack([x, y, z], dim=-1)                   # (B, K, 3)
    pts = centers[:, :, None, :] + voxel_offsets(bbox.device)  # (B,K,V,3)
    B, K, V, _ = pts.shape

    def proj(P, t):
        homo = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
        uvw = (homo.reshape(B, K * V, 4) @ P.transpose(1, 2)).reshape(
            B, K, V, 3)
        uv = uvw[..., :2] / torch.clamp(uvw[..., 2:3], min=1e-3)
        return _apply_affine(uv, t)

    cl, cr = proj(p2, trans), proj(p3, trans)

    def valid(c):
        return ((c[..., 0] >= 0) & (c[..., 0] <= feat_w - 1) &
                (c[..., 1] >= 0) & (c[..., 1] <= feat_h - 1))

    return cl, cr, valid(cl), valid(cr), depth_ori


def sample_corners(coords: torch.Tensor, valid: torch.Tensor, H: int,
                   W: int):
    """The gather's operands for (B, K, V, 2) pixel coordinates in an H x W
    map: invalid voxels at (0, 0), every coordinate clipped into the map,
    then (y0, x0) int32 and (fy, fx) f32, each contiguous (B, K, V)."""
    zero = torch.zeros((), dtype=coords.dtype, device=coords.device)
    u = torch.clamp(torch.where(valid, coords[..., 0], zero), 0, W - 1)
    v = torch.clamp(torch.where(valid, coords[..., 1], zero), 0, H - 1)
    x0, y0 = torch.floor(u), torch.floor(v)
    return (y0.to(torch.int32).contiguous(), x0.to(torch.int32).contiguous(),
            (v - y0).contiguous(), (u - x0).contiguous())


def grid_sample_feats(feat: torch.Tensor, coords: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Bilinear samples (B, K, V, C) in f32 of the NHWC map (B, H, W, C) at
    (B, K, V, 2) pixel coordinates, invalid voxels zeroed.  The four-corner
    gather is the kernel K5 on CUDA tensors (GatherBilinearFunction: its
    gradient with respect to feat is a scatter-add in PyTorch) and its plain
    version on CPU tensors; the clip into the map and the mask stay here."""
    B, H, W, C = feat.shape
    _, K, V, _ = coords.shape
    y0, x0, fy, fx = sample_corners(coords, valid, H, W)
    out = gather_bilinear_plain(feat, y0, x0, fy, fx, torch.float32)
    return out.reshape(B, K, V, C) * valid[..., None].to(out.dtype)


def dropout_keep_mask(shape, rate: float, generator, device
                      ) -> torch.Tensor:
    """The keep mask of PointNetDepth's dropout: each element kept with
    probability 1 - rate.  One function, so that a test can substitute the
    JAX run's mask (the two packages draw different random bits)."""
    return torch.rand(shape, generator=generator, device=device) >= rate


class PointNetDepth(nn.Module):
    """PointNet residual-depth head with the structure-aware attention gate.
    Input (N, V, 192) voxel point features; output (N,) in the compute
    dtype.  BatchNorm statistics over (N, V) (and N after the max-pool)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for name, cin, cout in (("conv1", 192, 256), ("conv2", 256, 512),
                                ("conv3", 512, 1024), ("conv4", 1024, 1024),
                                ("fc1", 1024, 512), ("fc2", 512, 256),
                                ("depth", 256, 1)):
            setattr(self, name, Dense(cin, cout))
        for name, ch in (("bn1", 256), ("bn2", 512), ("bn3", 1024),
                         ("bn4", 1024), ("fc_bn1", 512), ("fc_bn2", 256)):
            setattr(self, name, BatchNorm(ch))
        self.strAM_2D = Conv2d(1024, 1024, 3, padding=1, bias=True)
        self.strAM_2D.lecun = True

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, name)(x.to(self.dtype))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        x = F.relu(self.bn1(self._dense("conv1", x))).to(dt)
        x = F.relu(self.bn2(self._dense("conv2", x))).to(dt)
        x = self.bn3(self._dense("conv3", x)).to(dt)

        # gate: mean over the height axis of the (N, x, y, z, C) cube, 3x3
        # conv over (x, z), sigmoid, broadcast back over y
        r, N = VOXEL_RES, x.shape[0]
        cube = x.reshape(N, r, r, r, 1024)
        isp = cube.mean(dim=2).permute(0, 3, 1, 2)           # (N, C, x, z)
        isp = self.strAM_2D(isp).permute(0, 2, 3, 1)          # (N, x, z, C)
        gate = torch.sigmoid(isp)[:, :, None]
        gated = (cube * gate.to(cube.dtype)).reshape(N, r ** 3, 1024)

        x = F.relu(self.bn4(self._dense("conv4", gated))).to(dt) + x
        # max-pool over the points; amax shares the gradient among tied
        # points (masked voxels of a column are equal) as JAX's max does
        x = x.amax(dim=1)

        x = F.relu(self.fc_bn1(self._dense("fc1", x)))
        x = self._dense("fc2", x)
        if self.training:
            # under a mesh the mask is drawn at the global batch's shape
            # and each rank takes its rows: the ranks together apply the
            # one-process run's mask
            mesh = active_mesh()
            world, rank = (1, 0) if mesh is None else (mesh.world, mesh.rank)
            n = x.shape[0]
            keep = dropout_keep_mask((n * world,) + tuple(x.shape[1:]),
                                     DROPOUT_RATE, generator,
                                     x.device)[rank * n:(rank + 1) * n]
            x = torch.where(keep, x / (1.0 - DROPOUT_RATE),
                            torch.zeros((), dtype=x.dtype, device=x.device))
        x = F.relu(self.fc_bn2(x))
        return self._dense("depth", x)[..., 0]


class StereoVoxelNet(nn.Module):
    """The flagship's trunk and heads with the voxel + PointNet depth path.
    Decodes `topk` slots at inference (no cost-volume cap)."""

    LEFT_ONLY = ("kept_type",)
    takes_generator = True       # PointNetDepth's dropout in training

    def __init__(self, heads: Dict[str, int], topk: int = 100,
                 down_ratio: int = 4, input_w: int = 1280,
                 input_h: int = 384, dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        super().__init__()
        self.heads = dict(heads)
        self.topk, self.down_ratio = topk, down_ratio
        self.input_w, self.input_h, self.dtype = input_w, input_h, dtype
        self.feature_extraction = FeatureExtractor(down_ratio=down_ratio)
        for name, ch in self.heads.items():
            deep = name in self.LEFT_ONLY
            setattr(self, name, Head(64 if deep else 128, ch, deep=deep))
        self.feaReduce = Conv2d(64, 64, 3, padding=1, bias=True)
        self.feaReduce_bn = BatchNorm(64, channel_dim=1)
        self.pointNet = PointNetDepth(dtype)
        init_weights(self, torch.Generator().manual_seed(seed))
        if "hm" in self.heads:
            set_hm_bias(getattr(self.hm, f"Conv_{self.hm.n_mid}"))

    def forward(self, batch: Dict[str, torch.Tensor],
                target: Optional[Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]] = None,
                use_cost_volume: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """batch: input / input_right (B, H, W, 3), fb (B,), p2 / p3
        (B, 3, 4), trans / trans_inv (B, 2, 3).  target: GT (bbox,
        bbox_right, valid) at feature resolution, or None to decode the
        heads.  Returns NHWC float32 head maps plus depth (B, K, 1);
        `use_cost_volume=False` returns the head maps alone.  `generator`
        draws the dropout mask in training."""
        dt = self.dtype
        left = nchw_input(batch["input"], dt)
        right = nchw_input(batch["input_right"], dt)
        B = left.shape[0]
        f_left, f_right, feats = stereo_features(self.feature_extraction,
                                                 left, right)
        f_stereo = torch.cat([f_left, f_right], dim=1)
        out: Dict[str, torch.Tensor] = {}
        for name in self.heads:
            src = f_left if name in self.LEFT_ONLY else f_stereo
            out[name] = getattr(self, name)(src).permute(0, 2, 3, 1)
        if not use_cost_volume:
            return out

        red = F.relu(self.feaReduce_bn(self.feaReduce(feats))).to(dt)
        red = red.permute(0, 2, 3, 1)                          # NHWC
        if target is not None:
            bbox, bbox_right, valid = target
        else:
            bbox, bbox_right, valid = dec.bbox_decode(
                out["hm"], out["wh"], out["reg"], K=self.topk)
        cl, cr, vl, vr, depth_ori = voxel_coords(
            bbox, bbox_right, batch["fb"].reshape(B).float(),
            batch["p2"].float(), batch["p3"].float(), batch["trans"].float(),
            batch["trans_inv"].float(), self.input_w // self.down_ratio,
            self.input_h // self.down_ratio)
        pl = grid_sample_feats(red[:B], cl, vl)               # (B, K, V, 64)
        pr = grid_sample_feats(red[B:], cr, vr)
        voxel = torch.cat([pl - pr, pl, pr], dim=-1)          # 192 channels
        K, V = voxel.shape[1], voxel.shape[2]
        resid = self.pointNet(voxel.reshape(B * K, V, 192), generator)
        depth = (depth_ori + resid.float().reshape(B, K)).reshape(B, K, 1)
        out["depth"] = depth * valid[..., None].to(depth.dtype)
        return out
