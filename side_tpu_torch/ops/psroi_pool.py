"""Deformable position-sensitive RoI pooling (port of
side_tpu/ops/psroi_pool.py), in plain PyTorch gathers.

The reference's DCNv2 pooling op (DCNPooling); the stereo models do not
call it.  Each output bin (i, j) of output channel c averages
`sample_per_part`^2 bilinear samples of the position-sensitive input
channel (c * group_size + gy) * group_size + gx, where (gy, gx) is the
group cell of the bin; an optional per-bin (dy, dx) offset, scaled by
`trans_std` and the RoI's size, moves the bin.  Feature maps are NHWC.
"""

from __future__ import annotations

from typing import Optional

import torch


def psroi_pool(feat: torch.Tensor, rois: torch.Tensor,
               batch_idx: torch.Tensor, out_size: int, output_dim: int,
               group_size: int = 1, spatial_scale: float = 1.0,
               sample_per_part: int = 4,
               trans: Optional[torch.Tensor] = None,
               trans_std: float = 0.0, no_trans: bool = False
               ) -> torch.Tensor:
    """feat (B, H, W, C) with C == output_dim * group_size**2; rois (N, 4)
    x1, y1, x2, y2; batch_idx (N,); trans (N, out_size, out_size, 2) bin
    offsets (dy, dx).  Returns (N, out_size, out_size, output_dim)."""
    B, H, W, C = feat.shape
    N = rois.shape[0]
    P, S, G = out_size, sample_per_part, group_size
    if C != output_dim * G * G:
        raise ValueError(f"{C} channels != output_dim {output_dim} * "
                         f"group_size {G}^2")
    dev = feat.device
    r = rois.float()
    # the RoI rounded to the pixel grid, then padded by half a pixel
    x1 = torch.round(r[:, 0]) * spatial_scale - 0.5
    y1 = torch.round(r[:, 1]) * spatial_scale - 0.5
    x2 = (torch.round(r[:, 2]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(r[:, 3]) + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp(x2 - x1, min=0.1)
    roi_h = torch.clamp(y2 - y1, min=0.1)
    bin_w, bin_h = roi_w / P, roi_h / P

    if trans is None or no_trans:
        trans = feat.new_zeros((N, P, P, 2))
    dy = trans[..., 0].float() * trans_std * roi_h[:, None, None]
    dx = trans[..., 1].float() * trans_std * roi_w[:, None, None]

    sub = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) / S
    cell = torch.arange(P, dtype=torch.float32, device=dev)[None, :, None]
    gy = y1[:, None, None] + bin_h[:, None, None] * (cell + sub)  # (N, P, S)
    gx = x1[:, None, None] + bin_w[:, None, None] * (cell + sub)
    sy = gy[:, :, None, :] + dy[..., None]                     # (N, Py, Px, S)
    sx = gx[:, None, :, :] + dx[..., None]

    inb = ((sy[..., :, None] >= -0.5) & (sy[..., :, None] <= H - 0.5) &
           (sx[..., None, :] >= -0.5) & (sx[..., None, :] <= W - 0.5))
    syc = sy.clamp(0.0, H - 1.0)
    sxc = sx.clamp(0.0, W - 1.0)
    y0f, x0f = torch.floor(syc), torch.floor(sxc)
    fy, fx = syc - y0f, sxc - x0f
    y0, x0 = y0f.long(), x0f.long()
    y1i = torch.clamp(y0 + 1, max=H - 1)
    x1i = torch.clamp(x0 + 1, max=W - 1)

    flat = feat.reshape(B * H * W, C)
    base = batch_idx.long() * (H * W)

    def corner(yi, xi, wgt):
        idx = (base[:, None, None, None, None] + yi[..., :, None] * W +
               xi[..., None, :])                           # (N,P,P,S,S)
        vals = flat.index_select(0, idx.reshape(-1)).reshape(
            N, P, P, S, S, C)
        return vals * wgt[..., None].to(vals.dtype)

    def w(a, b):
        return a[..., :, None] * b[..., None, :]

    val = (corner(y0, x0, w(1 - fy, 1 - fx)) + corner(y0, x1i, w(1 - fy, fx))
           + corner(y1i, x0, w(fy, 1 - fx)) + corner(y1i, x1i, w(fy, fx)))
    val = val * inb[..., None].to(val.dtype)
    pooled = val.mean(dim=(3, 4))                          # (N, P, P, C)

    # the position-sensitive channel of each (bin, output channel)
    g = torch.clamp((torch.arange(P, device=dev) * G) // P, 0, G - 1)
    cch = ((torch.arange(output_dim, device=dev)[:, None, None] * G +
            g[None, :, None]) * G + g[None, None, :])      # (D, Py, Px)
    cch = cch.permute(1, 2, 0)[None].expand(N, P, P, output_dim)
    return torch.gather(pooled, -1, cch)
