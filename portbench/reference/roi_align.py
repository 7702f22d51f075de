# Frozen copy of side_tpu_torch/ops/roi_align.py at commit ca59ff401c87, kept with the benchmark
# so that later changes to the program do not move the yardstick.
"""RoIAlign (port of side_tpu/ops/roi_align.py).

torchvision's legacy RoIAlign with aligned=False (the reference's
cost-volume pooling: RoIAlign((16, 16), spatial_scale=1,
sampling_ratio=2)): a fixed S x S sampling grid per bin, zero outside the
feature map (a sample < -1 or > size gives 0, otherwise it is clamped
into the map and interpolated bilinearly), averaged over the samples.
Feature maps are NHWC; rois come as (N, 4) x1, y1, x2, y2 boxes and an
(N,) batch index.  `roi_align` gathers the four corners of every sample;
`roi_align_mm` is the same function as two contractions with the
interpolation matrices of `pool_interp_matrix`.
"""

from __future__ import annotations

import torch


def pool_interp_matrix(lo: torch.Tensor, hi: torch.Tensor, size: int,
                       out_size: int, sampling_ratio: int) -> torch.Tensor:
    """Averaged bilinear-interpolation matrix for one axis of RoIAlign.

    W[p, j] = mean over the S samples of bin p of their bilinear weight onto
    integer coordinate j (torchvision legacy semantics: a sample < -1 or
    > size contributes 0, otherwise it is clamped into the map).
    lo, hi: (...,) box extents in feature pixels.  Returns (..., P, size)
    float32."""
    P, S = out_size, sampling_ratio
    extent = torch.clamp(hi - lo, min=1.0)
    grid = (torch.arange(P * S, dtype=torch.float32, device=lo.device)
            + 0.5) / S
    s = lo[..., None] + (extent / P)[..., None] * grid         # (..., P*S)
    valid = (s >= -1.0) & (s <= float(size))
    sc = s.clamp(0.0, size - 1.0)
    j = torch.arange(size, dtype=torch.float32, device=lo.device)
    tri = torch.clamp(1.0 - (sc[..., None] - j).abs(), min=0.0)
    tri = tri * valid[..., None]
    return tri.reshape(tri.shape[:-2] + (P, S, size)).mean(-2)


def roi_align_mm(feat: torch.Tensor, boxes: torch.Tensor,
                 batch_idx: torch.Tensor, out_size: int,
                 spatial_scale: float = 1.0, sampling_ratio: int = 2
                 ) -> torch.Tensor:
    """`roi_align` as two contractions: out[n] = Wy[n] @ feat[batch_idx[n]]
    @ Wx[n]^T, the S x S sample average folded into the interpolation
    matrices; the per-roi image is picked by a mask per image."""
    B, H, W, C = feat.shape
    P = out_size
    b = boxes.float() * spatial_scale
    Wy = pool_interp_matrix(b[:, 1], b[:, 3], H, P, sampling_ratio)
    Wx = pool_interp_matrix(b[:, 0], b[:, 2], W, P, sampling_ratio)
    feat32 = feat.float()
    out = feat32.new_zeros((boxes.shape[0], P, W, C))
    for bi in range(B):
        sel = (batch_idx == bi).float()[:, None, None]
        out = out + torch.einsum("nph,hwc->npwc", Wy * sel, feat32[bi])
    out = torch.einsum("nqw,npwc->npqc", Wx, out)
    return out.to(feat.dtype)


def roi_align(feat: torch.Tensor, boxes: torch.Tensor,
              batch_idx: torch.Tensor, out_size: int,
              spatial_scale: float = 1.0, sampling_ratio: int = 2
              ) -> torch.Tensor:
    """feat (B, H, W, C), boxes (N, 4), batch_idx (N,) ->
    (N, out_size, out_size, C) in feat's dtype (gathered and averaged in
    f32 for bf16 / f16 maps)."""
    B, H, W, C = feat.shape
    N = boxes.shape[0]
    P, S = out_size, sampling_ratio
    b = boxes.float() * spatial_scale
    x1, y1, x2, y2 = b.unbind(-1)
    bin_w = torch.clamp(x2 - x1, min=1.0) / P
    bin_h = torch.clamp(y2 - y1, min=1.0) / P
    grid = (torch.arange(P * S, dtype=torch.float32, device=feat.device)
            + 0.5) / S
    sy = y1[:, None] + bin_h[:, None] * grid                  # (N, P*S)
    sx = x1[:, None] + bin_w[:, None] * grid
    vy = (sy >= -1.0) & (sy <= float(H))
    vx = (sx >= -1.0) & (sx <= float(W))
    syc = sy.clamp(0.0, H - 1.0)
    sxc = sx.clamp(0.0, W - 1.0)
    y0f, x0f = torch.floor(syc), torch.floor(sxc)
    fy, fx = syc - y0f, sxc - x0f
    y0, x0 = y0f.long(), x0f.long()
    y1i = torch.clamp(y0 + 1, max=H - 1)
    x1i = torch.clamp(x0 + 1, max=W - 1)

    gdt = (torch.float32 if feat.dtype in (torch.bfloat16, torch.float16)
           else feat.dtype)
    flat = feat.to(gdt).reshape(B * H * W, C)
    base = batch_idx.long() * (H * W)

    def gather(yi, xi):
        idx = base[:, None, None] + yi[:, :, None] * W + xi[:, None, :]
        return flat.index_select(0, idx.reshape(-1)).reshape(N, -1, C)

    def weight(wy, wx):
        return (wy[:, :, None] * wx[:, None, :]).reshape(N, -1, 1).to(gdt)

    val = (gather(y0, x0) * weight(1 - fy, 1 - fx) +
           gather(y0, x1i) * weight(1 - fy, fx) +
           gather(y1i, x0) * weight(fy, 1 - fx) +
           gather(y1i, x1i) * weight(fy, fx))
    valid = (vy[:, :, None] & vx[:, None, :]).reshape(N, -1, 1)
    val = val * valid.to(val.dtype)
    return val.reshape(N, P, S, P, S, C).mean(dim=(2, 4)).to(feat.dtype)
