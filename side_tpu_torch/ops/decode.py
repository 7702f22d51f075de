"""Shape-static CenterNet stereo decode on the device (port of
side_tpu/ops/decode.py).  Feature maps are NHWC: (B, H, W, C).

Ties: `lax.top_k` orders equal scores by lower index, and `torch.topk`
promises no order on CUDA, so `topk` sorts stably instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nms_peaks(heat: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep only the local maxima of a (B, H, W, C) heatmap; max_pool2d
    pads with -inf, as the JAX reduce_window does."""
    pad = (kernel - 1) // 2
    hmax = F.max_pool2d(heat.permute(0, 3, 1, 2), kernel, 1, pad)
    hmax = hmax.permute(0, 2, 3, 1)
    return torch.where(hmax == heat, heat, torch.zeros_like(heat))


def _top_k_stable(x: torch.Tensor, k: int):
    """Top k along the last axis, equal values ordered by lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk(scores: torch.Tensor, K: int):
    """Two-stage top-K over a peak map.  scores: (B, H, W, C) ->
    (score, inds, clses, ys, xs), each (B, K); `inds` indexes the flattened
    H*W plane."""
    B, H, W, C = scores.shape
    flat = scores.reshape(B, H * W, C).transpose(1, 2)        # (B, C, HW)
    topk_scores, topk_inds = _top_k_stable(flat, K)           # (B, C, K)
    topk_ys = (topk_inds // W).float()
    topk_xs = (topk_inds % W).float()

    topk_score, topk_ind = _top_k_stable(topk_scores.reshape(B, C * K), K)
    topk_clses = (topk_ind // K).int()

    def pick(x):
        return torch.gather(x.reshape(B, C * K), 1, topk_ind)

    return (topk_score, pick(topk_inds).int(), topk_clses, pick(topk_ys),
            pick(topk_xs))


def gather_feat(fmap: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) features at flattened cell indices (B, K) -> (B, K, C)."""
    B, H, W, C = fmap.shape
    flat = fmap.reshape(B, H * W, C)
    return torch.gather(flat, 1, ind.long()[..., None].expand(-1, -1, C))


def ddd_decode(heat, kept, dim, orien, wh, reg, grid_size: int, K: int = 40):
    """Full stereo 3D decode; `heat` already sigmoided.  Returns
    detections (B, K, 6): x, y, w_left, h, score, cls;
    detections_right (B, K, 6): x_right, y, w_right, h, score, cls;
    info_3d (B, K, 9): dim(3), orien(2), border_left, border_right,
    kept_offset, kept_type."""
    peaks = nms_peaks(heat)
    scores, inds, clses, ys, xs = topk(peaks, K=K)

    reg = gather_feat(reg, inds)
    xs_right = xs[..., None] + reg[:, :, 1:2]
    xs = xs[..., None] + reg[:, :, 0:1]
    ys = ys[..., None] + reg[:, :, 2:3]

    dim = gather_feat(dim, inds)
    orien = gather_feat(orien, inds)
    wh = gather_feat(wh, inds)
    clses = clses[..., None].float()
    scores = scores[..., None]

    kept = gather_feat(kept, inds)
    g = grid_size
    kept_off = torch.argmax(kept[:, :, :4 * g], dim=2)
    kept_type = (kept_off // g).float()[..., None]
    kept_offset = (kept_off % g).float()[..., None]
    border_left = torch.argmax(kept[:, :, 4 * g:5 * g], dim=2).float()[..., None]
    border_right = torch.argmax(kept[:, :, 5 * g:], dim=2).float()[..., None]

    detections = torch.cat(
        [xs, ys, wh[:, :, 0:1], wh[:, :, 2:3], scores, clses], dim=2)
    detections_right = torch.cat(
        [xs_right, ys, wh[:, :, 1:2], wh[:, :, 2:3], scores, clses], dim=2)
    info_3d = torch.cat(
        [dim, orien, border_left, border_right, kept_offset, kept_type], dim=2)
    return detections, detections_right, info_3d


def bbox_decode(heat, wh, reg, K: int = 100):
    """Top-K left/right RoI boxes for the cost volume.  Returns bbox,
    bbox_right (B, K, 4) as x1, y1, x2, y2 at feature resolution, and valid
    (B, K) bool (coordinate sum > 0)."""
    peaks = nms_peaks(torch.sigmoid(heat))
    scores, inds, clses, ys, xs = topk(peaks, K=K)

    reg = gather_feat(reg, inds)
    xs_right = xs[..., None] + reg[:, :, 1:2]
    xs = xs[..., None] + reg[:, :, 0:1]
    ys = ys[..., None] + reg[:, :, 2:3]
    wh = gather_feat(wh, inds)

    center = torch.cat([xs, ys], dim=2)
    center_right = torch.cat([xs_right, ys], dim=2)
    half = 0.5 * wh[:, :, [0, 2]]
    half_right = 0.5 * wh[:, :, [1, 2]]
    bbox = torch.cat([center - half, center + half], dim=2)
    bbox_right = torch.cat([center_right - half_right,
                            center_right + half_right], dim=2)
    valid = bbox.sum(dim=2) > 0
    return bbox, bbox_right, valid
