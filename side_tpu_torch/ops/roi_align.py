"""RoIAlign as an interpolation matrix (port of side_tpu/ops/roi_align.py
`pool_interp_matrix`)."""

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
