# Frozen copy of `gather_bilinear_plain` of side_tpu_torch/ops/gather_cuda.py
# at commit ca59ff401c87, kept with the benchmark.
"""The four-corner bilinear gather, plain PyTorch."""

from __future__ import annotations

import torch


def gather_bilinear_plain(x: torch.Tensor, y0: torch.Tensor,
                          x0: torch.Tensor, fy: torch.Tensor,
                          fx: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """The plain version of the kernel.  x (B, H, W, C); y0, x0 integer and
    fy, fx f32 of B*P elements (any shape), sample s in image s // P.
    Returns (B*P, C) in `out_dtype` (default x.dtype)."""
    B, H, W, C = x.shape
    y0 = y0.reshape(B, -1).long()
    x0 = x0.reshape(B, -1).long()
    fy = fy.reshape(B, -1).float()
    fx = fx.reshape(B, -1).float()
    flat = x.reshape(B, H * W, C)
    acc = torch.zeros((B, y0.shape[1], C), dtype=torch.float32,
                      device=x.device)
    for dy in (0, 1):
        for dx in (0, 1):
            yi = torch.clamp(y0 + dy, max=H - 1)
            xi = torch.clamp(x0 + dx, max=W - 1)
            idx = (yi * W + xi)[..., None].expand(-1, -1, C)
            v = torch.gather(flat, 1, idx).float()
            wt = (fy if dy else 1 - fy) * (fx if dx else 1 - fx)
            acc = acc + v * wt[..., None]
    return acc.to(out_dtype or x.dtype).reshape(-1, C)
