# Frozen copy of the plain path of side_tpu_torch/ops/deform_conv.py at
# commit ca59ff401c87 (`_sample_columns`, `deform_conv_plain`,
# `deform_block_om`), kept with the benchmark.  Edits: the windowed
# semantics at the radius the configurations state (R = 1) always, no
# kernel route, products read through precision.q.
"""Modulated deformable 3x3 convolution (DCNv2), plain PyTorch."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .precision import q

RADIUS = 1     # offsets clamped to [-1, 1]: the windowed DCN


def _sample_columns(x: torch.Tensor, offset: torch.Tensor,
                    mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Deformable im2col: (B, H*W, 9*C) in x.dtype, tap-major.

    Each value is the zero-padded bilinear sample at pixel + tap + offset
    (offset clamped to [-radius, radius] when radius >= 0), times the mask,
    computed in f32 and rounded once to x.dtype — the same arithmetic as the
    Hopper kernel."""
    B, H, W, C = x.shape
    dev = x.device
    k = torch.arange(9, device=dev)
    ky = torch.arange(H, device=dev)[:, None, None] + (k // 3 - 1)  # (H,1,9)
    kx = torch.arange(W, device=dev)[None, :, None] + (k % 3 - 1)   # (1,W,9)
    dy = offset[..., 0].float()
    dx = offset[..., 1].float()
    if radius >= 0:
        dy = dy.clamp(-radius, radius)
        dx = dx.clamp(-radius, radius)
        by, bx = torch.floor(dy), torch.floor(dx)
        fy, fx = dy - by, dx - bx
        y0 = ky + by.long()
        x0 = kx + bx.long()
    else:
        sy = (ky.float() + dy).clamp(-2.0, H + 1.0)
        sx = (kx.float() + dx).clamp(-2.0, W + 1.0)
        by, bx = torch.floor(sy), torch.floor(sx)
        fy, fx = sy - by, sx - bx
        y0, x0 = by.long(), bx.long()

    xf = x.float().reshape(B, H * W, C)
    val = None
    for cy, cx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                        (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yy, xx = y0 + cy, x0 + cx
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(B, -1)
        v = torch.gather(xf, 1, idx[..., None].expand(-1, -1, C))
        term = v * (wgt * inside).reshape(B, -1, 1)
        val = term if val is None else val + term
    cols = (val * mask.float().reshape(B, -1, 1)).to(x.dtype)
    return cols.reshape(B, H * W, 9 * C)


def deform_conv_plain(x: torch.Tensor, offset: torch.Tensor,
                      mask: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor], radius: int
                      ) -> torch.Tensor:
    """The plain version of the Hopper kernel: columns in x.dtype, f32
    contraction with the f32 weight, bias, result in x.dtype."""
    B, H, W, C = x.shape
    Cout = weight.shape[-1]
    cols = _sample_columns(x, offset, mask, radius)
    out = q(cols.float()) @ q(weight.float().reshape(9 * C, Cout))
    if bias is not None:
        out = out + bias.float()
    return q(out.reshape(B, H, W, Cout).to(x.dtype))


def deform_block_om(x: torch.Tensor, w_om_oihw: torch.Tensor,
                    b_om: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    """`deform_conv2d_om` with the offset/mask conv weight in OIHW, as the
    model stores it.  The conv is an ordinary convolution on both routes
    (the JAX package leaves it to XLA, dcn_pallas.py:711); its output is
    rounded to x's dtype before the DCN reads it."""
    B, H, W, _ = x.shape
    om = q(F.conv2d(q(x.permute(0, 3, 1, 2)), q(w_om_oihw.to(x.dtype)),
                    padding=1))
    om = (om + b_om.to(om.dtype)[:, None, None]).permute(0, 2, 3, 1)
    om = om.reshape(B, H, W, 9, 3)
    offset = om[..., 0:2].float()
    mask = torch.sigmoid(om[..., 2].float())
    return deform_conv_plain(x, offset, mask, weight, bias, RADIUS)
