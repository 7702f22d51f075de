"""Modulated deformable 3x3 convolution (DCNv2), PyTorch.

Port of side_tpu/ops/deform_conv.py for the one configuration every DCN of
the model uses: 3x3 kernel, stride 1, padding 1, dilation 1, one
deformable group.  Public layouts are the JAX package's:

    x:      (B, H, W, Cin)       NHWC
    offset: (B, H, W, 9, 2)      (dy, dx) per tap
    mask:   (B, H, W, 9)         modulation in [0, 1]
    weight: (3, 3, Cin, Cout)    HWIO

Two semantics, as in the JAX package:
    windowed (default, R = 1): offsets clamped to [-R, R] — the function the
        TPU kernels compute and that checkpoints trained on the TPU expect;
    exact: unbounded offsets — the reference DCNv2 function.
`deform_conv2d` runs the Hopper kernel (ops/dcn_cuda.py) on CUDA tensors and
the plain version below on CPU tensors.  The mode comes from the environment
(SIDE_TPU_TORCH_DCN = windowed | exact, SIDE_TPU_TORCH_DCN_RADIUS = R) or
`set_dcn_mode` / `dcn_mode`.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
import torch.nn.functional as F

_DCN_MODES = ("windowed", "exact")
_mode = os.environ.get("SIDE_TPU_TORCH_DCN", "windowed")
_radius = int(os.environ.get("SIDE_TPU_TORCH_DCN_RADIUS", "1"))
if _mode not in _DCN_MODES:
    raise ValueError(f"SIDE_TPU_TORCH_DCN={_mode!r}; one of {_DCN_MODES}")


def set_dcn_mode(mode: str, radius: Optional[int] = None):
    """Set the DCN semantics; returns the previous (mode, radius)."""
    global _mode, _radius
    if mode not in _DCN_MODES:
        raise ValueError(f"unknown DCN mode {mode!r}; one of {_DCN_MODES}")
    prev = (_mode, _radius)
    _mode = mode
    if radius is not None:
        _radius = int(radius)
    return prev


def get_dcn_mode() -> str:
    return _mode


@contextlib.contextmanager
def dcn_mode(mode: str, radius: Optional[int] = None):
    """Scoped DCN mode override; restores the prior mode on exit."""
    prev = set_dcn_mode(mode, radius)
    try:
        yield
    finally:
        set_dcn_mode(*prev)


def dcn_radius_tag() -> int:
    """The offset bound in force: R when windowed, -1 when exact (the
    checkpoint's `meta::dcn_radius` convention)."""
    return -1 if _mode == "exact" else _radius


def set_dcn_radius_tag(tag: int) -> None:
    """Inverse of `dcn_radius_tag`: -1 selects exact, R >= 0 windowed R."""
    if tag < 0:
        set_dcn_mode("exact")
    else:
        set_dcn_mode("windowed", tag)


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
    out = cols.float() @ weight.float().reshape(9 * C, Cout)
    if bias is not None:
        out = out + bias.float()
    return out.reshape(B, H, W, Cout).to(x.dtype)


def deform_conv2d_windowed(x, offset, mask, weight, bias=None, radius=1):
    """Offsets clamped to [-radius, radius] (side_tpu deform_conv2d_windowed)."""
    return deform_conv_plain(x, offset, mask, weight, bias, radius)


def deform_conv2d_exact(x, offset, mask, weight, bias=None):
    """Unbounded offsets (side_tpu _deform_conv2d_gather)."""
    return deform_conv_plain(x, offset, mask, weight, bias, -1)


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """DCN forward in the current mode: the Hopper kernel for CUDA tensors,
    the plain version for CPU tensors.  Inference only."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, offset, mask, weight, bias)):
        raise RuntimeError(
            "deform_conv2d is inference-only in this port: its backward "
            "kernels come with the training slice.  Call it under "
            "torch.no_grad() / torch.inference_mode().")
    radius = dcn_radius_tag()
    if x.device.type == "cuda":
        from .dcn_cuda import DCN_FWD
        if bias is None:
            bias = torch.zeros(weight.shape[-1], device=x.device)
        return DCN_FWD(x.contiguous(), offset.float().contiguous(),
                       mask.float().contiguous(), weight.float().contiguous(),
                       bias.float().contiguous(), radius)
    return deform_conv_plain(x, offset, mask, weight, bias, radius)


def deform_conv2d_om(x: torch.Tensor, w_om: torch.Tensor, b_om: torch.Tensor,
                     weight: torch.Tensor, bias: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Offset/mask conv + modulated deformable conv (side_tpu
    deform_conv2d_om).  x NHWC; w_om (3, 3, Cin, 27) HWIO and b_om (27,)
    with the per-tap interleaved [dy, dx, mask-logit] channel order."""
    return deform_block_om(x, w_om.permute(3, 2, 0, 1), b_om, weight, bias)


def deform_block_om(x: torch.Tensor, w_om_oihw: torch.Tensor,
                    b_om: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    """`deform_conv2d_om` with the offset/mask conv weight in OIHW, as the
    model stores it."""
    B, H, W, _ = x.shape
    om = F.conv2d(x.permute(0, 3, 1, 2), w_om_oihw.to(x.dtype), padding=1)
    om = (om + b_om.to(om.dtype)[:, None, None]).permute(0, 2, 3, 1)
    om = om.reshape(B, H, W, 9, 3)
    offset = om[..., 0:2].float()
    mask = torch.sigmoid(om[..., 2].float())
    return deform_conv2d(x, offset, mask, weight, bias)
