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
`deform_conv2d` runs the Hopper kernels (ops/dcn_cuda.py) on CUDA tensors:
the forward `dcn_fwd`, and in the backward K2 `dcn_bwd_dx` and K3
`dcn_bwd_dcoord` through `DcnFunction`.  CPU tensors take the plain version
below, with ordinary autograd.  The mode comes from the environment
(SIDE_TPU_TORCH_DCN = windowed | exact, SIDE_TPU_TORCH_DCN_RADIUS = R) or
`set_dcn_mode` / `dcn_mode`.

`deform_block_om` (offset/mask conv + DCN, what a DeformBlock runs) has a
second, inference-only route, as in the JAX package
(side_tpu/ops/deform_conv.py:322-348): with the fused switch on
(SIDE_TPU_TORCH_DCN_FUSED=1, `set_dcn_fused` / `dcn_fused`; off by default),
in windowed mode and when no gradient is wanted, the raw 27-channel conv
output goes to one kernel, `dcn_fwd_om` (K4), which clamps the offsets and
takes the mask's sigmoid itself.  K4 has no backward kernel (nor has the
TPU's): whenever autograd would record the op the unfused route runs.
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


def get_dcn_radius() -> int:
    """The window's radius R, kept while the mode is exact."""
    return _radius


@contextlib.contextmanager
def dcn_mode(mode: str, radius: Optional[int] = None):
    """Scoped DCN mode override; restores the prior mode on exit."""
    prev = set_dcn_mode(mode, radius)
    try:
        yield
    finally:
        set_dcn_mode(*prev)


_fused = os.environ.get("SIDE_TPU_TORCH_DCN_FUSED", "0") == "1"


def set_dcn_fused(on: bool) -> bool:
    """Switch the fused offset/mask route of `deform_block_om`; returns the
    previous setting."""
    global _fused
    prev = _fused
    _fused = bool(on)
    return prev


def get_dcn_fused() -> bool:
    return _fused


@contextlib.contextmanager
def dcn_fused(on: bool = True):
    """Scoped fused-route switch; restores the prior setting on exit."""
    prev = set_dcn_fused(on)
    try:
        yield
    finally:
        set_dcn_fused(prev)


def apply_reference_exact() -> None:
    """The `--reference_exact` rule (side_tpu/config.py's): exact mode for
    the process, unless SIDE_TPU_TORCH_DCN pins a mode.  The training
    entry point and the Detector call it; `Config.cli` imports no DCN
    module and only sets the field."""
    if os.environ.get("SIDE_TPU_TORCH_DCN") is None:
        set_dcn_mode("exact")


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


def deform_conv_om_plain(x: torch.Tensor, om: torch.Tensor,
                         weight: torch.Tensor, bias: Optional[torch.Tensor],
                         radius: int) -> torch.Tensor:
    """The plain version of the fused kernel `dcn_fwd_om`: om (B, H, W, 27)
    is the raw offset/mask conv output, per tap [dy, dx, mask logit]; split,
    sigmoid in f32, then `deform_conv_plain` (which clamps to +-radius)."""
    B, H, W, _ = x.shape
    om = om.reshape(B, H, W, 9, 3)
    offset = om[..., 0:2].float()
    mask = torch.sigmoid(om[..., 2].float())
    return deform_conv_plain(x, offset, mask, weight, bias, radius)


def deform_conv_mma_model(x: torch.Tensor, offset: torch.Tensor,
                          mask: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor], radius: int,
                          split_weight: bool = False) -> torch.Tensor:
    """A model of the tensor-core route's arithmetic (csrc/dcn_fwd_body.cuh
    and, through autograd, K3's g·W^T in csrc/dcn_bwd.cu), for tests only:
    `deform_conv_plain` with the weight rounded to bf16 before the f32
    contraction, as the kernels round it while staging.  `split_weight`
    models the alternative the kernels do not take: W as a bf16 high part
    plus a bf16 low part, two products.  The gradient passes through the
    rounding unchanged (d_W is taken with respect to the f32 weight, as in
    the kernels)."""
    B, H, W, C = x.shape
    Cout = weight.shape[-1]
    cols = _sample_columns(x, offset, mask, radius)
    w = weight.float().reshape(9 * C, Cout)
    w_hi = w + (w.bfloat16().float() - w).detach()
    out = cols.float() @ w_hi
    if split_weight:
        rest = w - w_hi.detach()
        out = out + cols.float() @ (rest + (rest.bfloat16().float()
                                            - rest).detach())
    if bias is not None:
        out = out + bias.float()
    return out.reshape(B, H, W, Cout).to(x.dtype)


def dcn_dx_patch_model(g: torch.Tensor, offset: torch.Tensor,
                       mask: torch.Tensor, weight: torch.Tensor, radius: int,
                       patch_h: int, patch_w: int = 16) -> torch.Tensor:
    """A model of the formulation of K2's patch route (csrc/dcn_bwd.cu
    `dcn_bwd_dx_patch_kernel`), for tests only: d_x of the windowed DCN
    assembled patch by patch.  Each `patch_h` x `patch_w` patch of d_x takes
    the scatter of the output pixels of the patch grown by radius + 1 on
    every side, and only of those; whatever they send outside the patch is
    dropped (a neighbouring patch computes it again).  f32 throughout;
    returns (B, H, W, Cin) f32."""
    if radius < 0:
        raise ValueError("the patch route is the windowed function's")
    B, H, W, _ = g.shape
    C = weight.shape[2]
    halo = radius + 1
    dx = torch.zeros((B, H, W, C), dtype=torch.float32, device=g.device)
    for py0 in range(0, H, patch_h):
        for px0 in range(0, W, patch_w):
            ys = torch.arange(max(py0 - halo, 0),
                              min(py0 + patch_h + halo, H), device=g.device)
            xs = torch.arange(max(px0 - halo, 0),
                              min(px0 + patch_w + halo, W), device=g.device)
            g_r = g[:, ys][:, :, xs].float()
            off_r = offset[:, ys][:, :, xs].float()
            m_r = mask[:, ys][:, :, xs].float()
            acc = torch.zeros((B, patch_h, patch_w, C), dtype=torch.float32,
                              device=g.device)
            bidx = torch.arange(B, device=g.device)[:, None, None].expand(
                B, len(ys), len(xs))
            for k in range(9):
                gw = g_r @ weight[k // 3, k % 3].float().T
                d = off_r[..., k, :].clamp(-radius, radius)
                base = torch.floor(d)
                fy, fx = (d - base).unbind(-1)
                y0 = ys[None, :, None] + (k // 3 - 1) + base[..., 0].long()
                x0 = xs[None, None, :] + (k % 3 - 1) + base[..., 1].long()
                for a, b, cw in ((0, 0, (1 - fy) * (1 - fx)),
                                 (0, 1, (1 - fy) * fx),
                                 (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
                    yy, xx = y0 + a, x0 + b
                    inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
                    ly, lx = yy - py0, xx - px0
                    keep = (inside & (ly >= 0) & (ly < patch_h)
                            & (lx >= 0) & (lx < patch_w))
                    term = (m_r[..., k] * cw)[..., None] * gw
                    acc.index_put_((bidx[keep], ly[keep], lx[keep]),
                                   term[keep], accumulate=True)
            dx[:, py0:py0 + patch_h, px0:px0 + patch_w] = \
                acc[:, :H - py0, :W - px0]
    return dx


def deform_conv2d_windowed(x, offset, mask, weight, bias=None, radius=1):
    """Offsets clamped to [-radius, radius] (side_tpu deform_conv2d_windowed)."""
    return deform_conv_plain(x, offset, mask, weight, bias, radius)


def deform_conv2d_exact(x, offset, mask, weight, bias=None):
    """Unbounded offsets (side_tpu _deform_conv2d_gather)."""
    return deform_conv_plain(x, offset, mask, weight, bias, -1)


class DcnFunction(torch.autograd.Function):
    """The DCN forward kernel with the backward kernels as its gradient
    (side_tpu/ops/dcn_pallas.py:964-1033 `_dcn_pallas` + `_dcn_bwd`): K2
    gives d_x in x's dtype, K3 d_offset, d_mask and d_weight in f32, and
    d_bias = sum of g stays a plain reduction, as in the JAX package
    (dcn_pallas_bwd.py:493).  Operands as `DCN_FWD` takes them."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, radius: int):
        from .dcn_cuda import DCN_FWD
        ctx.radius = radius
        ctx.save_for_backward(x, offset, mask, weight)
        return DCN_FWD(x, offset, mask, weight, bias, radius)

    @staticmethod
    def backward(ctx, g):
        from .dcn_cuda import DCN_BWD_DCOORD, DCN_BWD_DX
        x, offset, mask, weight = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        need = ctx.needs_input_grad
        d_x = d_off = d_mask = d_w = d_b = None
        if need[0]:
            d_x = DCN_BWD_DX(g, offset, mask, weight, ctx.radius)
        if need[1] or need[2] or need[3]:
            d_off, d_mask, d_w = DCN_BWD_DCOORD(x, g, offset, mask, weight,
                                                ctx.radius)
        if need[4]:
            d_b = g.float().sum((0, 1, 2))
        return d_x, d_off, d_mask, d_w, d_b, None


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """DCN in the current mode: the Hopper kernels for CUDA tensors (forward
    and backward), the plain version with autograd for CPU tensors."""
    radius = dcn_radius_tag()
    if x.device.type == "cuda":
        if bias is None:
            bias = torch.zeros(weight.shape[-1], device=x.device)
        return DcnFunction.apply(
            x.contiguous(), offset.float().contiguous(),
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


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def deform_block_om(x: torch.Tensor, w_om_oihw: torch.Tensor,
                    b_om: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    """`deform_conv2d_om` with the offset/mask conv weight in OIHW, as the
    model stores it.  The conv is an ordinary convolution on both routes
    (the JAX package leaves it to XLA, dcn_pallas.py:711); its output is
    rounded to x's dtype before the DCN reads it."""
    B, H, W, _ = x.shape
    om = F.conv2d(x.permute(0, 3, 1, 2), w_om_oihw.to(x.dtype), padding=1)
    om = (om + b_om.to(om.dtype)[:, None, None]).permute(0, 2, 3, 1)
    if (_fused and _mode == "windowed"
            and not _wants_grad(x, w_om_oihw, b_om, weight, bias)):
        return _deform_conv2d_fused(x, om, weight, bias)
    om = om.reshape(B, H, W, 9, 3)
    offset = om[..., 0:2].float()
    mask = torch.sigmoid(om[..., 2].float())
    return deform_conv2d(x, offset, mask, weight, bias)


def _deform_conv2d_fused(x, om, weight, bias):
    """The fused route: K4 for CUDA tensors, its plain version for CPU
    tensors.  `om` is made NHWC-contiguous here (one copy, unless the conv
    already answered in channels-last memory)."""
    if x.device.type == "cuda":
        from .dcn_cuda import DCN_FWD_OM
        if bias is None:
            bias = torch.zeros(weight.shape[-1], device=x.device)
        return DCN_FWD_OM(x.contiguous(), om.contiguous(),
                          weight.float().contiguous(),
                          bias.float().contiguous(), _radius)
    return deform_conv_om_plain(x, om, weight, bias, _radius)
