"""Bilinear 4-corner gather: the Hopper kernel's binding and its plain
version.

csrc/gather_bilinear.cu `gather_bilinear` replaces the TPU kernel of the JAX
package's gather probe (tools/gather_microbench.py:111 `variant_E.kernel`):

    out[b*P + p, :] = sum over dy, dx in {0, 1} of
        x[b, min(y0+dy, H-1), min(x0+dx, W-1), :] * w_dydx(fy, fx)

accumulated in f32 in the corner order (0,0), (0,1), (1,0), (1,1) and stored
in x's dtype.  `GATHER_BILINEAR(x, y0, x0, fy, fx)` launches the kernel on
PyTorch's current stream for CUDA tensors, raises on anything it cannot take
and counts its launches in `.launches`; CPU tensors take
`gather_bilinear_plain`.  The library is built with nvcc at first use (see
ops/dcn_cuda.py); nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from .dcn_cuda import CudaLibrary, _dtype_code, _stream

_VP, _CI = ctypes.c_void_p, ctypes.c_int
GATHER_LIB = CudaLibrary("gather_bilinear", {
    "gather_bilinear_launch": [_VP] * 6 + [ctypes.c_longlong] + [_CI] * 5
    + [_VP]}, "gather_error_string")


def gather_bilinear_plain(x: torch.Tensor, y0: torch.Tensor,
                          x0: torch.Tensor, fy: torch.Tensor,
                          fx: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernel.  x (B, H, W, C); y0, x0 integer and
    fy, fx f32 of B*P elements (any shape), sample s in image s // P.
    Returns (B*P, C) in x.dtype."""
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
    return acc.to(x.dtype).reshape(-1, C)


class GatherBilinearKernel:
    """`gather_bilinear_launch` with a launch counter."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                 fy: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
        """x (B,H,W,C) bf16|f32 with C a multiple of 8; y0, x0 int32 in
        [0, H-1] / [0, W-1] and fy, fx f32, each of B*P elements, contiguous.
        Returns (B*P, C) in x.dtype."""
        if x.device.type != "cuda":
            return gather_bilinear_plain(x, y0, x0, fy, fx)
        if x.dim() != 4:
            raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
        B, H, W, C = x.shape
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
        if C == 0 or C % 8:
            raise ValueError(f"C must be a positive multiple of 8, got {C}")
        S = y0.numel()
        if S == 0 or S % B:
            raise ValueError(f"{S} samples do not divide into {B} images")
        for name, t, dt in (("y0", y0, torch.int32), ("x0", x0, torch.int32),
                            ("fy", fy, torch.float32),
                            ("fx", fx, torch.float32)):
            if t.dtype != dt:
                raise TypeError(f"{name} must be {dt}, got {t.dtype}")
            if t.numel() != S:
                raise ValueError(f"{name} must have {S} elements, got "
                                 f"{t.numel()}")
        for name, t in dict(x=x, y0=y0, x0=x0, fy=fy, fx=fx).items():
            if t.device != x.device:
                raise ValueError(f"{name} must lie on x's CUDA device "
                                 f"({x.device}), got {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if H * W * C >= 2 ** 31:
            raise ValueError("one image must hold fewer than 2**31 values")
        lib = GATHER_LIB.load()
        out = torch.empty((S, C), dtype=x.dtype, device=x.device)
        err = lib.gather_bilinear_launch(
            x.data_ptr(), y0.data_ptr(), x0.data_ptr(), fy.data_ptr(),
            fx.data_ptr(), out.data_ptr(), S, S // B, H, W, C,
            _dtype_code(x), _stream(x.device))
        GATHER_LIB.check(err, "gather_bilinear")
        self.launches += 1
        return out


GATHER_BILINEAR = GatherBilinearKernel()
