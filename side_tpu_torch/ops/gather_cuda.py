"""Bilinear 4-corner gather: the Hopper kernel's binding and its plain
version.

csrc/gather_bilinear.cu `gather_bilinear` replaces the TPU kernel of the JAX
package's gather probe (tools/gather_microbench.py:111 `variant_E.kernel`):

    out[b*P + p, :] = sum over dy, dx in {0, 1} of
        x[b, min(y0+dy, H-1), min(x0+dx, W-1), :] * w_dydx(fy, fx)

accumulated in f32 in the corner order (0,0), (0,1), (1,0), (1,1) and stored
in x's dtype, or in f32 with `out_dtype=torch.float32` (for bf16 x: the
voxel depth variant's `grid_sample_feats`, models/voxel_net.py).
`GATHER_BILINEAR(x, y0, x0, fy, fx)` launches the kernel on PyTorch's
current stream for CUDA tensors, raises on anything it cannot take and
counts its launches in `.launches`; CPU tensors take
`gather_bilinear_plain`.  `GatherBilinearFunction` is the kernel with a
gradient with respect to x: the corner-weighted scatter-add in PyTorch (the
JAX package computes this function in XLA, so no TPU kernel has a backward
to port).  The library is
built with nvcc at first use (see ops/dcn_cuda.py); nothing is built when
this module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from .dcn_cuda import CudaLibrary, _dtype_code, _stream

_VP, _CI = ctypes.c_void_p, ctypes.c_int
GATHER_LIB = CudaLibrary("gather_bilinear", {
    "gather_bilinear_launch": [_VP] * 6 + [ctypes.c_longlong] + [_CI] * 7
    + [_VP],
    "gather_l2_read_launch": [_VP, ctypes.c_longlong, _CI, _VP, _VP]},
    "gather_error_string")
WARP_BODY_GROUPS = (1, 2, 4, 8, 16, 32)   # C / 8 the warp-chunk kernel takes


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


class GatherBilinearFunction(torch.autograd.Function):
    """`GATHER_BILINEAR` (any device: the kernel on CUDA tensors, the plain
    version on CPU tensors) with a gradient with respect to x: g scattered
    back to each sample's four corners with its weights, accumulated in f32
    with `index_add_` and cast to x's dtype.  The coordinates get none."""

    @staticmethod
    def forward(ctx, x, y0, x0, fy, fx, out_dtype=None):
        ctx.save_for_backward(y0, x0, fy, fx)
        ctx.shape, ctx.dtype = tuple(x.shape), x.dtype
        return GATHER_BILINEAR(x, y0, x0, fy, fx, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None
        y0, x0, fy, fx = ctx.saved_tensors
        B, H, W, C = ctx.shape
        y0 = y0.reshape(B, -1).long()
        x0 = x0.reshape(B, -1).long()
        fy = fy.reshape(-1).float()
        fx = fx.reshape(-1).float()
        base = (torch.arange(B, device=g.device) * (H * W))[:, None]
        g = g.float()
        d = torch.zeros((B * H * W, C), dtype=torch.float32, device=g.device)
        for dy in (0, 1):
            for dx in (0, 1):
                yi = torch.clamp(y0 + dy, max=H - 1)
                xi = torch.clamp(x0 + dx, max=W - 1)
                wt = (fy if dy else 1 - fy) * (fx if dx else 1 - fx)
                d.index_add_(0, (base + yi * W + xi).reshape(-1),
                             g * wt[:, None])
        return (d.reshape(B, H, W, C).to(ctx.dtype), None, None, None, None,
                None)


def gather_body(C: int) -> str:
    """Which kernel of csrc/gather_bilinear.cu serves a width: "warp" (a warp
    takes 32 samples at a time; C / 8 a power of two up to 32) or "thread"
    (one thread per sample and 8 channels, any C % 8 == 0)."""
    return "warp" if C % 8 == 0 and C // 8 in WARP_BODY_GROUPS else "thread"


class GatherBilinearKernel:
    """`gather_bilinear_launch` with a launch counter."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                 fy: torch.Tensor, fx: torch.Tensor, out_dtype=None,
                 per_thread: bool = False) -> torch.Tensor:
        """x (B,H,W,C) bf16|f32 with C a multiple of 8; y0, x0 int32 in
        [0, H-1] / [0, W-1] and fy, fx f32, each of B*P elements, contiguous.
        Returns (B*P, C) in `out_dtype`: x.dtype (the default) or, for bf16
        x, float32.  The kernel follows `gather_body`;
        `per_thread=True` (tests and timing only) runs the one-thread-per-
        (sample, 8 channels) kernel, the earlier design, at any width."""
        if x.device.type != "cuda":
            return gather_bilinear_plain(x, y0, x0, fy, fx, out_dtype)
        if x.dim() != 4:
            raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
        B, H, W, C = x.shape
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
        out_dtype = out_dtype or x.dtype
        if out_dtype not in (x.dtype, torch.float32):
            raise TypeError(f"out_dtype must be x's dtype or float32, got "
                            f"{out_dtype}")
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
        if H * W * C >= 2 ** 31 or B * H * W >= 2 ** 29 or S >= 2 ** 31:
            raise ValueError("the gather kernel takes fewer than 2**31 values "
                             "an image, 2**29 pixels and 2**31 samples")
        body = "thread" if per_thread else gather_body(C)
        lib = GATHER_LIB.load()
        out = torch.empty((S, C), dtype=out_dtype, device=x.device)
        err = lib.gather_bilinear_launch(
            x.data_ptr(), y0.data_ptr(), x0.data_ptr(), fy.data_ptr(),
            fx.data_ptr(), out.data_ptr(), S, S // B, H, W, C,
            _dtype_code(x), _dtype_code(out), int(body == "warp"),
            _stream(x.device))
        GATHER_LIB.check(err, "gather_bilinear")
        self.launches += 1
        return out


def l2_read_ms(x: torch.Tensor, total_bytes: int, reps: int = 20):
    """Device time (median of `reps`, CUDA events) of `gather_l2_read_kernel`
    reading x's bytes again and again until about `total_bytes` have come
    out of L2: the yardstick for what the gather's corner reads can reach.
    Returns (ms of one launch, bytes it read)."""
    import statistics
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("x must be a contiguous CUDA tensor")
    nbytes = x.numel() * x.element_size()
    if nbytes % 16 or x.data_ptr() % 16:
        raise ValueError("x must hold a multiple of 16 bytes, 16-byte aligned")
    passes = max(1, round(total_bytes / nbytes))
    lib = GATHER_LIB.load()
    out = torch.zeros(4, dtype=torch.int32, device=x.device)

    def launch():
        GATHER_LIB.check(lib.gather_l2_read_launch(
            x.data_ptr(), nbytes, passes, out.data_ptr(),
            _stream(x.device)), "gather_l2_read")

    for _ in range(3):
        launch()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), passes * nbytes


GATHER_BILINEAR = GatherBilinearKernel()
