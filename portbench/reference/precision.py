"""The precision of the reference's products.

Off (the default), `q` is the identity and the reference computes in
float32.  Within `control("fp8")` the network computes in float8 e4m3 as
the program computes in bfloat16: every conv, dense and DCN product reads
its two operands rounded to e4m3 with one scale per tensor (amax over 448,
the format's largest finite value), as an fp8 GEMM with f32 accumulation
reads them, and every conv, DCN and BatchNorm result is stored rounded the
same way, as the program stores its activations in bfloat16.  The backward
is rounded too: the gradient that reaches a rounded tensor is itself
rounded to e4m3 (one scale per tensor) before it goes on, so that the
backward's products read e4m3 operands (the incoming gradient, rounded where
the forward stored its result, and the rounded forward operand) and store
e4m3 gradients.  It is the precision one step below the configuration's
bfloat16: the control of the network's correctness check.  "bf16" rounds
to bfloat16, with no scale: the control of a stage that computes in
float32 (the device tail)."""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
FORMATS = ("fp8", "bf16")
_format = None


def _round(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """`x` rounded to `fmt` and back to its own dtype."""
    if fmt == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    scale = x.abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    y = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return y.to(x.dtype)


class _Rounded(torch.autograd.Function):
    """Forward: the tensor rounded.  Backward: the gradient rounded."""

    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        return _round(x, fmt)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.fmt), None


def q(x: torch.Tensor) -> torch.Tensor:
    if _format is None or not x.is_floating_point():
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _round(x.detach(), _format)
    return _Rounded.apply(x, _format)


@contextlib.contextmanager
def control(fmt: str = "fp8"):
    """Products in `fmt` within the block."""
    global _format
    if fmt not in FORMATS:
        raise ValueError(f"unknown control precision {fmt!r}")
    prev, _format = _format, fmt
    try:
        yield
    finally:
        _format = prev
