"""The plain reference: frozen copies of the port's plain paths, in
float32, importing nothing of the program."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32():
    """TF32 off in matrix products and cuDNN convolutions within the block:
    float32 is float32."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    prev = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, v in zip(flags, prev):
            f.allow_tf32 = v
