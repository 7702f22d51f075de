"""Binding of the hand-written Hopper DCN forward kernel (csrc/dcn_fwd.cu).

The kernel replaces the JAX package's two Pallas forward kernels
(side_tpu/ops/dcn_pallas.py:240 `_dcn_kernel` and :402 `_dcn_kernel_packed`).
It is compiled with nvcc into a shared library with a plain C interface at
first use, under `side_tpu_torch/_build/` (git-ignored), and loaded with
ctypes.  Nothing is imported or built when this module is imported.

`DCN_FWD(x, offset, mask, weight, bias, radius)` launches the kernel on
PyTorch's current stream for CUDA tensors and raises on anything it cannot
take; it never falls back to the plain version.  `DCN_FWD.launches` counts
the launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "dcn_fwd.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the DCN kernel "
                           "is built from csrc/dcn_fwd.cu at first use")
    return found


class DcnForwardKernel:
    """ctypes wrapper of `dcn_fwd_launch` with a launch counter."""

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(SOURCE.read_bytes() +
                                " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"libdcn_fwd_{digest[:16]}.so"

    def build(self) -> Path:
        """Compile the kernel unless a library of this source exists."""
        path = self.library_path()
        if path.exists():
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, path)
        return path

    def _load(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                vp, ci = ctypes.c_void_p, ctypes.c_int
                lib.dcn_fwd_launch.argtypes = [vp] * 6 + [ci] * 7 + [vp]
                lib.dcn_fwd_launch.restype = ci
                lib.dcn_error_string.argtypes = [ci]
                lib.dcn_error_string.restype = ctypes.c_char_p
                self._lib = lib
        return self._lib

    def __call__(self, x: torch.Tensor, offset: torch.Tensor,
                 mask: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor, radius: int) -> torch.Tensor:
        """x (B,H,W,C) bf16|f32; offset (B,H,W,9,2) f32 (dy, dx); mask
        (B,H,W,9) f32; weight (3,3,C,Cout) f32; bias (Cout,) f32; all
        contiguous on one CUDA device.  Returns (B,H,W,Cout) in x.dtype."""
        _check(x, offset, mask, weight, bias)
        B, H, W, C = x.shape
        Cout = weight.shape[-1]
        lib = self._load()
        out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.dcn_fwd_launch(
                x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                B, H, W, C, Cout, int(radius),
                0 if x.dtype == torch.float32 else 1, stream)
        if err != 0:
            raise RuntimeError("dcn_fwd launch failed: " +
                               lib.dcn_error_string(err).decode())
        self.launches += 1
        return out


def _check(x, offset, mask, weight, bias) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    B, H, W, C = x.shape
    want = {"offset": (B, H, W, 9, 2), "mask": (B, H, W, 9),
            "weight": (3, 3, C, weight.shape[-1] if weight.dim() == 4 else -1),
            "bias": (weight.shape[-1] if weight.dim() == 4 else -1,)}
    got = {"offset": offset, "mask": mask, "weight": weight, "bias": bias}
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in dict(x=x, **got).items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device "
                             f"({x.device}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.numel() >= 2 ** 31 or B * H * W * 18 >= 2 ** 31:
        raise ValueError("dcn_fwd indexes with 32-bit offsets; input too large")
    if B * H * W == 0 or weight.shape[-1] == 0:
        raise ValueError("dcn_fwd needs a non-empty input and output")


DCN_FWD = DcnForwardKernel()
