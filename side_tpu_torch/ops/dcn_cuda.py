"""Bindings of the hand-written Hopper DCN kernels.

    csrc/dcn_fwd.cu  `dcn_fwd`: the forward, replacing the JAX package's two
        Pallas forward kernels (side_tpu/ops/dcn_pallas.py:240 `_dcn_kernel`
        and :402 `_dcn_kernel_packed`);
    csrc/dcn_bwd.cu  `dcn_bwd_dx` (K2, side_tpu/ops/dcn_pallas_bwd.py:104
        `_dx_kernel`) and `dcn_bwd_dcoord` (K3, :193 `_dcoord_kernel`): the
        backward;
    csrc/dcn_fwd_om.cu  `dcn_fwd_om` (K4, side_tpu/ops/dcn_pallas.py:691
        `_dcn_kernel_packed_om`): the forward fed the raw 27-channel
        offset/mask conv output.  It shares its body with `dcn_fwd` through
        csrc/dcn_fwd_body.cuh.

Each source is compiled with nvcc into a shared library with a plain C
interface at first use, under `side_tpu_torch/_build/` (git-ignored), and
loaded with ctypes; `build_all()` compiles every source at once.  Nothing is
imported or built when this module is imported.

`DCN_FWD(x, offset, mask, weight, bias, radius)`,
`DCN_BWD_DX(g, offset, mask, weight, radius)`,
`DCN_BWD_DCOORD(x, g, offset, mask, weight, radius)` and
`DCN_FWD_OM(x, om, weight, bias, radius)` launch their kernel on
PyTorch's current stream for CUDA tensors and raise on anything they cannot
take; they never fall back to the plain version.  Each counts its launches
in `.launches`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the DCN kernels "
                           "are built from side_tpu_torch/csrc at first use")
    return found


class CudaLibrary:
    """One csrc/*.cu source, built into `_build/lib<name>_<hash>.so` and
    loaded with ctypes; `signatures` gives each launch function's argtypes,
    `error_fn` names the function that turns an error code into text, and
    `headers` the csrc/ files the source includes (the hash covers them, so
    an edited header is never served by a stale library)."""

    def __init__(self, name: str, signatures, error_fn: str,
                 headers: Sequence[str] = ()):
        self.name = name
        self.source = _PKG / "csrc" / f"{name}.cu"
        self.headers = [_PKG / "csrc" / h for h in headers]
        self.signatures = signatures
        self.error_fn = error_fn
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(
            b"".join(p.read_bytes() for p in [self.source, *self.headers]) +
            " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.name}_{digest[:16]}.so"

    def start_build(self):
        """Start nvcc unless a library of this source exists; returns the
        process (None when there is nothing to build)."""
        path = self.library_path()
        if path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        proc.output_path = tmp
        return proc

    def finish_build(self, proc) -> Path:
        path = self.library_path()
        if proc is not None:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source}:\n{err}")
            os.replace(proc.output_path, path)
        return path

    def build(self) -> Path:
        return self.finish_build(self.start_build())

    def load(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for fn, argtypes in self.signatures.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                err = getattr(lib, self.error_fn)
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib = lib
        return self._lib

    def check(self, err: int, what: str) -> None:
        if err != 0:
            msg = getattr(self.load(), self.error_fn)(err)
            raise RuntimeError(f"{what} launch failed: {msg.decode()}")


_VP, _CI = ctypes.c_void_p, ctypes.c_int
FWD_LIB = CudaLibrary("dcn_fwd", {
    "dcn_fwd_launch": [_VP] * 6 + [_CI] * 7 + [_VP]}, "dcn_error_string",
    headers=("dcn_fwd_body.cuh",))
BWD_LIB = CudaLibrary("dcn_bwd", {
    "dcn_bwd_dx_launch": [_VP] * 5 + [_CI] * 7 + [_VP],
    "dcn_bwd_dcoord_launch": [_VP] * 8 + [_CI] * 7 + [_VP]},
    "dcn_bwd_error_string")
OM_LIB = CudaLibrary("dcn_fwd_om", {
    "dcn_fwd_om_launch": [_VP] * 5 + [_CI] * 7 + [_VP]},
    "dcn_om_error_string", headers=("dcn_fwd_body.cuh",))
LIBRARIES = (FWD_LIB, BWD_LIB, OM_LIB)


def build_all(libraries: Optional[Sequence[CudaLibrary]] = None):
    """Compile every source at once (one nvcc each); returns the paths.
    By default every kernel of the package (`all_libraries`)."""
    if libraries is None:
        libraries = all_libraries()
    procs = [lib.start_build() for lib in libraries]
    return [lib.finish_build(p) for lib, p in zip(libraries, procs)]


def all_libraries() -> Sequence[CudaLibrary]:
    """The DCN libraries and the gather probe's."""
    from .gather_cuda import GATHER_LIB
    return (*LIBRARIES, GATHER_LIB)


def _dtype_code(x: torch.Tensor) -> int:
    return 0 if x.dtype == torch.float32 else 1


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


class DcnForwardKernel:
    """`dcn_fwd_launch` with a launch counter."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x: torch.Tensor, offset: torch.Tensor,
                 mask: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor, radius: int) -> torch.Tensor:
        """x (B,H,W,C) bf16|f32; offset (B,H,W,9,2) f32 (dy, dx); mask
        (B,H,W,9) f32; weight (3,3,C,Cout) f32; bias (Cout,) f32; all
        contiguous on one CUDA device.  Returns (B,H,W,Cout) in x.dtype."""
        _check(x, offset, mask, weight, bias=bias)
        B, H, W, C = x.shape
        Cout = weight.shape[-1]
        lib = FWD_LIB.load()
        out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
        err = lib.dcn_fwd_launch(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, H, W, C, Cout, int(radius), _dtype_code(x), _stream(x.device))
        FWD_LIB.check(err, "dcn_fwd")
        self.launches += 1
        return out


class DcnBackwardDx:
    """K2 (`dcn_bwd_dx_launch`): d_x of the DCN forward, with a launch
    counter."""

    def __init__(self):
        self.launches = 0

    def __call__(self, g: torch.Tensor, offset: torch.Tensor,
                 mask: torch.Tensor, weight: torch.Tensor,
                 radius: int) -> torch.Tensor:
        """g (B,H,W,Cout) bf16|f32, the cotangent of the forward's output;
        offset, mask, weight as for the forward.  Returns d_x (B,H,W,C) in
        g.dtype (the kernel sums into f32 and the result is cast once)."""
        C = weight.shape[2] if weight.dim() == 4 else -1
        _check(g, offset, mask, weight, x_shape=(*g.shape[:3], C))
        if tuple(g.shape[3:]) != (weight.shape[-1],):
            raise ValueError(f"g must end in Cout = {weight.shape[-1]}, got "
                             f"{tuple(g.shape)}")
        B, H, W, Cout = g.shape
        lib = BWD_LIB.load()
        dx = torch.zeros((B, H, W, C), dtype=torch.float32, device=g.device)
        err = lib.dcn_bwd_dx_launch(
            g.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), dx.data_ptr(), B, H, W, C, Cout, int(radius),
            _dtype_code(g), _stream(g.device))
        BWD_LIB.check(err, "dcn_bwd_dx")
        self.launches += 1
        return dx.to(g.dtype)


class DcnBackwardDcoord:
    """K3 (`dcn_bwd_dcoord_launch`): d_offset, d_mask and d_weight of the DCN
    forward, with a launch counter."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x: torch.Tensor, g: torch.Tensor,
                 offset: torch.Tensor, mask: torch.Tensor,
                 weight: torch.Tensor, radius: int):
        """x as for the forward; g (B,H,W,Cout) in x.dtype.  Returns
        (d_offset (B,H,W,9,2), d_mask (B,H,W,9), d_weight (3,3,C,Cout)), all
        f32."""
        _check(x, offset, mask, weight, g=g)
        B, H, W, C = x.shape
        Cout = weight.shape[-1]
        lib = BWD_LIB.load()
        d_off = torch.empty((B, H, W, 9, 2), dtype=torch.float32,
                            device=x.device)
        d_mask = torch.empty((B, H, W, 9), dtype=torch.float32,
                             device=x.device)
        d_w = torch.zeros((3, 3, C, Cout), dtype=torch.float32,
                          device=x.device)
        err = lib.dcn_bwd_dcoord_launch(
            x.data_ptr(), g.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), d_off.data_ptr(), d_mask.data_ptr(),
            d_w.data_ptr(), B, H, W, C, Cout, int(radius), _dtype_code(x),
            _stream(x.device))
        BWD_LIB.check(err, "dcn_bwd_dcoord")
        self.launches += 1
        return d_off, d_mask, d_w


class DcnForwardOmKernel:
    """K4 (`dcn_fwd_om_launch`): the forward fed the raw offset/mask conv
    output, with a launch counter."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x: torch.Tensor, om: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor,
                 radius: int) -> torch.Tensor:
        """x (B,H,W,C) bf16|f32; om (B,H,W,27) in x.dtype, per tap [dy, dx,
        mask logit]; weight (3,3,C,Cout) f32; bias (Cout,) f32; all
        contiguous on one CUDA device; radius >= 0 (windowed).  Returns
        (B,H,W,Cout) in x.dtype."""
        _check(x, None, None, weight, bias=bias, om=om)
        if int(radius) < 0:
            raise ValueError("dcn_fwd_om is the windowed function: radius "
                             f">= 0, got {radius}")
        B, H, W, C = x.shape
        Cout = weight.shape[-1]
        lib = OM_LIB.load()
        out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
        err = lib.dcn_fwd_om_launch(
            x.data_ptr(), om.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, H, W, C, Cout, int(radius), _dtype_code(x),
            _stream(x.device))
        OM_LIB.check(err, "dcn_fwd_om")
        self.launches += 1
        return out


def _check(x, offset, mask, weight, bias=None, g=None, x_shape=None,
           om=None) -> None:
    """Shapes, dtypes, device and contiguity of a DCN kernel's operands.  K2
    reads no x: it passes g as `x` and x's shape as `x_shape`.  K4 passes
    `om` (in x's dtype) in place of offset and mask."""
    shape = tuple(x.shape) if x_shape is None else tuple(x_shape)
    if len(shape) != 4:
        raise ValueError(f"x must be (B, H, W, C), got {shape}")
    B, H, W, C = shape
    Cout = weight.shape[-1] if weight.dim() == 4 else -1
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if om is None:
        want = {"offset": (B, H, W, 9, 2), "mask": (B, H, W, 9)}
        got = {"offset": offset, "mask": mask}
    else:
        want = {"om": (B, H, W, 27)}
        got = {"om": om}
    want["weight"] = (3, 3, C, Cout)
    got["weight"] = weight
    if bias is not None:
        want["bias"] = (Cout,)
        got["bias"] = bias
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
        dtype = x.dtype if name == "om" else torch.float32
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    tensors = dict(x=x, **got)
    if g is not None:
        if tuple(g.shape) != (B, H, W, Cout):
            raise ValueError(f"g must be {(B, H, W, Cout)}, got "
                             f"{tuple(g.shape)}")
        if g.dtype != x.dtype:
            raise TypeError(f"g must be {x.dtype}, got {g.dtype}")
        tensors["g"] = g
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device "
                             f"({x.device}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (B * H * W * C >= 2 ** 31 or B * H * W * 27 >= 2 ** 31
            or B * H * W * max(Cout, 1) >= 2 ** 31):
        raise ValueError("the DCN kernels index with 32-bit offsets; input "
                         "too large")
    if B * H * W == 0 or C == 0 or Cout <= 0:
        raise ValueError("the DCN kernels need a non-empty input and output")


DCN_FWD = DcnForwardKernel()
DCN_BWD_DX = DcnBackwardDx()
DCN_BWD_DCOORD = DcnBackwardDcoord()
DCN_FWD_OM = DcnForwardOmKernel()
KERNELS = {"dcn_fwd": DCN_FWD, "dcn_bwd_dx": DCN_BWD_DX,
           "dcn_bwd_dcoord": DCN_BWD_DCOORD, "dcn_fwd_om": DCN_FWD_OM}
