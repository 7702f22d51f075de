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

The forward body (K1 and K4), K2 and K3 each have two routes, and
`dcn_route` picks one from the dtype and the widths alone: "tensor" (bf16
products on the tensor cores, wgmma in the forward and mma.sync in K2 and
K3: bf16 operands, Cin a multiple of 64, Cout 64, 128 or 256, which covers
every DeformBlock of the model) or "cuda_core" (f32 FMA: f32 operands and
every other width).  `fwd_plan`, `dx_plan` and `dcoord_plan` size the
tensor-core launches (tiles or patches, splits of the reduction, dynamic
shared memory); the C launchers follow them and refuse a plan whose bytes
are not their own.  On its tensor-core route K2 has two bodies, and
`dx_plan` picks from the window and Cout alone: "patch" keeps the scatter
in the block and writes d_x once in g's dtype (the model's window R = 1 at
Cout 64), "tile" adds to an f32 d_x in device memory (exact mode, other
windows, Cout 128 and 256).

Under `torch.use_deterministic_algorithms` (`deterministic_mode()` sets it
with cuDNN's and cuBLAS's own switches) K2 and K3 give the same bits every
run: K2 takes its patch body at every width of the window R = 1, and K3's
tensor-core route writes its partial sums to copies that the wrapper adds
in a fixed order.  Where neither applies (the CUDA-core routes, K2 off the
window) they raise as PyTorch's own operations do, or warn where PyTorch
is set to warn only.  The forward body adds no atomics and is the same
bits every run in either mode.

Each source is compiled with nvcc into a shared library with a plain C
interface at first use, under `side_tpu_torch/_build/` (git-ignored), and
loaded with ctypes; `build_all()` compiles every source at once.  Nothing is
imported or built when this module is imported.

`DCN_FWD(x, offset, mask, weight, bias, radius)`,
`DCN_BWD_DX(g, offset, mask, weight, radius)`,
`DCN_BWD_DCOORD(x, g, offset, mask, weight, radius)` and
`DCN_FWD_OM(x, om, weight, bias, radius)` launch their kernel on
PyTorch's current stream for CUDA tensors and raise on anything they cannot
take; they never fall back to the plain version, and a build or launch
error never changes the route.  Each counts its launches in `.launches`,
those that took the tensor-core route in `.tensor_core_launches`, and its
launches per offset bound in `.radius_launches` ({radius: n}, -1 = exact);
`launch_counts()` reads every kernel's counters, `launches_since` the
launches after an earlier reading.
Their `cuda_core=True` argument is the test entry that times the CUDA-core
body on operands the tensor-core route would take (K2's `scatter="tile"`
likewise the device-memory scatter on operands the patch body would take).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from collections import Counter
from contextlib import contextmanager
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
    an edited header is never served by a stale library); `defines` are
    macros of a measurement build (tools/dx_split.py)."""

    def __init__(self, name: str, signatures, error_fn: str,
                 headers: Sequence[str] = (), defines: Sequence[str] = ()):
        self.name = name
        self.source = _PKG / "csrc" / f"{name}.cu"
        self.headers = [_PKG / "csrc" / h for h in headers]
        self.flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
        self.signatures = signatures
        self.error_fn = error_fn
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(
            b"".join(p.read_bytes() for p in [self.source, *self.headers]) +
            " ".join(self.flags).encode()).hexdigest()
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
            [_nvcc(), *self.flags, "-o", str(tmp), str(self.source)],
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
_MMA_HEADERS = ("dcn_mma.cuh",)
FWD_LIB = CudaLibrary("dcn_fwd", {
    "dcn_fwd_launch": [_VP] * 7 + [_CI] * 10 + [_VP]}, "dcn_error_string",
    headers=("dcn_fwd_body.cuh", *_MMA_HEADERS))
BWD_SIGNATURES = {
    "dcn_bwd_dx_launch": [_VP] * 5 + [_CI] * 11 + [_VP],
    "dcn_bwd_dcoord_launch": [_VP] * 8 + [_CI] * 11 + [_VP]}
BWD_LIB = CudaLibrary("dcn_bwd", BWD_SIGNATURES, "dcn_bwd_error_string",
                      headers=_MMA_HEADERS)
OM_LIB = CudaLibrary("dcn_fwd_om", {
    "dcn_fwd_om_launch": [_VP] * 6 + [_CI] * 10 + [_VP]},
    "dcn_om_error_string", headers=("dcn_fwd_body.cuh", *_MMA_HEADERS))
LIBRARIES = (FWD_LIB, BWD_LIB, OM_LIB)

# ---------------------------------------------------------------- the routes
SM_COUNT = 132                 # H100 SXM
SMEM_PER_BLOCK = 232_448       # most dynamic shared memory of one block
SMEM_PER_SM = 233_472          # 228 KB, each resident block reserving 1 KB
TENSOR_CORE_COUT = (64, 128, 256)
_ROUTE_CODE = {"cuda_core": 0, "tensor": 1}


def dcn_route(dtype: torch.dtype, C: int, Cout: int) -> str:
    """Which body the forward (K1, K4) and K3 run: "tensor" for bf16 with
    Cin a multiple of 64 (the staged chunk) and Cout 64, 128 or 256 (one
    block owns all of Cout), else "cuda_core".  Dtype and widths only."""
    if (dtype == torch.bfloat16 and C > 0 and C % 64 == 0
            and Cout in TENSOR_CORE_COUT):
        return "tensor"
    return "cuda_core"


def _blocks_per_sm(smem_bytes: int) -> int:
    """Resident blocks of 256 threads at <= 128 registers a thread (the
    kernels' launch bounds): two unless shared memory allows only one."""
    return max(1, min(2, SMEM_PER_SM // (smem_bytes + 1024)))


def fwd_plan(B: int, H: int, W: int, C: int, Cout: int) -> dict:
    """Launch plan of the tensor-core forward body (csrc/dcn_fwd_body.cuh):
    the pixel tile, a patch of one image `tile_h` x 16 pixels (bm = 64
    pixels at Cout 256, else 128; the block owns all of Cout), `splits` of
    the 9 * C/64 (chunk, tap) list, the dynamic shared memory and the grid.
    Where the pixel tiles alone do not give every SM a block, the reduction
    is split until they do (or it cannot be split further); the partial
    sums go through an f32 scratch of `scratch_floats` values and a second
    kernel."""
    bm = 64 if Cout == 256 else 128
    tile_h, tile_w = bm // 16, 16
    tiles = B * -(-H // tile_h) * -(-W // tile_w)
    n_iter = 9 * (C // 64)
    splits = 1
    if tiles < SM_COUNT:
        splits = min(n_iter, -(-SM_COUNT // tiles))
        # no empty split: ceil(n_iter / splits) turns per split must reach
        # the list's end with the last one
        per = -(-n_iter // splits)
        splits = -(-n_iter // per)
    smem = 2 * bm * 128 + 2 * 64 * Cout * 2 + bm * 9 * 20 + bm * 4
    return {"bm": bm, "bn": Cout, "tile_h": tile_h, "tile_w": tile_w,
            "tiles": tiles, "splits": splits, "blocks": tiles * splits,
            "smem_bytes": smem, "blocks_per_sm": _blocks_per_sm(smem),
            "scratch_floats": splits * B * H * W * Cout if splits > 1 else 0}


def dcoord_plan(P: int, C: int, Cout: int) -> dict:
    """Launch plan of the tensor-core K3 (csrc/dcn_bwd.cu): 9 * C/64 (tap,
    channel tile) combinations, each cut into `slices` runs of 64-pixel
    tiles so that the grid fills the card's resident blocks about twice
    (and never exceeds two waves), the dynamic shared memory and the
    grid."""
    combos = 9 * (C // 64)
    n_pt = -(-P // 64)
    smem = 2 * 64 * Cout * 2 + 64 * 128 + 64 * 72 * 4 + 64 * 36
    per_sm = _blocks_per_sm(smem)
    slices = max(1, min(n_pt, (2 * SM_COUNT * per_sm) // combos))
    per = -(-n_pt // slices)
    slices = -(-n_pt // per)            # no empty slice
    return {"combos": combos, "pixel_tiles": n_pt, "slices": slices,
            "blocks": combos * slices, "smem_bytes": smem,
            "blocks_per_sm": per_sm}


DX_PATCH_W = 16                # columns of a d_x patch
DX_PATCH_RADIUS = 1            # the window and the width at which keeping the
DX_PATCH_COUT = 64             # scatter in the block pays (PERF.md)


def _dx_patch_smem(Cout: int, patch_h: int, halo: int):
    """(region pixels, staged g rows, bytes) of csrc/dcn_bwd.cu's
    `dx_patch_smem_bytes`."""
    region = (patch_h + 2 * halo) * (DX_PATCH_W + 2 * halo)
    g_rows = -(-region // 32) * 32
    smem = (g_rows * Cout * 2 + 64 * Cout * 2 + region * 72 * 4
            + (2 * halo - 1) ** 2 * patch_h * DX_PATCH_W * 4)
    return region, g_rows, smem


def _dx_tile_plan(P: int, C: int, Cout: int) -> dict:
    smem = 2 * 64 * Cout * 2 + 64 * 72 * 4 + 64 * 9 * 32
    tiles = -(-P // 64)
    blocks = tiles * (C // 64)
    splits = 1
    if blocks < SM_COUNT:
        per = -(-9 // min(9, -(-SM_COUNT // blocks)))
        splits = -(-9 // per)           # no block without a tap
    return {"scatter": "tile", "patch_h": 0, "halo": 0, "tiles": tiles,
            "tap_splits": splits, "blocks": blocks * splits,
            "smem_bytes": smem, "blocks_per_sm": _blocks_per_sm(smem)}


def dx_plan(B: int, H: int, W: int, C: int, Cout: int, radius: int,
            deterministic: bool = False) -> dict:
    """Launch plan of the tensor-core K2 (csrc/dcn_bwd.cu), whose blocks
    each own 64 input channels and loop over the 9 taps.

    "patch" (radius 1, the model's window, and Cout = 64): a block owns `patch_h` x 16
    pixels of one image's d_x in registers and forms g·W_k^T for the patch
    grown by `halo` = radius + 1 pixels (`region` output pixels; `g_rows`
    rows of g staged, with the padding to a warp's 32 rows); it writes d_x
    once, in g's dtype.  The patch is 8 rows, or 4 where only that lets two
    blocks share an SM or where 8 rows would leave an SM without a block.
    "tile" (exact mode, other windows, and Cout 128 and 256, where the
    product over the halo costs more than the device-memory scatter it
    saves): a block owns 64 output pixels and adds to an f32 d_x in device
    memory (`patch_h` 0); where that leaves SMs without a block the nine
    taps are split over `tap_splits` blocks.  `deterministic` takes the
    patch at every Cout of the window (4 rows at Cout 256, where 8 exceed a
    block's shared memory): its sums have one order."""
    if radius != DX_PATCH_RADIUS or (Cout != DX_PATCH_COUT
                                     and not deterministic):
        return _dx_tile_plan(B * H * W, C, Cout)
    halo = radius + 1
    plans = []
    for patch_h in (8, 4):
        region, g_rows, smem = _dx_patch_smem(Cout, patch_h, halo)
        tiles = B * -(-H // patch_h) * -(-W // DX_PATCH_W)
        plans.append({"scatter": "patch", "patch_h": patch_h, "halo": halo,
                      "region": region, "g_rows": g_rows, "tiles": tiles,
                      "tap_splits": 1,
                      "blocks": tiles * (C // 64), "smem_bytes": smem,
                      "blocks_per_sm": _blocks_per_sm(smem)})
    tall, short = plans
    if tall["smem_bytes"] > SMEM_PER_BLOCK:
        return short
    if (short["blocks_per_sm"] > tall["blocks_per_sm"]
            or tall["blocks"] < SM_COUNT <= short["blocks"]):
        return short
    return tall


CUBLAS_WORKSPACE = ":4096:8"    # cuBLAS's setting for repeatable results


@contextmanager
def deterministic_mode():
    """Within the block PyTorch's operations and these kernels give the same
    bits every run: `torch.use_deterministic_algorithms` (warn only, for the
    operations without a deterministic implementation whose result is
    repeatable all the same: max_pool3d's backward over windows that do not
    overlap adds one value to each element), cuDNN's deterministic
    algorithms without autotuning, and cuBLAS's workspace setting where
    none is set (read when cuBLAS first runs in the process).  The previous
    settings come back afterwards."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic = prev[2]
        torch.backends.cudnn.benchmark = prev[3]


def _not_deterministic(what: str) -> None:
    """PyTorch's rule for an operation with no deterministic
    implementation under `torch.use_deterministic_algorithms`: raise, or
    warn where it is set to warn only."""
    msg = (f"{what} does not have a deterministic implementation, but "
           "torch.use_deterministic_algorithms(True) is set")
    if torch.is_deterministic_algorithms_warn_only_enabled():
        warnings.warn(msg)
    else:
        raise RuntimeError(msg)


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


class _CountedKernel:
    """Launch counters of a DCN wrapper: all launches, those on the
    tensor-core route, and per offset bound (-1 = exact)."""

    def __init__(self):
        self.launches = 0
        self.tensor_core_launches = 0
        self.radius_launches = Counter()

    def _count(self, route: str, radius: int) -> None:
        self.launches += 1
        self.tensor_core_launches += route == "tensor"
        self.radius_launches[int(radius)] += 1


class DcnForwardKernel(_CountedKernel):
    """`dcn_fwd_launch` with launch counters (`_CountedKernel`)."""

    def __call__(self, x: torch.Tensor, offset: torch.Tensor,
                 mask: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor, radius: int,
                 cuda_core: bool = False) -> torch.Tensor:
        """x (B,H,W,C) bf16|f32; offset (B,H,W,9,2) f32 (dy, dx); mask
        (B,H,W,9) f32; weight (3,3,C,Cout) f32; bias (Cout,) f32; all
        contiguous on one CUDA device.  Returns (B,H,W,Cout) in x.dtype.
        The route follows `dcn_route`; `cuda_core=True` (tests and timing
        only) runs the CUDA-core body whatever the shape."""
        _check(x, offset, mask, weight, bias=bias)
        B, H, W, C = x.shape
        Cout = weight.shape[-1]
        lib = FWD_LIB.load()
        out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
        route, splits, smem, part = _forward_route(x, C, Cout, cuda_core)
        err = lib.dcn_fwd_launch(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            0 if part is None else part.data_ptr(),
            B, H, W, C, Cout, int(radius), _dtype_code(x),
            _ROUTE_CODE[route], splits, smem, _stream(x.device))
        FWD_LIB.check(err, "dcn_fwd")
        self._count(route, radius)
        return out


def _forward_route(x: torch.Tensor, C: int, Cout: int, cuda_core: bool):
    """(route, splits, smem_bytes, scratch) of one forward launch."""
    route = "cuda_core" if cuda_core else dcn_route(x.dtype, C, Cout)
    if route != "tensor":
        return route, 1, 0, None
    plan = fwd_plan(x.shape[0], x.shape[1], x.shape[2], C, Cout)
    part = None
    if plan["scratch_floats"]:
        part = torch.empty(plan["scratch_floats"], dtype=torch.float32,
                           device=x.device)
    return route, plan["splits"], plan["smem_bytes"], part


class DcnBackwardDx(_CountedKernel):
    """K2 (`dcn_bwd_dx_launch`): d_x of the DCN forward, with launch
    counters (`_CountedKernel`)."""

    def __init__(self, lib: CudaLibrary = BWD_LIB):
        super().__init__()
        self.lib = lib

    def __call__(self, g: torch.Tensor, offset: torch.Tensor,
                 mask: torch.Tensor, weight: torch.Tensor,
                 radius: int, cuda_core: bool = False,
                 scatter: Optional[str] = None) -> torch.Tensor:
        """g (B,H,W,Cout) bf16|f32, the cotangent of the forward's output;
        offset, mask, weight as for the forward.  Returns d_x (B,H,W,C) in
        g.dtype, rounded once from an f32 sum.  The route follows
        `dcn_route`, and on the tensor-core route `dx_plan` says where the
        scatter happens: in shared memory ("patch": the kernel writes d_x
        itself) or in device memory ("tile": the kernel adds to a zeroed
        f32 buffer, cast here, as on the CUDA-core route).  `cuda_core=True`
        and `scatter="tile"` (tests and timing only) run the CUDA-core body
        and the device-memory scatter whatever the operands."""
        C = weight.shape[2] if weight.dim() == 4 else -1
        _check(g, offset, mask, weight, x_shape=(*g.shape[:3], C))
        if tuple(g.shape[3:]) != (weight.shape[-1],):
            raise ValueError(f"g must end in Cout = {weight.shape[-1]}, got "
                             f"{tuple(g.shape)}")
        if scatter not in (None, "tile"):
            raise ValueError(f"scatter must be None or 'tile', got {scatter!r}")
        B, H, W, Cout = g.shape
        lib = self.lib.load()
        det = torch.are_deterministic_algorithms_enabled()
        route = "cuda_core" if cuda_core else dcn_route(g.dtype, C, Cout)
        patch_h = smem = 0
        splits = 1
        if route == "tensor":
            plan = dx_plan(B, H, W, C, Cout,
                           -1 if scatter == "tile" else int(radius),
                           deterministic=det)
            patch_h, smem = plan["patch_h"], plan["smem_bytes"]
            splits = plan["tap_splits"]
        if det and not patch_h:
            _not_deterministic(f"dcn_bwd_dx on its {route} route "
                               f"(radius {radius}, Cout {Cout})")
        if patch_h:
            dx = torch.empty((B, H, W, C), dtype=g.dtype, device=g.device)
        else:
            dx = torch.zeros((B, H, W, C), dtype=torch.float32,
                             device=g.device)
        err = lib.dcn_bwd_dx_launch(
            g.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), dx.data_ptr(), B, H, W, C, Cout, int(radius),
            _dtype_code(g), _ROUTE_CODE[route], patch_h, splits, smem,
            _stream(g.device))
        self.lib.check(err, "dcn_bwd_dx")
        self._count(route, radius)
        return dx if patch_h else dx.to(g.dtype)


class DcnBackwardDcoord(_CountedKernel):
    """K3 (`dcn_bwd_dcoord_launch`): d_offset, d_mask and d_weight of the DCN
    forward, with launch counters (`_CountedKernel`)."""

    def __call__(self, x: torch.Tensor, g: torch.Tensor,
                 offset: torch.Tensor, mask: torch.Tensor,
                 weight: torch.Tensor, radius: int, cuda_core: bool = False):
        """x as for the forward; g (B,H,W,Cout) in x.dtype.  Returns
        (d_offset (B,H,W,9,2), d_mask (B,H,W,9), d_weight (3,3,C,Cout)), all
        f32.  The route follows `dcn_route`; `cuda_core=True` (tests and
        timing only) runs the CUDA-core body whatever the shape.  On the
        tensor-core route d_offset and d_mask are summed with f32 atomics
        over the Cin/64 channel tiles where Cin > 64, as d_weight is on both
        routes; under `torch.use_deterministic_algorithms` the tensor-core
        route writes each slice's and channel tile's partial sums to copies
        of their own, summed here in a fixed order."""
        _check(x, offset, mask, weight, g=g)
        B, H, W, C = x.shape
        Cout = weight.shape[-1]
        lib = BWD_LIB.load()
        det = torch.are_deterministic_algorithms_enabled()
        route = "cuda_core" if cuda_core else dcn_route(x.dtype, C, Cout)
        slices = smem = 0
        copies = 1                      # of d_offset and d_mask
        new = torch.empty
        if route == "tensor":
            plan = dcoord_plan(B * H * W, C, Cout)
            slices, smem = plan["slices"], plan["smem_bytes"]
            if plan["combos"] > 9:      # more than one channel tile adds
                new = torch.zeros
        elif det:
            _not_deterministic("dcn_bwd_dcoord on its cuda_core route")
        det = det and route == "tensor"
        if det:
            copies, new = C // 64, torch.empty
        f32 = dict(dtype=torch.float32, device=x.device)
        d_off = new((copies, B, H, W, 9, 2), **f32)
        d_mask = new((copies, B, H, W, 9), **f32)
        d_w = (torch.empty((slices, 3, 3, C, Cout), **f32) if det
               else torch.zeros((1, 3, 3, C, Cout), **f32))
        err = lib.dcn_bwd_dcoord_launch(
            x.data_ptr(), g.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), d_off.data_ptr(), d_mask.data_ptr(),
            d_w.data_ptr(), B, H, W, C, Cout, int(radius), _dtype_code(x),
            _ROUTE_CODE[route], slices, int(det), smem, _stream(x.device))
        BWD_LIB.check(err, "dcn_bwd_dcoord")
        self._count(route, radius)
        if copies > 1:
            d_off, d_mask = d_off.sum(0), d_mask.sum(0)
        else:
            d_off, d_mask = d_off[0], d_mask[0]
        return d_off, d_mask, d_w.sum(0) if det else d_w[0]


class DcnForwardOmKernel(_CountedKernel):
    """K4 (`dcn_fwd_om_launch`): the forward fed the raw offset/mask conv
    output, with launch counters (`_CountedKernel`)."""

    def __call__(self, x: torch.Tensor, om: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor,
                 radius: int, cuda_core: bool = False) -> torch.Tensor:
        """x (B,H,W,C) bf16|f32; om (B,H,W,27) in x.dtype, per tap [dy, dx,
        mask logit]; weight (3,3,C,Cout) f32; bias (Cout,) f32; all
        contiguous on one CUDA device; radius >= 0 (windowed).  Returns
        (B,H,W,Cout) in x.dtype.  Routes as `DcnForwardKernel`."""
        _check(x, None, None, weight, bias=bias, om=om)
        if int(radius) < 0:
            raise ValueError("dcn_fwd_om is the windowed function: radius "
                             f">= 0, got {radius}")
        B, H, W, C = x.shape
        Cout = weight.shape[-1]
        lib = OM_LIB.load()
        out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
        route, splits, smem, part = _forward_route(x, C, Cout, cuda_core)
        err = lib.dcn_fwd_om_launch(
            x.data_ptr(), om.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            out.data_ptr(), 0 if part is None else part.data_ptr(),
            B, H, W, C, Cout, int(radius), _dtype_code(x),
            _ROUTE_CODE[route], splits, smem, _stream(x.device))
        OM_LIB.check(err, "dcn_fwd_om")
        self._count(route, radius)
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
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                             "read 16 bytes a thread)")


DCN_FWD = DcnForwardKernel()
DCN_BWD_DX = DcnBackwardDx()
DCN_BWD_DCOORD = DcnBackwardDcoord()
DCN_FWD_OM = DcnForwardOmKernel()
KERNELS = {"dcn_fwd": DCN_FWD, "dcn_bwd_dx": DCN_BWD_DX,
           "dcn_bwd_dcoord": DCN_BWD_DCOORD, "dcn_fwd_om": DCN_FWD_OM}


def launch_counts() -> dict:
    """Every kernel's launches, those on the tensor-core route
    (`<name>_tensor_core`) and those at each offset bound
    (`<name>_radius<R>`, R = -1 for exact)."""
    counts = {k: v.launches for k, v in KERNELS.items()}
    for k, v in KERNELS.items():
        counts[f"{k}_tensor_core"] = v.tensor_core_launches
        for r, n in v.radius_launches.items():
            counts[f"{k}_radius{r}"] = n
    return counts


def launches_since(before: dict) -> dict:
    """The launches since `before` (a `launch_counts()`)."""
    return {k: v - before.get(k, 0) for k, v in launch_counts().items()}
