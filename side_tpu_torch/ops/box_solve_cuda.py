"""The Gauss-Newton box solve in one CUDA launch: the binding of
csrc/box_solve.cu.

`BOX_SOLVE(consts, z, num_iters)` runs the whole of
postprocess/box_solver.py:solve_x_y_theta_plain (the initial state, then
`num_iters` damped Gauss-Newton iterations of the 3-DoF residuals) for N
rows, one thread per row, on PyTorch's current stream, and returns (N, 3)
f32.  It reads the `FIELDS` of `SolveConsts` and z in place, through a table
of pointers and element strides in the order of the kernel's `Field` enum,
so no pack is copied: one launch per call, counted in `.launches`.  It takes
CUDA tensors only and raises on anything it cannot take; the plain version
is postprocess/box_solver.py's.  The library is built with nvcc at first
use (see ops/dcn_cuda.py); nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from .dcn_cuda import CudaLibrary, _stream

_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
BOX_SOLVE_LIB = CudaLibrary("box_solve", {
    "box_solve_launch": [ctypes.POINTER(_VP), ctypes.POINTER(_CLL), _CI, _VP,
                         _CLL, _VP, _CI, _CI, _VP]}, "box_solve_error_string")
# the SolveConsts fields the residuals read, in the order of csrc/box_solve.cu
# `Field` (tests/test_torch_tail.py holds the two equal)
FIELDS = ("left_u", "right_u", "top_v", "bottom_v", "kpt_u", "alpha", "h",
          "lw", "ll", "rw", "rl", "bw", "bot_l", "kw", "kl",
          "m_ul", "m_ur", "m_uk", "m_vt", "m_vb", "m_alpha")


class BoxSolveKernel:
    """`box_solve_launch` with a launch counter."""

    def __init__(self):
        self.launches = 0

    def __call__(self, consts, z: torch.Tensor, num_iters: int = 20
                 ) -> torch.Tensor:
        """consts: a SolveConsts whose `FIELDS` are f32 (N,) tensors on z's
        CUDA device (any strides); z (N,) f32.  Returns (N, 3) f32 =
        (x, y, theta)."""
        if z.device.type != "cuda":
            raise ValueError(f"z must be a CUDA tensor, got {z.device}")
        if z.dim() != 1 or z.dtype != torch.float32:
            raise TypeError(f"z must be (N,) float32, got {tuple(z.shape)} "
                            f"{z.dtype}")
        if num_iters < 0:
            raise ValueError(f"num_iters must be >= 0, got {num_iters}")
        n = z.shape[0]
        out = torch.empty((n, 3), dtype=torch.float32, device=z.device)
        fields = [getattr(consts, name) for name in FIELDS]
        for name, t in zip(FIELDS, fields):
            if t.device != z.device or t.dtype != torch.float32 or \
                    tuple(t.shape) != (n,):
                raise ValueError(f"consts.{name} must be ({n},) float32 on "
                                 f"{z.device}, got {tuple(t.shape)} {t.dtype}"
                                 f" on {t.device}")
        if n == 0:
            return out
        if n >= 2 ** 31:
            raise ValueError("the box solve takes fewer than 2**31 rows")
        lib = BOX_SOLVE_LIB.load()
        ptrs = (_VP * len(FIELDS))(*(t.data_ptr() for t in fields))
        strides = (_CLL * len(FIELDS))(*(t.stride(0) for t in fields))
        err = lib.box_solve_launch(ptrs, strides, len(FIELDS), z.data_ptr(),
                                   z.stride(0), out.data_ptr(), n,
                                   int(num_iters), _stream(z.device))
        BOX_SOLVE_LIB.check(err, "box_solve")
        self.launches += 1
        return out


BOX_SOLVE = BoxSolveKernel()
