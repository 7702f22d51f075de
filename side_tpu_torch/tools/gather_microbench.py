"""Micro-benchmark of bilinear-gather formulations on the GPU (port of
tools/gather_microbench.py).

    python -m side_tpu_torch.tools.gather_microbench [--device cpu] [--reps 20]

The probe's shape is the finest DCN level of the model: x (2, 96, 320, 64)
bf16 and 9 bilinear samples per pixel (552,960 samples), positions drawn
in-bounds from RandomState(0).  Variants:

  A  per-image `torch.gather` on (B, H*W, C), one gather per corner, the
     weights and the sum in x's dtype (the JAX probe's take_along_axis);
  B  batch folded into the row index, `index_select` on (B*H*W, C);
  E  the hand-written kernel `gather_bilinear` (csrc/gather_bilinear.cu),
     f32 accumulation: the TPU probe's Pallas variant E;
  grid_sample  one PyTorch call that computes the same function for in-bounds
     positions (bilinear, border padding, align_corners=True), on an NCHW
     copy of x; a yardstick only, nothing in the package calls it.

The JAX probe's variant C (`lax.gather` with PROMISE_IN_BOUNDS) has no
PyTorch counterpart distinct from A and is dropped.  Times are medians of
`--reps` runs by CUDA events after 3 warm-up runs (the JAX probe chains
scans because its device cannot be fenced; a GPU can).  Prints the card's
name and power limit, then ms per variant.  With `--device cpu` the variants
run on the CPU (E as its plain version) and are timed by the host clock.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.gather_cuda import GATHER_BILINEAR

B, H, W, C, K = 2, 96, 320, 64, 9


def make_inputs(device, dtype=torch.bfloat16, shape=(B, H, W, C), k=K):
    """x and in-bounds sample positions (sy, sx) of shape (B, H*W*k), drawn
    in the JAX probe's order from RandomState(0)."""
    b, h, w, c = shape
    rng = np.random.RandomState(0)
    x = rng.randn(b, h, w, c)
    # the JAX probe draws (and discards) one more array here
    rng.randn(b, h * w * k)
    sy = rng.rand(b, h * w * k) * (h - 1)
    sx = rng.rand(b, h * w * k) * (w - 1)
    as_t = lambda a, dt: torch.tensor(a, dtype=torch.float32).to(dt).to(device)
    return as_t(x, dtype), as_t(sy, torch.float32), as_t(sx, torch.float32)


def corners(sy, sx):
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    return y0.int(), x0.int(), sy - y0, sx - x0


def _corner_terms(x, sy, sx):
    h, w = x.shape[1:3]
    y0, x0, fy, fx = corners(sy, sx)
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yi = torch.clamp(y0 + dy, max=h - 1).long()
        xi = torch.clamp(x0 + dx, max=w - 1).long()
        wt = ((fy if dy else 1 - fy) * (fx if dx else 1 - fx)).to(x.dtype)
        yield yi * w + xi, wt


def variant_A(x, sy, sx):
    b, h, w, c = x.shape
    flat = x.reshape(b, h * w, c)
    out = 0.0
    for idx, wt in _corner_terms(x, sy, sx):
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        out = out + v * wt[..., None]
    return out.reshape(-1, c)


def variant_B(x, sy, sx):
    b, h, w, c = x.shape
    flat = x.reshape(b * h * w, c)
    base = (torch.arange(b, device=x.device) * (h * w))[:, None]
    out = 0.0
    for idx, wt in _corner_terms(x, sy, sx):
        v = flat.index_select(0, (base + idx).reshape(-1))
        out = out + v * wt.reshape(-1, 1)
    return out


def variant_E(x, sy, sx):
    y0, x0, fy, fx = corners(sy, sx)
    return GATHER_BILINEAR(x, y0.contiguous(), x0.contiguous(),
                           fy.contiguous(), fx.contiguous())


def grid_sample_call(x_nchw, sy, sx):
    """(B, C, 1, P) from one F.grid_sample call; positions in-bounds."""
    h, w = x_nchw.shape[2:]
    grid = torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1],
                       dim=-1)[:, None].to(x_nchw.dtype)
    return F.grid_sample(x_nchw, grid, mode="bilinear",
                         padding_mode="border", align_corners=True)


def time_ms(fn, device, reps: int) -> float:
    """Median time of fn(): CUDA events on the card, the host clock on the
    CPU."""
    for _ in range(3):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize()
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None) -> int:
    from ..runtime.detector import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)
    else:
        print("cpu (host clock; no device time)", flush=True)
    x, sy, sx = make_inputs(device)
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        for name, fn in (
                ("A torch.gather per image", lambda: variant_A(x, sy, sx)),
                ("B index_select, batch folded", lambda: variant_B(x, sy, sx)),
                ("E gather_bilinear kernel", lambda: variant_E(x, sy, sx)),
                ("grid_sample (library call)",
                 lambda: grid_sample_call(x_nchw, sy, sx))):
            print(f"{name}: {time_ms(fn, device, args.reps):.3f} ms/iter",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
