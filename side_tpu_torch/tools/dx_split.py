"""What the two halves of K2 (`dcn_bwd_dx`, d_x of the DCN) cost on the GPU.

    python -m side_tpu_torch.tools.dx_split [--reps 20] [--out FILE]

K2 forms gW = g·W_k^T per tap and scatters mask * corner weight * gW into
d_x.  csrc/dcn_bwd.cu compiles with -DDCN_DX_SPLIT=1 into a measurement
build that forms the product and leaves the scatter out (one store a
thread), and with -DDCN_DX_SPLIT=2 into one that leaves the product out (a
constant in its place) and keeps the scatter.  This tool builds both beside
the real library and times, at the 7 DeformBlock shapes of a training step
(B = 8, bf16, R = 1) and for each body of K2 ("cuda_core": the CUDA-core
kernel; "tile": the tensor-core kernel that scatters to device memory;
"routed": what the wrapper launches by itself, i.e. the tensor-core kernel
that keeps the scatter in the block where `dx_plan` says "patch", else the
tile kernel again): the whole wrapper call, the product alone and the
scatter alone; and, per shape, the memset of the f32 d_x plus its cast,
which the two device-memory bodies pay around the kernel (and which the
whole call's time includes).
Times are device times by CUDA events, median of `--reps`, each timed call
queued behind a short spin on the card.  Prints the card's name and power
limit, one JSON row per shape and body, and the sums over the 16 launches of
a step.  The measurement builds give wrong d_x by design and are used for
nothing else.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

from ..ops.dcn_cuda import (BWD_LIB, BWD_SIGNATURES, CudaLibrary,
                            DcnBackwardDx, _MMA_HEADERS, build_all, dx_plan)

# (Cin, H, W, Cout) -> DeformBlocks of that shape in one training step
SHAPES = [((512, 12, 40, 256), 1), ((256, 24, 80, 256), 1),
          ((256, 24, 80, 128), 2), ((256, 24, 80, 64), 1),
          ((128, 48, 160, 128), 2), ((128, 48, 160, 64), 4),
          ((64, 96, 320, 64), 5)]
BATCH = 8
BODIES = {"cuda_core": dict(cuda_core=True), "tile": dict(scatter="tile"),
          "routed": {}}
SPIN_CYCLES = 500_000


def time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dx_split: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    builds = {"whole": BWD_LIB}
    for name, value in (("product_only", 1), ("scatter_only", 2)):
        builds[name] = CudaLibrary(
            "dcn_bwd", BWD_SIGNATURES, "dcn_bwd_error_string",
            headers=_MMA_HEADERS, defines=(f"DCN_DX_SPLIT={value}",))
    build_all(list(builds.values()))
    kernels = {name: DcnBackwardDx(lib) for name, lib in builds.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (cin, h, w, cout), per_step in SHAPES:
        g = torch.randn(BATCH, h, w, cout, generator=gen,
                        device="cuda").bfloat16()
        off = torch.rand(BATCH, h, w, 9, 2, generator=gen,
                         device="cuda") * 3.0 - 1.5
        mask = torch.rand(BATCH, h, w, 9, generator=gen, device="cuda")
        wt = torch.randn(3, 3, cin, cout, generator=gen,
                         device="cuda") / (9 * cin) ** 0.5
        memset_cast = time_ms(lambda: torch.zeros(
            (BATCH, h, w, cin), dtype=torch.float32,
            device="cuda").to(torch.bfloat16), args.reps)
        scatter = dx_plan(BATCH, h, w, cin, cout, 1)["scatter"]
        for body, kw in BODIES.items():
            kept = body == "routed" and scatter == "patch"
            row = {"cin": cin, "h": h, "w": w, "cout": cout,
                   "per_step": per_step, "body": body,
                   "scatter": "device" if not kept else "block",
                   "memset_cast_ms": 0.0 if kept else memset_cast}
            for name, kern in kernels.items():
                row[f"{name}_ms"] = time_ms(
                    lambda: kern(g, off, mask, wt, 1, **kw), args.reps)
            rows.append(row)
            print(json.dumps(row), flush=True)
    sums = {body: {key: sum(r[key] * r["per_step"] for r in rows
                            if r["body"] == body)
                   for key in ("whole_ms", "product_only_ms",
                               "scatter_only_ms", "memset_cast_ms")}
            for body in BODIES}
    print(json.dumps({"per_step_ms": sums}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "per_step_ms": sums}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
