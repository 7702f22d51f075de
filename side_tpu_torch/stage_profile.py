"""Where one serving frame's time goes on the GPU.

    python -m side_tpu_torch.stage_profile [--frames 5] [--out FILE]

Runs the flagship Detector (Config(): 384x1280 input, bf16, K=100) on
seeded random weights and random KITTI-size frames, as chip_smoke.py does,
and reports two things:

  * `stages`: each stage of a frame between `torch.cuda.synchronize()`
    fences, median over `--frames` frames after two warm-up frames: host
    load + pre-process (with the upload), network, decode, device tail (box
    solve, dense alignment, re-solve) and fetch;
  * `profile`: one more frame under torch.profiler: kernel launches, device
    busy time and its share of the frame's wall time, device time by kind
    of kernel and the 15 kernels of most device time.

Prints the card's name and power limit, then one JSON object per section;
with `--out` also writes them to FILE.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from .config import Config
from .runtime.detector import Detector
from .runtime.synthetic import (he_scale, kitti_calib, perturb_offsets,
                                random_frame)

KINDS = (  # first match wins; lower-case substrings of kernel names
    ("dcn_fwd", ("dcn_fwd",)),
    ("convolution", ("conv", "implicit", "cudnn", "winograd", "fprop")),
    ("matmul", ("gemm", "xmma", "cutlass", "cublas")),
    ("sort / top-k", ("sort", "radix", "topk")),
    ("copy / layout", ("copy", "memcpy", "memset", "cat", "transpose")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def _fenced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def frame_stages(det: Detector, frame, calib) -> dict:
    """One frame, each stage between device fences; times in ms."""
    from .postprocess.device_tail import run_tail
    pre, t_pre = _fenced(lambda: det.load_and_pre(frame, calib))
    out, t_net = _fenced(lambda: det.network(pre["batch"]))
    (dets, dets_r, info), t_dec = _fenced(lambda: det.decode(out))
    with torch.inference_mode():
        (rows, _), t_tail = _fenced(lambda: run_tail(
            dets[0], dets_r[0], info[0], pre["image"], pre["image_right"],
            pre["meta"], det.cfg))
    _, t_fetch = _fenced(lambda: rows.cpu().numpy())
    return {"pre": t_pre, "network": t_net, "decode": t_dec,
            "tail": t_tail, "fetch": t_fetch}


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile_frame(det: Detector, frame, calib) -> dict:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        det.run(frame, calib=calib)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"wall_ms": wall_us / 1e3,
                "device": "not measured: the profiler recorded no kernels"}
    by_name = defaultdict(lambda: [0, 0.0])
    by_kind = defaultdict(float)
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name][0] += 1
        by_name[e.name][1] += us
        by_kind[_kind(e.name)] += us
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    return {
        "wall_ms": wall_us / 1e3,
        "kernel_launches": len(kernels),
        "device_busy_ms": busy / 1e3,
        "device_busy_share": busy / wall_us,
        "by_kind_ms": {k: v / 1e3 for k, v in
                       sorted(by_kind.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n[:100], "launches": c, "ms": us / 1e3}
                        for n, (c, us) in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage_profile: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cfg = Config()
    det = Detector(cfg)
    he_scale(det.model)
    perturb_offsets(det.model, seed=1)
    rng = np.random.RandomState(0)
    calib = kitti_calib()
    frames = [random_frame(rng) for _ in range(args.frames + 3)]
    for f in frames[:2]:
        det.run(f, calib=calib)
    runs = [frame_stages(det, f, calib) for f in frames[2:-1]]
    stages = {"card": card, "frames": len(runs),
              "median_ms": {k: statistics.median(r[k] for r in runs)
                            for k in runs[0]},
              "min_ms": {k: min(r[k] for r in runs) for k in runs[0]},
              "max_ms": {k: max(r[k] for r in runs) for k in runs[0]}}
    prof = {"card": card, **profile_frame(det, frames[-1], calib)}
    lines = [json.dumps({"stages": stages}), json.dumps({"profile": prof})]
    for line in lines:
        print(line, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
