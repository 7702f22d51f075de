#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which must pass:
  1. toolchain: CUDA version, device, capability 9.0, power limit; build the
     DCN forward kernel from side_tpu_torch/csrc/dcn_fwd.cu;
  2. the kernel against its plain PyTorch version on the card at the 7
     distinct DeformBlock shapes of the serving path (B=2), in bf16 and f32
     with R=1, and R=-1 (exact) at one shape; times, bound, F.conv2d;
  3. the main path: Detector(Config()) at full width (384x1280, bf16, K=100)
     on random seeded weights (He-scaled, offset convs perturbed) runs 3
     frames of random 375x1242 stereo pairs through load_and_pre, dispatch
     and finish (Detector.run); every frame must launch the DCN kernel 16
     times and give K finite rows;
  4. a small-input check: the same network on the card and on the CPU (f32,
     TF32 off) agree to 1e-3 of each head's largest value.
Prints a `kernels` JSON line, the card's name and power limit, and, last,
{"ok": true, "device": {...}}.  Exits non-zero if any phase fails or no
CUDA device is present.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# the 7 distinct DeformBlock shapes of one serving frame (2 images):
# (Cin, H, W, Cout) -> number of DeformBlocks with that shape
SERVING_SHAPES = [
    ((512, 12, 40, 256), 1),
    ((256, 24, 80, 256), 1),
    ((256, 24, 80, 128), 2),
    ((256, 24, 80, 64), 1),
    ((128, 48, 160, 128), 2),
    ((128, 48, 160, 64), 4),
    ((64, 96, 320, 64), 5),
]
BATCH = 2
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,  # tensor cores, dense
              torch.float32: 67e12}    # f32 outside the tensor cores
# kernel vs plain version, max |diff| / max |plain|: f32 differs only in the
# order of the 9*Cin-term sums; bf16 output rounds once more (2 bf16 ulps)
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
REPS = 20
STAGES = ("tot", "pre", "net", "dec", "post")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    """A failed check fails the run (and, unlike assert, survives -O)."""
    if not ok:
        raise RuntimeError(msg)


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of fn() over `reps` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def power_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_toolchain() -> dict:
    from side_tpu_torch.ops.dcn_cuda import DCN_FWD
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(f"[toolchain] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} capability {cap}")
    log(f"[toolchain] nvidia-smi: {power_line()}")
    check(cap == (9, 0), f"needs a Hopper card (9.0), got {cap}")
    t0 = time.perf_counter()
    path = DCN_FWD.build()
    log(f"[toolchain] dcn_fwd built in {time.perf_counter() - t0:.2f} s "
        f"-> {path.name}")
    return {"name": name, "capability": cap}


def _inputs(cin, h, w, cout, dtype, gen):
    dev = "cuda"
    x = torch.randn(BATCH, h, w, cin, generator=gen, device=dev).to(dtype)
    off = (torch.rand(BATCH, h, w, 9, 2, generator=gen, device=dev) * 3.0
           - 1.5)
    mask = torch.rand(BATCH, h, w, 9, generator=gen, device=dev)
    wt = torch.randn(3, 3, cin, cout, generator=gen, device=dev) / (
        9 * cin) ** 0.5
    bias = torch.randn(cout, generator=gen, device=dev) * 0.1
    return x, off, mask, wt, bias


def _bound_ms(cin, h, w, cout, dtype):
    pix = BATCH * h * w
    flops = pix * 9 * cin * (2 * cout + 8)   # contraction + bilinear sample
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (pix * cin * item + pix * 27 * 4 + 9 * cin * cout * 4
              + cout * 4 + pix * cout * item)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_kernels() -> dict:
    from side_tpu_torch.ops.dcn_cuda import DCN_FWD
    from side_tpu_torch.ops.deform_conv import deform_conv_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    cases = [(shape, n, dtype, 1) for shape, n in SERVING_SHAPES
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(SERVING_SHAPES[4][0], 0, dtype, -1)
              for dtype in (torch.bfloat16, torch.float32)]
    with torch.inference_mode():
        for (cin, h, w, cout), n, dtype, radius in cases:
            x, off, mask, wt, bias = _inputs(cin, h, w, cout, dtype, gen)
            got = DCN_FWD(x, off, mask, wt, bias, radius)
            ref = deform_conv_plain(x, off, mask, wt, bias, radius)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            rel = diff / max(scale, 1e-30)
            ms = time_ms(lambda: DCN_FWD(x, off, mask, wt, bias, radius))
            plain_ms = time_ms(lambda: deform_conv_plain(
                x, off, mask, wt, bias, radius))
            xc = x.permute(0, 3, 1, 2).contiguous()
            wc = wt.permute(3, 2, 0, 1).contiguous().to(dtype)
            conv_ms = time_ms(lambda: F.conv2d(xc, wc, padding=1))
            bound, bound_by = _bound_ms(cin, h, w, cout, dtype)
            row = {"cin": cin, "h": h, "w": w, "cout": cout,
                   "dtype": str(dtype).replace("torch.", ""),
                   "radius": radius, "per_frame": n,
                   "max_abs_err": diff, "max_rel_err": rel,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": bound_by, "conv2d_ref_ms": conv_ms}
            rows.append(row)
            log(f"[kernel] {json.dumps(row)}")
            check(np.isfinite(diff) and rel <= TOLERANCE[dtype],
                  f"dcn_fwd disagrees with its plain version: {row}")
    return {"rows": rows}


def phase_main_path() -> dict:
    from side_tpu_torch.config import Config
    from side_tpu_torch.ops.dcn_cuda import DCN_FWD
    from side_tpu_torch.runtime.detector import Detector
    from side_tpu_torch.runtime.synthetic import (he_scale, kitti_calib,
                                                  perturb_offsets,
                                                  random_frame)
    cfg = Config()
    det = Detector(cfg)     # cuda by default
    he_scale(det.model)
    perturb_offsets(det.model, seed=1)
    rng = np.random.RandomState(0)
    calib = kitti_calib()
    frames = [random_frame(rng) for _ in range(3)]
    DCN_FWD.launches = 0
    outs, raw = [], []
    for f in frames:        # Detector.run, with the tail's raw rows kept
        pending = det.dispatch(det.load_and_pre(f, calib))
        raw.append(pending["handles"][0])
        outs.append(det.finish(pending))
    launches = DCN_FWD.launches
    for i, (out, rows) in enumerate(zip(outs, raw)):
        # every decoded slot's row, before the score filter: finite
        check(tuple(rows.shape) == (cfg.K, 13), f"rows {tuple(rows.shape)}")
        check(bool(torch.isfinite(rows).all()), f"frame {i}: non-finite rows")
        kept = [r for r in out["results"].values() if len(r)]
        for r in kept:
            check(r.shape[1] == 13 and np.isfinite(r).all(), str(r))
        log(f"[main] frame {i}: " + " ".join(
            f"{k} {out[k] * 1e3:.3f} ms" for k in STAGES) +
            f" | {sum(len(r) for r in kept)} rows above peak_thresh, "
            f"top score {rows[:, 12].max().item():.4f}")
    check(launches == 16 * len(frames),
          f"expected {16 * len(frames)} dcn_fwd launches, got {launches}")
    log(f"[main] dcn_fwd launches: {launches} over {len(frames)} frames")
    return {"launches": launches,
            "frames": [{k: out[k] for k in STAGES} for out in outs]}


def phase_small_reference() -> None:
    """The network on the card equals the network on the CPU (f32, small
    input, same weights; TF32 off)."""
    from side_tpu_torch.config import Config
    from side_tpu_torch.models.factory import create_model
    from side_tpu_torch.runtime.synthetic import he_scale, perturb_offsets
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(input_h=128, input_w=256, compute_dtype="float32", K=20)
    cpu = create_model(cfg, seed=3).eval()
    he_scale(cpu)
    perturb_offsets(cpu, seed=4)
    gpu = create_model(cfg, seed=3).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.cuda()
    gen = torch.Generator().manual_seed(5)
    batch = {"input": torch.randn(1, 128, 256, 3, generator=gen),
             "input_right": torch.randn(1, 128, 256, 3, generator=gen),
             "fb": torch.tensor([380.0])}
    with torch.inference_mode():
        want = cpu(batch)
        got = gpu({k: v.cuda() for k, v in batch.items()})
    for k in ("hm", "wh", "reg", "dim", "orien", "kept_type"):
        err = (got[k].cpu() - want[k]).abs().max().item()
        scale = want[k].abs().max().item()
        log(f"[small] {k}: max abs err {err:.3e} (max |ref| {scale:.3e})")
        check(scale > 1.0 and err <= 1e-3 * scale, f"{k}: {err} of {scale}")
    check(bool(torch.isfinite(got["depth"]).all()), "non-finite depth")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from side_tpu_torch.ops.dcn_cuda import DCN_FWD, SOURCE
    dev = phase_toolchain()
    kern = phase_kernels()
    main_path = phase_main_path()
    phase_small_reference()

    bf16 = [r for r in kern["rows"] if r["dtype"] == "bfloat16"
            and r["radius"] == 1]
    per_frame = lambda key: sum(r[key] * r["per_frame"] for r in bf16)
    # the frame's bound is the sum of the layers' bounds; name the kind of
    # limit that contributes most of it
    by_kind = {kind: sum(r["bound_ms"] * r["per_frame"] for r in bf16
                         if r["bound_by"] == kind)
               for kind in ("operations", "bytes")}
    bound_by = max(by_kind, key=by_kind.get)
    kernels = {"kernels": [{
        "name": "dcn_fwd", "route": "cuda",
        "source": str(SOURCE.relative_to(SOURCE.parents[2])),
        "replaces": "side_tpu/ops/dcn_pallas.py:240",
        "replaces_kernels": ["side_tpu/ops/dcn_pallas.py:240 _dcn_kernel",
                             "side_tpu/ops/dcn_pallas.py:402 "
                             "_dcn_kernel_packed"],
        "launches": main_path["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kern["rows"]),
        "max_rel_err_bf16": max(r["max_rel_err"] for r in kern["rows"]
                                if r["dtype"] == "bfloat16"),
        "max_rel_err_f32": max(r["max_rel_err"] for r in kern["rows"]
                               if r["dtype"] == "float32"),
        "ms": per_frame("ms"), "plain_ms": per_frame("plain_ms"),
        "bound_ms": per_frame("bound_ms"), "bound_by": bound_by,
        "library_ms": None,
        "conv2d_ref_ms": per_frame("conv2d_ref_ms"),
        "checked_shapes": len({(r["cin"], r["h"], r["w"], r["cout"])
                               for r in kern["rows"]}),
        "per_shape": kern["rows"],
    }]}
    print(json.dumps(kernels), flush=True)
    print(power_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
