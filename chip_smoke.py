#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which must pass:
  1. toolchain: CUDA version, device, capability 9.0, power limit; build
     every kernel from side_tpu_torch/csrc (dcn_fwd.cu, dcn_bwd.cu,
     dcn_fwd_om.cu and gather_bilinear.cu, one nvcc each, started together);
  2. the forward kernel against its plain PyTorch version on the card at the
     7 distinct DeformBlock shapes of the serving path (B=2), in bf16 and
     f32 with R=1, and R=-1 (exact) at one shape; times, bound, F.conv2d;
  3. the serving path: Detector(Config()) at full width (384x1280, bf16,
     K=100) on random seeded weights (He-scaled, offset convs perturbed)
     runs 3 frames of random 375x1242 stereo pairs through load_and_pre,
     dispatch and finish (Detector.run); every frame must launch the DCN
     forward kernel 16 times, the backward kernels never, and give K finite
     rows;
  4. a small-input check: the same network on the card and on the CPU (f32,
     TF32 off) agree to 1e-3 of each head's largest value;
  5. the backward kernels K2 (dcn_bwd_dx) and K3 (dcn_bwd_dcoord) against
     autograd of the plain version on the card, every cotangent, at the 7
     DeformBlock shapes of a training step (B=8: 4 stereo pairs), bf16 and
     f32 with R=1, and R=-1 at one shape, offsets beyond +-R included;
     the forward kernel's output at the same shapes against the plain
     version's (phase 2's tolerance); times, plain times and bounds;
  6. the training path: Trainer(Config()) at full width (384x1280, bf16,
     max_objs 50, roi_size 16) on He-scaled seeded weights with perturbed
     offsets, fed 4 rendered stereo pairs held in memory, takes 1 warm-up
     and 3 timed steps (Trainer.train_step); every loss part finite, the
     parameters and BatchNorm statistics move, and the forward kernel, K2
     and K3 each launch 16 times per step; step time, its upload /
     forward / backward / optimizer split and the peak device memory;
  7. a small train-step check: one f32 step on the card and one on the CPU
     from the same weights and batch (TF32 off; the well-conditioned
     random point of tests/test_torch_train.py, offsets inside the
     window), in eval and in training-mode BatchNorm: losses to 1e-3;
     gradients, each relative to its tensor's largest value, to 1e-3 with
     running statistics, 0.4 at most and 3e-2 in the median with batch
     statistics (SMALL_TRAIN_BOUNDS); the CPU's own noise floor under a
     1e-6 input change, over three draws, is printed beside them;
  8. the fused forward kernel K4 (dcn_fwd_om) against its plain version and
     against dcn_fwd fed the split operands, at the 7 DeformBlock shapes
     with B=2 and B=8, bf16 and f32, offsets beyond +-1; the kernel's time,
     the time of the fused route for the layer (the NHWC copy of the conv's
     output + the kernel) and of the unfused route (split, sigmoid, casts,
     dcn_fwd), plain times and bounds;
  9. the gather kernel K5 (gather_bilinear) against its plain version at
     the probe's shape (x (2, 96, 320, 64) bf16, 552,960 samples) and in
     f32; time, bound, plain time and F.grid_sample's; then the probe's own
     entry point (side_tpu_torch.tools.gather_microbench), which must launch
     the kernel;
 10. the validation path: val.run_pass at full width over 10 rendered
     scenes held in memory, eval_batch 4 (3 groups of 8 images through the
     trunk, the last padded), fused switch on, pipelined: every group must
     launch dcn_fwd_om 16 times and dcn_fwd never; result files for exactly
     the 10 frames; the KITTI evaluator is built and run on them against
     the written ground truth and its AP lines parsed.  Then the same
     scenes frame by frame (eval_batch 1, unfused) and the rows of the two
     runs compared (VAL_MATCH_RULE); ms per image for eval_batch 1 and 4,
     fused and unfused; launches and device busy share of one group and of
     one frame.
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
# the 7 DeformBlock shapes of a training step run at 4 stereo pairs = 8
# images (both views through one trunk pass); same counts per image pair
TRAIN_BATCH = 8
BATCH = 2
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,  # tensor cores, dense
              torch.float32: 67e12}    # f32 outside the tensor cores
# kernel vs plain version, max |diff| / max |plain|: f32 differs only in the
# order of the 9*Cin-term sums; bf16 output rounds once more (2 bf16 ulps)
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
# K2/K3 vs autograd of the plain version, per cotangent, max |diff| / max
# |plain|: f32 sum order and atomics; bf16: the plain version also rounds
# the column gradient and d_x to bf16 (csrc/dcn_bwd.cu)
BWD_TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
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
    from side_tpu_torch.ops.dcn_cuda import all_libraries, build_all
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(f"[toolchain] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} capability {cap}")
    log(f"[toolchain] nvidia-smi: {power_line()}")
    check(cap == (9, 0), f"needs a Hopper card (9.0), got {cap}")
    t0 = time.perf_counter()
    paths = build_all()
    log(f"[toolchain] {', '.join(lib.source.name for lib in all_libraries())} "
        f"built in {time.perf_counter() - t0:.2f} s (one nvcc each, in "
        f"parallel) -> {', '.join(p.name for p in paths)}")
    return {"name": name, "capability": cap}


def _inputs(cin, h, w, cout, dtype, gen, batch=BATCH):
    dev = "cuda"
    x = torch.randn(batch, h, w, cin, generator=gen, device=dev).to(dtype)
    off = (torch.rand(batch, h, w, 9, 2, generator=gen, device=dev) * 3.0
           - 1.5)
    mask = torch.rand(batch, h, w, 9, generator=gen, device=dev)
    wt = torch.randn(3, 3, cin, cout, generator=gen, device=dev) / (
        9 * cin) ** 0.5
    bias = torch.randn(cout, generator=gen, device=dev) * 0.1
    return x, off, mask, wt, bias


def _bound_ms(cin, h, w, cout, dtype, batch=BATCH):
    pix = batch * h * w
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
    from side_tpu_torch.ops.dcn_cuda import KERNELS
    cfg = Config()
    det = Detector(cfg)     # cuda by default
    he_scale(det.model)
    perturb_offsets(det.model, seed=1)
    rng = np.random.RandomState(0)
    calib = kitti_calib()
    frames = [random_frame(rng) for _ in range(3)]
    for kern in KERNELS.values():
        kern.launches = 0
    outs, raw = [], []
    for f in frames:        # Detector.run, with the tail's raw rows kept
        pending = det.dispatch(det.load_and_pre(f, calib))
        raw.append(pending["handles"][0])
        outs.append(det.finish(pending))
    launches = DCN_FWD.launches
    bwd_launches = sum(k.launches for k in KERNELS.values()) - launches
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
    check(bwd_launches == 0, f"serving launched {bwd_launches} backward "
          "kernels")
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


def _bwd_bound_ms(cin, h, w, cout, dtype):
    """Least time of K2 and K3 at one shape: FLOPs over the dtype's peak
    (the in-kernel products g·W_k^T and, for K3, col^T·g, plus the per-
    sample arithmetic) against the bytes each must move (inputs read once,
    outputs written once) over the memory rate."""
    pix = TRAIN_BATCH * h * w
    item = torch.tensor([], dtype=dtype).element_size()
    mac = pix * 9 * cin * cout
    geo = pix * 27 * 4 + 9 * cin * cout * 4          # offsets, mask, weight
    g_bytes = pix * cout * item
    dx = {"flops": 2 * mac + pix * 9 * cin * 9,      # + mask*w_q, 4 corners
          "bytes": g_bytes + geo + pix * cin * item}
    dc = {"flops": 4 * mac + pix * 9 * cin * 30,     # + col, val, derivatives
          "bytes": pix * cin * item + g_bytes + geo + pix * 27 * 4
          + 9 * cin * cout * 4}
    out = {}
    for name, work in (("dcn_bwd_dx", dx), ("dcn_bwd_dcoord", dc)):
        t_ops = work["flops"] / PEAK_FLOPS[dtype]
        t_bytes = work["bytes"] / HBM_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def phase_backward_kernels() -> dict:
    """The forward kernel against the plain version, and K2 and K3 against
    its autograd, at the training shapes; per kernel and case the largest
    error over its outputs."""
    from side_tpu_torch.ops.dcn_cuda import (DCN_BWD_DCOORD, DCN_BWD_DX,
                                             DCN_FWD)
    from side_tpu_torch.ops.deform_conv import DcnFunction, deform_conv_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    rows = []
    cases = [(shape, n, dtype, 1) for shape, n in SERVING_SHAPES
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(SERVING_SHAPES[4][0], 0, dtype, -1)
              for dtype in (torch.bfloat16, torch.float32)]
    for (cin, h, w, cout), n, dtype, radius in cases:
        x, off, mask, wt, bias = _inputs(cin, h, w, cout, dtype, gen,
                                         TRAIN_BATCH)
        g = torch.randn(x.shape[:3] + (cout,), generator=gen,
                        device="cuda").to(dtype)
        leaves = [t.clone().requires_grad_(True)
                  for t in (x, off, mask, wt, bias)]
        out = DcnFunction.apply(*leaves, radius)
        out.backward(g)
        got = [out.detach()] + [t.grad for t in leaves[:4]]
        ref_in = [t.clone().requires_grad_(True)
                  for t in (x, off, mask, wt, bias)]
        ref_out = deform_conv_plain(*ref_in, radius)
        want = [ref_out.detach()] + list(torch.autograd.grad(
            ref_out, ref_in[:4], g, retain_graph=True))
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(("out", "x", "offset", "mask", "weight"),
                              got, want):
            diff = (a.float() - b.float()).abs().max().item()
            errs[name] = (diff, diff / max(b.float().abs().max().item(),
                                           1e-30))
        with torch.no_grad():
            fwd_ms = time_ms(lambda: DCN_FWD(x, off, mask, wt, bias, radius))
            fwd_plain = time_ms(lambda: deform_conv_plain(
                x, off, mask, wt, bias, radius))
        k2_ms = time_ms(lambda: DCN_BWD_DX(g, off, mask, wt, radius))
        k3_ms = time_ms(lambda: DCN_BWD_DCOORD(x, g, off, mask, wt, radius))
        k2_plain = time_ms(lambda: torch.autograd.grad(
            ref_out, ref_in[0], g, retain_graph=True))
        k3_plain = time_ms(lambda: torch.autograd.grad(
            ref_out, ref_in[1:4], g, retain_graph=True))
        bounds = _bwd_bound_ms(cin, h, w, cout, dtype)
        bounds["dcn_fwd"] = _bound_ms(cin, h, w, cout, dtype, TRAIN_BATCH)
        del ref_out
        for name, ms, plain_ms, parts in (
                ("dcn_fwd", fwd_ms, fwd_plain, ("out",)),
                ("dcn_bwd_dx", k2_ms, k2_plain, ("x",)),
                ("dcn_bwd_dcoord", k3_ms, k3_plain,
                 ("offset", "mask", "weight"))):
            row = {"kernel": name, "cin": cin, "h": h, "w": w, "cout": cout,
                   "dtype": str(dtype).replace("torch.", ""),
                   "radius": radius, "per_step": n,
                   "max_abs_err": max(errs[p][0] for p in parts),
                   "max_rel_err": max(errs[p][1] for p in parts),
                   "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
            rows.append(row)
            log(f"[backward] {json.dumps(row)}")
            tol = (TOLERANCE if name == "dcn_fwd" else BWD_TOLERANCE)[dtype]
            check(np.isfinite(row["max_rel_err"]) and
                  row["max_rel_err"] <= tol,
                  f"{name} disagrees with the plain version: {row} {errs}")
    return {"rows": rows}


def _batch_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith("running_mean") or k.endswith("running_var")}


def phase_training(steps: int = 3) -> dict:
    """The training path at full width: 1 warm-up + `steps` timed steps of
    Trainer.train_step; then one more step split into upload, forward,
    backward and optimizer between fences (not part of the counted run)."""
    from side_tpu_torch.ops.dcn_cuda import KERNELS
    from side_tpu_torch.stage_profile import flagship_trainer, step_stages
    t0 = time.perf_counter()
    tr, batches = flagship_trainer(steps + 2)          # cuda by default
    cfg, model = tr.cfg, tr.model
    log(f"[train] Trainer and {len(batches)} batches of {cfg.batch_size} "
        f"rendered pairs in {time.perf_counter() - t0:.2f} s (set-up)")
    params0 = {k: v.detach().clone() for k, v in tr.params.items()}
    stats0 = _batch_stats(model)
    torch.cuda.reset_peak_memory_stats()
    for kern in KERNELS.values():
        kern.launches = 0
    step_ms, losses = [], []
    for i in range(steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = tr.train_step(tr.to_device(batches[i]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in stats.items()})
    launches = {name: k.launches for name, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    for i, (ms, st) in enumerate(zip(step_ms, losses)):
        log(f"[train] step {i}{' (warm-up)' if i == 0 else ''}: {ms:.1f} ms "
            + " ".join(f"{k} {v:.4f}" for k, v in st.items()))
        check(all(np.isfinite(v) for v in st.values()),
              f"step {i}: non-finite loss part {st}")
    n_steps = steps + 1
    for name, count in launches.items():
        # the fused forward has no backward: training never takes it
        want = 0 if name == "dcn_fwd_om" else 16 * n_steps
        check(count == want, f"{name}: {count} launches in {n_steps} steps, "
              f"expected {want}")
    moved = sum(not torch.equal(params0[k], v.detach())
                for k, v in tr.params.items())
    check(moved >= len(params0) - 6, f"only {moved} of {len(params0)} "
          "parameter tensors changed")
    stats1 = _batch_stats(model)
    bs_moved = sum(not torch.equal(stats0[k], v) for k, v in stats1.items())
    check(bs_moved == len(stats0), f"only {bs_moved} of {len(stats0)} "
          "BatchNorm statistics changed")
    split = step_stages(tr, batches[-1])    # one more batch, between fences
    timed = step_ms[1:]
    out = {"step_ms": timed, "step_ms_median": statistics.median(timed),
           "warmup_ms": step_ms[0], "split": split,
           "peak_mem_gib": peak / 2 ** 30, "launches": launches,
           "steps": n_steps, "pairs_per_step": cfg.batch_size,
           "params_moved": moved, "params": len(params0)}
    log(f"[train] {json.dumps(out)}")
    return out


# the small card-vs-CPU train step: bounds on (loss parts, relative; each
# gradient's error over its tensor's largest value, worst and median over
# tensors).  The weights are drawn as in tests/test_torch_train.py, where
# eval-mode BatchNorm is well conditioned: every gradient to 1e-3, as
# there (on an H100 machine card vs CPU gave 1.4e-4; the printed CPU floor
# under a 1e-6 input change, a larger move than sum order, 1.2e-3).
# Batch statistics over few samples per channel amplify f32 sum-order
# noise: that floor, over NOISE_SEEDS, is 0.196 worst and 1.2e-2 median
# there, so train mode is held to twice that worst and to the test's 3e-2
# median.  The DCN kernels' backward runs in both modes.
SMALL_TRAIN_BOUNDS = {"eval": (1e-3, 1e-3, 1e-3),
                      "train": (1e-3, 0.4, 3e-2)}
NOISE_SEEDS = (33, 34, 35)


def _small_train_step(cfg, base, batch, dev, mode, noise=None):
    """Loss parts and gradients of one f32 train step of a copy of `base`
    on `dev`, its normalised input moved by `noise` if given."""
    from side_tpu_torch.models.factory import create_model
    from side_tpu_torch.runtime.trainer import Trainer, normalize_images
    model = create_model(cfg, seed=0)
    model.load_state_dict(base.state_dict())
    tr = Trainer(cfg, model, steps_per_epoch=10, device=dev)
    model.train(mode == "train")
    b = tr.to_device(batch)
    if noise is not None:
        b["input"] = normalize_images(b, tr.mean, tr.std)["input"] + \
            noise.to(tr.device)
    total, stats = tr.loss(b)
    total.backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             .detach().cpu() for k, p in tr.params.items()}
    return {k: v.item() for k, v in stats.items()}, grads


def _step_errors(want, got) -> dict:
    """Largest relative loss-part error; per gradient tensor max |diff|
    over max |want| (floored at 1e-4 of the largest gradient: a bias that
    feeds a batch-statistics BatchNorm has a gradient of 0 up to float
    residue), worst and median over tensors."""
    (want_s, want_g), (got_s, got_g) = want, got
    loss_err = max(abs(got_s[k] - v) / max(abs(v), 1e-3)
                   for k, v in want_s.items())
    top = max(float(g.abs().max()) for g in want_g.values())
    errs = [float((got_g[k] - g).abs().max()) /
            max(float(g.abs().max()), 1e-4 * top)
            for k, g in want_g.items()]
    return {"loss_rel_err": loss_err, "grad_err_max": max(errs),
            "grad_err_median": statistics.median(errs)}


def small_train_setup():
    """Config, seeded well-conditioned weights (interior_init) and one
    rendered batch of 2 pairs at 128x256, f32, --uncert."""
    from side_tpu_torch.config import Config
    from side_tpu_torch.data.synthetic import scene_batch
    from side_tpu_torch.models.factory import create_model
    from side_tpu_torch.runtime.synthetic import interior_init
    cfg = Config(input_h=128, input_w=256, compute_dtype="float32",
                 max_objs=8, roi_size=8, uncert=True)
    batch = scene_batch(cfg, np.random.RandomState(30), 2, cfg.max_objs)
    base = create_model(cfg, seed=31)
    interior_init(base, seed=32)
    return cfg, base, batch


def cpu_noise_floor(cfg, base, batch, mode, cpu=None) -> dict:
    """The CPU step against itself with the normalised input moved by
    normal noise of standard deviation 1e-6, one draw per seed of
    NOISE_SEEDS: the worst of each error over the draws."""
    cpu = cpu or _small_train_step(cfg, base, batch, "cpu", mode)
    runs = [_step_errors(cpu, _small_train_step(
        cfg, base, batch, "cpu", mode, torch.randn(
            batch["input"].shape,
            generator=torch.Generator().manual_seed(s)) * 1e-6))
        for s in NOISE_SEEDS]
    return {k: max(r[k] for r in runs) for k in runs[0]}


def phase_small_train_reference() -> dict:
    """One f32 train step on the card against the same on the CPU (the
    plain DCN with autograd): the kernel path against the plain path end to
    end, with --uncert, at the well-conditioned random point of
    tests/test_torch_train.py (offsets inside the window, off the kinks of
    the bilinear derivative) and to its bounds.  The CPU's own noise floor
    under a 1e-6 input change is printed beside the card-vs-CPU errors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, base, batch = small_train_setup()
    out = {}
    for mode in ("train", "eval"):
        cpu = _small_train_step(cfg, base, batch, "cpu", mode)
        out[mode] = _step_errors(cpu, _small_train_step(
            cfg, base, batch, "cuda", mode))
        out[mode]["cpu_noise_floor"] = cpu_noise_floor(cfg, base, batch,
                                                       mode, cpu)
        log(f"[small-train] {mode}-mode BatchNorm, card vs CPU: "
            f"{json.dumps(out[mode])}")
        bounds = dict(zip(("loss_rel_err", "grad_err_max",
                           "grad_err_median"), SMALL_TRAIN_BOUNDS[mode]))
        check(all(out[mode][k] <= b for k, b in bounds.items()),
              f"{mode}: card and CPU train steps disagree: {out[mode]} "
              f"(bounds {bounds})")
    return out


def _om_inputs(cin, h, w, cout, dtype, gen, batch):
    """x, the raw offset/mask conv output om (dy, dx ~ U(-1.5, 1.5), mask
    logits ~ N(0, 1.5), in x's dtype), weight and bias."""
    dev = "cuda"
    x = torch.randn(batch, h, w, cin, generator=gen, device=dev).to(dtype)
    om = torch.empty(batch, h, w, 9, 3, device=dev)
    om[..., :2] = torch.rand(batch, h, w, 9, 2, generator=gen,
                             device=dev) * 3.0 - 1.5
    om[..., 2] = torch.randn(batch, h, w, 9, generator=gen, device=dev) * 1.5
    wt = torch.randn(3, 3, cin, cout, generator=gen, device=dev) / (
        9 * cin) ** 0.5
    bias = torch.randn(cout, generator=gen, device=dev) * 0.1
    return x, om.reshape(batch, h, w, 27).to(dtype), wt, bias


def _om_bound_ms(cin, h, w, cout, dtype, batch):
    """K1's operations; bytes with om at 27 values of x's dtype a pixel."""
    pix = batch * h * w
    flops = pix * 9 * cin * (2 * cout + 8)
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (pix * cin * item + pix * 27 * item + 9 * cin * cout * 4
              + cout * 4 + pix * cout * item)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _unfused_route(x, om, wt, bias, radius):
    """What `deform_block_om` does after the conv with the switch off; `om`
    as the conv leaves it, an NHWC view of an NCHW tensor."""
    from side_tpu_torch.ops.dcn_cuda import DCN_FWD
    om5 = om.reshape(*om.shape[:3], 9, 3)
    offset = om5[..., 0:2].float().contiguous()
    mask = torch.sigmoid(om5[..., 2].float()).contiguous()
    return DCN_FWD(x, offset, mask, wt, bias, radius)


def phase_fused_kernel() -> dict:
    from side_tpu_torch.ops.dcn_cuda import DCN_FWD_OM
    from side_tpu_torch.ops.deform_conv import deform_conv_om_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(40)
    rows = []
    with torch.inference_mode():
        for batch in (2, 8):
            for (cin, h, w, cout), n in SERVING_SHAPES:
                for dtype in (torch.bfloat16, torch.float32):
                    x, om, wt, bias = _om_inputs(cin, h, w, cout, dtype, gen,
                                                 batch)
                    got = DCN_FWD_OM(x, om, wt, bias, 1)
                    ref = deform_conv_om_plain(x, om, wt, bias, 1)
                    # as the model's conv leaves it: NCHW memory, NHWC view
                    om_view = om.permute(0, 3, 1, 2).contiguous().permute(
                        0, 2, 3, 1)
                    split = _unfused_route(x, om_view, wt, bias, 1)
                    torch.cuda.synchronize()
                    scale = max(ref.float().abs().max().item(), 1e-30)
                    diff = (got.float() - ref.float()).abs().max().item()
                    diff_k1 = (got.float() - split.float()).abs().max().item()
                    ms = time_ms(lambda: DCN_FWD_OM(x, om, wt, bias, 1))
                    fused_ms = time_ms(lambda: DCN_FWD_OM(
                        x, om_view.contiguous(), wt, bias, 1))
                    unfused_ms = time_ms(lambda: _unfused_route(
                        x, om_view, wt, bias, 1))
                    plain_ms = time_ms(lambda: deform_conv_om_plain(
                        x, om, wt, bias, 1), reps=5, warmup=1)
                    bound, bound_by = _om_bound_ms(cin, h, w, cout, dtype,
                                                   batch)
                    row = {"kernel": "dcn_fwd_om", "batch": batch,
                           "cin": cin, "h": h, "w": w, "cout": cout,
                           "dtype": str(dtype).replace("torch.", ""),
                           "radius": 1, "per_group": n,
                           "max_abs_err": diff, "max_rel_err": diff / scale,
                           "max_rel_err_vs_dcn_fwd": diff_k1 / scale,
                           "ms": ms, "fused_route_ms": fused_ms,
                           "unfused_route_ms": unfused_ms,
                           "plain_ms": plain_ms, "bound_ms": bound,
                           "bound_by": bound_by}
                    rows.append(row)
                    log(f"[fused] {json.dumps(row)}")
                    check(np.isfinite(diff) and
                          row["max_rel_err"] <= TOLERANCE[dtype] and
                          row["max_rel_err_vs_dcn_fwd"] <= TOLERANCE[dtype],
                          f"dcn_fwd_om disagrees: {row}")
    return {"rows": rows}


def phase_gather_kernel() -> dict:
    """K5 at the probe's shape, then the probe itself."""
    from side_tpu_torch.ops.gather_cuda import (GATHER_BILINEAR,
                                                gather_bilinear_plain)
    from side_tpu_torch.tools import gather_microbench as probe
    rows = []
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            x, sy, sx = probe.make_inputs("cuda", dtype)
            y0, x0, fy, fx = (t.contiguous() for t in probe.corners(sy, sx))
            got = GATHER_BILINEAR(x, y0, x0, fy, fx)
            ref = gather_bilinear_plain(x, y0, x0, fy, fx)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs()
            if dtype == torch.float32:
                ok = diff.max().item() <= 1e-6 * ref.abs().max().item()
            else:
                # one bf16 ulp of each value, plus the f32 noise of the sum
                # (fused multiply-adds) where the four terms cancel
                top = ref.float().abs().max().item()
                ok = bool((diff <= ref.float().abs() * 2.0 ** -7
                           + 1e-6 * top).all())
            item = x.element_size()
            nbytes = (got.numel() * item + x.numel() * item
                      + y0.numel() * 16)
            flops = got.numel() * 8
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / PEAK_FLOPS[torch.float32]
            x_nchw = x.permute(0, 3, 1, 2).contiguous()
            row = {"kernel": "gather_bilinear",
                   "dtype": str(dtype).replace("torch.", ""),
                   "x": list(x.shape), "samples": y0.numel(),
                   "max_abs_err": diff.max().item(),
                   "ms": time_ms(lambda: GATHER_BILINEAR(x, y0, x0, fy, fx)),
                   "plain_ms": time_ms(lambda: gather_bilinear_plain(
                       x, y0, x0, fy, fx)),
                   "library_ms": time_ms(lambda: probe.grid_sample_call(
                       x_nchw, sy, sx)),
                   "bytes": nbytes,
                   "bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            rows.append(row)
            log(f"[gather] {json.dumps(row)}")
            check(ok, f"gather_bilinear disagrees with its plain version: "
                  f"{row}")
    GATHER_BILINEAR.launches = 0
    check(probe.main(["--reps", "5"]) == 0, "the gather probe failed")
    launches = GATHER_BILINEAR.launches
    check(launches > 0, "the gather probe never launched gather_bilinear")
    log(f"[gather] probe entry point: {launches} launches of the kernel")
    return {"rows": rows, "launches": launches}


# How the rows of two validation runs over the same frames are compared
# (eval_batch 4 fused against eval_batch 1 unfused, bf16, random weights).
# cuDNN picks other algorithms at other batch sizes and the two DCN routes
# sum in another order, so in bf16 the heads differ at the 1e-2 level and
# the top-K order among near-equal scores changes.  So slots are not
# compared by rank: a slot of one run is matched to the slot of the other
# run of the same class whose left-box centre is nearest, if within
# `centre_px` pixels.  At least `min_matched` of the K slots of every frame
# must match, and over the matched pairs of all frames the median
# differences of the score and of the box corners (pixels) must stay within
# `score` and `box_px`.  The 3D columns go through the box solver and the
# argmin of the alignment, which amplify those differences: their medians
# are printed, not bounded.
VAL_MATCH_RULE = {"centre_px": 6.0, "min_matched": 0.5, "score": 0.05,
                  "box_px": 2.0}


def _match_rows(a: np.ndarray, ca: np.ndarray, b: np.ndarray,
                cb: np.ndarray):
    """Index pairs (i, j): row i of `a` and its nearest row j of `b` of the
    same class by box centre, within VAL_MATCH_RULE["centre_px"]."""
    centre = lambda r: np.stack([(r[:, 1] + r[:, 3]) / 2,
                                 (r[:, 2] + r[:, 4]) / 2], 1)
    d = np.linalg.norm(centre(a)[:, None] - centre(b)[None], axis=2)
    d[ca[:, None] != cb[None]] = np.inf
    j = d.argmin(1)
    ok = d[np.arange(len(a)), j] <= VAL_MATCH_RULE["centre_px"]
    return np.flatnonzero(ok), j[ok]


class _RecordingDetector:
    """Forwards to a Detector; records each dispatch's kernel launches and
    the raw rows of every frame (before the score filter)."""

    def __init__(self, det, kernels):
        self._det, self._kernels = det, kernels
        self.group_launches, self.raw = [], []

    def __getattr__(self, name):
        return getattr(self._det, name)

    def _counted(self, fn, *a, **kw):
        before = {k: v.launches for k, v in self._kernels.items()}
        out = fn(*a, **kw)
        self.group_launches.append(
            {k: v.launches - before[k] for k, v in self._kernels.items()})
        return out

    def dispatch(self, pre, run_align=True):
        out = self._counted(self._det.dispatch, pre, run_align=run_align)
        self.raw.append(tuple(h[None] for h in out["handles"]))
        return out

    def dispatch_batch(self, pres, run_align=True):
        out = self._counted(self._det.dispatch_batch, pres,
                            run_align=run_align)
        self.raw.append(out["handles"])
        return out


def phase_validation(n_scenes: int = 10, eval_batch: int = 4) -> dict:
    import os
    import tempfile
    from side_tpu_torch import val
    from side_tpu_torch.config import CLASS_NAMES, Config
    from side_tpu_torch.data.synthetic import val_scenes
    from side_tpu_torch.ops import deform_conv as dc
    from side_tpu_torch.ops.dcn_cuda import KERNELS
    from side_tpu_torch.postprocess.post_process import save_kitti_results
    from side_tpu_torch.runtime.detector import Detector
    from side_tpu_torch.runtime.evaluator import run_eval
    from side_tpu_torch.runtime.synthetic import he_scale, perturb_offsets
    from side_tpu_torch.stage_profile import profile_call
    cfg = Config()
    det = Detector(cfg)         # cuda by default
    he_scale(det.model)
    perturb_offsets(det.model, seed=1)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        gt_dir = os.path.join(tmp, "label_2")
        scenes = val_scenes(n_scenes, seed=50, label_dir=gt_dir)

        def run(eb, fused, record=True):
            rec = _RecordingDetector(det, KERNELS)
            t0 = time.perf_counter()
            with dc.dcn_fused(fused):
                results, meters, steady = val.run_pass(
                    cfg, scenes, rec if record else det, n=n_scenes,
                    eval_batch=eb)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n_scenes
            return rec, results, steady, wall

        # the counted run: every count set to 0 just before, read just after
        for kern in KERNELS.values():
            kern.launches = 0
        rec4, results4, _, _ = run(eval_batch, True)
        launches = {k: v.launches for k, v in KERNELS.items()}
        n_groups = -(-n_scenes // eval_batch)
        check(len(rec4.group_launches) == n_groups,
              f"{len(rec4.group_launches)} groups, expected {n_groups}")
        for i, g in enumerate(rec4.group_launches):
            check(g["dcn_fwd_om"] == 16 and g["dcn_fwd"] == 0 and
                  g["dcn_bwd_dx"] == 0 and g["dcn_bwd_dcoord"] == 0,
                  f"group {i} launched {g}, expected 16 dcn_fwd_om only")
        check(sorted(results4) == list(range(n_scenes)),
              f"results for frames {sorted(results4)}")
        res_dir = save_kitti_results(results4, tmp, CLASS_NAMES)
        files = sorted(os.listdir(res_dir))
        check(files == [f"{i:06d}.txt" for i in range(n_scenes)],
              f"result files {files}")
        rows4 = torch.cat([r[0] for r in rec4.raw])[:n_scenes]
        cls4 = torch.cat([r[1] for r in rec4.raw])[:n_scenes]
        check(tuple(rows4.shape) == (n_scenes, cfg.K, 13) and
              bool(torch.isfinite(rows4).all()),
              f"validation rows {tuple(rows4.shape)} not finite")
        n_dets = sum(len(r) for per in results4.values()
                     for r in per.values())
        aps = run_eval(res_dir, gt_dir)
        check(any(k.endswith("_detection") for k in aps) and
              all(len(v) == 3 and all(np.isfinite(v)) for v in aps.values()),
              f"the evaluator's AP lines did not parse: {aps} "
              f"({n_dets} detections written)")
        log(f"[val] eval_batch {eval_batch} fused: {n_groups} groups, "
            f"launches {launches}, {n_dets} detections above peak_thresh in "
            f"{len(files)} files, AP {json.dumps(aps)}")

        # the same scenes frame by frame, unfused
        rec1, results1, _, _ = run(1, False)
        check(all(g["dcn_fwd"] == 16 and g["dcn_fwd_om"] == 0
                  for g in rec1.group_launches) and
              len(rec1.group_launches) == n_scenes,
              f"eval_batch 1 unfused launched {rec1.group_launches}")
        rows1 = torch.cat([r[0] for r in rec1.raw]).cpu().numpy()
        cls1 = torch.cat([r[1] for r in rec1.raw]).cpu().numpy()
        rows4, cls4 = rows4.cpu().numpy(), cls4.cpu().numpy()
        fractions, diffs = [], []
        for f in range(n_scenes):
            i, j = _match_rows(rows4[f], cls4[f], rows1[f], cls1[f])
            fractions.append(len(i) / cfg.K)
            diffs.append(np.abs(rows4[f][i] - rows1[f][j]))
        diffs = np.concatenate(diffs)
        med = np.median(diffs, axis=0)
        match = {"matched_fraction_min": min(fractions),
                 "matched_fraction_mean": float(np.mean(fractions)),
                 "pairs": len(diffs),
                 "median_abs_diff": {
                     "score": float(med[12]), "box_px": float(med[1:5].max()),
                     "alpha": float(med[0]), "dim": float(med[5:8].max()),
                     "xyz": float(med[8:11].max()), "ry": float(med[11])}}
        log(f"[val] eval_batch {eval_batch} fused vs eval_batch 1 unfused "
            f"(rule {json.dumps(VAL_MATCH_RULE)}): {json.dumps(match)}")
        check(match["matched_fraction_min"] >= VAL_MATCH_RULE["min_matched"]
              and match["median_abs_diff"]["score"] <= VAL_MATCH_RULE["score"]
              and match["median_abs_diff"]["box_px"]
              <= VAL_MATCH_RULE["box_px"],
              f"the two validation runs disagree: {match}")

        # times, warm: one more pass each
        times = {}
        for eb in (1, eval_batch):
            for fused in (False, True):
                _, _, steady, wall = run(eb, fused, record=False)
                times[f"eval_batch_{eb}_{'fused' if fused else 'unfused'}"] \
                    = {"steady_ms_per_image": steady,
                       "wall_ms_per_image": wall}
        log(f"[val] ms per image, pipelined, warm: {json.dumps(times)}")

        # launches and busy share: one batched group and one frame
        def one_group(eb):
            pres = [det.load_and_pre(pair, calib)
                    for _, pair, calib in scenes[:eb]]
            if eb == 1:
                return det.finish(det.dispatch(pres[0]))
            return det.finish_batch(det.dispatch_batch(pres))

        profiles = {}
        with dc.dcn_fused(True):
            for eb in (eval_batch, 1):
                prof = profile_call(lambda: one_group(eb))
                profiles[f"eval_batch_{eb}"] = {
                    k: prof.get(k) for k in
                    ("wall_ms", "kernel_launches", "device_busy_ms",
                     "device_busy_share", "by_kind_ms", "device")}
        log(f"[val] one group under torch.profiler (fused): "
            f"{json.dumps(profiles)}")
    out.update(launches=launches, groups=n_groups, aps=aps, match=match,
               times=times, profiles=profiles, detections=n_dets)
    return out


def _per_unit(rows, key, count_key):
    return sum(r[key] * r[count_key] for r in rows)


def _bound_by(rows, count_key):
    """The kind of limit that contributes most of the summed bound."""
    by_kind = {kind: sum(r["bound_ms"] * r[count_key] for r in rows
                         if r["bound_by"] == kind)
               for kind in ("operations", "bytes")}
    return max(by_kind, key=by_kind.get)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from side_tpu_torch.ops.dcn_cuda import BWD_LIB, FWD_LIB, OM_LIB
    from side_tpu_torch.ops.gather_cuda import GATHER_LIB
    t_start = time.perf_counter()
    dev = phase_toolchain()
    kern = phase_kernels()
    main_path = phase_main_path()
    phase_small_reference()
    bwd = phase_backward_kernels()
    train = phase_training()
    small_train = phase_small_train_reference()
    fused = phase_fused_kernel()
    gather = phase_gather_kernel()
    validation = phase_validation()

    bf16 = [r for r in kern["rows"] if r["dtype"] == "bfloat16"
            and r["radius"] == 1]
    fwd_rows = kern["rows"] + [r for r in bwd["rows"]
                               if r["kernel"] == "dcn_fwd"]
    fwd_step = [r for r in bwd["rows"] if r["kernel"] == "dcn_fwd"
                and r["dtype"] == "bfloat16" and r["radius"] == 1]
    root = FWD_LIB.source.parents[2]
    entries = [{
        "name": "dcn_fwd", "route": "cuda",
        "source": str(FWD_LIB.source.relative_to(root)),
        "replaces": "side_tpu/ops/dcn_pallas.py:240",
        "replaces_kernels": ["side_tpu/ops/dcn_pallas.py:240 _dcn_kernel",
                             "side_tpu/ops/dcn_pallas.py:402 "
                             "_dcn_kernel_packed"],
        "launches": main_path["launches"],
        "launches_path": "serving, 3 frames",
        "launches_training": train["launches"]["dcn_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in fwd_rows),
        "max_rel_err_bf16": max(r["max_rel_err"] for r in fwd_rows
                                if r["dtype"] == "bfloat16"),
        "max_rel_err_f32": max(r["max_rel_err"] for r in fwd_rows
                               if r["dtype"] == "float32"),
        "ms": _per_unit(bf16, "ms", "per_frame"),
        "plain_ms": _per_unit(bf16, "plain_ms", "per_frame"),
        "bound_ms": _per_unit(bf16, "bound_ms", "per_frame"),
        "bound_by": _bound_by(bf16, "per_frame"),
        "library_ms": None,
        "unit": "one serving frame (16 launches, B=2, bf16)",
        "conv2d_ref_ms": _per_unit(bf16, "conv2d_ref_ms", "per_frame"),
        "training_step": {
            key: _per_unit(fwd_step, key, "per_step")
            for key in ("ms", "plain_ms", "bound_ms")},
        "checked_shapes": {
            path: len({(r["cin"], r["h"], r["w"], r["cout"]) for r in rows})
            for path, rows in (
                ("serving, B=2", kern["rows"]),
                ("training, B=8", fwd_rows[len(kern["rows"]):]))},
        "per_shape": fwd_rows,
    }]
    for name, replaces in (("dcn_bwd_dx",
                            "side_tpu/ops/dcn_pallas_bwd.py:104"),
                           ("dcn_bwd_dcoord",
                            "side_tpu/ops/dcn_pallas_bwd.py:193")):
        rows = [r for r in bwd["rows"] if r["kernel"] == name]
        step = [r for r in rows if r["dtype"] == "bfloat16"
                and r["radius"] == 1]
        entries.append({
            "name": name, "route": "cuda",
            "source": str(BWD_LIB.source.relative_to(root)),
            "replaces": replaces,
            "launches": train["launches"][name],
            "launches_path": f"training, {train['steps']} steps",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err_bf16": max(r["max_rel_err"] for r in rows
                                    if r["dtype"] == "bfloat16"),
            "max_rel_err_f32": max(r["max_rel_err"] for r in rows
                                   if r["dtype"] == "float32"),
            "ms": _per_unit(step, "ms", "per_step"),
            "plain_ms": _per_unit(step, "plain_ms", "per_step"),
            "bound_ms": _per_unit(step, "bound_ms", "per_step"),
            "bound_by": _bound_by(step, "per_step"),
            "library_ms": None,
            "unit": "one training step (16 launches, B=8, bf16)",
            "per_shape": rows,
        })
    om_group = [r for r in fused["rows"] if r["dtype"] == "bfloat16"
                and r["batch"] == 8]
    entries.append({
        "name": "dcn_fwd_om", "route": "cuda",
        "source": str(OM_LIB.source.relative_to(root)),
        "replaces": "side_tpu/ops/dcn_pallas.py:691",
        "launches": validation["launches"]["dcn_fwd_om"],
        "launches_path": f"validation, {validation['groups']} groups of 4 "
                         "frames",
        "max_abs_err": max(r["max_abs_err"] for r in fused["rows"]),
        "max_rel_err_bf16": max(r["max_rel_err"] for r in fused["rows"]
                                if r["dtype"] == "bfloat16"),
        "max_rel_err_f32": max(r["max_rel_err"] for r in fused["rows"]
                               if r["dtype"] == "float32"),
        "ms": _per_unit(om_group, "ms", "per_group"),
        "plain_ms": _per_unit(om_group, "plain_ms", "per_group"),
        "bound_ms": _per_unit(om_group, "bound_ms", "per_group"),
        "bound_by": _bound_by(om_group, "per_group"),
        "library_ms": None,
        "fused_route_ms": _per_unit(om_group, "fused_route_ms",
                                    "per_group"),
        "unfused_route_ms": _per_unit(om_group, "unfused_route_ms",
                                      "per_group"),
        "unit": "one validation group of 4 frames (16 launches, B=8, bf16)",
        "per_shape": fused["rows"],
    })
    g_bf16 = next(r for r in gather["rows"] if r["dtype"] == "bfloat16")
    entries.append({
        "name": "gather_bilinear", "route": "cuda",
        "source": str(GATHER_LIB.source.relative_to(root)),
        "replaces": "tools/gather_microbench.py:111",
        "launches": gather["launches"],
        "launches_path": "python -m side_tpu_torch.tools.gather_microbench "
                         "--reps 5",
        "max_abs_err": max(r["max_abs_err"] for r in gather["rows"]),
        "ms": g_bf16["ms"], "plain_ms": g_bf16["plain_ms"],
        "bound_ms": g_bf16["bound_ms"], "bound_by": g_bf16["bound_by"],
        "library_ms": g_bf16["library_ms"],
        "library_call": "F.grid_sample(bilinear, border, align_corners=True)"
                        " on an NCHW copy; equal for in-bounds positions",
        "unit": "the probe's shape: x (2, 96, 320, 64) bf16, 552,960 samples",
        "per_shape": gather["rows"],
    })
    print(json.dumps({"kernels": entries}), flush=True)
    log(f"[summary] validation {json.dumps(validation['times'])}; "
        f"launches {json.dumps(validation['launches'])}")
    log(f"[summary] train step {train['step_ms_median']:.1f} ms median, "
        f"split {json.dumps(train['split'])}, peak "
        f"{train['peak_mem_gib']:.2f} GiB; small-train check "
        f"{json.dumps(small_train)}; script "
        f"{time.perf_counter() - t_start:.1f} s")
    print(power_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
