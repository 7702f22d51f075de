#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which must pass:
  1. toolchain: CUDA version, device, capability 9.0, power limit; build the
     DCN kernels from side_tpu_torch/csrc (dcn_fwd.cu and dcn_bwd.cu, one
     nvcc each, started together);
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
     1e-6 input change, over three draws, is printed beside them.
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
    from side_tpu_torch.ops.dcn_cuda import LIBRARIES, build_all
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(f"[toolchain] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} capability {cap}")
    log(f"[toolchain] nvidia-smi: {power_line()}")
    check(cap == (9, 0), f"needs a Hopper card (9.0), got {cap}")
    t0 = time.perf_counter()
    paths = build_all()
    log(f"[toolchain] {', '.join(lib.source.name for lib in LIBRARIES)} "
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
        check(count == 16 * n_steps,
              f"{name}: {count} launches in {n_steps} steps, expected "
              f"{16 * n_steps}")
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
    from side_tpu_torch.ops.dcn_cuda import BWD_LIB, FWD_LIB
    t_start = time.perf_counter()
    dev = phase_toolchain()
    kern = phase_kernels()
    main_path = phase_main_path()
    phase_small_reference()
    bwd = phase_backward_kernels()
    train = phase_training()
    small_train = phase_small_train_reference()

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
    print(json.dumps({"kernels": entries}), flush=True)
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
