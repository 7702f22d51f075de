#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which must pass:
  1. toolchain: CUDA version, device, capability 9.0, power limit; build
     every kernel from side_tpu_torch/csrc (dcn_fwd.cu, dcn_bwd.cu,
     dcn_fwd_om.cu, gather_bilinear.cu and box_solve.cu, one nvcc each,
     started together);
  2. the forward kernel against its plain PyTorch version on the card at the
     7 distinct DeformBlock shapes of the serving path (B=2), in bf16 and
     f32 with R=1, and R=-1 (exact) at one shape, at two ragged bf16
     shapes (B=3, 13x37: one the tensor-core route takes, one with Cin=24
     that it does not), and at the 7 DeformBlock shapes of the acceptance
     protocol's 128x384 input (B=8, bf16 and f32, R=1, offsets far outside
     the window: most are a tile or a few, ragged in both directions);
     per shape the route taken, times (also with all
     offsets 0), bound, F.conv2d and, on the tensor-core route, the time of
     the CUDA-core body (the earlier design) on the same operands;
  3. the serving path: Detector(Config()) at full width (384x1280, bf16,
     K=100) on random seeded weights (He-scaled, offset convs perturbed)
     runs 3 frames of random 375x1242 stereo pairs through load_and_pre,
     dispatch and finish (Detector.run); every frame must launch the DCN
     forward kernel 16 times, all on the tensor-core route, the backward
     kernels never, and give K finite rows;
  4. a small-input check: the same network on the card and on the CPU (f32,
     TF32 off) agree to 1e-3 of each head's largest value;
  5. the backward kernels K2 (dcn_bwd_dx) and K3 (dcn_bwd_dcoord) against
     autograd of the plain version on the card, every cotangent, at the 7
     DeformBlock shapes of a training step (B=8: 4 stereo pairs), bf16 and
     f32 with R=1, and R=-1 at one shape, offsets beyond +-R included;
     the forward kernel's output at the same shapes against the plain
     version's (phase 2's tolerance); the two ragged bf16 shapes of phase
     2 (13x37: no multiple of a d_x patch); bf16 at R=2 and R=-1 on a
     Cout-64 shape and the ragged one, and with every offset at exactly
     +-R and with offsets far outside the window; the 7 shapes of the
     acceptance protocol (128x384, B=8, bf16 and f32, R=1, offsets far
     outside the window); the route, times, plain
     times, bounds and, on the tensor-core route, the CUDA-core body's
     time; for K2 also where the scatter happens (`scatter`: "patch" in
     shared memory and registers, "tile" in device memory), the
     device-memory scatter's time on the patch route's operands
     (`tile_ms`), and d_x's error over the pixels on the image border and
     on patch seams alone (`max_rel_err_border`), held to the same
     tolerance; then K2 and K3 under `deterministic_mode` (phase 11's
     setting) at the 7 training shapes and the 7 protocol shapes (bf16,
     R=1): the same tolerances, K2 on its patch body at every width, two
     calls equal bit for bit, timed beside the default route;
  6. the training path: Trainer(Config()) at full width (384x1280, bf16,
     max_objs 50, roi_size 16) on He-scaled seeded weights with perturbed
     offsets, fed 4 rendered stereo pairs held in memory, takes 1 warm-up
     and 3 timed steps (Trainer.train_step); every loss part finite, the
     parameters and BatchNorm statistics move, and the forward kernel, K2
     and K3 each launch 16 times per step, all on the tensor-core route
     every time; step time, its upload /
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
     with B=2 and B=8, bf16 and f32, offsets beyond +-1 (equal to dcn_fwd's
     output bit for bit), and the two ragged shapes; the route, the
     kernel's time, the CUDA-core body's time on the tensor-core route,
     the time of the fused route for the layer (the NHWC copy of the conv's
     output + the kernel) and of the unfused route (split, sigmoid, casts,
     dcn_fwd), plain times and bounds;
  9. the gather kernel K5 (gather_bilinear) against its plain version at
     the probe's shape (x (2, 96, 320, 64) bf16, 552,960 samples) and in
     f32; time, the earlier one-thread-per-(sample, 8 channels) kernel's
     time on the same operands (`earlier_ms`), bound, plain time and
     F.grid_sample's; the time a plain read kernel takes to pull the bytes
     of the gather's corner rows out of L2 over the image's footprint
     (`l2_read_ms`, `l2_bytes`); then the probe's own entry point
     (side_tpu_torch.tools.gather_microbench), which must launch the kernel;
 10. the validation path: val.run_pass at full width over 10 rendered
     scenes held in memory, eval_batch 4 (3 groups of 8 images through the
     trunk, the last padded), fused switch on, pipelined: every group must
     launch dcn_fwd_om 16 times, all on the tensor-core route, and dcn_fwd
     never; result files for exactly
     the 10 frames; the KITTI evaluator is built and run on them against
     the written ground truth and its AP lines parsed.  Then the same
     scenes frame by frame (eval_batch 1, unfused) and the rows of the two
     runs compared (VAL_MATCH_RULE); ms per image for eval_batch 1 and 4,
     fused and unfused; launches and device busy share of one group and of
     one frame;
 11. a trained checkpoint (side_tpu_torch.tools.acceptance_16's 16-scene
     protocol, bf16, 128x384, the flagship at full width, seed 0), run
     under `deterministic_mode` so that its outcome is the same every run
     on an H100 with this software: first two runs of the protocol's first
     2 epochs from the same weights must end in the same weights bit for
     bit; then train on
     the fixed 16-scene fixture held in memory (4 pairs a step, 240 epochs
     = 960 steps), detect on the same scenes from the checkpoint written
     (eval_batch 1, with and without the dense alignment), write KITTI
     result files, score them with the C++ evaluator.  Every training step
     launches the forward kernel, K2 and K3 16 times each and every
     detection frame the forward kernel 16 times, all on the tensor-core
     route.  Fails unless every GT object is detected with its class and
     the injected convention bugs (ry_flip, depth_sign: AP3D and APBEV;
     class_shift: car 2D AP) take their APs to exactly 0.0 with the 2D AP
     unchanged.  The JAX tests' quality floors (AP3D / APBEV >= 5, IoU,
     z_cv, ry) are not held here: they are the acceptance, the tool's
     --check, which is open (ROADMAP.md Queue 3).  On the trained
     checkpoint, eval_batch 4 fused (16 dcn_fwd_om launches a group)
     against eval_batch 1 unfused: VAL_MATCH_RULE, and every row above
     peak_thresh of either run has its partner above peak_thresh in the
     other.  Prints each variant's summary line, the per-object errors,
     the trained weights' digest, seconds per epoch, ms per step and the
     phase's time.
 12. the model zoo (the models beyond the flagship, 384x1280, bf16,
     random seeded weights): (a) the forward kernel (B=2 and 8), K2 and K3
     (B=8) at resdcn_18's three DeformBlock shapes, bf16 and f32, against
     their plain versions (phases 2 and 5's tolerances); (b) K5 at the
     voxel path's shapes (1 image x 100 objects, 4 images x 50 objects,
     1000 voxels each, the coordinates `voxel_coords` gives for random
     cars), f32 out, bf16 and f32 maps, against its plain version, its
     autograd backward against the plain gradient (f32, 1e-5), with
     F.grid_sample's time; (c) `--depth_variant voxel`: Detector.run on
     3 frames (16 dcn_fwd and 2 K5 launches a frame) and 3 train steps at
     4 pairs (16 of each DCN kernel and 2 K5 a step); (d) `resdcn_18
     --not_cost_volume`: the same with 3 DCN launches a frame / of each
     kernel a step; (e) dlaseg_34 (batch 1), res_18 and dlav0_34 forwards:
     head shapes, finite values; (f) one flagship step with and one
     without `--remat` from the same weights and batch: loss parts and
     running statistics to one bf16 ulp, the statistics blended once, the
     peak memory with --remat the lower.
 13. data-parallel training (side_tpu_torch/parallel/mesh.py): 2 ranks on
     cuda:0 over gloo (NCCL refuses two ranks on one GPU; a file store in
     a temporary directory), each the flagship Trainer at full width
     (384x1280, bf16, max_objs 50, roi_size 16; the well-conditioned
     weights of phase 7, `interior_init`) on its 2 pairs of each global
     batch of 4 rendered pairs, 3 steps under deterministic_mode, against
     one process on the joined batches: (a) the parameter and
     running-statistics digests equal on both ranks after every step, (b)
     step 1's loss parts relative and running statistics over each
     tensor's largest value to 1e-2, or to twice the one process's own
     step 1 move when its pairs are permuted (3 orders, same run) where
     that is larger, (c) the forward kernel, K2 and K3 16 times a step on
     each rank, all on the tensor-core route; (d) a world-1 nccl group on
     cuda:0: one step with the collectives active, loss parts to 1e-6 of
     the step without a mesh; (e) with two or more cards, 2 nccl ranks on
     cuda:0 and cuda:1 held as in (a)-(c), else "not run"; (f) printed,
     no bound: at phase 6's He-scaled weights, bf16 and f32 (TF32 off in
     every process of the phase), eval and training mode, the loss parts
     of 2 ranks, of one process running the 4 pairs as two 2-pair
     forwards (in training mode at the 4 pairs' BatchNorm statistics) and
     of one process on the pairs permuted, each against one process on
     the 4 pairs.  Per rank the step ms and the
     share of steps 2-3 spent in all-reduce calls (timed between device
     fences): the two ranks share one card, so this is no scaling figure.
 14. exact mode, the offset audit and the clamp-finetune recipe: (a) the
     forward kernel, K2 and K3 in exact mode (R=-1) against the plain exact
     version and its autograd at the 7 DeformBlock shapes of the 128x384
     protocol, B=4 (the recipe's 2 pairs), f32 and bf16, offsets far
     outside +-1 (phases 2 and 5's tolerances; route, times, bounds);
     (b) side_tpu_torch.tools.offset_audit on the serving cell (384x1280,
     bf16, phase 3's seeded weights, 2 rendered frames) and on phase 11's
     trained checkpoint: 16 layers, finite statistics, each pass 16
     forward launches a frame at the radius its mode calls for (R=1, then
     R=-1); the captured offsets of one layer against F.conv2d of its
     input (f32); every offset conv zeroed, the two passes within phase
     2's tolerance; (c) side_tpu_torch.tools.finetune_clamp.run_recipe at
     its defaults (160 + 40 epochs, f32, 2 scenes): A's training and
     detection launch only at R=-1, B's detection and C's training and
     detection only at R=1; the checkpoints tagged -1 and 1; finite
     losses; the JAX recipe's summary keys (printed, no floor held: the
     outcome is a draw, ROADMAP.md Queue 3 item 1); then the audit of A's
     checkpoint loaded with the window in force (it stays) and its
     statistics from the exact pass.  f32 has no deterministic K2 / K3
     body, so the recipe runs in the default mode (said in its output);
 15. acceptance over seeds: side_tpu_torch.tools.acceptance_rate's run
     (`run_one`) of the 2-scene protocol at f32 (TF32 off, windowed R=1,
     default mode) at seeds 0 and 1, with both TF32 flags on before it
     and given back after: the two initial weights differ and the
     fixture is the same; finite losses; 16 launches each of the forward
     kernel, K2 and K3 a step, all on the f32 (CUDA-core) route.  Each
     seed's failed floors are printed, not held: a floor is a share over
     seeds (PERF.md, "Acceptance over seeds"), not a per-run check.
 16. the top-level entry points: side_tpu_torch.graft_entry.entry()'s
     function at full width (384x1280, bf16, K=100; seeded init): 16
     forward launches a call, all on the tensor-core route, nothing else,
     finite rows of the decode's shapes; the host syncs of one chained
     serving iteration at B=2 under torch.cuda.set_sync_debug_mode("warn"),
     counted and printed; side_tpu_torch.bench's main at its defaults (its
     JSON line printed), with spies that count the calls of entry()'s
     function, the Trainer's steps and the launches made before the
     first training step: 16 forward launches per serving call and 16 of
     each DCN kernel per training step, each the launches of its part
     over its calls, all on the tensor-core route; the calls match the
     loop lengths; the `--reference_exact` Detector on phase
     11's R = 1 checkpoint stays exact (forward launches at radius -1
     only); dryrun_multichip(2) on the card (2 gloo ranks on cuda:0, f32,
     TF32 off): passes, and each rank launches the forward kernel, K2 and
     K3 16 times;
 17. the box solve K6 (csrc/box_solve.cu, which replaces no TPU kernel)
     against the plain solve on the card at one frame's rows (N = 100)
     and a validation group's (N = 800), drawn by tests/torch_box_rows.py:
     the same finite rows; equal bit for bit to the plain solve over the
     rows tiled to 2,400 (where cuBLAS sums in the kernel's order); against
     the plain solve at N, at most 5 % of the rows beyond 1e-4 and none
     beyond 1e-2, beside the plain solve's own differences between the two
     batch sizes (the rows whose cost stalls at f32's resolution); the
     kernel's time, an empty launch's (`launch_floor_ms`, the spin kernel
     at 1 cycle), the plain chain's
     between two events (its host dispatch gaps included), the host time
     of one call of each, and the roofline bound.  Phase 10 also holds
     K6 to 2 launches a group (the solve and the re-solve).
Kernel times are device times: each timed call is queued behind a short
spin on the card (`time_ms`).  `cuda_core_ms` is the CUDA-core body of the
forward, of K2 and of K3 timed on the same bf16 operands in the same run: the
design that the tensor-core route replaced.
Prints a `kernels` JSON line, the script's elapsed time, the card's name and
power limit, and, last,
{"ok": true, "device": {...}}.  Exits non-zero if any phase fails or no
CUDA device is present.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# cuBLAS's setting for repeatable results (phases 5 and 11 run under
# deterministic_mode), read when cuBLAS first runs in the process
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
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
# ragged bf16 cases (Cin, H, W, Cout) at B=3: 1,443 pixels, no multiple of a
# tile; the first takes the tensor-core route, Cin=24 the CUDA-core route
RAGGED_BATCH = 3
RAGGED_SHAPES = [(64, 13, 37, 64), (24, 13, 37, 64)]
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,  # tensor cores, dense
              torch.float32: 67e12}    # f32 outside the tensor cores
# kernel vs plain version, max |diff| / max |plain|: f32 differs only in the
# order of the 9*Cin-term sums; bf16 output rounds once more (2 bf16 ulps);
# the tensor-core route also rounds the weight to bf16, which moves the f32
# sums by less than one ulp of the output (csrc/dcn_fwd_body.cuh)
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
# K2/K3 vs autograd of the plain version, per cotangent, max |diff| / max
# |plain|: f32 sum order and atomics; bf16: the plain version also rounds
# the column gradient and d_x to bf16 (csrc/dcn_bwd.cu)
BWD_TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
REPS = 20
# ~0.3 ms at the card's clock: longer than a wrapper's host time
SPIN_CYCLES = 500_000
STAGES = ("tot", "pre", "net", "dec", "post")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    """A failed check fails the run (and, unlike assert, survives -O)."""
    if not ok:
        raise RuntimeError(msg)


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of fn() over `reps` runs, by CUDA events.  Each
    timed run is queued behind a short spin on the device (SPIN_CYCLES), so
    that the host's work to launch fn() (wrapper checks, allocations) runs
    while the card is busy and does not count: for a single kernel the
    figure is the kernel's own time on the card."""
    for _ in range(warmup):
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


def reset_counts(kernels) -> None:
    for kern in kernels.values():
        kern.launches = 0
        if hasattr(kern, "tensor_core_launches"):
            kern.tensor_core_launches = 0
        if hasattr(kern, "radius_launches"):
            kern.radius_launches.clear()


def route_and_earlier_ms(kernel, args, cin, cout, dtype):
    """The route `kernel` takes for these operands and, on the tensor-core
    route, the time of the CUDA-core body (the earlier design) on them."""
    from side_tpu_torch.ops.dcn_cuda import dcn_route
    route = dcn_route(dtype, cin, cout)
    before = kernel.tensor_core_launches
    kernel(*args)
    check(kernel.tensor_core_launches - before == (route == "tensor"),
          f"{type(kernel).__name__} did not take the {route} route")
    earlier = None
    if route == "tensor":
        earlier = time_ms(lambda: kernel(*args, cuda_core=True))
    return route, earlier


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
    from side_tpu_torch.tools.acceptance_16 import PROTOCOL_SHAPES
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    cases = [(shape, n, dtype, 1, BATCH, "random")
             for shape, n in SERVING_SHAPES
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(SERVING_SHAPES[4][0], 0, dtype, -1, BATCH, "random")
              for dtype in (torch.bfloat16, torch.float32)]
    cases += [(shape, 0, torch.bfloat16, 1, RAGGED_BATCH, "random")
              for shape in RAGGED_SHAPES]
    # the acceptance protocol's shapes, offsets far outside the window (as
    # a trained model's are)
    cases += [(shape, 0, dtype, 1, TRAIN_BATCH, "far_outside")
              for shape in PROTOCOL_SHAPES
              for dtype in (torch.bfloat16, torch.float32)]
    with torch.inference_mode():
        for case in cases:
            rows.append(_fwd_row(gen, *case))
    return {"rows": rows}


@torch.inference_mode()
def _fwd_row(gen, shape, n, dtype, radius, batch, offsets,
             tag: str = "kernel") -> dict:
    """The forward kernel against its plain version at one shape, timed:
    its row (`n` launches of the shape a frame), checked to TOLERANCE."""
    from side_tpu_torch.ops.dcn_cuda import DCN_FWD
    from side_tpu_torch.ops.deform_conv import deform_conv_plain
    cin, h, w, cout = shape
    x, off, mask, wt, bias = _inputs(cin, h, w, cout, dtype, gen, batch)
    if offsets == "far_outside":
        off = off * 8.0
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
    bound, bound_by = _bound_ms(cin, h, w, cout, dtype, batch)
    route, earlier = route_and_earlier_ms(
        DCN_FWD, (x, off, mask, wt, bias, radius), cin, cout, dtype)
    # the same work sampling the regular grid (all offsets 0): says
    # whether the gathers cost by their bytes or by their count
    zero = torch.zeros_like(off)
    grid_ms = time_ms(lambda: DCN_FWD(x, zero, mask, wt, bias, radius))
    row = {"batch": batch, "cin": cin, "h": h, "w": w, "cout": cout,
           "dtype": str(dtype).replace("torch.", ""),
           "radius": radius, "offsets": offsets, "per_frame": n,
           "route": route,
           "cuda_core_ms": earlier, "regular_grid_ms": grid_ms,
           "max_abs_err": diff, "max_rel_err": rel,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": bound_by, "conv2d_ref_ms": conv_ms}
    log(f"[{tag}] {json.dumps(row)}")
    check(np.isfinite(diff) and rel <= TOLERANCE[dtype],
          f"dcn_fwd disagrees with its plain version: {row}")
    return row


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
    reset_counts(KERNELS)
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
    check(DCN_FWD.tensor_core_launches == launches,
          f"only {DCN_FWD.tensor_core_launches} of {launches} dcn_fwd "
          "launches took the tensor-core route")
    log(f"[main] dcn_fwd launches: {launches} over {len(frames)} frames, "
        f"{DCN_FWD.tensor_core_launches} on the tensor-core route")
    return {"launches": launches,
            "tensor_core_launches": DCN_FWD.tensor_core_launches,
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


def _bwd_bound_ms(cin, h, w, cout, dtype, batch=TRAIN_BATCH):
    """Least time of K2 and K3 at one shape: FLOPs over the dtype's peak
    (the in-kernel products g·W_k^T and, for K3, col^T·g, plus the per-
    sample arithmetic) against the bytes each must move (inputs read once,
    outputs written once) over the memory rate."""
    pix = batch * h * w
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


def _border_and_seams(h: int, w: int, patch_h: int) -> torch.Tensor:
    """(h, w) mask of the pixels on the image border and, where K2 owns
    patches of d_x (patch_h x 16), on a patch's first or last row or
    column."""
    ys = torch.arange(h, device="cuda")
    xs = torch.arange(w, device="cuda")
    on_y = (ys == 0) | (ys == h - 1)
    on_x = (xs == 0) | (xs == w - 1)
    if patch_h:
        on_y |= (ys % patch_h == 0) | (ys % patch_h == patch_h - 1)
        on_x |= (xs % 16 == 0) | (xs % 16 == 15)
    return on_y[:, None] | on_x[None, :]


def phase_backward_kernels() -> dict:
    """The forward kernel against the plain version, and K2 and K3 against
    its autograd, at the training shapes; per kernel and case the largest
    error over its outputs."""
    from side_tpu_torch.tools.acceptance_16 import PROTOCOL_SHAPES
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    rows = []
    cases = [(shape, n, dtype, 1, TRAIN_BATCH, "random")
             for shape, n in SERVING_SHAPES
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(SERVING_SHAPES[4][0], 0, dtype, -1, TRAIN_BATCH, "random")
              for dtype in (torch.bfloat16, torch.float32)]
    cases += [(shape, 0, torch.bfloat16, 1, RAGGED_BATCH, "random")
              for shape in RAGGED_SHAPES]
    # K2's routes off the model's window: a Cout-64 shape (the patch route
    # at R=2, the tile route at R=-1) and the ragged one, then every offset
    # at exactly +-R and offsets far outside [-R, R]
    cout64 = SERVING_SHAPES[5][0]
    cases += [(shape, 0, torch.bfloat16, radius, batch, "random")
              for radius in (2, -1)
              for shape, batch in ((cout64, TRAIN_BATCH),
                                   (RAGGED_SHAPES[0], RAGGED_BATCH))]
    cases += [(shape, 0, torch.bfloat16, 1, batch, offsets)
              for offsets in ("at_radius", "far_outside")
              for shape, batch in ((SERVING_SHAPES[3][0], TRAIN_BATCH),
                                   (RAGGED_SHAPES[0], RAGGED_BATCH))]
    # the acceptance protocol's training shapes (128x384, B=8), offsets far
    # outside the window
    cases += [(shape, 0, dtype, 1, TRAIN_BATCH, "far_outside")
              for shape in PROTOCOL_SHAPES
              for dtype in (torch.bfloat16, torch.float32)]
    for case in cases:
        rows += _bwd_rows(gen, *case)
    # phase 11's setting: the training and the protocol shapes, bf16, R=1
    det = []
    for shapes, offsets in ((SERVING_SHAPES, "random"),
                            (zip(PROTOCOL_SHAPES,
                                 [n for _, n in SERVING_SHAPES]),
                             "far_outside")):
        for shape, n in shapes:
            det += _deterministic_rows(gen, shape, n, TRAIN_BATCH, offsets)
    return {"rows": rows, "deterministic": det}


def _deterministic_rows(gen, shape, n, batch, offsets) -> list:
    """K2 and K3 under `deterministic_mode` at one bf16 shape, R=1: against
    autograd of the plain version (phase 5's tolerance; d_x also over the
    border and patch seams), K2 on its patch body, two calls equal bit for
    bit; timed beside the default route (`default_ms`)."""
    from side_tpu_torch.ops.dcn_cuda import (DCN_BWD_DCOORD, DCN_BWD_DX,
                                             deterministic_mode, dx_plan)
    from side_tpu_torch.ops.deform_conv import deform_conv_plain
    cin, h, w, cout = shape
    dtype = torch.bfloat16
    x, off, mask, wt, bias = _inputs(cin, h, w, cout, dtype, gen, batch)
    if offsets == "far_outside":
        off = off * 8.0
    g = torch.randn(x.shape[:3] + (cout,), generator=gen,
                    device="cuda").to(dtype)
    ref_in = [t.clone().requires_grad_(True)
              for t in (x, off, mask, wt, bias)]
    want = torch.autograd.grad(deform_conv_plain(*ref_in, 1), ref_in[:4], g)
    k2 = lambda: DCN_BWD_DX(g, off, mask, wt, 1)              # noqa: E731
    k3 = lambda: DCN_BWD_DCOORD(x, g, off, mask, wt, 1)       # noqa: E731
    with deterministic_mode():
        runs = [(k2(), *k3()) for _ in range(2)]
        ms = {"dcn_bwd_dx": time_ms(k2), "dcn_bwd_dcoord": time_ms(k3)}
    default_ms = {"dcn_bwd_dx": time_ms(k2), "dcn_bwd_dcoord": time_ms(k3)}
    torch.cuda.synchronize()
    plan = dx_plan(batch, h, w, cin, cout, 1, deterministic=True)
    seam = _border_and_seams(h, w, plan["patch_h"])

    def err(a, b):
        diff = (a.float() - b.float()).abs().max().item()
        return diff, diff / max(b.float().abs().max().item(), 1e-30)
    errs = [err(a, b.reshape(a.shape)) for a, b in zip(runs[0], want)]
    border = err(runs[0][0][:, seam], want[0][:, seam])[1]
    rows = []
    for name, parts in (("dcn_bwd_dx", (0,)), ("dcn_bwd_dcoord", (1, 2, 3))):
        row = {"kernel": name, "batch": batch, "cin": cin, "h": h, "w": w,
               "cout": cout, "dtype": "bfloat16", "radius": 1,
               "offsets": offsets, "per_step": n, "deterministic": True,
               "repeat_equal": all(torch.equal(runs[0][i], runs[1][i])
                                   for i in parts),
               "max_abs_err": max(errs[i][0] for i in parts),
               "max_rel_err": max(errs[i][1] for i in parts),
               "ms": ms[name], "default_ms": default_ms[name]}
        if name == "dcn_bwd_dx":
            row.update(scatter=plan["scatter"], patch_h=plan["patch_h"],
                       max_rel_err_border=border)
        rows.append(row)
        log(f"[backward, deterministic] {json.dumps(row)}")
        tol = BWD_TOLERANCE[dtype]
        check(np.isfinite(row["max_rel_err"]) and row["max_rel_err"] <= tol,
              f"{name} (deterministic) disagrees with the plain version: "
              f"{row}")
        check(row["repeat_equal"],
              f"{name} (deterministic) gave other bits on a second call: "
              f"{row}")
        check(name != "dcn_bwd_dx" or (
            plan["scatter"] == "patch" and np.isfinite(border)
            and border <= tol),
            f"dcn_bwd_dx (deterministic) off the patch body or disagrees "
            f"on the border and seam pixels: {row}")
    return rows


def _bwd_rows(gen, shape, n, dtype, radius, batch, offsets,
              tag: str = "backward") -> list:
    """The forward kernel against the plain version and K2 and K3 against
    its autograd at one shape, timed: one row per kernel (`n` launches of
    the shape a step), each checked to its tolerance."""
    from side_tpu_torch.ops.dcn_cuda import (DCN_BWD_DCOORD, DCN_BWD_DX,
                                             DCN_FWD, dcn_route, dx_plan)
    from side_tpu_torch.ops.deform_conv import DcnFunction, deform_conv_plain
    cin, h, w, cout = shape
    rows = []
    x, off, mask, wt, bias = _inputs(cin, h, w, cout, dtype, gen, batch)
    if offsets == "at_radius":
        off = torch.where(off > 0, 1.0, -1.0) * abs(radius)
    elif offsets == "far_outside":
        off = off * 8.0
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
    plan = (dx_plan(batch, h, w, cin, cout, radius)
            if dcn_route(dtype, cin, cout) == "tensor"
            else {"scatter": "tile", "patch_h": 0})
    seam = _border_and_seams(h, w, plan["patch_h"])
    border_err = ((got[1].float() - want[1].float())[:, seam].abs().max()
                  / want[1].float()[:, seam].abs().max()).item()
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
    bounds = _bwd_bound_ms(cin, h, w, cout, dtype, batch)
    bounds["dcn_fwd"] = _bound_ms(cin, h, w, cout, dtype, batch)
    del ref_out
    with torch.no_grad():
        fwd_route = route_and_earlier_ms(
            DCN_FWD, (x, off, mask, wt, bias, radius), cin, cout, dtype)
    k3_route = route_and_earlier_ms(
        DCN_BWD_DCOORD, (x, g, off, mask, wt, radius), cin, cout, dtype)
    k2_route = route_and_earlier_ms(
        DCN_BWD_DX, (g, off, mask, wt, radius), cin, cout, dtype)
    k2_extra = {"scatter": plan["scatter"] if k2_route[0] == "tensor"
                else None, "tile_ms": None,
                "max_rel_err_border": border_err}
    if plan["scatter"] == "patch":
        k2_extra["tile_ms"] = time_ms(lambda: DCN_BWD_DX(
            g, off, mask, wt, radius, scatter="tile"))
    for name, ms, plain_ms, parts, (route, earlier) in (
            ("dcn_fwd", fwd_ms, fwd_plain, ("out",), fwd_route),
            ("dcn_bwd_dx", k2_ms, k2_plain, ("x",), k2_route),
            ("dcn_bwd_dcoord", k3_ms, k3_plain,
             ("offset", "mask", "weight"), k3_route)):
        row = {"kernel": name, "batch": batch, "cin": cin, "h": h,
               "w": w, "cout": cout,
               "dtype": str(dtype).replace("torch.", ""),
               "radius": radius, "offsets": offsets, "per_step": n,
               "route": route, "cuda_core_ms": earlier,
               "max_abs_err": max(errs[p][0] for p in parts),
               "max_rel_err": max(errs[p][1] for p in parts),
               "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
        if name == "dcn_bwd_dx":
            row.update(k2_extra)
        rows.append(row)
        log(f"[{tag}] {json.dumps(row)}")
        tol = (TOLERANCE if name == "dcn_fwd" else BWD_TOLERANCE)[dtype]
        check(np.isfinite(row["max_rel_err"]) and
              row["max_rel_err"] <= tol,
              f"{name} disagrees with the plain version: {row} {errs}")
        # a halo one pixel short would show here, not under the max
        # over the interior
        check(name != "dcn_bwd_dx" or (np.isfinite(border_err) and
                                       border_err <= tol),
              f"dcn_bwd_dx disagrees on the border and seam pixels: "
              f"{row}")
    return rows


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
    reset_counts(KERNELS)
    step_ms, losses = [], []
    for i in range(steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = tr.train_step(tr.to_device(batches[i]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in stats.items()})
    launches = {name: k.launches for name, k in KERNELS.items()}
    tensor_core = {name: k.tensor_core_launches
                   for name, k in KERNELS.items()
                   if hasattr(k, "tensor_core_launches")}
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
        # every launch of the model's DeformBlocks takes the tensor-core
        # route
        check(tensor_core.get(name, want) == want,
              f"{name}: {tensor_core.get(name)} of {want} launches took the "
              "tensor-core route")
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
           "tensor_core_launches": tensor_core, "steps": n_steps,
           "pairs_per_step": cfg.batch_size,
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
    cases = [(batch, shape, n, dtype) for batch in (2, 8)
             for shape, n in SERVING_SHAPES
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(RAGGED_BATCH, shape, 0, torch.bfloat16)
              for shape in RAGGED_SHAPES]
    with torch.inference_mode():
        for batch, (cin, h, w, cout), n, dtype in cases:
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
            route, earlier = route_and_earlier_ms(
                DCN_FWD_OM, (x, om, wt, bias, 1), cin, cout, dtype)
            row = {"kernel": "dcn_fwd_om", "batch": batch,
                   "cin": cin, "h": h, "w": w, "cout": cout,
                   "dtype": str(dtype).replace("torch.", ""),
                   "radius": 1, "per_group": n, "route": route,
                   "cuda_core_ms": earlier,
                   "max_abs_err": diff, "max_rel_err": diff / scale,
                   "max_rel_err_vs_dcn_fwd": diff_k1 / scale,
                   "ms": ms, "fused_route_ms": fused_ms,
                   "unfused_route_ms": unfused_ms,
                   "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": bound_by}
            rows.append(row)
            log(f"[fused] {json.dumps(row)}")
            # one body, one sum order: dcn_fwd on the split
            # operands gives the same bits
            check(np.isfinite(diff) and
                  row["max_rel_err"] <= TOLERANCE[dtype] and
                  diff_k1 == 0.0,
                  f"dcn_fwd_om disagrees: {row}")
    return {"rows": rows}


def phase_gather_kernel() -> dict:
    """K5 at the probe's shape, then the probe itself."""
    from side_tpu_torch.ops.gather_cuda import (GATHER_BILINEAR,
                                                gather_bilinear_plain,
                                                gather_body, l2_read_ms)
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
            # what L2 delivers: each sample pulls four rows of C values
            l2_ms, l2_bytes = l2_read_ms(x, 4 * got.numel() * item)
            row = {"kernel": "gather_bilinear",
                   "dtype": str(dtype).replace("torch.", ""),
                   "x": list(x.shape), "samples": y0.numel(),
                   "body": gather_body(x.shape[-1]),
                   "max_abs_err": diff.max().item(),
                   "ms": time_ms(lambda: GATHER_BILINEAR(x, y0, x0, fy, fx)),
                   "earlier_ms": time_ms(lambda: GATHER_BILINEAR(
                       x, y0, x0, fy, fx, per_thread=True)),
                   "l2_read_ms": l2_ms, "l2_bytes": l2_bytes,
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


# K6: rows of one frame (K = 100) and of a validation group of 8 frames,
# (rows, seed of tests/torch_box_rows.py); about 20 * 370 operations a row
BOX_SOLVE_ROWS = ((100, 1), (800, 0))
# the batch at which the plain solve sums J^T r in the kernel's order
# (tests/test_torch_cuda.py: PLAIN_ORDER_ROWS)
BOX_SOLVE_ORDER_ROWS = 2400
BOX_SOLVE_OPS_PER_ROW = 7_400
BOX_SOLVE_BYTES_PER_ROW = 22 * 4 + 3 * 4


def _host_ms(fn, reps: int = 5) -> float:
    """Median host time of one call of fn() (its launches enqueued, not
    waited for), the device idle before each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def phase_box_solve() -> dict:
    """Phase 17: K6 against the plain solve, times and bound."""
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_box_rows
    from side_tpu_torch.ops.box_solve_cuda import BOX_SOLVE
    from side_tpu_torch.postprocess import box_solver as BS
    rows = []
    with torch.inference_mode():
        for n, seed in BOX_SOLVE_ROWS:
            consts, z = torch_box_rows.solve_rows(n, seed)
            consts = BS.SolveConsts(*[t.cuda() for t in consts])
            z = z.cuda()
            before = BOX_SOLVE.launches
            got = BS.solve_x_y_theta(consts, z)
            check(BOX_SOLVE.launches == before + 1,
                  "solve_x_y_theta on the card did not launch box_solve")
            want = BS.solve_x_y_theta_plain(consts, z)
            reps = BOX_SOLVE_ORDER_ROWS // n
            same_order = BS.solve_x_y_theta_plain(
                BS.SolveConsts(*[t.repeat(reps) for t in consts]),
                z.repeat(reps))[:n]
            finite = torch.isfinite(want).all(dim=1)
            check(torch.equal(torch.isfinite(got).all(dim=1), finite),
                  "box_solve and the plain solve differ in their finite rows")
            far = (got - want)[finite].abs().amax(dim=1)
            self_far = (same_order - want)[finite].abs().amax(dim=1)

            t_bytes = n * BOX_SOLVE_BYTES_PER_ROW / HBM_BYTES_PER_S
            t_ops = n * BOX_SOLVE_OPS_PER_ROW / PEAK_FLOPS[torch.float32]
            row = {"kernel": "box_solve", "rows": n,
                   "nonfinite_rows": int((~finite).sum()),
                   "equal_to_plain_at_order_rows": bool(
                       ((got == same_order) | (got.isnan() &
                                              same_order.isnan())).all()),
                   "max_abs_err": float(far.max()),
                   "rows_beyond_1e-4": int((far > 1e-4).sum()),
                   "plain_self_max_abs_diff": float(self_far.max()),
                   "plain_self_rows_beyond_1e-4": int(
                       (self_far > 1e-4).sum()),
                   "ms": time_ms(lambda: BS.solve_x_y_theta(consts, z)),
                   "launch_floor_ms": time_ms(
                       lambda: torch.cuda._sleep(1)),
                   "plain_ms": time_ms(lambda: BS.solve_x_y_theta_plain(
                       consts, z), reps=5, warmup=1),
                   "host_ms": _host_ms(lambda: BS.solve_x_y_theta(consts,
                                                                  z)),
                   "plain_host_ms": _host_ms(
                       lambda: BS.solve_x_y_theta_plain(consts, z)),
                   "bytes": n * BOX_SOLVE_BYTES_PER_ROW,
                   "bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "launch latency (roofline: " + (
                       "bytes" if t_bytes >= t_ops else "operations") + ")"}
            rows.append(row)
            log(f"[box_solve] {json.dumps(row)}")
            check(row["equal_to_plain_at_order_rows"] and
                  row["rows_beyond_1e-4"] <= 0.05 * n and
                  row["max_abs_err"] <= 1e-2,
                  f"box_solve disagrees with the plain solve: {row}")
    return {"rows": rows}


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


def _compare_val_runs(rec_b, rec1, n_frames: int, cfg) -> dict:
    """The rows of a batched fused run (`rec_b`) against those of the
    frame-by-frame unfused run (`rec1`) over the same frames, under
    VAL_MATCH_RULE; also, per run, the rows above peak_thresh that have no
    partner above peak_thresh in the other run (`unpartnered`)."""
    check(all(g["dcn_fwd"] == 16 and g["dcn_fwd_om"] == 0 and
              g["dcn_fwd_tensor_core"] == 16
              for g in rec1.group_launches) and
          len(rec1.group_launches) == n_frames,
          f"eval_batch 1 unfused launched {rec1.group_launches}")
    rows_b = torch.cat([r[0] for r in rec_b.raw])[:n_frames].cpu().numpy()
    cls_b = torch.cat([r[1] for r in rec_b.raw])[:n_frames].cpu().numpy()
    rows1 = torch.cat([r[0] for r in rec1.raw]).cpu().numpy()
    cls1 = torch.cat([r[1] for r in rec1.raw]).cpu().numpy()
    fractions, diffs, unpartnered = [], [], {"batched": 0, "frame": 0}
    above = {"batched": 0, "frame": 0}
    for f in range(n_frames):
        i, j = _match_rows(rows_b[f], cls_b[f], rows1[f], cls1[f])
        fractions.append(len(i) / cfg.K)
        diffs.append(np.abs(rows_b[f][i] - rows1[f][j]))
        # the detections written to the result files: both ways
        for name, (a, ca, b, cb) in (
                ("batched", (rows_b[f], cls_b[f], rows1[f], cls1[f])),
                ("frame", (rows1[f], cls1[f], rows_b[f], cls_b[f]))):
            ka = a[:, 12] > cfg.peak_thresh
            kb = b[:, 12] > cfg.peak_thresh
            above[name] += int(ka.sum())
            if ka.any():
                if not kb.any():
                    unpartnered[name] += int(ka.sum())
                    continue
                got, _ = _match_rows(a[ka], ca[ka], b[kb], cb[kb])
                unpartnered[name] += int(ka.sum()) - len(got)
    diffs = np.concatenate(diffs)
    med = np.median(diffs, axis=0)
    return {"matched_fraction_min": min(fractions),
            "matched_fraction_mean": float(np.mean(fractions)),
            "pairs": len(diffs), "above_peak_thresh": above,
            "unpartnered_above_peak_thresh": unpartnered,
            "median_abs_diff": {
                "score": float(med[12]), "box_px": float(med[1:5].max()),
                "alpha": float(med[0]), "dim": float(med[5:8].max()),
                "xyz": float(med[8:11].max()), "ry": float(med[11])}}


class _RecordingDetector:
    """Forwards to a Detector; records each dispatch's kernel launches and
    the raw rows of every frame (before the score filter)."""

    def __init__(self, det, kernels):
        self._det, self._kernels = det, kernels
        self.group_launches, self.raw = [], []

    def __getattr__(self, name):
        return getattr(self._det, name)

    def _counts(self):
        counts = {k: v.launches for k, v in self._kernels.items()}
        counts.update({f"{k}_tensor_core": v.tensor_core_launches
                       for k, v in self._kernels.items()
                       if hasattr(v, "tensor_core_launches")})
        return counts

    def _counted(self, fn, *a, **kw):
        before = self._counts()
        out = fn(*a, **kw)
        self.group_launches.append(
            {k: v - before[k] for k, v in self._counts().items()})
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
    from side_tpu_torch.ops.box_solve_cuda import BOX_SOLVE
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

        kernels = {**KERNELS, "box_solve": BOX_SOLVE}

        def run(eb, fused, record=True):
            rec = _RecordingDetector(det, kernels)
            t0 = time.perf_counter()
            with dc.dcn_fused(fused):
                results, meters, steady = val.run_pass(
                    cfg, scenes, rec if record else det, n=n_scenes,
                    eval_batch=eb)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n_scenes
            return rec, results, steady, wall

        # the counted run: every count set to 0 just before, read just after
        reset_counts(kernels)
        rec4, results4, _, _ = run(eval_batch, True)
        launches = {k: v.launches for k, v in kernels.items()}
        tensor_core = KERNELS["dcn_fwd_om"].tensor_core_launches
        n_groups = -(-n_scenes // eval_batch)
        check(len(rec4.group_launches) == n_groups,
              f"{len(rec4.group_launches)} groups, expected {n_groups}")
        for i, g in enumerate(rec4.group_launches):
            check(g["dcn_fwd_om"] == 16 and g["dcn_fwd"] == 0 and
                  g["dcn_bwd_dx"] == 0 and g["dcn_bwd_dcoord"] == 0 and
                  g["dcn_fwd_om_tensor_core"] == 16 and g["box_solve"] == 2,
                  f"group {i} launched {g}, expected 16 dcn_fwd_om only, "
                  "all on the tensor-core route, and 2 box_solve")
        check(sorted(results4) == list(range(n_scenes)),
              f"results for frames {sorted(results4)}")
        res_dir = save_kitti_results(results4, tmp, CLASS_NAMES)
        files = sorted(os.listdir(res_dir))
        check(files == [f"{i:06d}.txt" for i in range(n_scenes)],
              f"result files {files}")
        rows4 = torch.cat([r[0] for r in rec4.raw])[:n_scenes]
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
        rec1 = run(1, False)[0]
        match = _compare_val_runs(rec4, rec1, n_scenes, cfg)
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
    out.update(launches=launches, groups=n_groups,
               tensor_core_launches=tensor_core, aps=aps, match=match,
               times=times, profiles=profiles, detections=n_dets)
    return out


# the protocol phase 11 trains, in bf16: (scenes, pairs per step, epochs),
# as tests/test_overfit_ap.py runs its 16-scene protocol
TRAINED_RUN = (16, 4, 240)
REPEAT_EPOCHS = 2              # of phase 11's repeatability check


def _protocol_digest(tmp: str, epochs: int) -> str:
    """The weights digest after `epochs` epochs of phase 11's protocol from
    its seed-0 weights (detection without the dense alignment)."""
    from side_tpu_torch.tools import acceptance_16 as acc
    n, batch, _ = TRAINED_RUN
    cap = {}
    acc.run_overfit_ap(tmp, epochs=epochs, n_scenes=n, batch_size=batch,
                       compute_dtype="bfloat16", run_align=False,
                       _capture=cap)
    return cap["timing"]["weights_digest"]


def phase_trained_checkpoint(keep_dir: str) -> dict:
    """The 16-scene protocol of side_tpu_torch.tools.acceptance_16 on the
    card in bf16: train on the fixed fixture, detect on the same scenes
    from the checkpoint written, score with the C++ evaluator.  Every
    training step must launch the forward kernel, K2 and K3 16 times each,
    every detection frame the forward kernel 16 times, all on the
    tensor-core route; the convention checks must hold.  Then, on the
    trained checkpoint, eval_batch 4 fused against eval_batch 1 unfused:
    every row above peak_thresh of either run has its partner in the
    other, under VAL_MATCH_RULE.  The JAX tests' quality floors are not
    held here: the acceptance is `acceptance_16 --check` (ROADMAP.md).
    All of it runs under `deterministic_mode`, and first two short runs of
    the protocol must end in the same weights: the phase's outcome is then
    the same every run on one card and software stack, where the default
    kernels' f32 atomics made the trained model, and with it the checks on
    its detections, differ from run to run.  The trained checkpoint is
    copied to `keep_dir` for phase 14's offset audit."""
    from side_tpu_torch.ops.dcn_cuda import deterministic_mode
    with deterministic_mode():
        return _trained_checkpoint(keep_dir)


def _trained_checkpoint(keep_dir: str) -> dict:
    import shutil
    import tempfile
    from dataclasses import replace
    from side_tpu_torch import val
    from side_tpu_torch.data.synthetic import fixture_frames, fixture_scenes
    from side_tpu_torch.ops import deform_conv as dc
    from side_tpu_torch.ops.dcn_cuda import KERNELS
    from side_tpu_torch.runtime.detector import Detector
    from side_tpu_torch.tools import acceptance_16 as acc
    t_phase = time.perf_counter()
    n, batch, epochs = TRAINED_RUN
    with tempfile.TemporaryDirectory() as tmp:
        repeat = [_protocol_digest(os.path.join(tmp, f"repeat{i}"),
                                   REPEAT_EPOCHS) for i in range(2)]
        log(f"[trained] {REPEAT_EPOCHS} epochs twice, weights digests "
            f"{repeat}")
        check(repeat[0] == repeat[1],
              f"two runs of {REPEAT_EPOCHS} epochs under deterministic_mode "
              f"ended in other weights: {repeat}")
        cap = {}
        # the counted run: every count set to 0 just before
        reset_counts(KERNELS)
        t0 = time.perf_counter()
        res = acc.run_overfit_variants(
            os.path.join(tmp, f"acc{n}"), epochs=epochs, n_scenes=n,
            batch_size=batch, compute_dtype="bfloat16", _capture=cap)
        wall = time.perf_counter() - t0
        total = {k: v.launches for k, v in KERNELS.items()}
        summary = acc.summarize(res)
        for line in summary.values():
            log(f"[trained] {n} scenes: {json.dumps(line)}")
        timing, launches = cap["timing"], cap["launches"]
        steps, frames = timing["steps"], timing["detect_frames"]
        check(steps == epochs * (n // batch),
              f"{steps} steps, expected {epochs * (n // batch)}")
        train, detect = launches["train"], launches["detect"]
        for name in ("dcn_fwd", "dcn_bwd_dx", "dcn_bwd_dcoord"):
            check(train[name] == train[f"{name}_tensor_core"] == 16 * steps,
                  f"{name} launched {train[name]} times "
                  f"({train[f'{name}_tensor_core']} on the tensor-core "
                  f"route) in {steps} steps, expected {16 * steps}")
        check(detect["dcn_fwd"] == detect["dcn_fwd_tensor_core"]
              == 16 * frames and detect["dcn_bwd_dx"] == 0 and
              detect["dcn_bwd_dcoord"] == 0 and
              train["dcn_fwd_om"] == detect["dcn_fwd_om"] == 0,
              f"detection over {frames} frames launched {detect}")
        check(sum(total.values()) == sum(
            train[k] + detect[k] for k in total),
            f"launches outside training and detection: {total}")
        out = {"scenes": n, "pairs_per_step": batch, "epochs": epochs,
               "steps": steps, "wall_s": wall,
               "train_s": timing["train_s"],
               "s_per_epoch": timing["s_per_epoch"],
               "ms_per_step": timing["ms_per_step"],
               "detect_s": timing["detect_s"], "detect_frames": frames,
               "final_loss": timing["final_loss"],
               "launches": launches, "summary": summary,
               "weights_digest": timing["weights_digest"],
               "convention_failed": acc.convention_failures(res),
               "checkpoint": shutil.copy(
                   cap["checkpoint"], os.path.join(keep_dir,
                                                   "trained.npz"))}
        log(f"[trained] {n} scenes, {batch} pairs a step, {epochs} epochs: "
            f"{steps} steps in {timing['train_s']:.1f} s "
            f"({timing['s_per_epoch']:.3f} s per epoch, "
            f"{timing['ms_per_step']:.1f} ms per step), detection of "
            f"{frames} frames {timing['detect_s']:.1f} s, run {wall:.1f} s; "
            f"launches {json.dumps(launches)}; final loss "
            f"{json.dumps(timing['final_loss'])}; weights digest "
            f"{timing['weights_digest']}")
        log(f"[trained] clean run, per GT object: "
            + json.dumps([{k: (round(v, 3) if isinstance(v, float) else v)
                           for k, v in e.items()} for e in res["clean"][1]]))
        check(not out["convention_failed"],
              f"convention checks failed: {out['convention_failed']}")

        # batched fused against frame-by-frame unfused, trained weights
        cfg = acc.protocol_config(os.path.join(tmp, "data"), tmp,
                                  batch_size=batch, compute_dtype="bfloat16")
        det = Detector(replace(cfg, load_model=cap["checkpoint"]))
        scenes = fixture_frames(fixture_scenes(n, 2, seed=0)[:n])
        recs = {}
        reset_counts(KERNELS)
        for eb, fused in ((4, True), (1, False)):
            recs[eb] = _RecordingDetector(det, KERNELS)
            with dc.dcn_fused(fused):
                val.run_pass(cfg, scenes, recs[eb], n=n, eval_batch=eb)
        out["fused_launches"] = KERNELS["dcn_fwd_om"].launches
        out["fused_tensor_core_launches"] = \
            KERNELS["dcn_fwd_om"].tensor_core_launches
        check(len(recs[4].group_launches) == n // 4 and all(
            g["dcn_fwd_om"] == g["dcn_fwd_om_tensor_core"] == 16 and
            g["dcn_fwd"] == 0 for g in recs[4].group_launches),
            f"eval_batch 4 fused launched {recs[4].group_launches}")
        match = _compare_val_runs(recs[4], recs[1], n, cfg)
        out["match"] = match
        log(f"[trained] eval_batch 4 fused vs eval_batch 1 unfused (rule "
            f"{json.dumps(VAL_MATCH_RULE)}): {json.dumps(match)}")
        unmatched = match["unpartnered_above_peak_thresh"]
        check(match["matched_fraction_min"] >= VAL_MATCH_RULE["min_matched"]
              and match["median_abs_diff"]["score"] <= VAL_MATCH_RULE["score"]
              and match["median_abs_diff"]["box_px"]
              <= VAL_MATCH_RULE["box_px"]
              and not any(unmatched.values()),
              f"the two validation runs of the trained checkpoint "
              f"disagree: {match}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[trained] phase {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------- phase 12: model zoo
RESDCN = dict(arch="resdcn_18", head_conv=64, cost_volume=False)
ZOO_FRAMES = 3
ZOO_STEPS = 3
# K5 on the voxel path: (images, objects per image) of a serving frame
# (K = 100 decoded slots) and of a training step's view (4 pairs, max_objs
# 50 GT slots); each object samples VOXEL_RES**3 = 1000 voxels
VOXEL_GATHER_CASES = ((1, 100), (4, 50))
# the gather's f32 output against its plain version: equal up to fused
# multiply-add contraction (phase 9's f32 bound); its backward (the
# scatter-add in PyTorch) against autograd of the plain version
GATHER_TOL, GATHER_BWD_TOL = 1e-6, 1e-5
# --remat against the plain step from the same weights and batch: the
# recompute runs the same kernels on the same values; loss parts and the
# running statistics to one bf16 unit in the last place
REMAT_TOL = 2.0 ** -8


def _zoo_dcn_kernels() -> dict:
    """(a) the forward kernel (B=2 and B=8), K2 and K3 (B=8) at resdcn_18's
    three DeformBlock shapes, bf16 and f32, R=1."""
    from side_tpu_torch.models.resnet_dcn import deform_shapes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    fwd, bwd = [], []
    for shape in deform_shapes(18):
        for dtype in (torch.bfloat16, torch.float32):
            fwd.append(_fwd_row(gen, shape, 1, dtype, 1, BATCH, "random",
                                tag="zoo dcn"))
            bwd += _bwd_rows(gen, shape, 1, dtype, 1, TRAIN_BATCH, "random",
                             tag="zoo dcn")
    return {"fwd": fwd, "bwd": bwd}


def _voxel_samples(images: int, objects: int, rng):
    """The left view's voxel coordinates of `objects` random cars per image
    at 384x1280 (KITTI calibration, 375x1242 frames, 5-45 m away), as the
    voxel variant computes them; returns the gather's operands and the
    clipped sample positions (v, u), (images, objects * 1000)."""
    from side_tpu_torch.data import geometry as G
    from side_tpu_torch.models.voxel_net import sample_corners, voxel_coords
    from side_tpu_torch.runtime.synthetic import KITTI_H, KITTI_W, kitti_calib
    calib = kitti_calib()
    p2 = np.asarray(calib[2], np.float32)
    p3 = np.asarray(calib[3], np.float32)
    c = np.array([KITTI_W / 2.0, KITTI_H / 2.0], np.float32)
    s = np.array([KITTI_W, KITTI_H], np.float32)
    trans = G.get_affine_transform(c, s, 0, [320, 96])
    trans_inv = G.get_affine_transform(c, s, 0, [320, 96], inv=True)
    fb = float(p2[0, 3] - p3[0, 3])
    cx = rng.uniform(20, 300, (images, objects))
    cy = rng.uniform(30, 70, (images, objects))
    disp = fb / rng.uniform(5, 45, (images, objects)) / trans_inv[0, 0]
    half = rng.uniform(2, 10, (images, objects, 2))
    bbox = np.stack([cx - half[..., 0], cy - half[..., 1],
                     cx + half[..., 0], cy + half[..., 1]], -1)
    bbox_r = bbox - np.stack([disp, 0 * disp, disp, 0 * disp], -1)

    def dev(a):
        a = np.asarray(a, np.float32)
        return torch.from_numpy(np.broadcast_to(
            a, (images,) + a.shape[-2:]) if a.ndim == 2 else a).cuda()
    cl, _, vl, _, _ = voxel_coords(
        dev(bbox), dev(bbox_r), torch.full((images,), fb, device="cuda"),
        dev(p2), dev(p3), dev(trans), dev(trans_inv), 320, 96)
    y0, x0, fy, fx = sample_corners(cl, vl, 96, 320)
    v = (y0.float() + fy).reshape(images, -1)
    u = (x0.float() + fx).reshape(images, -1)
    return (y0.reshape(-1), x0.reshape(-1), fy.reshape(-1), fx.reshape(-1),
            v, u, float(vl.float().mean()))


def _zoo_gather() -> dict:
    """(b) K5 at the voxel path's shapes, f32 output, bf16 and f32 maps;
    its autograd backward against the plain version's gradient."""
    from side_tpu_torch.ops.gather_cuda import (GATHER_BILINEAR,
                                                GatherBilinearFunction,
                                                gather_bilinear_plain)
    from side_tpu_torch.tools import gather_microbench as probe
    rng = np.random.RandomState(12)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    rows = []
    for images, objects in VOXEL_GATHER_CASES:
        y0, x0, fy, fx, v, u, in_map = _voxel_samples(images, objects, rng)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(images, 96, 320, 64, generator=gen,
                            device="cuda").to(dtype)
            with torch.inference_mode():
                got = GATHER_BILINEAR(x, y0, x0, fy, fx,
                                      out_dtype=torch.float32)
                ref = gather_bilinear_plain(x, y0, x0, fy, fx,
                                            torch.float32)
                torch.cuda.synchronize()
                diff = (got - ref).abs().max().item()
                top = ref.abs().max().item()
                S, C = got.shape
                nbytes = S * C * 4 + x.numel() * x.element_size() + S * 16
                t_bytes = nbytes / HBM_BYTES_PER_S
                t_ops = S * C * 8 / PEAK_FLOPS[torch.float32]
                x_nchw = x.permute(0, 3, 1, 2).contiguous()
                row = {"kernel": "gather_bilinear",
                       "dtype": str(dtype).replace("torch.", ""),
                       "out_dtype": "float32", "x": list(x.shape),
                       "images": images, "objects": objects,
                       "samples": S, "in_map_share": in_map,
                       "max_abs_err": diff, "max_rel_err": diff / top,
                       "ms": time_ms(lambda: GATHER_BILINEAR(
                           x, y0, x0, fy, fx, out_dtype=torch.float32)),
                       "plain_ms": time_ms(lambda: gather_bilinear_plain(
                           x, y0, x0, fy, fx, torch.float32)),
                       "library_ms": time_ms(lambda: probe.grid_sample_call(
                           x_nchw, v, u)),
                       "bytes": nbytes,
                       "bound_ms": max(t_bytes, t_ops) * 1e3,
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations"}
            if dtype == torch.float32:
                xg = x.clone().requires_grad_(True)
                out = GatherBilinearFunction.apply(xg, y0, x0, fy, fx,
                                                   torch.float32)
                g = torch.randn(out.shape, generator=gen, device="cuda")
                out.backward(g)
                xp = x.clone().requires_grad_(True)
                gather_bilinear_plain(xp, y0, x0, fy, fx).backward(g)
                bwd = (xg.grad - xp.grad).abs().max().item()
                row["bwd_rel_err"] = bwd / xp.grad.abs().max().item()
                row["bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                    GatherBilinearFunction.apply(xg, y0, x0, fy, fx,
                                                 torch.float32), xg, g))
                check(row["bwd_rel_err"] <= GATHER_BWD_TOL,
                      f"the gather's backward disagrees: {row}")
            rows.append(row)
            log(f"[zoo gather] {json.dumps(row)}")
            check(np.isfinite(diff) and diff <= GATHER_TOL * top,
                  f"gather_bilinear (f32 out) disagrees: {row}")
    return {"rows": rows}


def _counts(kernels) -> dict:
    out = {name: k.launches for name, k in kernels.items()}
    out.update({f"{name}_tensor_core": k.tensor_core_launches
                for name, k in kernels.items()
                if hasattr(k, "tensor_core_launches")})
    return out


def _zoo_detect(label: str, cfg, per_frame: dict) -> dict:
    """Detector.run on ZOO_FRAMES random frames at full width; every frame
    launches per_frame[name] of each kernel, DCN launches on the tensor-core
    route, and gives K finite rows."""
    from side_tpu_torch.ops.dcn_cuda import KERNELS
    from side_tpu_torch.ops.gather_cuda import GATHER_BILINEAR
    from side_tpu_torch.runtime.detector import Detector
    from side_tpu_torch.runtime.synthetic import (he_scale, kitti_calib,
                                                  perturb_offsets,
                                                  random_frame)
    kernels = dict(KERNELS, gather_bilinear=GATHER_BILINEAR)
    det = Detector(cfg)
    he_scale(det.model)
    perturb_offsets(det.model, seed=1)
    rng = np.random.RandomState(3)
    frames = [random_frame(rng) for _ in range(ZOO_FRAMES)]
    calib = kitti_calib()
    reset_counts(kernels)
    times = []
    for i, f in enumerate(frames):
        pending = det.dispatch(det.load_and_pre(f, calib))
        rows = pending["handles"][0]
        out = det.finish(pending)
        check(tuple(rows.shape) == (cfg.K, 13) and
              bool(torch.isfinite(rows).all()),
              f"{label} frame {i}: rows {tuple(rows.shape)} not finite")
        times.append({k: out[k] * 1e3 for k in STAGES})
    counts = _counts(kernels)
    log(f"[zoo {label}] frames (ms): {json.dumps(times)}; launches "
        f"{json.dumps(counts)}")
    for name in kernels:
        want = per_frame.get(name, 0) * len(frames)
        check(counts[name] == want, f"{label}: {name} launched "
              f"{counts[name]} times in {len(frames)} frames, want {want}")
        if f"{name}_tensor_core" in counts:
            check(counts[f"{name}_tensor_core"] == want,
                  f"{label}: {name} off the tensor-core route")
    return {"frames_ms": times, "launches": counts,
            "tot_ms_median": statistics.median(t["tot"] for t in times[1:])}


def _zoo_train(label: str, per_step: dict, **overrides) -> dict:
    """ZOO_STEPS Trainer.train_steps at 4 pairs (max_objs 50) at full width:
    finite loss parts, per_step[name] launches of each kernel a step, DCN
    launches on the tensor-core route; step times and the peak memory."""
    from side_tpu_torch.ops.dcn_cuda import KERNELS
    from side_tpu_torch.ops.gather_cuda import GATHER_BILINEAR
    from side_tpu_torch.stage_profile import flagship_trainer
    kernels = dict(KERNELS, gather_bilinear=GATHER_BILINEAR)
    tr, batches = flagship_trainer(ZOO_STEPS, **overrides)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    step_ms, losses = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = tr.train_step(tr.to_device(b))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in stats.items()})
    counts = _counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[zoo {label}] steps (ms): {step_ms}; losses {json.dumps(losses)}; "
        f"launches {json.dumps(counts)}; peak {peak:.2f} GiB")
    for i, st in enumerate(losses):
        check(set(st) == set(tr.loss_states) and
              all(np.isfinite(v) for v in st.values()),
              f"{label} step {i}: loss parts {st}")
    for name in kernels:
        want = per_step.get(name, 0) * len(batches)
        check(counts[name] == want, f"{label}: {name} launched "
              f"{counts[name]} times in {len(batches)} steps, want {want}")
        if f"{name}_tensor_core" in counts:
            check(counts[f"{name}_tensor_core"] == want,
                  f"{label}: {name} off the tensor-core route")
    del tr, batches
    return {"step_ms": step_ms, "step_ms_median": statistics.median(
        step_ms[1:]), "losses": losses, "launches": counts,
        "peak_mem_gib": peak}


def _zoo_forwards() -> dict:
    """(e) dlaseg_34 (stereo, batch 1) and the monocular res_18 and
    dlav0_34 forward at full width: head shapes and finite values."""
    from side_tpu_torch.config import Config
    from side_tpu_torch.models.factory import create_model
    from side_tpu_torch.ops.dcn_cuda import DCN_FWD
    from side_tpu_torch.runtime.synthetic import he_scale
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    out = {}
    for arch, kw in (("dlaseg_34", dict(cost_volume=False)),
                     ("res_18", dict(head_conv=64)), ("dlav0_34", {})):
        cfg = Config(arch=arch, **kw)
        model = create_model(cfg, seed=4).cuda().eval()
        he_scale(model)
        x = torch.randn(1, cfg.input_h, cfg.input_w, 3, generator=gen,
                        device="cuda")
        arg = ({"input": x, "input_right": x.roll(-24, dims=2)}
               if arch == "dlaseg_34" else x)
        DCN_FWD.launches = 0
        with torch.inference_mode():
            model(arg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            heads = model(arg)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for name, ch in cfg.heads.items():
            t = heads[name]
            check(tuple(t.shape) == (1, cfg.output_h, cfg.output_w, ch)
                  and bool(torch.isfinite(t).all()),
                  f"{arch} {name}: {tuple(t.shape)} or not finite")
        out[arch] = {"ms": ms, "dcn_fwd_launches": DCN_FWD.launches // 2}
        log(f"[zoo forward] {arch}: {ms:.2f} ms, heads "
            f"{sorted(heads)}, {DCN_FWD.launches // 2} dcn_fwd a forward")
        del model
    return out


def _zoo_remat() -> dict:
    """(f) one flagship step with and one without --remat from the same
    weights and batch: loss parts and running statistics agree, the
    feature extractor's recompute leaves the statistics alone (they blend
    once), and the peak memory with --remat is the lower."""
    import gc
    from side_tpu_torch.config import Config
    from side_tpu_torch.models import dla
    from side_tpu_torch.models.factory import create_model
    from side_tpu_torch.runtime.trainer import Trainer
    from side_tpu_torch.stage_profile import flagship_trainer
    tr, batches = flagship_trainer(1)
    state = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    stats0 = _batch_stats(tr.model)
    del tr
    out = {}
    for remat in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = Config(batch_size=4, remat=remat)
        model = create_model(cfg, seed=21)
        model.load_state_dict(state)
        tr = Trainer(cfg, model, steps_per_epoch=100)
        calls = []
        hook = tr.model.feature_extraction.register_forward_pre_hook(
            lambda m, a: calls.append(dla._frozen_statistics))
        b = tr.to_device(batches[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        st = tr.train_step(b)
        torch.cuda.synchronize()
        hook.remove()
        out[remat] = {"losses": {k: float(v) for k, v in st.items()},
                      "stats": _batch_stats(tr.model), "calls": calls,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "step_peak_gib": (torch.cuda.max_memory_allocated()
                                        - base) / 2 ** 30}
        # the step's time: two more steps (the first one warms up)
        ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            tr.train_step(b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[remat]["step_ms"] = ms[-1]
        del tr, model, b
    plain, remat = out[False], out[True]
    loss_err = max(abs(remat["losses"][k] - v) / max(abs(v), 1e-6)
                   for k, v in plain["losses"].items())
    stat_err = max(((remat["stats"][k] - v).abs().max() /
                    v.abs().max().clamp(min=1e-30)).item()
                   for k, v in plain["stats"].items())
    moved = sum(not torch.equal(v, stats0[k])
                for k, v in remat["stats"].items())
    res = {"loss_rel_err": loss_err, "stats_rel_err": stat_err,
           "stats_moved": moved, "stats": len(stats0),
           "feature_passes": {"plain": plain["calls"],
                              "remat": remat["calls"]},
           "peak_gib": {"plain": plain["peak_gib"],
                        "remat": remat["peak_gib"]},
           "step_peak_gib": {"plain": plain["step_peak_gib"],
                             "remat": remat["step_peak_gib"]},
           "step_ms": {"plain": plain["step_ms"], "remat": remat["step_ms"]},
           "losses": {"plain": plain["losses"], "remat": remat["losses"]}}
    log(f"[zoo remat] {json.dumps(res)}")
    check(plain["calls"] == [False] and remat["calls"] == [False, True],
          f"feature-extractor passes {res['feature_passes']}")
    check(loss_err <= REMAT_TOL, f"--remat loss parts differ by {loss_err}")
    check(stat_err <= REMAT_TOL and moved == len(stats0),
          f"--remat running statistics: {stat_err}, {moved} moved")
    check(remat["peak_gib"] < plain["peak_gib"],
          f"--remat peak {remat['peak_gib']:.2f} GiB not below "
          f"{plain['peak_gib']:.2f} GiB")
    return res


def phase_model_zoo() -> dict:
    """Phase 12: the models beyond the flagship, at full width, bf16."""
    from side_tpu_torch.config import Config
    t0 = time.perf_counter()
    out = {"dcn": _zoo_dcn_kernels(), "gather": _zoo_gather()}
    dcn16 = {"dcn_fwd": 16}
    out["voxel_detect"] = _zoo_detect(
        "voxel serving", Config(depth_variant="voxel"),
        dict(dcn16, gather_bilinear=2))
    out["voxel_train"] = _zoo_train(
        "voxel training", {"dcn_fwd": 16, "dcn_bwd_dx": 16,
                           "dcn_bwd_dcoord": 16, "gather_bilinear": 2},
        depth_variant="voxel")
    out["resdcn_detect"] = _zoo_detect("resdcn_18 serving",
                                       Config(**RESDCN), {"dcn_fwd": 3})
    out["resdcn_train"] = _zoo_train(
        "resdcn_18 training", {"dcn_fwd": 3, "dcn_bwd_dx": 3,
                               "dcn_bwd_dcoord": 3}, **RESDCN)
    out["forwards"] = _zoo_forwards()
    out["remat"] = _zoo_remat()
    out["phase_s"] = time.perf_counter() - t0
    log(f"[zoo] phase {out['phase_s']:.1f} s")
    return out


DP_STEPS = 3
# (b): step 1 of 2 ranks against one process, bf16: loss parts and running
# statistics to DP_TOL, or to twice the one process's own move under a
# permutation of its pairs where that is larger (the largest over
# DP_PERMUTATIONS, measured in the same run).  A bf16 forward at full
# width moves its smallest loss parts (orien, off, depth: ~1e-1 to 3) by
# 1e-2 to 2.4e-2 when only the order of its sums changes (PERF.md §6)
DP_TOL = 1e-2
DP_WORLD1_TOL = 1e-6  # (d): a world-1 nccl mesh against no mesh
DP_KERNELS = ("dcn_fwd", "dcn_bwd_dx", "dcn_bwd_dcoord")
DP_PERMUTATIONS = ([2, 3, 0, 1], [1, 0, 3, 2], [3, 2, 1, 0])
# (a)-(e) run the flagship at the well-conditioned point of phase 7
# (interior_init), bf16.  At phase 6's He-scaled weights 2 ranks land far
# from one process, in eval mode too, where no BatchNorm collective runs,
# while a permutation of the pairs moves the one process much less: what
# differs is the per-call numerics of a 2-pair batch against a 4-pair
# one, and (f) prints it beside the same split made in one process
DP_WEIGHTS = "interior"
DP_DTYPE = "bfloat16"


def _dp_trainer(weights: str, dtype: str, mesh=None):
    """The flagship Trainer at full width (Config(batch_size=4): 384x1280,
    max_objs 50, roi_size 16) at `weights`, "interior" (interior_init) or
    "he" (He-scaled, offset convs perturbed: phase 6's), on the mesh's
    device (cuda without one)."""
    from side_tpu_torch.config import Config
    from side_tpu_torch.models.factory import create_model
    from side_tpu_torch.runtime.synthetic import (he_scale, interior_init,
                                                  perturb_offsets)
    from side_tpu_torch.runtime.trainer import Trainer
    cfg = Config(batch_size=4, compute_dtype=dtype)
    model = create_model(cfg, seed=21)
    if weights == "he":
        he_scale(model)
        perturb_offsets(model, seed=22)
    else:
        interior_init(model, seed=32)
    return Trainer(cfg, model, steps_per_epoch=100, mesh=mesh,
                   device=None if mesh is not None else "cuda")


def _dp_batches(n: int) -> list:
    """`n` global batches of 4 rendered pairs (max_objs 50), seeded."""
    from side_tpu_torch.config import Config
    from side_tpu_torch.data.synthetic import scene_batch
    cfg = Config(batch_size=4)
    rng = np.random.RandomState(20)
    return [scene_batch(cfg, rng, cfg.batch_size, cfg.max_objs)
            for _ in range(n)]


def _loss_err(got: dict, want: dict) -> float:
    """The largest relative loss-part error."""
    return max(abs(got[k] - v) / max(abs(v), 1e-6) for k, v in want.items())


def _dp_errors(got: dict, want: dict) -> list:
    """[largest relative loss-part error, largest running-statistic error
    over its tensor's largest value]."""
    stat = max(float((got["running"][k] - v).abs().max() /
                     v.abs().max().clamp(min=1e-30))
               for k, v in want["running"].items())
    return [_loss_err(got["losses"], want["losses"]), stat]


class _StatisticsTape:
    """Within `record()` every training-mode BatchNorm's (mean, var) is
    kept in call order; within `replay()` each forward gets them back in
    that order in place of its own batch's."""

    def __init__(self):
        from side_tpu_torch.models import dla
        self.cls, self.real = dla.FoldedBatchNorm, \
            dla.FoldedBatchNorm.statistics
        self.tape, self.pos = [], None

    def _statistics(self, bn, x):
        if self.pos is None:
            out = self.real(bn, x)
            if bn.training:
                self.tape.append(out)
            return out
        if not bn.training:
            return self.real(bn, x)
        self.pos += 1
        return self.tape[self.pos - 1]

    @contextlib.contextmanager
    def _patched(self, pos):
        self.pos = pos
        self.cls.statistics = lambda bn, x: self._statistics(bn, x)
        try:
            yield self
        finally:
            self.cls.statistics = self.real
            self.pos = None

    def record(self):
        self.tape = []
        return self._patched(None)

    def replay(self):
        return self._patched(0)


def _forward_losses(tr, batch, mesh=None) -> dict:
    """The loss parts of a forward in the model's current mode (under
    `mesh` the global ones of the rank's share)."""
    from side_tpu_torch.parallel.mesh import data_parallel
    with torch.no_grad(), data_parallel(mesh):
        _, stats = tr.loss(batch)
    return {k: float(v) for k, v in stats.items()}


def _split_losses(tr, batch, tape=None) -> dict:
    """The loss parts of the whole batch from outputs that the network
    computed two pairs at a time, in one process: the forwards of 2 ranks
    without their collectives.  In training mode each BatchNorm takes the
    statistics that `tape` recorded on the whole batch."""
    from side_tpu_torch.ops.decode import boxes_from_targets
    from side_tpu_torch.ops.losses import stereo_loss
    from side_tpu_torch.runtime.trainer import normalize_images
    cfg = tr.cfg
    with torch.no_grad():
        b = normalize_images(batch, tr.mean, tr.std)
        target = boxes_from_targets(b["ind_float"], b["wh"], b["reg"],
                                    cfg.output_w, cfg.wh_scale)
        outs = []
        for half in (slice(0, 2), slice(2, 4)):
            with (tape.replay() if tape is not None
                  else contextlib.nullcontext()):
                outs.append(tr.model({k: v[half] for k, v in b.items()},
                                     target=tuple(t[half] for t in target),
                                     use_cost_volume=cfg.cost_volume))
        out = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        _, stats = stereo_loss(out, b, tr.loss_weight, cfg.grid, cfg.uncert,
                               cfg.cost_volume,
                               depth_aux_weight=cfg.depth_aux_weight,
                               mse_loss=cfg.mse_loss)
    return {k: float(v) for k, v in stats.items()}


def _he_witness(batch, mesh=None) -> dict:
    """(f) at He-scaled weights, bf16 and f32, eval and training mode,
    under deterministic_mode and without TF32: the loss parts of one
    forward on the whole batch (under `mesh`: of the rank's share), and
    without a mesh also of the batch's pairs permuted and of the 2-pair
    forwards of `_split_losses`."""
    import gc
    from side_tpu_torch.ops.dcn_cuda import deterministic_mode
    from side_tpu_torch.parallel.mesh import Mesh, shard_batch
    out = {}
    swapped = {k: v[DP_PERMUTATIONS[0]] for k, v in batch.items()}
    with deterministic_mode():
        for dtype in ("bfloat16", "float32"):
            tr = _dp_trainer("he", dtype, mesh)
            b = tr.to_device(shard_batch(batch, mesh or Mesh()))
            for mode in ("eval", "train"):   # eval first: train blends
                tr.model.train(mode == "train")
                if mesh is not None:
                    out[dtype, mode] = _forward_losses(tr, b, mesh)
                    continue
                tape = _StatisticsTape()
                with tape.record():
                    want = _forward_losses(tr, b)
                out[dtype, mode] = {
                    "whole": want,
                    "permuted": _forward_losses(tr, tr.to_device(swapped)),
                    "split": _split_losses(tr, b, tape if mode == "train"
                                           else None)}
            del tr, b
            gc.collect()
            torch.cuda.empty_cache()
    return out


def _digest(tensors) -> str:
    import hashlib
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


class _CollectiveClock:
    """Wraps torch.distributed.all_reduce: counts the calls and adds up
    their time between device fences (the host waits for a gloo collective
    on CUDA tensors in any case)."""

    def __init__(self):
        import torch.distributed as dist
        self.dist, self.real = dist, dist.all_reduce
        self.calls, self.seconds = 0, 0.0

    def __call__(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.real(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out

    def __enter__(self):
        self.dist.all_reduce = self
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.real


def _dp_steps(tr, batches, mesh) -> list:
    """DP_STEPS train steps of `tr` on its slices of `batches` under
    deterministic_mode: per step the host ms, collective calls and ms,
    loss parts, the DCN kernels' launches (set to 0 just before the step,
    read just after) and the digests of the parameters and running
    statistics; step 1's running statistics themselves."""
    from side_tpu_torch.ops.dcn_cuda import KERNELS, deterministic_mode
    from side_tpu_torch.parallel.mesh import shard_batch
    out = []
    with deterministic_mode():
        for i, batch in enumerate(batches[:DP_STEPS]):
            b = tr.to_device(shard_batch(batch, mesh))
            reset_counts(KERNELS)
            with _CollectiveClock() as clock:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stats = tr.train_step(b)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            row = {"ms": ms, "collectives": clock.calls,
                   "collective_ms": clock.seconds * 1e3,
                   "losses": {k: float(v) for k, v in stats.items()},
                   "launches": _counts(KERNELS),
                   "param_digest": _digest(tr.params),
                   "running_digest": _digest(_batch_stats(tr.model))}
            if i == 0:
                row["running"] = {k: v.cpu() for k, v in
                                  _batch_stats(tr.model).items()}
            out.append(row)
    return out


def _dp_rank(rank: int, world: int, backend: str, store: str, batches,
             out_dir: str, witness: bool) -> None:
    """One rank of phase 13: the flagship Trainer at full width on its
    share of each global batch (and, with `witness`, the He-scaled
    forwards of (f) on the first); gloo ranks share cuda:0, nccl rank r
    runs on cuda:r.  Writes its rows to out_dir/rank<r>.pt."""
    import gc
    from side_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                              shutdown)
    torch.backends.cuda.matmul.allow_tf32 = False   # as in the parent
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    init_distributed(f"file://{store}", world, rank, backend=backend)
    try:
        mesh = make_mesh(world, device)
        out = {"steps": _dp_steps(_dp_trainer(DP_WEIGHTS, DP_DTYPE, mesh),
                                  batches, mesh)}
        gc.collect()
        torch.cuda.empty_cache()
        if witness:
            out["he"] = _he_witness(batches[0], mesh)
    finally:
        shutdown()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _run_ranks(backend: str, batches, tmp: str, witness: bool = False):
    """The ranks' step rows, and rank 0's (f) readings with `witness`."""
    import torch.multiprocessing as mp
    world = 2
    mp.spawn(_dp_rank, args=(world, backend, os.path.join(tmp, "store"),
                             batches, tmp, witness), nprocs=world, join=True)
    res = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
           for r in range(world)]
    return [r["steps"] for r in res], res[0].get("he")


def _check_ranks(label: str, ranks: list, ref: list, floor: list) -> dict:
    """(a) equal digests on the ranks after every step, (b) step 1 against
    the one-process run, to DP_TOL or twice the permutation `floor`
    ([loss parts, running statistics]), (c) 16 tensor-core launches of
    each DCN kernel a step on every rank."""
    for i in range(DP_STEPS):
        for key in ("param_digest", "running_digest"):
            check(len({r[i][key] for r in ranks}) == 1,
                  f"{label}: step {i + 1}: {key} differs across ranks")
        for r, rows in enumerate(ranks):
            for name in DP_KERNELS:
                n = rows[i]["launches"][name]
                tc = rows[i]["launches"][f"{name}_tensor_core"]
                check(n == 16 and tc == 16, f"{label}: rank {r} step "
                      f"{i + 1}: {name} {n} launches, {tc} tensor-core")
    got, want = ranks[0][0], ref[0]
    loss_err, stat_err = _dp_errors(got, want)
    res = {"loss_rel_err": loss_err, "running_rel_err": stat_err,
           "step_ms": [[row["ms"] for row in rows] for rows in ranks],
           "collective_ms": [[row["collective_ms"] for row in rows]
                             for rows in ranks],
           "collectives_per_step": ranks[0][-1]["collectives"],
           "collective_share": [
               sum(row["collective_ms"] for row in rows[1:]) /
               sum(row["ms"] for row in rows[1:]) for rows in ranks],
           "launches_per_rank": [
               {name: sum(row["launches"][name] for row in rows)
                for name in DP_KERNELS} for rows in ranks],
           "losses_step1": {"ranks": got["losses"],
                            "one_process": want["losses"]},
           "bound": [max(DP_TOL, 2 * f) for f in floor]}
    log(f"[data parallel] {label}: {json.dumps(res)}")
    bound = res["bound"]
    check(loss_err <= bound[0] and stat_err <= bound[1],
          f"{label}: step 1 against one process: loss parts {loss_err}, "
          f"running statistics {stat_err} (bounds {bound})")
    return res


def phase_data_parallel() -> dict:
    """Phase 13: data-parallel training, 2 ranks on one card over gloo,
    against one process on the joined batches; a world-1 nccl mesh against
    no mesh; nccl over two cards where there are two; (f) the He-scaled
    weights' split forward."""
    import gc
    import tempfile
    from side_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                              shutdown)
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    batches = _dp_batches(DP_STEPS)
    no_mesh = make_mesh(1, "cuda")
    ref = _dp_steps(_dp_trainer(DP_WEIGHTS, DP_DTYPE), batches, no_mesh)
    # the yardstick of (b): one process on the first batch with its pairs
    # in other orders (the same function, its sums in other orders)
    moves = [_dp_errors(_dp_steps(_dp_trainer(DP_WEIGHTS, DP_DTYPE),
                                  [{k: v[order] for k, v in
                                    batches[0].items()}], no_mesh)[0],
                        ref[0]) for order in DP_PERMUTATIONS]
    floor = [max(m[i] for m in moves) for i in range(2)]
    gc.collect()
    torch.cuda.empty_cache()
    out = {"one_process_step_ms": [row["ms"] for row in ref],
           "permuted_pairs_step1": {"loss_rel_err": [m[0] for m in moves],
                                    "running_rel_err": [m[1] for m in moves]}}
    log(f"[data parallel] one process, step 1 with the pairs in the orders "
        f"{DP_PERMUTATIONS} against in order: "
        f"{json.dumps(out['permuted_pairs_step1'])}")
    with tempfile.TemporaryDirectory() as tmp:
        ranks, he_ranks = _run_ranks("gloo", batches, tmp, witness=True)
        out["gloo_one_card"] = _check_ranks("2 gloo ranks on cuda:0",
                                            ranks, ref, floor)

    # (f) He-scaled weights: 2 ranks, and one process on the 4 pairs as
    # two 2-pair forwards (no collective; in training mode at the whole
    # batch's BatchNorm statistics) or with its pairs permuted, each
    # against one process on the 4 pairs in order (printed, no bound)
    he = _he_witness(batches[0])
    out["he_scaled"] = {
        f"{dtype} {mode}": {
            "two_ranks": _loss_err(he_ranks[dtype, mode], one["whole"]),
            "one_process_split": _loss_err(one["split"], one["whole"]),
            "one_process_permuted": _loss_err(one["permuted"],
                                              one["whole"])}
        for (dtype, mode), one in he.items()}
    log(f"[data parallel] (f) He-scaled weights, step 1 loss parts against "
        f"one process on the 4 pairs in order: "
        f"{json.dumps(out['he_scaled'])}")
    gc.collect()
    torch.cuda.empty_cache()

    # (d) a world-1 nccl group: the collectives run and change nothing
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(f"file://{os.path.join(tmp, 'store')}", 1, 0,
                         backend="nccl")
        try:
            mesh = make_mesh(1, "cuda:0")
            check(mesh.active, "world-1 nccl mesh without a group")
            world1 = _dp_steps(_dp_trainer(DP_WEIGHTS, DP_DTYPE, mesh),
                               batches[:1], mesh)[0]
        finally:
            shutdown()
    err = max(abs(world1["losses"][k] - v) / max(abs(v), 1e-6)
              for k, v in ref[0]["losses"].items())
    out["nccl_world1"] = {"loss_rel_err": err,
                          "collectives": world1["collectives"],
                          "step_ms": world1["ms"]}
    log(f"[data parallel] world-1 nccl mesh vs no mesh: "
        f"{json.dumps(out['nccl_world1'])}")
    check(world1["collectives"] > 0, "world-1 mesh issued no collective")
    check(err <= DP_WORLD1_TOL, f"world-1 nccl mesh: loss parts differ by "
          f"{err} from the step without a mesh")

    # (e) nccl across two cards
    if torch.cuda.device_count() >= 2:
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            out["nccl_two_cards"] = _check_ranks(
                "2 nccl ranks on cuda:0 and cuda:1",
                _run_ranks("nccl", batches, tmp)[0], ref, floor)
    else:
        out["nccl_two_cards"] = "not run: 1 GPU visible"
        log("[data parallel] nccl over two cards: not run (1 GPU visible)")
    out["phase_s"] = time.perf_counter() - t_phase
    g = out["gloo_one_card"]
    log(f"[data parallel] per-rank step ms {json.dumps(g['step_ms'])}, "
        f"collective share (steps 2-{DP_STEPS}) "
        f"{json.dumps(g['collective_share'])}; both ranks share one card, "
        f"so this is no scaling figure; one process on the joined batches "
        f"{json.dumps(out['one_process_step_ms'])} ms; phase "
        f"{out['phase_s']:.1f} s")
    return out


# ------------------------- phase 14: exact mode, offset audit, the recipe
EXACT_BATCH = 4                # the recipe's 2 pairs a step
AUDIT_FRAMES = 2
RECIPE_EPOCHS = (160, 40)      # finetune_clamp.run_recipe's defaults
SUMMARY_KEYS = ["detected", "iou_min", "n_objects", "ry_max", "z_max",
                "z_med"]       # tools/finetune_clamp.py:_summary's


def _exact_rows() -> list:
    """(a) The forward kernel, K2 and K3 in exact mode (R = -1) against the
    plain exact version and its autograd at the 7 DeformBlock shapes of
    the 128x384 protocol, B = 4 (2 pairs), f32 and bf16, offsets far
    outside +-1: phases 2 and 5's tolerances (`_bwd_rows`)."""
    from side_tpu_torch.tools.acceptance_16 import PROTOCOL_SHAPES
    gen = torch.Generator(device="cuda")
    gen.manual_seed(140)
    rows = []
    for shape, (_, n) in zip(PROTOCOL_SHAPES, SERVING_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            rows += _bwd_rows(gen, shape, n, dtype, -1, EXACT_BATCH,
                              "far_outside", tag="exact")
    return rows


def _run_audit(label: str, det, frames) -> dict:
    """`offset_audit.audit` over `frames` with the windowed mode in force
    (its statistics from the clamped pass): 16 layers, finite statistics
    and deltas, and each pass's 16 forward launches a frame at the radius
    its mode calls for (R = 1, then R = -1), no other DCN kernel."""
    from side_tpu_torch.ops import deform_conv as dc
    from side_tpu_torch.ops.dcn_cuda import KERNELS
    from side_tpu_torch.tools import offset_audit
    reset_counts(KERNELS)
    with dc.dcn_mode("windowed", 1):
        res = offset_audit.audit(det, frames, log=lambda m: log(
            f"[audit, {label}] {m.strip()}"))
    layers = res["layers"]
    check(len(layers) == 16 and all(
        np.isfinite(v) for st in layers.values() for v in st.values()),
        f"audit ({label}): {len(layers)} layers, {layers}")
    check(all(np.isfinite(v) for row in res["deltas"] for k, v in
              row.items() if k != "image"), f"audit ({label}): "
          f"non-finite deltas {res['deltas']}")
    n = 16 * len(frames)
    for name, radius in (("windowed", 1), ("exact", -1)):
        got = res["launches"][name]
        at = {k: v for k, v in got.items()
              if k.startswith("dcn_fwd_radius") and v}
        check(got["dcn_fwd"] == n and at == {f"dcn_fwd_radius{radius}": n}
              and got["dcn_bwd_dx"] == got["dcn_bwd_dcoord"]
              == got["dcn_fwd_om"] == 0,
              f"audit ({label}), {name} pass: launches {got}, expected "
              f"{n} dcn_fwd at radius {radius}")
    log(f"[audit, {label}] launches per pass "
        f"{json.dumps(res['launches'])}")
    return res


def _capture_check(det, frame) -> float:
    """The audit's captured offsets of the last DeformBlock against
    F.conv2d of that block's input on the card, in f32 (TF32 off; the
    network run in f32 for this forward): relative error."""
    from side_tpu_torch.tools.offset_audit import DeformBlock, capture_offsets
    name, block = [(n, m) for n, m in det.model.named_modules()
                   if isinstance(m, DeformBlock)][-1]
    seen, got = {}, {}
    hook = block.register_forward_pre_hook(
        lambda mod, args: seen.setdefault("x", args[0].clone()))
    dtype, det.model.dtype = det.model.dtype, torch.float32
    try:
        with capture_offsets(det.model, lambda n, o: got.setdefault(n, o)):
            det.network(det.load_and_pre(frame[1], frame[2])["batch"])
    finally:
        hook.remove()
        det.model.dtype = dtype
    with torch.inference_mode():
        om = F.conv2d(seen["x"], block.offset_mask.weight,
                      block.offset_mask.bias, padding=1).permute(0, 2, 3, 1)
    want = om.reshape(*om.shape[:3], 9, 3)[..., 0:2]
    err = ((got[name] - want).abs().max() / want.abs().max()).item()
    log(f"[audit] {name}: captured offsets {tuple(got[name].shape)} vs "
        f"F.conv2d of its input, f32: max rel err {err:.3e}")
    check(seen["x"].dtype == torch.float32 and
          err <= TOLERANCE[torch.float32],
          f"captured offsets of {name} differ from F.conv2d: {err}")
    return err


def _zeroed_check(det, frame) -> dict:
    """Every offset conv zeroed: the clamped and the exact pass are one
    function; every dense head within phase 2's forward tolerance (the
    depth rows follow the decode order and are printed)."""
    from side_tpu_torch.ops import deform_conv as dc
    with torch.no_grad():
        for name, m in det.model.named_modules():
            if name.endswith("offset_mask"):
                m.weight.zero_()
                m.bias.zero_()
    batch = det.load_and_pre(frame[1], frame[2])["batch"]
    outs = {}
    for mode in (("windowed", 1), ("exact", None)):
        with dc.dcn_mode(*mode):
            outs[mode[0]] = det.network(batch)
    errs = {k: ((a.float() - outs["windowed"][k].float()).abs().max()
                / outs["windowed"][k].float().abs().max().clamp_min(1e-30)
                ).item()
            for k, a in outs["exact"].items()}
    log(f"[audit] offset convs zeroed, exact vs clamped, max rel err per "
        f"output: {json.dumps(errs)}")
    tol = TOLERANCE[det.model.dtype]
    check(all(e <= tol for k, e in errs.items()
              if outs["exact"][k].dim() == 4),
          f"zeroed offsets: clamped and exact differ: {errs}")
    return errs


def _audit_phase(trained_ckpt: str) -> dict:
    """(b) The offset audit on the serving cell (384x1280, bf16, phase 3's
    He-scaled seeded weights with perturbed offset convs, 2 rendered
    frames) and on phase 11's trained checkpoint (128x384, its 2 first
    scenes, loaded keeping the mode)."""
    from dataclasses import replace
    from side_tpu_torch.config import Config
    from side_tpu_torch.data.synthetic import (fixture_frames,
                                               fixture_scenes, val_scenes)
    from side_tpu_torch.runtime.detector import Detector
    from side_tpu_torch.runtime.synthetic import he_scale, perturb_offsets
    from side_tpu_torch.tools import acceptance_16 as acc
    det = Detector(Config())
    he_scale(det.model)
    perturb_offsets(det.model, seed=1)
    frames = val_scenes(AUDIT_FRAMES, seed=14)
    out = {"serving": _run_audit("serving 384x1280", det, frames),
           "capture_rel_err": _capture_check(det, frames[0]),
           "zeroed_rel_err": _zeroed_check(det, frames[0])}
    del det
    cfg = acc.protocol_config("", "", batch_size=TRAINED_RUN[1],
                              compute_dtype="bfloat16")
    det = Detector(replace(cfg, load_model=trained_ckpt), keep_dcn_mode=True)
    n = TRAINED_RUN[0]
    frames = fixture_frames(fixture_scenes(n, 2, seed=0)[:AUDIT_FRAMES])
    out["trained"] = _run_audit("phase 11's checkpoint", det, frames)
    return out


def _only_at(launches: dict, radius: int, kernels, what: str) -> None:
    for k in kernels:
        check(launches[k] > 0 and launches.get(f"{k}_radius{radius}", 0)
              == launches[k],
              f"{what}: {k} launched {launches[k]} times, "
              f"{launches.get(f'{k}_radius{radius}', 0)} at radius {radius}: "
              f"{launches}")


def _recipe_phase() -> dict:
    """(c) `finetune_clamp.run_recipe` at its defaults (f32): A trains and
    detects exact, B detects A's checkpoint and C finetunes and detects at
    R = 1, each launch counted per radius; the checkpoints' tags; finite
    losses; the JAX recipe's summary keys; then the audit of A's
    checkpoint, its statistics from the exact pass."""
    import tempfile
    from dataclasses import replace
    from side_tpu_torch.data.synthetic import fixture_frames, fixture_scenes
    from side_tpu_torch.ops import deform_conv as dc
    from side_tpu_torch.ops.dcn_cuda import KERNELS, dcn_route
    from side_tpu_torch.runtime.detector import Detector
    from side_tpu_torch.tools import acceptance_16 as acc
    from side_tpu_torch.tools import finetune_clamp as fc
    from side_tpu_torch.tools import offset_audit
    routes = sorted({dcn_route(torch.float32, cin, cout)
                     for cin, _, _, cout in acc.PROTOCOL_SHAPES})
    note = (f"f32 runs the forward, K2 and K3 on the {routes} route at every "
            f"protocol shape, where K2 and K3 add with f32 atomics "
            f"(dcn_cuda.deterministic_mode has no repeatable body for "
            f"them in f32, exact or windowed): the recipe runs in the "
            f"default mode, and its outcome is one draw, not one per "
            f"software stack")
    log(f"[recipe] {note}")
    epochs, epochs_ft = RECIPE_EPOCHS
    kernels = ("dcn_fwd", "dcn_bwd_dx", "dcn_bwd_dcoord")
    cap = {}
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts(KERNELS)
        t0 = time.perf_counter()
        summaries = fc.run_recipe(tmp, epochs, epochs_ft, verbose=True,
                                  _capture=cap)
        wall = time.perf_counter() - t0
        tags = {k: int(np.load(cap[k]["checkpoint"])["meta::dcn_radius"])
                for k in ("exact", "finetuned")}
        a, b, c = cap["exact"], cap["naive"], cap["finetuned"]
        _only_at(a["launches"]["train"], -1, kernels, "recipe A, training")
        _only_at(a["launches"]["detect"], -1, kernels[:1],
                 "recipe A, detection")
        _only_at(b["launches"]["detect"], 1, kernels[:1],
                 "recipe B, detection")
        _only_at(c["launches"]["train"], 1, kernels, "recipe C, training")
        _only_at(c["launches"]["detect"], 1, kernels[:1],
                 "recipe C, detection")
        for part in (a, b, c):
            det = part["launches"]["detect"]
            check(det["dcn_bwd_dx"] == det["dcn_bwd_dcoord"] == 0,
                  f"recipe detection ran a backward kernel: {det}")
        check(a["timing"]["steps"] == epochs and
              c["timing"]["steps"] == epochs_ft,
              f"recipe steps {a['timing']['steps']} / "
              f"{c['timing']['steps']}")
        for k in kernels:
            check(a["launches"]["train"][k] == 16 * epochs and
                  c["launches"]["train"][k] == 16 * epochs_ft,
                  f"recipe {k}: {a['launches']['train'][k]} / "
                  f"{c['launches']['train'][k]} training launches")
        check(tags == {"exact": -1, "finetuned": 1},
              f"checkpoint tags {tags}")
        losses = {k: cap[k]["timing"]["final_loss"]
                  for k in ("exact", "finetuned")}
        check(all(np.isfinite(v) for d in losses.values()
                  for v in d.values()), f"recipe losses {losses}")
        check(all(sorted(v) == SUMMARY_KEYS for v in summaries.values())
              and list(summaries) == ["exact", "naive", "finetuned"],
              f"recipe summaries {summaries}")
        # the audit of A's exact-tagged checkpoint, loaded as the audit's
        # CLI loads it: the window stays in force; then its statistics from
        # the exact pass (the offsets A was trained to produce)
        cfg = acc.protocol_config("", "")
        with dc.dcn_mode("windowed", 1):
            det = Detector(replace(cfg, load_model=a["checkpoint"]),
                           keep_dcn_mode=True)
            check(dc.dcn_radius_tag() == 1, "loading A's checkpoint for "
                  f"the audit switched the mode to {dc.dcn_radius_tag()}")
        frames = fixture_frames(fixture_scenes(2, 2, seed=0)[:2])
        audit_a = _run_audit("A's checkpoint, windowed in force", det,
                             frames)
        with dc.dcn_mode("exact"):
            audit_a_exact = offset_audit.audit(
                det, frames, radius=1,
                log=lambda m: log(f"[audit, A's checkpoint, exact pass] "
                                  f"{m.strip()}"))
        check(audit_a["stats_pass"] == "windowed" and
              audit_a_exact["stats_pass"] == "exact" and
              len(audit_a_exact["layers"]) == 16, "audit of A's checkpoint")
    out = {"epochs": epochs, "epochs_ft": epochs_ft, "wall_s": wall,
           "summaries": summaries, "tags": tags, "losses": losses,
           "deterministic": note,
           "launches": {k: cap[k]["launches"] for k in cap},
           "timing": {k: {t: cap[k]["timing"].get(t) for t in
                          ("train_s", "ms_per_step", "detect_s")}
                      for k in cap},
           "audit_exact_checkpoint": audit_a_exact,
           "audit_exact_checkpoint_windowed": audit_a}
    log(f"[recipe] {epochs} + {epochs_ft} epochs, f32, {wall:.1f} s: "
        f"summaries {json.dumps(summaries)}; tags {json.dumps(tags)}; "
        f"final losses {json.dumps(losses)}; "
        f"timing {json.dumps(out['timing'])}; launches "
        f"{json.dumps(out['launches'])}")
    return out


def phase_exact_audit_recipe(trained_ckpt: str) -> dict:
    """Phase 14: (a) the DCN kernels in exact mode at the protocol's
    shapes, (b) the offset audit at full width and on phase 11's
    checkpoint, (c) the clamp-finetune recipe."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"exact": _exact_rows()}
    t = time.perf_counter()
    out["audit"] = _audit_phase(trained_ckpt)
    out["audit_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["recipe"] = _recipe_phase()
    out["recipe_s"] = time.perf_counter() - t
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[phase 14] audit {out['audit_s']:.1f} s, recipe "
        f"{out['recipe_s']:.1f} s, phase {out['phase_s']:.1f} s")
    return out


# ------------------------------------- phase 15: acceptance over seeds
SHARE_SEEDS = (0, 1)


def phase_acceptance_seeds() -> dict:
    """Phase 15: `acceptance_rate.run_one`, the 2-scene protocol at f32
    (windowed R = 1, default mode), at each of SHARE_SEEDS."""
    from side_tpu_torch.ops.dcn_cuda import KERNELS
    from side_tpu_torch.tools import acceptance_rate as rate
    t_phase = time.perf_counter()
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    kernels = ("dcn_fwd", "dcn_bwd_dx", "dcn_bwd_dcoord")
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for seed in SHARE_SEEDS:
            for f in flags:
                f.allow_tf32 = True
            cap = {}
            reset_counts(KERNELS)
            line = rate.run_one(tmp, 2, "windowed", "float32", seed,
                                _capture=cap)
            check(all(f.allow_tf32 for f in flags),
                  f"seed {seed}: the run did not give the TF32 flags back")
            for f in flags:
                f.allow_tf32 = False
            timing, train = cap["timing"], cap["launches"]["train"]
            steps = timing["steps"]
            for name in kernels:
                check(train[name] == 16 * steps and
                      train[f"{name}_tensor_core"] == 0,
                      f"seed {seed}: {name} launched {train[name]} times "
                      f"({train[f'{name}_tensor_core']} on the tensor-core "
                      f"route) in {steps} steps, expected {16 * steps} on "
                      f"the f32 route")
            check(all(np.isfinite(v) for v in timing["final_loss"].values()),
                  f"seed {seed}: losses {timing['final_loss']}")
            runs[seed] = {"line": line,
                          "initial_digest": cap["initial_digest"],
                          "fixture_digest": cap["fixture_digest"],
                          "launches": cap["launches"],
                          "ms_per_step": timing["ms_per_step"],
                          "final_loss": timing["final_loss"]}
            log(f"[seeds] seed {seed}: {json.dumps(line)}; initial weights "
                f"{cap['initial_digest'][:12]}, fixture "
                f"{cap['fixture_digest'][:12]}; {steps} steps, "
                f"{timing['ms_per_step']:.1f} ms a step; launches "
                f"{json.dumps(cap['launches'])}")
    a, b = (runs[s] for s in SHARE_SEEDS)
    check(a["initial_digest"] != b["initial_digest"],
          "two seeds drew the same initial weights")
    check(a["fixture_digest"] == b["fixture_digest"],
          "two seeds trained on different fixtures")
    out = {"runs": runs, "phase_s": time.perf_counter() - t_phase,
           "floors_failed": {seed: r["line"]["floors_failed"]
                             for seed, r in runs.items()}}
    log(f"[seeds] floors failed by seed (printed, not held): "
        f"{json.dumps(out['floors_failed'])}; phase {out['phase_s']:.1f} s")
    return out


# ------------------------------- phase 16: the top-level entry points
def _bench_counts(iters: int) -> dict:
    """Serving calls and training steps of one `bench.main` at its
    defaults: a warm-up of the short loop, then each loop length twice;
    2 warm-up steps, then each step count twice."""
    from side_tpu_torch import bench
    n_small = max(2, iters // 10)
    return {"serving_calls": 3 * n_small + 2 * iters,
            "training_steps": 2 + 2 * sum(bench.TRAIN_STEPS)}


# launches per serving call and per training step of each kernel in
# `bench.main` at its defaults (bf16, full width)
BENCH_PER_CALL = {"dcn_fwd": (16, 16), "dcn_bwd_dx": (0, 16),
                  "dcn_bwd_dcoord": (0, 16), "dcn_fwd_om": (0, 0)}


def _bench_spied(kernels) -> tuple:
    """`bench.main([])`'s result line, and what spies counted in that run:
    the calls of the served function, the Trainer's steps, every kernel's
    launches at the first training figure's start (the serving loop's)
    and at the end, and the seconds."""
    import io
    from side_tpu_torch import bench
    spied = {"serving_calls": 0, "training_steps": 0}
    real_serving, real_trainer = bench.serving_pairs_per_s, bench.Trainer
    real_train = bench.train_pairs_per_s

    def serving_pairs_per_s(fn, *args, **kw):
        def counted(model, batch):
            spied["serving_calls"] += 1
            return fn(model, batch)
        return real_serving(counted, *args, **kw)

    class Trainer(real_trainer):
        def train_step(self, batch):
            spied["training_steps"] += 1
            return super().train_step(batch)

    def train_pairs_per_s(*args, **kw):
        spied.setdefault("at_train", _counts(kernels))
        return real_train(*args, **kw)

    reset_counts(kernels)
    buf = io.StringIO()
    t = time.perf_counter()
    bench.serving_pairs_per_s, bench.Trainer = serving_pairs_per_s, Trainer
    bench.train_pairs_per_s = train_pairs_per_s
    try:
        with contextlib.redirect_stdout(buf):
            check(bench.main([]) == 0, "bench.main failed")
    finally:
        bench.serving_pairs_per_s, bench.Trainer = real_serving, real_trainer
        bench.train_pairs_per_s = real_train
    spied["seconds"] = time.perf_counter() - t
    spied["counts"] = _counts(kernels)
    check("at_train" in spied, "bench.main took no training figure")
    line = buf.getvalue().strip().splitlines()[-1]
    log(line)
    return json.loads(line), spied


def _host_syncs(fn, model, batch) -> dict:
    """The synchronising CUDA calls of one chained serving iteration, as
    `torch.cuda.set_sync_debug_mode("warn")` reports them."""
    import warnings
    from side_tpu_torch import bench
    bench.chained(fn, model, batch, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            bench.chained(fn, model, batch, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    where = [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
             if "synchronizing" in str(w.message)]
    return {"count": len(where), "where": where}


def _reference_exact_on(trained_ckpt: str) -> dict:
    """Phase 3's `--reference_exact` rule on phase 11's R = 1 checkpoint:
    the Detector keeps exact mode (the JAX package's rule) and its forward
    launches only at radius -1."""
    from dataclasses import replace
    from side_tpu_torch.data.synthetic import fixture_frames, fixture_scenes
    from side_tpu_torch.ops import deform_conv as dc
    from side_tpu_torch.ops.dcn_cuda import KERNELS, launch_counts
    from side_tpu_torch.runtime.detector import Detector
    from side_tpu_torch.runtime import checkpoint
    from side_tpu_torch.tools import acceptance_16 as acc
    check(checkpoint.load_checkpoint(trained_ckpt).get("dcn_radius") == 1,
          "phase 11's checkpoint is not tagged R = 1")
    pinned = os.environ.pop("SIDE_TPU_TORCH_DCN", None)
    cfg = acc.protocol_config("", "", batch_size=TRAINED_RUN[1],
                              compute_dtype="bfloat16")
    _, images, calib = fixture_frames(
        fixture_scenes(TRAINED_RUN[0], 2, seed=0)[:1])[0]
    try:
        with dc.dcn_mode("windowed", 1):
            det = Detector(replace(cfg, load_model=trained_ckpt,
                                   reference_exact=True))
            mode = dc.dcn_radius_tag()
            reset_counts(KERNELS)
            det.run(images, calib=calib)
            torch.cuda.synchronize()
            launches = launch_counts()
    finally:
        if pinned is not None:
            os.environ["SIDE_TPU_TORCH_DCN"] = pinned
    check(mode == -1, f"--reference_exact on an R = 1 checkpoint runs at "
          f"radius {mode}, not exact")
    _only_at(launches, -1, ("dcn_fwd",), "--reference_exact detection")
    return {"radius": mode, "launches": {
        k: v for k, v in launches.items() if k.startswith("dcn_fwd") and v}}


def phase_entry_points(trained_ckpt: str) -> dict:
    """Phase 16: graft_entry.entry()'s function at full width, the host
    syncs of one chained iteration, `bench.main` at its defaults, the
    `--reference_exact` Detector on phase 11's checkpoint and
    `dryrun_multichip(2)` on the card."""
    from side_tpu_torch import bench, graft_entry
    from side_tpu_torch.ops.dcn_cuda import KERNELS
    t_phase = time.perf_counter()
    out = {}

    fn, (model, pair) = graft_entry.entry()
    reset_counts(KERNELS)
    rows = fn(model, pair)
    torch.cuda.synchronize()
    counts = _counts(KERNELS)
    check(counts["dcn_fwd"] == 16 and counts["dcn_fwd_tensor_core"] == 16
          and sum(counts[k] for k in KERNELS) == 16,
          f"entry()'s fn: launches {counts}, expected 16 dcn_fwd on the "
          f"tensor-core route and nothing else")
    check([tuple(r.shape) for r in rows] == [(1, 100, 6), (1, 100, 6),
                                             (1, 100, 10)],
          f"entry()'s fn: shapes {[tuple(r.shape) for r in rows]}")
    check(all(bool(torch.isfinite(r).all()) for r in rows),
          "entry()'s fn: non-finite rows")
    out["entry_launches"] = counts
    out["syncs"] = _host_syncs(fn, model, bench.repeat_pairs(pair, 2))
    log(f"[entry] fn: {json.dumps(counts)}; top score "
        f"{rows[0][0, 0, 4].item():.4f}; host syncs of one chained "
        f"iteration (B=2): {out['syncs']['count']} at "
        f"{json.dumps(out['syncs']['where'])}")
    del fn, model, pair, rows
    torch.cuda.empty_cache()

    iters = int(os.environ.get("BENCH_ITERS", "20"))
    out["bench"], spied = _bench_spied(KERNELS)
    counts, at_train = spied["counts"], spied["at_train"]
    calls = {k: spied[k] for k in ("serving_calls", "training_steps")}
    check(calls == _bench_counts(iters),
          f"bench: {calls}, expected {_bench_counts(iters)}")
    served, steps = calls["serving_calls"], calls["training_steps"]
    per_call = {k: {"per_serving_call": at_train[k] / served,
                    "per_training_step": (counts[k] - at_train[k]) / steps}
                for k in BENCH_PER_CALL}
    check(all(per_call[k] == {"per_serving_call": a, "per_training_step": b}
              and counts.get(f"{k}_tensor_core", 0) == counts[k]
              for k, (a, b) in BENCH_PER_CALL.items()),
          f"bench: launches per serving call and training step {per_call} "
          f"(totals {counts}), expected {BENCH_PER_CALL}, all on the "
          f"tensor-core route")
    out["bench_s"] = spied["seconds"]
    out["bench_launches"] = {**calls, **counts, "per_call": per_call}
    log(f"[bench] {served} serving calls, {steps} training steps "
        f"(counted): launches {json.dumps(counts)}, of them before the "
        f"first training step {json.dumps(at_train)}; per call and step "
        f"{json.dumps(per_call)}; {out['bench_s']:.1f} s")

    out["reference_exact"] = _reference_exact_on(trained_ckpt)
    log(f"[reference_exact] phase 11's R = 1 checkpoint under the flag: "
        f"radius {out['reference_exact']['radius']}, launches "
        f"{json.dumps(out['reference_exact']['launches'])}")

    dry = graft_entry.dryrun_multichip(2)
    for r in dry["ranks"]:
        check(r["launches"] == {k: 16 for k in ("dcn_fwd", "dcn_bwd_dx",
                                                 "dcn_bwd_dcoord")},
              f"dryrun rank on {r['device']}: launches {r['launches']}")
    out["dryrun"] = {k: dry[k] for k in ("loss", "loss_one", "rel",
                                         "seconds")}
    out["dryrun"]["ranks"] = dry["ranks"]
    log(f"[dryrun] {json.dumps(out['dryrun'])}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[phase 16] {out['phase_s']:.1f} s")
    return out


def _shape(row) -> tuple:
    return (row["cin"], row["h"], row["w"], row["cout"])


def _per_unit(rows, key, count_key):
    """Sum over the unit's launches: each shape's value times its count
    (cases off the main path have count 0)."""
    return sum(r[key] * r[count_key] for r in rows if r[count_key])


def _routes(rows) -> dict:
    """How many of the checked cases took each route."""
    return {route: sum(r["route"] == route for r in rows)
            for route in ("tensor", "cuda_core")}


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
    from side_tpu_torch.ops.box_solve_cuda import BOX_SOLVE_LIB
    from side_tpu_torch.ops.dcn_cuda import BWD_LIB, FWD_LIB, OM_LIB
    from side_tpu_torch.ops.gather_cuda import GATHER_LIB
    from side_tpu_torch.tools.acceptance_16 import PROTOCOL_SHAPES
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
    with tempfile.TemporaryDirectory() as keep:
        trained = phase_trained_checkpoint(keep)
        zoo = phase_model_zoo()
        dp = phase_data_parallel()
        p14 = phase_exact_audit_recipe(trained["checkpoint"])
        p15 = phase_acceptance_seeds()
        p16 = phase_entry_points(trained["checkpoint"])
    box = phase_box_solve()

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
        "tensor_core_launches": main_path["tensor_core_launches"],
        "tensor_core_launches_training":
            train["tensor_core_launches"]["dcn_fwd"],
        "routes_checked": _routes(fwd_rows),
        "cuda_core_ms": _per_unit(bf16, "cuda_core_ms", "per_frame"),
        "regular_grid_ms": _per_unit(bf16, "regular_grid_ms", "per_frame"),
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
            for key in ("ms", "cuda_core_ms", "plain_ms", "bound_ms")},
        "checked_shapes": {
            path: len({shape for shape in map(_shape, rows)
                       if shape in shapes})
            for path, rows, shapes in (
                ("serving, B=2", kern["rows"],
                 [sh for sh, _ in SERVING_SHAPES]),
                ("training, B=8", fwd_rows[len(kern["rows"]):],
                 [sh for sh, _ in SERVING_SHAPES]),
                ("acceptance 128x384, B=8", fwd_rows, PROTOCOL_SHAPES))},
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
            "tensor_core_launches":
                train["tensor_core_launches"].get(name, 0),
            "routes_checked": _routes(rows),
            "cuda_core_ms": _per_unit(step, "cuda_core_ms", "per_step"),
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
        det = [r for r in bwd["deterministic"] if r["kernel"] == name]
        train_det = [r for r in det if r["offsets"] == "random"]
        entries[-1]["deterministic"] = {
            "unit": "one training step under deterministic_mode (16 "
                    "launches, B=8, bf16); protocol: one step of phase 11",
            **{key: _per_unit(train_det, key, "per_step")
               for key in ("ms", "default_ms")},
            **{f"protocol_{key}": _per_unit(
                [r for r in det if r["offsets"] == "far_outside"], key,
                "per_step") for key in ("ms", "default_ms")},
            "max_rel_err_bf16": max(r["max_rel_err"] for r in det),
            "repeat_equal": all(r["repeat_equal"] for r in det),
            "per_shape": det}
    entries[-2]["scatter_checked"] = {
        kind: sum(r.get("scatter") == kind for r in bwd["rows"])
        for kind in ("patch", "tile")}
    entries[-2]["max_rel_err_border"] = max(
        r["max_rel_err_border"] for r in bwd["rows"]
        if r["kernel"] == "dcn_bwd_dx")
    om_group = [r for r in fused["rows"] if r["dtype"] == "bfloat16"
                and r["batch"] == 8]
    entries.append({
        "name": "dcn_fwd_om", "route": "cuda",
        "source": str(OM_LIB.source.relative_to(root)),
        "replaces": "side_tpu/ops/dcn_pallas.py:691",
        "launches": validation["launches"]["dcn_fwd_om"],
        "tensor_core_launches": validation["tensor_core_launches"],
        "routes_checked": _routes(fused["rows"]),
        "cuda_core_ms": _per_unit(om_group, "cuda_core_ms", "per_group"),
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
        "ms": g_bf16["ms"], "earlier_ms": g_bf16["earlier_ms"],
        "l2_read_ms": g_bf16["l2_read_ms"], "l2_bytes": g_bf16["l2_bytes"],
        "plain_ms": g_bf16["plain_ms"],
        "bound_ms": g_bf16["bound_ms"], "bound_by": g_bf16["bound_by"],
        "library_ms": g_bf16["library_ms"],
        "library_call": "F.grid_sample(bilinear, border, align_corners=True)"
                        " on an NCHW copy; equal for in-bounds positions",
        "unit": "the probe's shape: x (2, 96, 320, 64) bf16, 552,960 samples",
        "per_shape": gather["rows"],
    })
    # phase 11's launches, in training and in detection
    for entry in entries:
        name = entry["name"]
        if name in ("dcn_fwd", "dcn_bwd_dx", "dcn_bwd_dcoord"):
            entry["launches_trained_run"] = {
                part: trained["launches"][part][name]
                for part in ("train", "detect")}
            entry["tensor_core_launches_trained_run"] = {
                part: trained["launches"][part][f"{name}_tensor_core"]
                for part in ("train", "detect")}
        elif name == "dcn_fwd_om":
            entry["launches_trained_run"] = trained["fused_launches"]
            entry["tensor_core_launches_trained_run"] = \
                trained["fused_tensor_core_launches"]
    # phase 12: the model zoo's launches and the resdcn_18 shapes
    zoo_fwd = zoo["dcn"]["fwd"] + [r for r in zoo["dcn"]["bwd"]
                                   if r["kernel"] == "dcn_fwd"]
    for entry in entries:
        name = entry["name"]
        if name in ("dcn_fwd", "dcn_bwd_dx", "dcn_bwd_dcoord"):
            rows = (zoo_fwd if name == "dcn_fwd" else
                    [r for r in zoo["dcn"]["bwd"] if r["kernel"] == name])
            unit = [r for r in rows if r["dtype"] == "bfloat16" and
                    r["batch"] == (BATCH if name == "dcn_fwd"
                                   else TRAIN_BATCH)]
            count = "per_frame" if name == "dcn_fwd" else "per_step"
            entry["model_zoo"] = {
                "launches": {part: zoo[part]["launches"][name] for part in
                             ("voxel_detect", "voxel_train", "resdcn_detect",
                              "resdcn_train")},
                "resdcn_18_unit": ("one resdcn_18 frame (3 launches, B=2, "
                                   "bf16)" if name == "dcn_fwd" else
                                   "one resdcn_18 step (3 launches, B=8, "
                                   "bf16)"),
                **{key: _per_unit(unit, key, count) for key in
                   ("ms", "plain_ms", "bound_ms", "cuda_core_ms")},
                "bound_by": _bound_by(unit, count),
                "max_rel_err_bf16": max(r["max_rel_err"] for r in rows
                                        if r["dtype"] == "bfloat16"),
                "max_rel_err_f32": max(r["max_rel_err"] for r in rows
                                       if r["dtype"] == "float32"),
                "per_shape": rows}
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       max(r["max_abs_err"] for r in rows))
        elif name == "gather_bilinear":
            serve = next(r for r in zoo["gather"]["rows"]
                         if r["images"] == 1 and r["dtype"] == "bfloat16")
            entry["probe"] = {k: entry[k] for k in (
                "launches", "launches_path", "ms", "earlier_ms",
                "l2_read_ms", "l2_bytes", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "unit")}
            entry.update({
                "launches": zoo["voxel_detect"]["launches"][name],
                "launches_path": f"--depth_variant voxel serving, "
                                 f"{ZOO_FRAMES} frames",
                "launches_training": zoo["voxel_train"]["launches"][name],
                "max_abs_err": max(entry["max_abs_err"], *(
                    r["max_abs_err"] for r in zoo["gather"]["rows"])),
                "ms": serve["ms"], "plain_ms": serve["plain_ms"],
                "bound_ms": serve["bound_ms"],
                "bound_by": serve["bound_by"],
                "library_ms": serve["library_ms"],
                "library_call": entry["library_call"],
                "unit": "the voxel path's serving launch: x (1, 96, 320, 64) "
                        "bf16, 100 objects x 1000 voxels, f32 out",
                "bwd_rel_err": max(r["bwd_rel_err"] for r in
                                   zoo["gather"]["rows"]
                                   if "bwd_rel_err" in r),
                "per_shape_voxel": zoo["gather"]["rows"]})
            for key in ("earlier_ms", "l2_read_ms", "l2_bytes"):
                entry.pop(key)
    # phase 13: the launches of each rank of the data-parallel run
    for entry in entries:
        if entry["name"] in DP_KERNELS:
            entry["launches_data_parallel"] = {
                "per_rank": [counts[entry["name"]] for counts in
                             dp["gloo_one_card"]["launches_per_rank"]],
                "path": f"data-parallel training, 2 gloo ranks on one "
                        f"card, {DP_STEPS} steps of 2 pairs a rank"}
    # phase 14: exact mode at the protocol's shapes, the audit's and the
    # recipe's launches
    for entry in entries:
        name = entry["name"]
        if name not in DP_KERNELS:
            continue
        rows = [r for r in p14["exact"] if r["kernel"] == name]
        audit, recipe = p14["audit"], p14["recipe"]["launches"]
        entry["exact_protocol"] = {
            "unit": "one recipe step at 128x384 (16 launches, B=4), exact "
                    "mode (R=-1), offsets far outside +-1",
            **{dtype: {key: _per_unit([r for r in rows
                                       if r["dtype"] == dtype], key,
                                      "per_step")
                       for key in ("ms", "plain_ms", "bound_ms")}
               for dtype in ("float32", "bfloat16")},
            "routes_checked": _routes(rows),
            "max_rel_err_bf16": max(r["max_rel_err"] for r in rows
                                    if r["dtype"] == "bfloat16"),
            "max_rel_err_f32": max(r["max_rel_err"] for r in rows
                                   if r["dtype"] == "float32"),
            "per_shape": rows}
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   max(r["max_abs_err"] for r in rows))
        entry["launches_phase14"] = {
            "recipe": {f"{phase} {part}": {
                k.replace(f"{name}_", ""): v
                for k, v in recipe[phase][part].items()
                if k == name or k.startswith(f"{name}_radius")}
                for phase in recipe for part in recipe[phase]}}
        if name == "dcn_fwd":
            entry["launches_phase14"].update({
                f"audit {cell} {mode} pass": {
                    k.replace(f"{name}_", ""): v
                    for k, v in audit[cell]["launches"][mode].items()
                    if k == name or k.startswith(f"{name}_radius")}
                for cell in ("serving", "trained")
                for mode in ("windowed", "exact")})
    # phase 15: the launches of each seed's 2-scene f32 run
    for entry in entries:
        if entry["name"] in DP_KERNELS:
            entry["launches_acceptance_seeds"] = {
                f"seed {seed}": {part: r["launches"][part][entry["name"]]
                                 for part in ("train", "detect")}
                for seed, r in p15["runs"].items()}
    # phase 16: graft_entry.entry()'s function, bench.main, the dry run
    for entry in entries:
        name = entry["name"]
        if name not in DP_KERNELS:
            continue
        bl = p16["bench_launches"]
        entry["launches_bench"] = {
            "path": f"python -m side_tpu_torch.bench at its defaults: "
                    f"{bl['serving_calls']} calls of entry()'s function "
                    f"(B=2 pairs), {bl['training_steps']} training steps "
                    f"(2 pairs, bf16)",
            "total": bl[name], "tensor_core": bl[f"{name}_tensor_core"],
            **bl["per_call"][name]}
        entry["launches_dryrun_per_rank"] = [
            r["launches"][name] for r in p16["dryrun"]["ranks"]]
        if name == "dcn_fwd":
            entry["launches_entry_fn"] = p16["entry_launches"][name]
            entry["launches_reference_exact"] = \
                p16["reference_exact"]["launches"]
    group = next(r for r in box["rows"] if r["rows"] == 800)
    entries.append({
        "name": "box_solve", "route": "cuda",
        "source": str(BOX_SOLVE_LIB.source.relative_to(root)),
        "replaces": None,
        "replaces_note": "replaces no TPU kernel: the JAX package solves "
                         "with jnp ops under vmap(jacfwd)",
        "launches": validation["launches"]["box_solve"],
        "launches_path": f"validation, {validation['groups']} groups of 4 "
                         "frames (2 a group)",
        "max_abs_err": max(r["max_abs_err"] for r in box["rows"]),
        **{k: group[k] for k in ("ms", "launch_floor_ms", "plain_ms",
                                 "host_ms", "plain_host_ms", "bound_ms",
                                 "bound_by")},
        "library_ms": None,
        "unit": "one validation group of 8 frames at K = 100 (800 rows)",
        "per_shape": box["rows"],
    })
    print(json.dumps({"kernels": entries}), flush=True)
    log(f"[summary] validation {json.dumps(validation['times'])}; "
        f"launches {json.dumps(validation['launches'])}")
    log(f"[summary] trained run, {trained['scenes']} scenes, bf16: clean "
        f"{json.dumps(trained['summary']['clean'])}; "
        f"{trained['s_per_epoch']:.3f} s per epoch, "
        f"{trained['ms_per_step']:.1f} ms per step, run "
        f"{trained['wall_s']:.1f} s, phase {trained['phase_s']:.1f} s, "
        f"weights digest {trained['weights_digest']}; "
        f"eval_batch 4 fused vs 1 unfused {json.dumps(trained['match'])}")
    log(f"[summary] train step {train['step_ms_median']:.1f} ms median, "
        f"split {json.dumps(train['split'])}, peak "
        f"{train['peak_mem_gib']:.2f} GiB; small-train check "
        f"{json.dumps(small_train)}; script "
        f"{time.perf_counter() - t_start:.1f} s")
    log(f"[summary] model zoo: voxel frame "
        f"{zoo['voxel_detect']['tot_ms_median']:.1f} ms, step "
        f"{zoo['voxel_train']['step_ms_median']:.1f} ms (peak "
        f"{zoo['voxel_train']['peak_mem_gib']:.2f} GiB); resdcn_18 "
        f"--not_cost_volume frame "
        f"{zoo['resdcn_detect']['tot_ms_median']:.1f} ms, step "
        f"{zoo['resdcn_train']['step_ms_median']:.1f} ms (peak "
        f"{zoo['resdcn_train']['peak_mem_gib']:.2f} GiB); forwards "
        f"{json.dumps(zoo['forwards'])}; --remat peak "
        f"{json.dumps(zoo['remat']['peak_gib'])} GiB; phase "
        f"{zoo['phase_s']:.1f} s")
    gloo, two = dp["gloo_one_card"], dp["nccl_two_cards"]
    log(f"[summary] data parallel: per-rank step ms "
        f"{json.dumps(gloo['step_ms'])}, collective share "
        f"{json.dumps(gloo['collective_share'])} (2 ranks on one card: no "
        f"scaling figure), step 1 vs one process "
        f"{gloo['loss_rel_err']:.2e} / {gloo['running_rel_err']:.2e} "
        f"(bounds {gloo['bound'][0]:.2e} / {gloo['bound'][1]:.2e}); "
        f"world-1 nccl {dp['nccl_world1']['loss_rel_err']:.2e}; nccl two "
        f"cards {two if isinstance(two, str) else two['step_ms']}; phase "
        f"{dp['phase_s']:.1f} s")
    rec = p14["recipe"]
    log(f"[summary] phase 14: exact-mode kernels at the protocol's shapes "
        f"{len(p14['exact'])} rows held; audit serving global max "
        f"|offset| {p14['audit']['serving']['global_max']:.3f}, deltas "
        f"{json.dumps(p14['audit']['serving']['deltas'])}; trained "
        f"checkpoint global max "
        f"{p14['audit']['trained']['global_max']:.3f}, deltas "
        f"{json.dumps(p14['audit']['trained']['deltas'])}; recipe "
        f"{rec['epochs']} + {rec['epochs_ft']} epochs "
        f"{rec['wall_s']:.1f} s: {json.dumps(rec['summaries'])}; A's "
        f"checkpoint global max |offset| "
        f"{rec['audit_exact_checkpoint']['global_max']:.3f}; phase "
        f"{p14['phase_s']:.1f} s; script "
        f"{time.perf_counter() - t_start:.1f} s")
    log(f"[summary] phase 15: floors failed by seed "
        f"{json.dumps(p15['floors_failed'])}; phase "
        f"{p15['phase_s']:.1f} s; script "
        f"{time.perf_counter() - t_start:.1f} s")
    log(f"[summary] phase 16: bench {json.dumps(p16['bench'])} "
        f"({p16['bench_s']:.1f} s); host syncs of one chained iteration "
        f"{p16['syncs']['count']}; dryrun_multichip(2) "
        f"{p16['dryrun']['seconds']:.1f} s, rel diff "
        f"{p16['dryrun']['rel']:.2e}; phase {p16['phase_s']:.1f} s; script "
        f"{time.perf_counter() - t_start:.1f} s")
    print(power_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
