"""Where one serving frame's, one batched validation group's, or one
training step's time goes on the GPU.

    python -m side_tpu_torch.stage_profile [--frames 5] [--out FILE]
    python -m side_tpu_torch.stage_profile --train [--frames 5] [--out FILE]
    python -m side_tpu_torch.stage_profile --val --eval_batch 4 [--dcn_fused]

Serving: runs the flagship Detector (Config(): 384x1280 input, bf16, K=100)
on seeded random weights and random KITTI-size frames, as chip_smoke.py
does, and reports two things:

  * `stages`: each stage of a frame between `torch.cuda.synchronize()`
    fences, median over `--frames` frames after two warm-up frames: host
    load + pre-process (with the upload), network, decode, device tail (box
    solve, dense alignment, re-solve) and fetch;
  * `profile`: one more frame under torch.profiler: kernel launches, device
    busy time and its share of the frame's wall time, device time by kind
    of kernel and the 15 kernels of most device time.

Training (`--train`): the flagship Trainer (Config(), batch 4 stereo pairs
of rendered scenes held in memory, He-scaled seeded weights): `stages` are
the forward + loss, backward and optimizer of a step between fences,
median over `--frames` steps after two warm-up steps, and `profile` one
more step under torch.profiler.

Validation (`--val --eval_batch B`): the flagship Detector on rendered
scenes held in memory, one group of B frames through
`dispatch_batch` / `finish_batch` (`dispatch` / `finish` at B = 1):
`stages` are the group's pre-process, network, decode, batched tail and
fetch between fences, median over `--frames` groups after two warm-up
groups, and `profile` one more group under torch.profiler (launches, busy
share, time by kernel kind), with the per-frame figures beside them.

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
    # K4 is the forward body instantiated with the OmGeom functor; the pass
    # that adds a small layer's split sums (dcn_fwd_finish) counts as dcn_fwd
    ("dcn_fwd_om (K4)", ("dcn_fwd_om", "omgeom")),
    ("dcn_fwd", ("dcn_fwd",)),
    ("dcn_bwd_dx (K2)", ("dcn_bwd_dx",)),
    ("dcn_bwd_dcoord (K3)", ("dcn_bwd_dcoord",)),
    ("optimizer (foreach)", ("multi_tensor",)),
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


def profile_call(fn) -> dict:
    """fn() under torch.profiler, ended by a device fence."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
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


def step_stages(tr, batch) -> dict:
    """One training step, forward + loss, backward and optimizer each
    between device fences; times in ms."""
    tr.model.train()
    for p in tr.params.values():
        p.grad = None
    b, t_up = _fenced(lambda: tr.to_device(batch))
    (total, _), t_fwd = _fenced(lambda: tr.loss(b))
    _, t_bwd = _fenced(total.backward)
    _, t_opt = _fenced(tr.optimizer.step)
    return {"upload": t_up, "forward": t_fwd, "backward": t_bwd,
            "optimizer": t_opt}


def flagship_trainer(n_batches: int):
    """The flagship Trainer on the card (Config(): 384x1280, bf16, max_objs
    50, roi_size 16; batch 4 stereo pairs) on He-scaled seeded weights with
    perturbed offsets, and `n_batches` host batches of rendered scenes."""
    from .data.synthetic import scene_batch
    from .models.factory import create_model
    from .runtime.trainer import Trainer
    cfg = Config(batch_size=4)
    model = create_model(cfg, seed=21)
    he_scale(model)
    perturb_offsets(model, seed=22)
    tr = Trainer(cfg, model, steps_per_epoch=100)
    rng = np.random.RandomState(20)
    batches = [scene_batch(cfg, rng, cfg.batch_size, cfg.max_objs)
               for _ in range(n_batches)]
    return tr, batches


def train_profile(card: str, steps: int):
    tr, batches = flagship_trainer(steps + 3)
    for b in batches[:2]:
        tr.train_step(tr.to_device(b))
    torch.cuda.reset_peak_memory_stats()
    runs = [step_stages(tr, b) for b in batches[2:-1]]
    stages = {"card": card, "steps": len(runs), "pairs_per_step": 4,
              "median_ms": {k: statistics.median(r[k] for r in runs)
                            for k in runs[0]},
              "min_ms": {k: min(r[k] for r in runs) for k in runs[0]},
              "max_ms": {k: max(r[k] for r in runs) for k in runs[0]},
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    last = tr.to_device(batches[-1])
    prof = {"card": card, **profile_call(lambda: tr.train_step(last))}
    return stages, prof


def group_stages(det: Detector, frames) -> dict:
    """One group of (image id, (left, right), calib) frames, a single one
    for serving, each stage between device fences; times in ms."""
    from .postprocess.device_tail import run_tail_batch
    pres, t_pre = _fenced(lambda: [det.load_and_pre(pair, calib)
                                   for _, pair, calib in frames])
    batch = {k: torch.cat([p["batch"][k] for p in pres], dim=0)
             for k in pres[0]["batch"]}
    out, t_net = _fenced(lambda: det.network(batch))
    (dets, dets_r, info), t_dec = _fenced(lambda: det.decode(out))
    with torch.inference_mode():
        (rows, _), t_tail = _fenced(lambda: run_tail_batch(
            dets, dets_r, info, [p["image"] for p in pres],
            [p["image_right"] for p in pres], [p["meta"] for p in pres],
            det.cfg))
    _, t_fetch = _fenced(lambda: rows.cpu().numpy())
    return {"pre": t_pre, "network": t_net, "decode": t_dec,
            "tail": t_tail, "fetch": t_fetch}


def val_profile(card: str, groups: int, eval_batch: int, fused: bool):
    from .data.synthetic import val_scenes
    from .ops import deform_conv as dc
    det = Detector(Config())
    he_scale(det.model)
    perturb_offsets(det.model, seed=1)
    scenes = val_scenes(eval_batch * (groups + 3), seed=0)
    chunks = [scenes[i:i + eval_batch]
              for i in range(0, len(scenes), eval_batch)]

    def run_group(frames):
        pres = [det.load_and_pre(pair, calib) for _, pair, calib in frames]
        if eval_batch == 1:
            return [det.finish(det.dispatch(pres[0]))]
        return det.finish_batch(det.dispatch_batch(pres))

    with dc.dcn_fused(fused):
        for frames in chunks[:2]:
            run_group(frames)
        runs = [group_stages(det, frames) for frames in chunks[2:-1]]
        prof = profile_call(lambda: run_group(chunks[-1]))
    med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    stages = {"card": card, "groups": len(runs), "eval_batch": eval_batch,
              "dcn_fused": fused, "median_ms": med,
              "median_ms_per_frame": {k: v / eval_batch
                                      for k, v in med.items()},
              "min_ms": {k: min(r[k] for r in runs) for k in runs[0]},
              "max_ms": {k: max(r[k] for r in runs) for k in runs[0]}}
    prof = {"card": card, "eval_batch": eval_batch, "dcn_fused": fused,
            **prof}
    if "kernel_launches" in prof:
        prof["kernel_launches_per_frame"] = \
            prof["kernel_launches"] / eval_batch
        prof["wall_ms_per_frame"] = prof["wall_ms"] / eval_batch
    return stages, prof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--train", action="store_true",
                    help="profile a training step instead of a frame")
    ap.add_argument("--val", action="store_true",
                    help="profile a batched validation group")
    ap.add_argument("--eval_batch", type=int, default=4)
    ap.add_argument("--dcn_fused", action="store_true",
                    help="--val: the fused offset/mask DCN kernel")
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
    if args.train:
        stages, prof = train_profile(card, args.frames)
        return _report(stages, prof, args.out)
    if args.val:
        stages, prof = val_profile(card, args.frames, args.eval_batch,
                                   args.dcn_fused)
        return _report(stages, prof, args.out)
    cfg = Config()
    det = Detector(cfg)
    he_scale(det.model)
    perturb_offsets(det.model, seed=1)
    rng = np.random.RandomState(0)
    calib = kitti_calib()
    frames = [random_frame(rng) for _ in range(args.frames + 3)]
    for f in frames[:2]:
        det.run(f, calib=calib)
    runs = [group_stages(det, [(0, f, calib)]) for f in frames[2:-1]]
    stages = {"card": card, "frames": len(runs),
              "median_ms": {k: statistics.median(r[k] for r in runs)
                            for k in runs[0]},
              "min_ms": {k: min(r[k] for r in runs) for k in runs[0]},
              "max_ms": {k: max(r[k] for r in runs) for k in runs[0]}}
    prof = {"card": card,
            **profile_call(lambda: det.run(frames[-1], calib=calib))}
    return _report(stages, prof, args.out)


def _report(stages, prof, out) -> int:
    lines = [json.dumps({"stages": stages}), json.dumps({"profile": prof})]
    for line in lines:
        print(line, flush=True)
    if out:
        with open(out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
