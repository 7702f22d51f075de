"""The readings that the correctness limits are set from.

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--f32-seeds 1,2] [--seconds 2]

For each of `--seeds`, one whole run of the cell (a short window) prints
the program's numbers, the lower readings, with the look behind them: the
numbers no limit holds (the worst leaves by name, each single layer's
gap, the tail's worst row).  `--f32-seeds` runs the program itself at
float32, TF32 off: a second witness.  For each of `--control-seeds`, the
reference is put in the program's place on the same inputs and weights in
a control precision and compared with the float32 reference as the run
compares the program: the upper readings.  A training cell reads fp8
(one step below its bfloat16) and, as a fault, half of each batch left
out; a validation cell reads the network in fp8 and the device tail,
which computes in float32, in bf16.  One JSON line per reading."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from typing import Dict

import numpy as np
import torch

from . import check, run as bench_run, weights
from .reference import float32, layers, model as ref_model
from .reference.detect import decoded, pre_process, tail_on
from .reference.precision import control
from .reference.train import run_steps, stereo_images
from .traffic import generator

TRAIN_SIDES = (("control", "fp8"), ("half_batch", None))


def _as_program(ref: dict, p0: dict) -> dict:
    return {"losses": ref["losses"],
            "mu1": {k: g * (1 - check.B1) for k, g in ref["first_grads"].items()},
            "p0": p0, "pn": ref["params"]}


def first_grads(prog: dict) -> Dict[str, torch.Tensor]:
    """The first step's gradient as the optimizer got it: Adam's first
    moment after one step over 1 - b1."""
    return {k: v / (1.0 - check.B1) for k, v in prog["mu1"].items()}


def train_look(prog: dict, ref: dict, n: int = 6) -> dict:
    """What the training numbers do not show: the worst step's loss gap, the
    first gradient's gap of norms by the median leaf, the worst leaves of
    the first gradient and
    of the change (name, gap, reference norm over the median leaf's), and
    each single layer's gap."""
    def worst(gaps, norms):
        med = float(np.median(list(norms.values())))
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
        return [[k, round(v, 5), round(norms[k] / med, 5)] for k, v in top]
    grad = check.leaf_gaps(first_grads(prog), ref["first_grads"])
    gnorm = {k: float(v.double().norm())
             for k, v in ref["first_grads"].items()}
    keep = check.moved_leaves(ref)
    d_prog, d_ref = check.changes(prog, ref, keep)
    update = check.leaf_gaps(d_prog, d_ref)
    unorm = {k: float(v.double().norm()) for k, v in d_ref.items()}
    return {"loss_gap": max(check.loss_gaps(prog, ref)),
            "grad_gap_p50": float(np.median(list(grad.values()))),
            "grad_gap_max": max(grad.values()),
            "grad_gap_p90": float(np.percentile(list(grad.values()), 90)),
            "worst_grad": worst(grad, gnorm),
            "update_gap_max": max(update.values()),
            "worst_update": worst(update, unorm),
            "layers": prog["layers"]}


def val_look(group) -> dict:
    """What the validation numbers do not show: rows returned per frame of
    the group, each single layer's gap, and the tail's worst row and rows
    judged."""
    m = group["mask"]
    d = check.tail_dist(group["rows"][m], group["ref_rows"][m])
    return {"rows": [sum(len(r) for r in f.values())
                     for f in group["filtered"]],
            "layers": group["layers"],
            "tail_rows": int(m.sum()),
            "tail_max": float(d.max()) if len(d) else 0.0}


def train_readings(r: "bench_run.Run", device) -> dict:
    mix = r.mix
    keys = dict(r.config_keys, batch_size=int(mix["pairs_per_step"]))
    cfg = r.ref_config(keys)
    pool = generator.train_pool(cfg, mix, r.seed)
    w = weights.draw(ref_model.build(cfg), r.seed, device)
    batches = pool[:int(mix["warmup_steps"])]
    out = {}
    with float32():
        base = run_steps(cfg, ref_model.loaded(cfg, w, device), batches,
                         steps_per_epoch=len(pool))
        p0 = {k: v.clone() for k, v in w.items() if k in base["params"]}
        if cfg.uncert:
            p0["loss_weight"] = torch.full((7,), -1.0, device=device)
        for side, fmt in TRAIN_SIDES:
            m = ref_model.loaded(cfg, w, device)
            if fmt:
                with control(fmt):
                    other = run_steps(cfg, m, batches, len(pool),
                                      keep_layers=True)
            else:
                other = run_steps(cfg, m, batches, len(pool),
                                  fault="half_batch", keep_layers=True)
            del m
            first = ref_model.loaded(cfg, w, device)
            as_prog = _as_program(other, p0)
            as_prog["layers"] = layers.gaps(
                first, other["layers"], device,
                layers.stem_input(cfg, stereo_images(batches[0]), device))
            del first
            look = train_look(as_prog, base)
            out[side] = dict(check.train_numbers(as_prog, base),
                             loss_gap=look["loss_gap"],
                             grad_gap_p50=look["grad_gap_p50"], **{
                                 f"layer.{k}": v
                                 for k, v in look["layers"].items()})
            del other
            gc.collect()
    return out


def val_readings(r: "bench_run.Run", device) -> dict:
    """The validation numbers of each control on the pool's first group:
    the network's single layers in fp8 (the first frame's forward), and
    the device tail's in bf16 on the float32 reference's decoded
    detections."""
    mix = r.mix
    cfg = r.ref_config(dict(r.config_keys))
    pool = generator.val_pool(cfg, mix, r.seed)
    w = weights.draw(ref_model.build(cfg), r.seed, device)
    B = int(mix["eval_batch"])
    group = [pool[i % len(pool)][1:] for i in range(B)]
    align = bool(mix["align"])
    out = {}
    with float32():
        m = ref_model.loaded(cfg, w, device)
        (image, image_right), calib = group[0]
        stem_x = layers.stem_input(
            cfg, pre_process(cfg, image, image_right, calib)[0][0], device)
        kept, unhook = layers.capture(m)
        with control("fp8"):
            decoded(cfg, m, (image, image_right), calib, cfg.K)
        unhook()
        out["control"] = check.val_numbers(
            {"layers": layers.gaps(m, kept, device, stem_x)})
        dec = [decoded(cfg, m, pair, calib, cfg.K) for pair, calib in group]
        dets, dets_r, info = (torch.cat([d[j] for d in dec])
                              for j in range(3))
        base = tail_on(cfg, dets, dets_r, info, group, align)
        with control("bf16"):
            rows = tail_on(cfg, dets, dets_r, info, group, align)
        out["control_tail"] = check.val_numbers({
            "rows": rows, "ref_rows": base,
            "mask": check.tail_rows(rows, cfg.peak_thresh, cfg.align_topk)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--f32-seeds", default="",
                    help="seeds of a second witness: the program itself at "
                         "float32 compute, TF32 off")
    args = ap.parse_args(argv)
    bench_run._fixed_caches()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")

    def look(r):
        return (train_look(*r.compared) if r.mix["kind"] == "train_loop"
                else val_look(r.compared))

    for seed in (int(s) for s in args.seeds.split(",") if s):
        r = bench_run.execute(args.workload, seed, args.seconds, False)
        out = r.result()
        print(json.dumps({"seed": seed, "side": "program",
                          "correct": out["correct"], "numbers": r.numbers,
                          "look": look(r), "metrics": out["metrics"]}),
              flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    for seed in (int(s) for s in args.f32_seeds.split(",") if s):
        with float32():
            r = bench_run.execute(args.workload, seed, args.seconds, False,
                                  config_overrides={
                                      "compute_dtype": "float32"})
        print(json.dumps({"seed": seed, "side": "program_f32",
                          "numbers": r.numbers, "look": look(r)}), flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    bench = json.load(open(os.path.join(bench_run.ROOT, "BENCHMARK.json")))
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        r = bench_run.Run(bench, args.workload, seed, 0, False, device)
        kind = r.mix["kind"]
        readings = (train_readings(r, device) if kind == "train_loop"
                    else val_readings(r, device))
        for side, numbers in readings.items():
            print(json.dumps({"seed": seed, "side": side,
                              "numbers": numbers}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
