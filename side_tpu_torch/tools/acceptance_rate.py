"""How often the acceptance protocol meets its floors, over seeds and over
repeats of one seed, and how well each trained checkpoint fits the cost
volume's depth on its own training samples.

    python -m side_tpu_torch.tools.acceptance_rate --scenes 2 --seeds 0-15 \\
        --dcn windowed --dtypes float32,bfloat16

Each run is `acceptance_16.run_overfit_variants` (the 2-scene protocol:
batch 2, 160 epochs; `--scenes 16`: batch 4, 240 epochs), with the DCN
windowed at R = 1 (the protocol's) or exact (unbounded).  `--seeds` (a
list or ranges: `0-15`, `0,3,5-7`; default 0) draws the initial weights
and the batch order of each run, the scenes staying those of seed 0;
`--reps` repeats each seed (one draw of the card's f32 atomics each).  An
f32 run is IEEE f32 (TF32 off).  Then, on the checkpoint it wrote,
`depth_fit`: the cost volume's depth against the GT depth on the training
samples themselves, fed the GT boxes as in training, once with the batch's
own BatchNorm statistics (as the last training steps saw them) and once
with the running statistics (as detection sees them).  `z_cv` of the
protocol adds the predicted boxes to the latter.

Prints one JSON line per run (`mode`, `dtype`, `seed`, `rep`,
`floors_failed`, the per-object `z_cv`, `ry`, `z`, the car 2D AP, seconds
`s`, and `depth_fit`: the median absolute and the mean signed error in
metres of each BatchNorm mode), then a `tally` line: the runs and those
that met every floor, in all and for each `mode/dtype`, with the misses of
each floor by name.  Runs on the GPU unless `--device cpu` is given;
writes under `--out`.  `--input_h` and `--input_w` (default 128x384, the
protocol's) exist for the CPU test.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import time

import numpy as np

from ..ops import deform_conv as dc
from . import acceptance_16 as acc

PROTOCOLS = {2: (2, 160), 16: (4, 240)}   # scenes -> (pairs a step, epochs)


def depth_fit(cfg, scenes, checkpoint, device=None) -> dict:
    """Signed errors (m) of the cost volume's depth against the GT depth
    over every GT object of `scenes`, fed the GT boxes: {"train_bn": the
    batch's statistics, "eval_bn": the running ones}.  Run under the DCN
    mode the checkpoint was trained in."""
    import torch
    from .. import weights
    from ..data.loader import Loader
    from ..data.synthetic import FixtureKitti
    from ..models.factory import create_model
    from ..ops.decode import boxes_from_targets
    from ..runtime.trainer import Trainer, normalize_images

    model = create_model(cfg, seed=0)
    weights.load_npz(model, checkpoint, log=lambda msg: None)
    tr = Trainer(cfg, model, 1, device=device)
    kept = copy.deepcopy(model.state_dict())
    loader = Loader(FixtureKitti(cfg, scenes), cfg.batch_size, shuffle=False,
                    num_workers=1, drop_last=True, seed=0)
    errs = {"train_bn": [], "eval_bn": []}
    with torch.no_grad():
        for batch in loader:
            b = normalize_images(tr.to_device(batch), tr.mean, tr.std)
            target = boxes_from_targets(b["ind_float"], b["wh"], b["reg"],
                                        cfg.output_w, cfg.wh_scale)
            valid = b["rot_mask"] > 0
            gt = b["depth"][..., 0][valid].float()
            for key, train in (("train_bn", True), ("eval_bn", False)):
                model.train(train)
                depth = model(b, target=target)["depth"][..., 0]
                errs[key] += (depth[valid].float() - gt).cpu().tolist()
            model.load_state_dict(kept)   # undo the running-stat update
    return errs


def parse_seeds(text) -> list:
    """`0-15`, `0,3,5-7` -> the listed seeds, in order."""
    seeds = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        seeds += range(int(lo), int(hi or lo) + 1)
    return seeds


def run_line(out, scenes, **keys) -> dict:
    """One run's JSON line: `keys`, then the floors it failed and the
    per-object errors and car 2D AP of its clean variant."""
    errors = out["clean"][1]
    return {**keys, "floors_failed": acc.FLOORS[scenes](out),
            **{k: [round(float(e[k]), 2) for e in errors]
               for k in ("z_cv", "ry", "z")},
            "ap2d": list(out["clean"][0].get("car_detection", []))}


def tally(lines, scenes) -> dict:
    """The runs of `lines` and those that met every floor, in all and for
    each `mode/dtype`, with the misses of each floor by name."""
    out = {"scenes": scenes, "runs": len(lines),
           "met_every_floor": sum(not ln["floors_failed"] for ln in lines),
           "by": {}}
    for ln in lines:
        row = out["by"].setdefault(f"{ln['mode']}/{ln['dtype']}",
                                   {"runs": 0, "met_every_floor": 0,
                                    "misses": {}})
        row["runs"] += 1
        row["met_every_floor"] += not ln["floors_failed"]
        for name in ln["floors_failed"]:
            row["misses"][name] = row["misses"].get(name, 0) + 1
    return out


def _summary(errs) -> dict:
    return {k: {"median_abs": round(float(np.median(np.abs(v))), 3),
                "mean": round(float(np.mean(v)), 3)}
            for k, v in errs.items()}


def run_one(out_dir, scenes, mode, dtype, seed, rep=0, device=None,
            hw=(128, 384), _capture=None) -> dict:
    """One run of the `scenes`-scene protocol under DCN `mode` ("windowed":
    R = 1; "exact") in `dtype` from `seed`, then the depth fit of its
    checkpoint: the run's JSON line.  `_capture` gets what
    `run_overfit_ap` captures."""
    from ..data.synthetic import fixture_scenes
    from ..runtime.detector import ieee_f32
    batch, epochs = PROTOCOLS[scenes]
    radius = 1 if mode == "windowed" else -1
    tmp = os.path.join(out_dir, f"{mode}_{dtype}_{seed}_{rep}")
    cap = {} if _capture is None else _capture
    t0 = time.perf_counter()
    out = acc.run_overfit_variants(
        tmp, epochs=epochs, n_scenes=scenes, batch_size=batch, input_hw=hw,
        compute_dtype=dtype, device=device, radius=radius, seed=seed,
        _capture=cap)
    seconds = time.perf_counter() - t0
    cfg = acc.protocol_config(tmp, tmp, hw, batch, epochs=epochs,
                              compute_dtype=dtype)
    with (dc.dcn_mode("windowed", radius) if radius >= 0
          else dc.dcn_mode("exact")), \
            (ieee_f32() if dtype == "float32"
             else contextlib.nullcontext()):
        fit = depth_fit(cfg, fixture_scenes(scenes, 2, seed=0)[:scenes],
                        cap["checkpoint"], device)
    return dict(run_line(out, scenes, mode=mode, dtype=dtype, seed=seed,
                         rep=rep), s=round(seconds, 1),
                depth_fit=_summary(fit))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m side_tpu_torch.tools.acceptance_rate")
    ap.add_argument("--scenes", type=int, default=2, choices=sorted(PROTOCOLS))
    ap.add_argument("--seeds", type=parse_seeds, default=[0])
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--dcn", default="windowed,exact")
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--device", default=None)
    ap.add_argument("--input_h", type=int, default=128)
    ap.add_argument("--input_w", type=int, default=384)
    ap.add_argument("--out", default=os.path.join("exp", "acc_rate"))
    args = ap.parse_args(argv)

    hw = (args.input_h, args.input_w)
    lines = []
    for mode in args.dcn.split(","):
        for dtype in args.dtypes.split(","):
            for seed in args.seeds:
                for rep in range(args.reps):
                    line = run_one(args.out, args.scenes, mode, dtype, seed,
                                   rep, args.device, hw)
                    lines.append(line)
                    print(json.dumps(acc._jsonable(line)), flush=True)
    print("tally:", json.dumps(tally(lines, args.scenes)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
