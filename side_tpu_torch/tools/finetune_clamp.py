"""The clamp-finetune recipe on the port (port of tools/finetune_clamp.py).

Weights trained with unbounded DCN offsets (exact mode, as the reference's
DCNv2 trains them) meet the production kernels' clamp to [-R, R], R = 1:
the port's default mode.  On the 2-scene overfit fixture
(`acceptance_16.run_overfit_ap`, held in memory, with the JAX recipe's
config: 128x384, 2 pairs a step, lr 1e-3, max_objs 16, K 16, no
augmentation, f32, no uncertainty weighting, peak_thresh 0.25):

  A. train `epochs` in exact mode (checkpoint `meta::dcn_radius` = -1),
     detect and score it in exact mode (`exact`);
  B. detect and score A's checkpoint under the clamp, the mode kept
     whatever the checkpoint's tag says (`naive`);
  C. load A's weights into a Trainer under the clamp, finetune `epochs_ft`,
     save (`meta::dcn_radius` = 1), detect and score under the clamp
     (`finetuned`).

f32, the recipe's dtype, has no repeatable K2 / K3 body on the card (both
add with f32 atomics, exact or windowed): a run's outcome is one draw.

Prints one JSON line per phase with the JAX recipe's summary keys
(`_summary`) and writes `summary.json` under `--out`.

    python -m side_tpu_torch.tools.finetune_clamp [--epochs 160] \\
        [--epochs_ft 40] [--out exp/finetune_clamp] [--verbose] \\
        [--device cpu]

Runs on the GPU unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from . import acceptance_16 as acc

CLAMP_RADIUS = 1
SCENES = 2
PAIRS = 2


def _protocol(tmp, **kw):
    """One run of the 2-scene protocol; returns (errors, capture)."""
    cap = {}
    _, errors = acc.run_overfit_ap(tmp, n_scenes=SCENES, batch_size=PAIRS,
                                   _capture=cap, **kw)
    return errors, cap


def train_exact(out_dir, epochs, **kw):
    """A: train under exact mode; returns (errors of its exact-mode
    detection, capture)."""
    return _protocol(os.path.join(out_dir, "exact"), epochs=epochs,
                     radius=-1, **kw)


def eval_naive(out_dir, ckpt, **kw):
    """B: detect with `ckpt` under the clamp, the mode kept."""
    return _protocol(os.path.join(out_dir, "naive"), ckpt=ckpt,
                     radius=CLAMP_RADIUS, keep_dcn_mode=True, **kw)


def finetune(out_dir, ckpt, epochs_ft, **kw):
    """C: finetune `ckpt`'s weights under the clamp, then detect."""
    return _protocol(os.path.join(out_dir, "finetuned"), epochs=epochs_ft,
                     init=ckpt, radius=CLAMP_RADIUS, **kw)


def run_recipe(out_dir, epochs=160, epochs_ft=40, device=None,
               verbose=False, _capture=None):
    """Returns {phase: `_summary`} for "exact" (A's own detection),
    "naive" (B) and "finetuned" (C); `_capture` receives each phase's
    capture of `run_overfit_ap` (launches per route and radius, timing,
    checkpoint) under the same keys."""
    kw = dict(device=device, verbose=verbose)
    capture = {} if _capture is None else _capture
    summaries = {}

    print(f"[finetune-clamp] A: training {epochs} epochs with EXACT "
          f"(unbounded) DCN", flush=True)
    errors, capture["exact"] = train_exact(out_dir, epochs, **kw)
    ckpt_exact = capture["exact"]["checkpoint"]
    summaries["exact"] = _summary(errors)
    print(json.dumps({"exact": summaries["exact"]}), flush=True)

    print(f"[finetune-clamp] B: naive eval under windowed R="
          f"{CLAMP_RADIUS}", flush=True)
    errors, capture["naive"] = eval_naive(out_dir, ckpt_exact, **kw)
    summaries["naive"] = _summary(errors)
    print(json.dumps({"naive": summaries["naive"]}), flush=True)

    print(f"[finetune-clamp] C: finetuning {epochs_ft} epochs under the "
          f"clamp", flush=True)
    errors, capture["finetuned"] = finetune(out_dir, ckpt_exact, epochs_ft,
                                            **kw)
    summaries["finetuned"] = _summary(errors)
    print(json.dumps({"finetuned": summaries["finetuned"]}), flush=True)
    return summaries


def _summary(errors):
    """tools/finetune_clamp.py's error summary of one phase."""
    fin = [e for e in errors if np.isfinite(e["z"])]
    return {
        "n_objects": len(errors),
        "detected": sum(1 for e in errors if e["iou"] > 0),
        "iou_min": float(min((e["iou"] for e in errors), default=0.0)),
        "z_med": float(np.median([e["z"] for e in fin])) if fin else None,
        "z_max": float(max(e["z"] for e in fin)) if fin else None,
        "ry_max": float(max(e["ry"] for e in fin)) if fin else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m side_tpu_torch.tools.finetune_clamp")
    ap.add_argument("--epochs", type=int, default=160)
    ap.add_argument("--epochs_ft", type=int, default=40)
    ap.add_argument("--out", default=os.path.join("exp", "finetune_clamp"))
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain CPU path (default: the GPU)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    summaries = run_recipe(args.out, args.epochs, args.epochs_ft,
                           device=args.device, verbose=args.verbose)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summaries, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
