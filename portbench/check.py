"""The numbers that decide `correct`: what the timed path produced against
the plain reference.  Each cell's limits file (limits/<cell>.json) names
the numbers it holds and their limits; `judge` compares those alone.

Training (`train_numbers`), over the steps that set-up ran through the
window's own call and feed:
  loss_gap_1      the first step's |loss - reference loss| / |reference|;
  update_gap_p50  the parameters' change over the steps by the median leaf:
                  |norm - reference norm| / max(reference norm, median
                  leaf's reference norm), over the leaves whose reference
                  gradient is at least a thousandth of the median leaf's
                  (the rest move under Adam by rounding);
  layer_gap       the first step's single layers (reference.layers), each
                  on the program's own input to it (the stem on the
                  reference's own normalisation of the image): the worst
                  layer's |output - reference| / |reference|.
Validation (`val_numbers`), over one of the window's groups run again
through the same Detector, each stage judged on the program's own input
to it (drivers/val_pass.judge_group):
  layer_gap       the network's single layers in the group's forward, as
                  in training, the stem on the reference's own pre-process;
  decode_gap      the reference's sigmoid + ddd_decode (peak filter, top K,
                  gathers) on the program's own head maps against the
                  program's decoded detections: the largest difference,
                  exact;
  tail_p50, tail_p90  the device tail (box solve, dense alignment,
                  re-solve) on the program's decoded detections, its rows
                  against the reference tail's on the same inputs:
                  max(|box diff| / |box size|, |x, y, z diff| / max(|z|,
                  1 m), |theta diff|, |alpha diff| (rad)), over the slots
                  the score filter keeps and each frame's first align_topk
                  slots (those dense alignment refines);
  rerun_gap       the rows the window returned for the group's frames
                  against the reference's score filter over the group's
                  tail rows: the largest difference (a row more or less:
                  infinite), exact.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

B1 = 0.9


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep=None) -> Dict[str, float]:
    """Per leaf, |norm - reference norm| / max(reference norm, median
    leaf's reference norm)."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(ref[k].double().norm()) for k in names}
    pn = {k: float(prog[k].double().norm()) for k in names}
    med = float(np.median(list(rn.values())))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names}


def moved_leaves(ref: dict) -> set:
    gn = {k: float(v.double().norm()) for k, v in ref["first_grads"].items()}
    med = float(np.median(list(gn.values())))
    return {k for k, v in gn.items() if v >= 1e-3 * med}


def changes(prog: dict, ref: dict, keep) -> tuple:
    return ({k: prog["pn"][k] - prog["p0"][k] for k in keep},
            {k: ref["params"][k] - prog["p0"][k] for k in keep})


def loss_gaps(prog: dict, ref: dict) -> List[float]:
    """Each step's |loss - reference loss| / |reference| (a step missing or
    not finite reads infinite)."""
    losses = [abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a) else math.inf
              for a, b in zip(prog["losses"], ref["losses"])]
    return losses + [math.inf] * (len(ref["losses"]) - len(losses))


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog: losses, p0, pn (the parameters before the first step and after
    the last one set-up ran), layers (reference.layers.gaps of the first
    step); ref: run_steps' result from the same p0 and batches."""
    update = leaf_gaps(*changes(prog, ref, moved_leaves(ref)))
    return {"loss_gap_1": loss_gaps(prog, ref)[0],
            "update_gap_p50": float(np.median(list(update.values()))),
            "layer_gap": max(prog["layers"].values(), default=math.inf)}


def _angle(a, b):
    d = np.abs(a - b) % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def tail_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rows a (n, 13) against rows b (n, 13): the tail distance of each."""
    size = np.maximum(np.maximum(np.abs(b[:, 3] - b[:, 1]),
                                 np.abs(b[:, 4] - b[:, 2])), 1.0)
    box = np.abs(a[:, 1:5] - b[:, 1:5]).max(axis=1) / size
    xyz = np.abs(a[:, 8:11] - b[:, 8:11]).max(axis=1) / \
        np.maximum(np.abs(b[:, 10]), 1.0)
    return np.maximum.reduce([box, xyz, _angle(a[:, 11], b[:, 11]),
                              _angle(a[:, 0], b[:, 0])])


def tail_rows(rows: np.ndarray, peak_thresh: float, align_topk: int
              ) -> np.ndarray:
    """(B, K) mask of the slots the tail is judged on."""
    keep = rows[..., 12] > peak_thresh
    keep[:, :max(align_topk, 0)] = True
    return keep


def pct(x, q) -> float:
    return (float(np.percentile(np.asarray(x), q, method="higher"))
            if len(x) else 0.0)


def _largest_gap(pairs) -> float:
    gap = 0.0
    for a, b in pairs:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.shape != b.shape or not np.isfinite(a).all():
            return math.inf
        if a.size:
            gap = max(gap, float(np.abs(a - b).max()))
    return gap


def val_numbers(group: dict) -> Dict[str, float]:
    """group: the stages of one group (drivers/val_pass.judge_group; a
    control fills only the stages it reads)."""
    out = {}
    if "layers" in group:
        out["layer_gap"] = max(group["layers"].values(), default=math.inf)
    if "decode" in group:
        out["decode_gap"] = _largest_gap(
            (a.detach().cpu().numpy(), b.numpy()) for a, b in group["decode"])
    if "ref_rows" in group:
        m = group["mask"]
        d = tail_dist(group["rows"][m], group["ref_rows"][m])
        if not np.isfinite(group["rows"][m]).all() or not len(d):
            d = np.full(1, math.inf)
        out.update(tail_p50=pct(d, 50), tail_p90=pct(d, 90))
    if "window" in group:
        pairs = []
        for got, want in zip(group["window"], group["filtered"]):
            if got is None or set(got) != set(want):
                pairs.append((np.zeros(1), np.zeros(2)))
                continue
            pairs.extend((got[c], want[c]) for c in want)
        out["rerun_gap"] = _largest_gap(pairs)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a number that is not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        checks[name] = {"value": value, "limit": limit}
        if not (math.isfinite(value) and value <= limit):
            ok = False
    return ok, checks
