"""Checkpoints in the JAX package's `.npz` format (port of
side_tpu/runtime/checkpoint.py), so that either package reads what the
other writes.

One `.npz` of flattened path -> array: `params::<flax path>`,
`batch_stats::<flax path>`, `opt::leaf_<i>` (the optimizer state's leaves in
the JAX package's order, see runtime/trainer.py), `loss_weight::lw`,
`meta::epoch` and `meta::dcn_radius` (the DCN offset bound the weights were
trained with, -1 = exact).  No pickle.  `weights.to_flax` / `from_flax`
convert between these trees and a model's `state_dict`; loading uses the
shape-tolerant merge of `weights.merge_state`.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np

from ..ops import deform_conv as dc
from ..weights import _flatten, _radius_name, _unflatten


def save_checkpoint(path: str, epoch: int, params: Mapping,
                    batch_stats: Mapping,
                    opt_state_flat: Optional[Mapping[str, np.ndarray]] = None,
                    loss_weight=None) -> None:
    """Write the trees (numpy leaves) atomically: a temporary file, then a
    rename."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blobs: Dict[str, np.ndarray] = {}
    for name, tree in (("params", params), ("batch_stats", batch_stats)):
        for k, v in _flatten(tree).items():
            blobs[f"{name}::{k}"] = v
    for k, v in (opt_state_flat or {}).items():
        blobs[f"opt::{k}"] = np.asarray(v)
    if loss_weight is not None:
        blobs["loss_weight::lw"] = np.asarray(loss_weight)
    blobs["meta::epoch"] = np.asarray(epoch)
    blobs["meta::dcn_radius"] = np.asarray(dc.dcn_radius_tag())
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **blobs)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """{"epoch", "params", "batch_stats", "opt" (flat dict or None),
    ["loss_weight"], ["dcn_radius"]}."""
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            group, sub = key.split("::", 1)
            groups.setdefault(group, {})[sub] = data[key]
    meta = groups.get("meta", {})
    out: Dict[str, Any] = {
        "epoch": int(meta.get("epoch", 0)),
        "params": _unflatten(groups.get("params", {})),
        "batch_stats": _unflatten(groups.get("batch_stats", {})),
        "opt": groups.get("opt"),
    }
    if "loss_weight" in groups:
        out["loss_weight"] = groups["loss_weight"]["lw"]
    if "dcn_radius" in meta:
        out["dcn_radius"] = int(meta["dcn_radius"])
    return out


def warn_radius_mismatch(loaded: Mapping[str, Any],
                         log: Callable[[str], None] = print) -> None:
    """Warn when a checkpoint is trained on under another DCN offset bound
    than it was trained with (checkpoints without the tag are skipped)."""
    stored = loaded.get("dcn_radius")
    if stored is None:
        return
    active = dc.dcn_radius_tag()
    if stored != active:
        log(f"WARNING: checkpoint trained with DCN {_radius_name(stored)} "
            f"but running with {_radius_name(active)}: the offset clamp is "
            f"part of the trained function; set SIDE_TPU_TORCH_DCN / "
            f"SIDE_TPU_TORCH_DCN_RADIUS to match.")
