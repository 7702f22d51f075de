"""Convert a full reference stereo_network torch checkpoint to a checkpoint
of the port (port of tools/convert_reference_weights.py).

Extends `convert_dla34_weights` (the DLA-34 trunk) to the whole flagship
model: the DLAUp / IDAUp deformable blocks, the bilinear-init upsamplers,
feaRuduce, the six heads and the cost-volume 3D CNN, so that a
reference-trained `model_last.pth` state_dict maps onto the parameter tree
of the JAX package, the layout of the port's `.npz`:
  * 2D conv weight (O, I, kh, kw)     -> kernel (kh, kw, I, O)
  * 3D conv weight (O, I, kd, kh, kw) -> kernel (kd, kh, kw, I, O)
  * DCN offset / mask conv: the reference emits channels
    [dy0 dx0 dy1 dx1 ... dy8 dx8 | m0..m8]; the packages interleave per
    tap [dy0 dx0 m0 | dy1 dx1 m1 | ...], so its output channels are
    permuted (`_OM_PERM`);
  * ConvTranspose2d depthwise weight (C, 1, k, k) -> kernel (k, k, 1, C),
    unflipped;
  * BatchNorm weight / bias / running_mean / running_var -> scale / bias +
    batch_stats mean / var.

The reference's DCNv2 samples its offsets unbounded, so the checkpoint is
tagged `meta::dcn_radius` = -1 (exact): the Detector runs it exact, and
`tools/finetune_clamp.py` is the recipe that brings it under the clamp.

    python -m side_tpu_torch.tools.convert_reference_weights model.pth out.npz
"""

from __future__ import annotations

import re
import sys
from typing import Dict, Tuple

import numpy as np

from .convert_dla34_weights import convert, torch_state

# our per-tap-interleaved offset/mask channel order from the reference's
# offsets-then-masks order
_OM_PERM = []
for _k in range(9):
    _OM_PERM += [2 * _k, 2 * _k + 1, 18 + _k]


def _put(tree, path, leaf):
    node = tree
    parts = path.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf


def _conv2d(w):
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _conv3d(w):
    return np.ascontiguousarray(np.transpose(w, (2, 3, 4, 1, 0)))


def _deform_block(state, params, stats, tprefix: str, fprefix: str):
    """One DeformConv block: DCN conv + offset_mask conv + BN."""
    _put(params, f"{fprefix}/kernel", _conv2d(state[f"{tprefix}.conv.weight"]))
    _put(params, f"{fprefix}/bias", state[f"{tprefix}.conv.bias"])
    omw = state[f"{tprefix}.conv.conv_offset_mask.weight"][_OM_PERM]
    omb = state[f"{tprefix}.conv.conv_offset_mask.bias"][_OM_PERM]
    _put(params, f"{fprefix}/offset_mask/kernel", _conv2d(omw))
    _put(params, f"{fprefix}/offset_mask/bias", omb)
    _bn(state, params, stats, f"{tprefix}.actf.0", f"{fprefix}/BatchNorm_0")


def _bn(state, params, stats, tprefix: str, fpath: str):
    _put(params, f"{fpath}/scale", state[f"{tprefix}.weight"])
    _put(params, f"{fpath}/bias", state[f"{tprefix}.bias"])
    _put(stats, f"{fpath}/mean", state[f"{tprefix}.running_mean"])
    _put(stats, f"{fpath}/var", state[f"{tprefix}.running_var"])


def convert_full(state: Dict[str, np.ndarray]
                 ) -> Tuple[Dict, Dict]:
    """Full stereo_network state_dict -> (params, batch_stats) trees."""
    state = {k[7:] if k.startswith("module.") else k: np.asarray(v)
             for k, v in state.items()}
    params: Dict = {}
    stats: Dict = {}

    # ----- trunk (reuse the validated DLA-34 mapping), re-rooted
    trunk_prefix = "feature_extraction.base."
    trunk = {k[len(trunk_prefix):]: v for k, v in state.items()
             if k.startswith(trunk_prefix)}
    tp, ts = convert(trunk)
    params["feature_extraction"] = {"base": tp}
    stats["feature_extraction"] = {"base": ts}

    # ----- DLAUp / IDAUp deformable blocks + upsamplers (discovered from
    # the state keys so every depth config maps without a hand list)
    seen = set()
    for k in state:
        m = re.match(
            r"feature_extraction\.(dla_up\.ida_\d+|ida_up)\."
            r"((?:proj|node)_\d+)\.conv\.weight$", k)
        if m:
            tmod, blk = m.group(1), m.group(2)
            fmod = tmod.replace(".", "/")
            _deform_block(state, params, stats,
                          f"feature_extraction.{tmod}.{blk}",
                          f"feature_extraction/{fmod}/{blk}")
            seen.add(k)
        m = re.match(
            r"feature_extraction\.(dla_up\.ida_\d+|ida_up)\."
            r"(up_\d+)\.weight$", k)
        if m:
            fmod = m.group(1).replace(".", "/")
            w = state[k]                       # (C, 1, k, k)
            _put(params,
                 f"feature_extraction/{fmod}/{m.group(2)}/kernel",
                 np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0))))

    # ----- feaRuduce (reference spelling) -> feaReduce
    _put(params, "feaReduce/kernel", _conv2d(state["feaRuduce.0.weight"]))
    _bn(state, params, stats, "feaRuduce.1", "feaReduce_bn")

    # ----- heads: 2-conv stacks, kept_type 6-conv stack
    for head in ("hm", "wh", "reg", "dim", "orien"):
        if f"{head}.0.weight" not in state:
            continue
        _put(params, f"{head}/Conv_0/kernel",
             _conv2d(state[f"{head}.0.weight"]))
        _put(params, f"{head}/Conv_1/kernel",
             _conv2d(state[f"{head}.2.weight"]))
        _put(params, f"{head}/Conv_1/bias", state[f"{head}.2.bias"])
    if "kept_type.0.weight" in state:
        for i, tidx in enumerate((0, 2, 4, 6, 8, 10)):
            _put(params, f"kept_type/Conv_{i}/kernel",
                 _conv2d(state[f"kept_type.{tidx}.weight"]))
            if f"kept_type.{tidx}.bias" in state:
                _put(params, f"kept_type/Conv_{i}/bias",
                     state[f"kept_type.{tidx}.bias"])

    # ----- cost-volume 3D-CNN (submodule.py cost_volume layout:
    # dres0.{0,3}, dres1.{0,3}, dres2.{0,3}, classify.{0,3}, strAM_2D)
    cv_pairs = [("dres0.0", 0), ("dres0.3", 1), ("dres1.0", 2),
                ("dres1.3", 3), ("dres2.0", 4), ("dres2.3", 5),
                ("classify.0", 6)]
    for tname, i in cv_pairs:
        key = f"depth_estimator.{tname}.weight"
        if key not in state:
            continue
        fpre = f"depth_estimator/ConvBN3D_{i}"
        _put(params, f"{fpre}/Conv_0/kernel", _conv3d(state[key]))
        bn_t = f"depth_estimator.{tname[:-1]}{int(tname[-1]) + 1}"
        _bn(state, params, stats, bn_t, f"{fpre}/BatchNorm_0")
    if "depth_estimator.classify.3.weight" in state:
        _put(params, "depth_estimator/classify/kernel",
             _conv3d(state["depth_estimator.classify.3.weight"]))
    if "depth_estimator.strAM_2D.0.weight" in state:
        _put(params, "depth_estimator/strAM_conv/kernel",
             _conv2d(state["depth_estimator.strAM_2D.0.weight"]))
        _put(params, "depth_estimator/strAM_conv/bias",
             state["depth_estimator.strAM_2D.0.bias"])
        _bn(state, params, stats, "depth_estimator.strAM_2D.1",
            "depth_estimator/strAM_bn")

    return params, stats


def main(argv=None) -> int:
    import torch
    from ..ops.deform_conv import dcn_mode
    from ..runtime.checkpoint import save_checkpoint
    pth_path, out_path = (sys.argv[1:] if argv is None else argv)[:2]
    raw = torch.load(pth_path, map_location="cpu")
    epoch = int(raw.get("epoch", 0)) if isinstance(raw, dict) else 0
    params, stats = convert_full(torch_state(raw))
    with dcn_mode("exact"):
        save_checkpoint(out_path, epoch, params, stats)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
