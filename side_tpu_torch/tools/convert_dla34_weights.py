"""Convert torch DLA-34 ImageNet weights to a checkpoint of the port (port
of tools/convert_dla34_weights.py).

The reference initialises its trunk from `dla34-ba72cf86.pth`.  This
offline converter maps that torch state_dict onto the JAX package's
`FeatureExtractor.base` parameter tree, the layout of the port's `.npz`
(conv weights OIHW -> HWIO, BatchNorm weight / bias / running statistics ->
scale / bias / mean / var), and writes it through
`runtime/checkpoint.save_checkpoint`.  `Trainer.load` and
`Detector(cfg with load_model)` restore it shape-tolerantly: head and DCN
parameters keep their fresh initialisation, as in the reference's partial
load.

    python -m side_tpu_torch.tools.convert_dla34_weights dla34.pth out.npz
"""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

import numpy as np


def tree_mapping() -> List[Tuple[str, str, str]]:
    """(flax_conv_path_prefix, torch_prefix, kind) for the DLA-34 trunk.

    Flax paths are relative to params['feature_extraction']['base'];
    kind is 'convbn' (Conv_0 + BatchNorm_0 inside a ConvBN) so each entry
    expands to conv kernel + bn scale/bias + bn stats.
    """
    pairs: List[Tuple[str, str, str]] = []
    pairs.append(("ConvBN_0", "base_layer.0", "convbn"))
    pairs.append(("ConvBN_1", "level0.0", "convbn"))
    pairs.append(("ConvBN_2", "level1.0", "convbn"))

    def basic(flax_prefix, torch_prefix):
        return [(f"{flax_prefix}/ConvBN_0", f"{torch_prefix}.conv1", "convbn"),
                (f"{flax_prefix}/ConvBN_1", f"{torch_prefix}.conv2", "convbn")]

    def tree(flax_prefix, torch_prefix, levels, has_project):
        out = []
        if levels == 1:
            if has_project:
                out.append((f"{flax_prefix}/ConvBN_0",
                            f"{torch_prefix}.project.0", "convbn_proj"))
            out += basic(f"{flax_prefix}/BasicBlock_0",
                         f"{torch_prefix}.tree1")
            out += basic(f"{flax_prefix}/BasicBlock_1",
                         f"{torch_prefix}.tree2")
            out.append((f"{flax_prefix}/Root_0/ConvBN_0",
                        f"{torch_prefix}.root.conv", "convbn_root"))
            return out
        # levels == 2: outer project (if any), then two sub-trees
        if has_project:
            out.append((f"{flax_prefix}/ConvBN_0",
                        f"{torch_prefix}.project.0", "convbn_proj"))
        out += tree(f"{flax_prefix}/Tree_0", f"{torch_prefix}.tree1", 1, True)
        out += tree(f"{flax_prefix}/Tree_1", f"{torch_prefix}.tree2", 1,
                    False)
        return out

    pairs += tree("Tree_0", "level2", 1, True)    # 32 -> 64
    pairs += tree("Tree_1", "level3", 2, True)    # 64 -> 128
    pairs += tree("Tree_2", "level4", 2, True)    # 128 -> 256
    pairs += tree("Tree_3", "level5", 1, True)    # 256 -> 512
    return pairs


# torch BN sits right after the conv: for base_layer/levelN the Sequential
# index +1; for tree convs it's convN->bnN; project.0 -> project.1;
# root.conv -> root.bn
def _bn_name(torch_conv: str, kind: str) -> str:
    if kind == "convbn_proj":
        return torch_conv[:-1] + "1"          # project.0 -> project.1
    if kind == "convbn_root":
        return torch_conv.rsplit(".", 1)[0] + ".bn"
    if ".conv" in torch_conv:
        return torch_conv.replace(".conv", ".bn")
    head, idx = torch_conv.rsplit(".", 1)
    return f"{head}.{int(idx) + 1}"


def convert(state: Dict[str, np.ndarray]):
    """torch state_dict (name -> ndarray) -> (params, batch_stats) trees
    rooted at feature_extraction/base."""
    params: Dict = {}
    stats: Dict = {}

    def put(tree, path, leaf):
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    missing = []
    for flax_prefix, torch_conv, kind in tree_mapping():
        bn = _bn_name(torch_conv, kind)
        try:
            w = state[torch_conv + ".weight"]
            put(params, f"{flax_prefix}/Conv_0/kernel",
                np.transpose(w, (2, 3, 1, 0)).astype(np.float32))
            put(params, f"{flax_prefix}/BatchNorm_0/scale",
                state[bn + ".weight"].astype(np.float32))
            put(params, f"{flax_prefix}/BatchNorm_0/bias",
                state[bn + ".bias"].astype(np.float32))
            put(stats, f"{flax_prefix}/BatchNorm_0/mean",
                state[bn + ".running_mean"].astype(np.float32))
            put(stats, f"{flax_prefix}/BatchNorm_0/var",
                state[bn + ".running_var"].astype(np.float32))
        except KeyError as e:
            missing.append(str(e))
    if missing:
        print(f"WARNING: {len(missing)} torch keys missing, e.g. "
              f"{missing[:3]}")
    return params, stats


def torch_state(raw) -> Dict[str, np.ndarray]:
    """What `torch.load` read from a `.pth` file, as a state_dict of numpy
    arrays: the `state_dict` entry of a training checkpoint where there is
    one, `module.` prefixes (of DataParallel) dropped."""
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return {k[7:] if k.startswith("module.") else k: v.numpy()
            for k, v in raw.items() if hasattr(v, "numpy")}


def main(argv=None) -> int:
    import torch
    from ..runtime.checkpoint import save_checkpoint
    pth_path, out_path = (sys.argv[1:] if argv is None else argv)[:2]
    params, stats = convert(torch_state(torch.load(pth_path,
                                                   map_location="cpu")))
    save_checkpoint(
        out_path, epoch=0,
        params={"feature_extraction": {"base": params}},
        batch_stats={"feature_extraction": {"base": stats}})
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
