"""Weights across the two packages.

`from_flax` turns the JAX package's parameter trees (as numpy arrays) into
a `state_dict` of the port: the flax path becomes the module path, and the
layouts change as follows:
    conv kernel       HWIO  -> OIHW
    3D conv kernel    DHWIO -> OIDHW
    Dense kernel      (in, out) -> Linear weight (out, in)
    BilinearUp kernel (k, k, 1, C) -> (C, 1, k, k), unflipped
    BN scale / bias / mean / var -> weight / bias / running_mean / running_var
    DCN kernel (3, 3, Cin, Cout) and bias: kept (DLA's proj_N / node_N,
        the resdcn family's DeconvStage_N/DeformBlock_0)
    offset_mask kernel (3, 3, Cin, 27) -> (27, Cin, 3, 3), channel order kept
`to_flax` is its inverse, so that a checkpoint the port writes loads in
the JAX package.  `load_npz` reads the JAX checkpoint format
(runtime/checkpoint.py of the JAX package: `params::<path>`,
`batch_stats::<path>`, `meta::dcn_radius`) into a model with the same
shape-tolerant merge, and puts the port's DCN mode in line with the radius
the checkpoint was trained with (or, with `keep_dcn_mode=True`, keeps the
mode in force and only warns, as the JAX package does).

`jax_param_order` gives the order in which the JAX package's Adam state
lists a model's parameters (`jax.tree.leaves` of {"loss_weight", "model"}:
sorted keys at every level), so an optimizer state moves between the two
packages leaf by leaf; `param_to_flax` / `param_from_flax` change one
tensor's layout.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from .ops import deform_conv as dc

_DCN_BLOCK = re.compile(r"(^|/)(proj|node|DeformBlock)_\d+$")
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _param_entry(path: str, a: np.ndarray):
    module, _, leaf = path.rpartition("/")
    key = module.replace("/", ".")
    if leaf == "kernel":
        if _DCN_BLOCK.search(module):
            return f"{key}.kernel", a
        if a.ndim not in (2, 4, 5):
            raise ValueError(f"unexpected kernel rank at {path}: {a.shape}")
        return f"{key}.weight", param_from_flax(f"{key}.weight", a)
    if leaf == "scale":
        return f"{key}.weight", a
    if leaf == "bias":
        return f"{key}.bias", a
    raise ValueError(f"unknown parameter leaf {path}")


def from_flax(params: Mapping, batch_stats: Mapping
              ) -> Dict[str, torch.Tensor]:
    """JAX parameter / batch-stat trees (numpy leaves) -> port state_dict."""
    sd = {}
    for path, a in _flatten(params).items():
        key, v = _param_entry(path, a)
        sd[key] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    for path, a in _flatten(batch_stats).items():
        module, _, leaf = path.rpartition("/")
        if leaf not in _BN_STATS:
            raise ValueError(f"unknown batch-stat leaf {path}")
        key = f"{module.replace('/', '.')}.{_BN_STATS[leaf]}"
        sd[key] = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return sd


def param_to_flax(key: str, a: np.ndarray) -> np.ndarray:
    """A port parameter (state_dict key, array) in the JAX layout."""
    if key.endswith(".weight"):
        if a.ndim == 2:                      # Linear (out, in) -> (in, out)
            return a.T
        if a.ndim == 4:                      # OIHW -> HWIO
            return a.transpose(2, 3, 1, 0)
        if a.ndim == 5:                      # OIDHW -> DHWIO
            return a.transpose(2, 3, 4, 1, 0)
    return a


def param_from_flax(key: str, a: np.ndarray) -> np.ndarray:
    """Inverse of `param_to_flax`."""
    if key.endswith(".weight"):
        if a.ndim == 2:                      # (in, out) -> Linear (out, in)
            return a.T
        if a.ndim == 4:                      # HWIO -> OIHW (also BilinearUp)
            return a.transpose(3, 2, 0, 1)
        if a.ndim == 5:                      # DHWIO -> OIDHW
            return a.transpose(4, 3, 0, 1, 2)
    return a


def flax_param_path(key: str, ndim: int) -> str:
    """The flax parameter path of a port parameter of rank `ndim` (a 1-D
    `weight` is a BatchNorm scale, any other a kernel)."""
    module, _, leaf = key.rpartition(".")
    if leaf == "weight":
        leaf = "scale" if ndim == 1 else "kernel"
    elif leaf not in ("kernel", "bias"):
        raise ValueError(f"unknown parameter {key}")
    return f"{module.replace('.', '/')}/{leaf}"


def to_flax(state_dict: Mapping[str, torch.Tensor]):
    """Port state_dict -> (params, batch_stats) trees of numpy arrays in the
    JAX layouts, the inverse of `from_flax`."""
    params, stats = {}, {}
    for key, t in state_dict.items():
        a = t.detach().cpu().float().numpy()
        module, _, leaf = key.rpartition(".")
        if leaf in ("running_mean", "running_var"):
            stats[f"{module.replace('.', '/')}/{leaf[len('running_'):]}"] = a
        else:
            params[flax_param_path(key, a.ndim)] = np.ascontiguousarray(
                param_to_flax(key, a))
    return _unflatten(params), _unflatten(stats)


def jax_param_order(model: nn.Module, uncert: bool):
    """The model's parameter names (plus "loss_weight" under --uncert) in
    the JAX package's optimizer-leaf order."""
    names = sorted(((tuple(flax_param_path(k, p.dim()).split("/")), k)
                    for k, p in model.named_parameters()))
    return (["loss_weight"] if uncert else []) + [k for _, k in names]


def read_npz(path: str) -> Dict[str, Any]:
    """The JAX checkpoint as {"params", "batch_stats"} trees plus its
    `dcn_radius` (None for checkpoints older than the tag)."""
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            group, sub = key.split("::", 1)
            groups.setdefault(group, {})[sub] = data[key]
    meta = groups.get("meta", {})
    return {"params": _unflatten(groups.get("params", {})),
            "batch_stats": _unflatten(groups.get("batch_stats", {})),
            "dcn_radius": (int(meta["dcn_radius"]) if "dcn_radius" in meta
                           else None)}


def _radius_name(r: int) -> str:
    return "exact (unbounded)" if r < 0 else f"windowed R={r}"


def apply_radius(stored, log: Callable[[str], None] = print,
                 keep_dcn_mode: bool = False) -> None:
    """Run with the DCN offset bound the checkpoint was trained with: warn
    when the one in force differs, then switch to the stored one (-1 =
    exact).  With `keep_dcn_mode` warn and keep the one in force (the JAX
    package's behaviour: a caller that sets the mode on purpose, as the
    offset audit and the clamp-finetune recipe do).  A checkpoint without
    the tag changes nothing."""
    if stored is None:
        return
    active = dc.dcn_radius_tag()
    if stored == active:
        return
    if keep_dcn_mode:
        log(f"WARNING: checkpoint trained with DCN {_radius_name(stored)} "
            f"but running with {_radius_name(active)}, as the caller set "
            f"it (the offset clamp is part of the trained function)")
        return
    log(f"WARNING: checkpoint trained with DCN {_radius_name(stored)} "
        f"but the port was set to {_radius_name(active)}; switching to "
        f"{_radius_name(stored)} (the offset clamp is part of the "
        f"trained function)")
    dc.set_dcn_radius_tag(stored)


def merge_state(model: nn.Module, loaded: Mapping[str, torch.Tensor],
                log: Callable[[str], None] = print) -> None:
    """Shape-tolerant load: a loaded tensor replaces the model's when the
    key exists and the shape matches; otherwise the model keeps its value
    and a message is printed."""
    own = model.state_dict()
    merged = {}
    for k, v in own.items():
        lv = loaded.get(k)
        if lv is None:
            log(f"No param {k} in checkpoint; keeping fresh init.")
            merged[k] = v
        elif tuple(lv.shape) != tuple(v.shape):
            log(f"Skip loading parameter {k}: required {tuple(v.shape)}, "
                f"loaded {tuple(lv.shape)}")
            merged[k] = v
        else:
            merged[k] = lv.to(v.dtype)
    for k in loaded:
        if k not in own:
            log(f"Drop parameter {k} (not in model).")
    model.load_state_dict(merged)


def load_npz(model: nn.Module, path: str,
             log: Callable[[str], None] = print,
             keep_dcn_mode: bool = False) -> None:
    """Load a JAX `.npz` checkpoint into `model` and switch to its DCN
    radius, or with `keep_dcn_mode` keep the mode in force
    (`apply_radius`)."""
    ck = read_npz(path)
    merge_state(model, from_flax(ck["params"], ck["batch_stats"]), log)
    apply_radius(ck["dcn_radius"], log, keep_dcn_mode)
