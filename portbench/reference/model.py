"""The reference model: the frozen copies of the port's networks, built at
float32 from a configuration's keys and loaded with the benchmark's
weights.  Each arch family ('<family>_<depth>', as the port's factory
reads `arch`) has a module of its own, `arch_<family>.py` here, found by
that name: its builder, the single layers judged (reference.layers) and
the leaves that take the heatmap's initial bias (weights.py); arch_dla.py
says what such a module provides."""

from __future__ import annotations

import importlib
import pkgutil
from types import ModuleType
from typing import Dict, List

import torch

from ..traffic.config import Config

PREFIX = "arch_"


def family(arch: str) -> ModuleType:
    """The family module of `arch`."""
    name = f"{__package__}.{PREFIX}{arch.split('_')[0]}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
    raise ValueError(
        f"the reference has no family for arch {arch!r}: add "
        f"portbench/reference/{name.rsplit('.', 1)[1]}.py (build, MODELS, "
        "LAYERS, hm_bias; see arch_dla.py)")


def families() -> List[ModuleType]:
    """Every family module here."""
    here = importlib.import_module(__package__)
    return [importlib.import_module(f"{__package__}.{m.name}")
            for m in pkgutil.iter_modules(here.__path__)
            if m.name.startswith(PREFIX)]


def family_of(model: torch.nn.Module) -> ModuleType:
    """The family module whose MODELS names `model`'s class (a reference
    model or the program's: they carry the same class names)."""
    cls = type(model).__name__
    found = [f for f in families() if cls in f.MODELS]
    if len(found) != 1:
        raise ValueError(
            f"{len(found)} reference families name the model class {cls!r} "
            "in MODELS; exactly one portbench/reference/arch_<family>.py "
            "has to")
    return found[0]


def build(cfg: Config, device="meta") -> torch.nn.Module:
    """The architecture of `cfg` at float32 on `device` (meta: shapes only,
    nothing allocated)."""
    fam = family(cfg.arch)
    with torch.device(device):
        return fam.build(cfg)


def loaded(cfg: Config, weights: Dict[str, torch.Tensor], device
           ) -> torch.nn.Module:
    """The reference model on `device` holding copies of `weights`."""
    model = build(cfg).to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model
