"""Single layers of one forward (a training step's first, or a validation
group's), each judged on the input the model under test gave it: one
deformable block's DCN product (K1), the heatmap head's 3x3 convolution,
and the depth path's first layer where the model has one (the cost
volume's 3D convolution, or the PointNet's first dense layer); and the
stem convolution on the reference's own pre-processed image, so that the
pre-process is judged with it.  Which module each is comes from the table
of the model's arch family (`LAYERS` of reference/arch_<family>.py, found
by the model's class).  Hooks keep the first image's (or RoI's) input and
output of each layer on the first call (a training step's stem: its
output over the whole batch, so that a batch cut short or fed the wrong
images shows); the reference layer, float32, recomputes the output.
Because each layer starts from the same input, the gap is that layer's
own rounding and nothing that the layers before it amplified."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from ..traffic.config import Config
from . import model as ref_model
from .deform_conv import deform_block_om


def table(model: nn.Module) -> Dict[str, str]:
    """The single layers of `model`'s family: name -> module path."""
    return ref_model.family_of(model).LAYERS


def capture(model: nn.Module, whole_stem: bool = False):
    """Hooks on `model` that keep each layer's first input and output, of
    the first image (or RoI), or with `whole_stem` the stem's output over
    every image of the batch.  Returns (store {name: {"x", "y"}},
    remove())."""
    store: Dict[str, dict] = {}
    handles = []
    for name, path in table(model).items():
        try:
            mod = model.get_submodule(path)
        except AttributeError:
            continue
        slot = store.setdefault(name, {})
        rows = None if whole_stem and name == "stem" else 1

        def keep_x(m, args, slot=slot, rows=rows):
            slot.setdefault("x", args[0][:rows].detach().float().cpu())

        def keep_y(m, args, out=None, slot=slot, rows=rows):
            t = args[0] if out is None else out
            slot.setdefault("y", t[:rows].detach().float().cpu())
        if name != "stem":      # the stem reads the reference's own input
            handles.append(mod.register_forward_pre_hook(keep_x))
        if hasattr(mod, "offset_mask"):
            # a deformable block: its DCN product is what its BatchNorm reads
            handles.append(mod.BatchNorm_0.register_forward_pre_hook(keep_y))
        else:
            handles.append(mod.register_forward_hook(keep_y))

    def remove():
        for h in handles:
            h.remove()
    return store, remove


def stem_input(cfg: Config, images, device) -> torch.Tensor:
    """The stem's input from pre-processed uint8 (..., H, W, 3) images: the
    reference's normalisation, (N, 3, H, W) float32."""
    x = torch.as_tensor(np.ascontiguousarray(images)).to(device).float()
    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=device)
    std = torch.tensor(cfg.std, dtype=torch.float32, device=device)
    return ((x / 255.0 - mean) / std).reshape(-1, *x.shape[-3:]).permute(
        0, 3, 1, 2)


@torch.no_grad()
def gaps(model: nn.Module, store: Dict[str, dict], device,
         stem_x: torch.Tensor) -> Dict[str, float]:
    """Per layer, |output - reference layer on the same input| / |reference|,
    `model` the float32 reference at the forward's weights; the stem reads
    `stem_x` (stem_input) in place of the input it was given."""
    out, paths = {}, table(model)
    for name, got in store.items():
        mod = model.get_submodule(paths[name])
        x = stem_x if name == "stem" else got["x"].to(device)
        if hasattr(mod, "offset_mask"):
            ref = deform_block_om(x.permute(0, 2, 3, 1), mod.offset_mask.weight,
                                  mod.offset_mask.bias, mod.kernel,
                                  mod.bias).permute(0, 3, 1, 2)
        else:
            ref = mod(x)
        ref = ref.double().cpu()
        y = got["y"].double()
        if y.shape != ref.shape:
            out[name] = float("inf")
            continue
        out[name] = float((y - ref).norm() / ref.norm().clamp(min=1e-30))
    return out
