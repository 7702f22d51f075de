"""Operations of the model's work, counted once per configuration and shape
on the benchmark's plain reference over meta tensors (nothing is computed
or allocated): `torch.utils.flop_counter.FlopCounterMode` counts every
convolution and matrix product, forward and backward, which is the work a
model-utilisation figure counts.  The same pass records the shapes of the
DCN layers, whose least times the DCN roofline reads."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import model as ref_model
from ..reference.decode import boxes_from_targets
from ..reference.dla import DeformBlock
from ..reference.losses import stereo_loss
from ..traffic.config import Config


def _meta_batch(cfg: Config, B: int, train: bool) -> Dict[str, torch.Tensor]:
    H, W, h, w = cfg.input_h, cfg.input_w, cfg.output_h, cfg.output_w
    m = cfg.max_objs
    meta = {"device": "meta"}
    u8 = {"dtype": torch.uint8, **meta}
    b = {"input": torch.empty(B, H, W, 3, **u8),
         "input_right": torch.empty(B, H, W, 3, **u8),
         "fb": torch.empty(B, **meta),
         "p2": torch.empty(B, 3, 4, **meta), "p3": torch.empty(B, 3, 4, **meta),
         "trans": torch.empty(B, 2, 3, **meta),
         "trans_inv": torch.empty(B, 2, 3, **meta)}
    if train:
        b.update({"hm": torch.empty(B, cfg.num_classes, h, w, **meta),
                  "wh": torch.empty(B, m, 3, **meta),
                  "reg": torch.empty(B, m, 3, **meta),
                  "dim": torch.empty(B, m, 3, **meta),
                  "orien": torch.empty(B, m, 2, **meta),
                  "depth": torch.empty(B, m, 1, **meta),
                  "kept": torch.empty(B, m, 6, **meta),
                  "ind": torch.empty(B, m, dtype=torch.int64, **meta),
                  "ind_float": torch.empty(B, m, **meta),
                  "rot_mask": torch.empty(B, m, **u8)})
    return b


def count(cfg: Config, B: int, train: bool) -> Tuple[float, List[tuple]]:
    """(FLOPs, DCN layer shapes [(images, h, w, cin, cout)]) of one training
    step of B pairs (forward, loss, backward) or of one inference pass over
    B frames (the network and the cost volume or voxel path)."""
    model = ref_model.build(cfg)
    model.train(train)
    shapes = []

    def hook(mod, args):
        x = args[0]
        shapes.append((x.shape[0], x.shape[2], x.shape[3], x.shape[1],
                       mod.kernel.shape[-1]))
    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, DeformBlock)]
    batch = _meta_batch(cfg, B, train)
    counter = FlopCounterMode(display=False)
    with counter:
        if train:
            target = boxes_from_targets(batch["ind_float"], batch["wh"],
                                        batch["reg"], cfg.output_w,
                                        cfg.wh_scale)
            extra = {}
            if getattr(model, "takes_generator", False):
                extra["generator"] = None
            out = model(batch, target=target,
                        use_cost_volume=cfg.cost_volume, **extra)
            lw = torch.full((7,), -1.0, device="meta", requires_grad=True)
            total, _ = stereo_loss(out, batch, lw, cfg.grid, cfg.uncert,
                                   cfg.cost_volume,
                                   depth_aux_weight=cfg.depth_aux_weight,
                                   mse_loss=cfg.mse_loss)
            total.backward()
        else:
            with torch.no_grad():
                model(batch, use_cost_volume=cfg.cost_volume)
    for h in handles:
        h.remove()
    return float(counter.get_total_flops()), shapes
