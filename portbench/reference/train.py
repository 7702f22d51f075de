"""The reference training step: the loss of the port's Trainer, autograd,
and optax's Adam with its piecewise schedule, as plain PyTorch.  The Adam
and the image normalisation are frozen copies of
side_tpu_torch/runtime/trainer.py at commit ca59ff401c87."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..traffic.config import Config
from .decode import boxes_from_targets
from . import layers
from .losses import stereo_loss

BATCH_KEYS = ("input", "input_right", "hm", "wh", "reg", "dim", "orien",
              "depth", "kept", "ind", "ind_float", "rot_mask", "fb",
              "p2", "p3", "trans", "trans_inv")
INT32_MAX = 2 ** 31 - 1


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(batch[k])).to(device)
            for k in BATCH_KEYS if k in batch}


def normalize_images(batch, mean, std):
    out = dict(batch)
    for k in ("input", "input_right"):
        x = out.get(k)
        if x is not None and x.dtype == torch.uint8:
            out[k] = (x.float() / 255.0 - mean) / std
    return out


def learning_rate(cfg: Config, count: int, steps_per_epoch: int) -> float:
    v = cfg.lr
    for b in sorted({min(e * steps_per_epoch, INT32_MAX)
                     for e in cfg.lr_step}):
        if count >= b:
            v = v * 0.1
    return v


class Adam:
    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.params = params
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for k, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.mu[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + self.eps)
            p.add_(upd, alpha=-lr)


def stereo_images(batch) -> np.ndarray:
    """A host batch's images in the order the trunk reads them: the left
    views, then the right, uint8 (2B, H, W, 3)."""
    return np.concatenate([np.asarray(batch["input"]),
                           np.asarray(batch["input_right"])])


def run_steps(cfg: Config, model: torch.nn.Module, batches: List[dict],
              steps_per_epoch: int, fault: str = "",
              keep_layers: bool = False) -> dict:
    """len(batches) training steps of `model` (batch-statistics BatchNorm)
    from its current weights.  Returns each step's loss, the first step's
    gradients and the parameters after the last step, by name (the
    Trainer's names: "loss_weight" and the model's).  `fault` plants a
    fault of the correctness check's list in place of the program:
    "half_batch" takes the loss over the first half of every batch.
    `keep_layers` also keeps the first step's single layers (`layers`,
    reference.layers.capture) for a control in the program's place."""
    device = next(model.parameters()).device
    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=device)
    std = torch.tensor(cfg.std, dtype=torch.float32, device=device)
    params: Dict[str, torch.Tensor] = {}
    loss_weight = (torch.full((7,), -1.0, device=device, requires_grad=True)
                   if cfg.uncert else torch.tensor(
                       cfg.loss_weight, dtype=torch.float32, device=device))
    if cfg.uncert:
        params["loss_weight"] = loss_weight
    params.update(dict(model.named_parameters()))
    opt = Adam(params)
    model.train()
    losses, first_grads = [], None
    kept, unhook = (layers.capture(model, whole_stem=True) if keep_layers
                    else ({}, None))
    for step, host_batch in enumerate(batches):
        batch = to_device(host_batch, device)
        if fault == "half_batch":
            half = batch["input"].shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        for p in params.values():
            p.grad = None
        batch = normalize_images(batch, mean, std)
        target = boxes_from_targets(batch["ind_float"], batch["wh"],
                                    batch["reg"], cfg.output_w, cfg.wh_scale)
        extra = {}
        if getattr(model, "takes_generator", False):
            gen = torch.Generator(device=device)
            gen.manual_seed((cfg.seed << 32) + step)
            extra["generator"] = gen
        out = model(batch, target=target, use_cost_volume=cfg.cost_volume,
                    **extra)
        total, stats = stereo_loss(out, batch, loss_weight, cfg.grid,
                                   cfg.uncert, cfg.cost_volume,
                                   depth_aux_weight=cfg.depth_aux_weight,
                                   mse_loss=cfg.mse_loss)
        total.backward()
        losses.append(float(stats["loss"].detach()))
        if step == 0:
            if unhook:
                unhook()
            first_grads = {k: (p.grad.detach().clone() if p.grad is not None
                               else torch.zeros_like(p))
                           for k, p in params.items()}
        opt.step(learning_rate(cfg, opt.count, steps_per_epoch))
        del out, total, stats, batch
    return {"losses": losses, "first_grads": first_grads, "layers": kept,
            "params": {k: p.detach() for k, p in params.items()}}
