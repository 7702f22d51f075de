"""Training engine: data-parallel Adam with the uncertainty-weighted stereo
loss (port of side_tpu/runtime/trainer.py).

One step normalises the uint8 images on the device, feeds the GT RoIs to
the cost volume (`boxes_from_targets`), computes the 7-part `stereo_loss`,
back-propagates (on the card the DCN backward runs the hand-written K2/K3
kernels) and applies Adam.  The optimizer is optax.adam's: b1 0.9, b2
0.999, eps 1e-8 outside the square root, with the learning rate scaled by
0.1 at every `lr_step` epoch (boundaries `lr_step * steps_per_epoch`,
clamped to 2^31 - 1) and evaluated at the number of updates made before the
current one.  With `--uncert` the 7 Kendall log-variances `loss_weight`
start at -1 and are trained by the same Adam.  Every arch of the factory
that takes the stereo batch trains here; `--not_cost_volume` drops the
depth path and its loss part.  The voxel variant's dropout draws from a
generator seeded from (cfg.seed, step), as the JAX trainer folds the step
into its dropout key.

With a `mesh` (parallel/mesh.py) of several ranks, every rank holds the
same weights (broadcast from rank 0 at the start) and its slice of the
global batch.  The forward and backward run within `data_parallel(mesh)`:
BatchNorm statistics and loss normalisers are over the global batch, as
under the JAX package's SPMD partitioning.  After the backward every
gradient, `loss_weight`'s included, is summed over the ranks in one
all-reduce of a flat f32 buffer, and every rank takes the same Adam step.
Rank 0 alone writes checkpoints; validation runs whole on every rank.

The Trainer runs on `cuda` (or the mesh's device) unless the caller passes
`device="cpu"`; with no CUDA device and no explicit device it raises.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..models.factory import check_stereo_model
from ..ops.decode import boxes_from_targets
from ..ops.losses import stereo_loss
from ..parallel.mesh import Mesh, all_reduce_, data_parallel, replicate
from .. import weights
from . import checkpoint as ckpt
from .detector import resolve_device
from .logger import AverageMeter, Logger

BATCH_KEYS = ("input", "input_right", "hm", "wh", "reg", "dim", "orien",
              "depth", "kept", "ind", "ind_float", "rot_mask", "fb",
              "p2", "p3", "trans", "trans_inv")
INT32_MAX = 2 ** 31 - 1


def normalize_images(batch: Dict[str, torch.Tensor], mean: torch.Tensor,
                     std: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(x/255 - mean)/std in f32 for uint8 images; float images pass
    through (already normalised on the host)."""
    out = dict(batch)
    for k in ("input", "input_right"):
        x = out.get(k)
        if x is not None and x.dtype == torch.uint8:
            out[k] = (x.float() / 255.0 - mean) / std
    return out


class PiecewiseLR:
    """optax.piecewise_constant_schedule(lr, {boundary: 0.1}): lr times 0.1
    for every boundary <= count."""

    def __init__(self, lr: float, lr_step, steps_per_epoch: int):
        self.lr = lr
        self.boundaries = sorted({min(e * steps_per_epoch, INT32_MAX)
                                  for e in lr_step})

    def __call__(self, count: int) -> float:
        v = self.lr
        for b in self.boundaries:
            if count >= b:
                v = v * 0.1
        return v


class Adam:
    """optax.adam over named tensors: mu/nu per tensor, one update count
    (`count`) for the bias correction and one for the schedule
    (`sched_count`), as optax keeps them.  Tensors without a gradient take a
    zero one, as in JAX, where every parameter has a gradient."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: Dict[str, torch.Tensor], schedule: PiecewiseLR):
        self.params = params
        self.schedule = schedule
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0
        self.sched_count = 0

    @torch.no_grad()
    def step(self) -> float:
        """One update from the params' .grad; returns the learning rate."""
        lr = self.schedule(self.sched_count)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        names = list(self.params)
        ps = [self.params[k] for k in names]
        gs = [p.grad if p.grad is not None else torch.zeros_like(p)
              for p in ps]
        mus = [self.mu[k] for k in names]
        nus = [self.nu[k] for k in names]
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, gs, alpha=1.0 - self.b1)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_addcmul_(nus, gs, gs, value=1.0 - self.b2)
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mus, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(ps, upd, alpha=-lr)
        self.sched_count += 1
        return lr


class Trainer:
    def __init__(self, cfg: Config, model: torch.nn.Module,
                 steps_per_epoch: int, device=None,
                 mesh: Optional[Mesh] = None):
        check_stereo_model(model, cfg)
        self.cfg = cfg
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else Mesh(device=self.device)
        self.model = model.to(self.device)
        replicate(self.model, self.mesh)
        self.steps_per_epoch = max(1, steps_per_epoch)
        self.mean = torch.tensor(cfg.mean, dtype=torch.float32,
                                 device=self.device)
        self.std = torch.tensor(cfg.std, dtype=torch.float32,
                                device=self.device)
        self.params: Dict[str, torch.Tensor] = {}
        if cfg.uncert:
            self.loss_weight = torch.full((7,), -1.0, device=self.device,
                                          requires_grad=True)
            self.params["loss_weight"] = self.loss_weight
        else:
            self.loss_weight = torch.tensor(cfg.loss_weight,
                                            dtype=torch.float32,
                                            device=self.device)
        self.params.update(dict(model.named_parameters()))
        self.optimizer = Adam(self.params, PiecewiseLR(
            cfg.lr, cfg.lr_step, self.steps_per_epoch))
        self.step = 0
        self.loss_states = ["loss", "hm_loss", "wh_loss", "off_loss",
                            "dim_loss", "orien_loss", "kept_loss"]
        if cfg.cost_volume:
            self.loss_states.append("depth_loss")

    # ------------------------------------------------------------------ steps
    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        """The batch's training keys as tensors on the trainer's device."""
        return {k: torch.as_tensor(np.asarray(batch[k])).to(self.device)
                for k in BATCH_KEYS if k in batch}

    def loss(self, batch: Dict[str, torch.Tensor]):
        """Forward and loss in the model's current mode: (total, stats)."""
        cfg = self.cfg
        batch = normalize_images(batch, self.mean, self.std)
        target = boxes_from_targets(batch["ind_float"], batch["wh"],
                                    batch["reg"], cfg.output_w, cfg.wh_scale)
        extra = {}
        if getattr(self.model, "takes_generator", False) \
                and self.model.training:
            extra["generator"] = self.dropout_generator()
        out = self.model(batch, target=target,
                         use_cost_volume=cfg.cost_volume, **extra)
        return stereo_loss(out, batch, self.loss_weight, cfg.grid,
                           cfg.uncert, cfg.cost_volume,
                           depth_aux_weight=cfg.depth_aux_weight,
                           mse_loss=cfg.mse_loss)

    def dropout_generator(self) -> torch.Generator:
        """The generator of this step's dropout masks, seeded from
        (cfg.seed, step)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.cfg.seed << 32) + self.step)
        return gen

    def gradients(self, batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """Forward, loss and backward in the model's current mode, leaving
        every parameter's .grad (summed over the mesh's ranks); returns the
        loss parts (global ones under a mesh), detached."""
        for p in self.params.values():
            p.grad = None
        with data_parallel(self.mesh):
            total, stats = self.loss(batch)
            total.backward()
        if self.mesh.active:
            self.all_reduce_gradients()
        return {k: v.detach() for k, v in stats.items()}

    def all_reduce_gradients(self) -> None:
        """Every gradient summed over the ranks: one all-reduce of one flat
        f32 buffer, which the .grad tensors then view."""
        ps = list(self.params.values())
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1).float()
                          for p in ps])
        all_reduce_(flat, self.mesh)
        offset = 0
        for p in ps:
            p.grad = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()

    def train_step(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """Forward in training mode (batch statistics), backward, Adam."""
        self.model.train()
        stats = self.gradients(batch)
        self.optimizer.step()
        self.step += 1
        return stats

    @torch.no_grad()
    def val_step(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Forward and loss with running-statistics BatchNorm."""
        self.model.eval()
        return self.loss(batch)[1]

    # ------------------------------------------------------------------ epoch
    def run_epoch(self, phase: str, epoch: int, loader,
                  logger: Optional[Logger] = None) -> Dict[str, float]:
        cfg = self.cfg
        meters = {name: AverageMeter() for name in self.loss_states}
        data_time, batch_time = AverageMeter(), AverageMeter()
        num_iters = len(loader) if cfg.num_iters < 0 else cfg.num_iters
        end = time.time()
        for it, batch in enumerate(loader):
            if it >= num_iters:
                break
            data_time.update(time.time() - end)
            n = batch["input"].shape[0]
            batch = self.to_device(batch)
            stats = (self.train_step(batch) if phase == "train"
                     else self.val_step(batch))
            for name in meters:
                meters[name].update(stats[name].item(), n)
            batch_time.update(time.time() - end)
            end = time.time()

            if cfg.print_iter > 0 and it % cfg.print_iter == 0 and \
                    self.mesh.rank == 0:
                msg = (f"{cfg.task}/{cfg.exp_id} {phase} "
                       f"[{epoch}][{it}/{num_iters}]")
                for name in meters:
                    msg += f"|{name} {meters[name].avg:.4f} "
                if cfg.uncert:
                    msg += "|lw " + ",".join(
                        f"{w:.3f}" for w in self.loss_weight.tolist())
                if not cfg.hide_data_time:
                    msg += (f"|Data {data_time.val:.3f}s"
                            f"({data_time.avg:.3f}s)|Net {batch_time.avg:.3f}s")
                print(msg, flush=True)

        ret = {name: m.avg for name, m in meters.items()}
        ret["time"] = batch_time.sum / 60.0
        return ret

    def train(self, epoch: int, loader, logger=None):
        return self.run_epoch("train", epoch, loader, logger)

    def val(self, epoch: int, loader, logger=None):
        return self.run_epoch("val", epoch, loader, logger)

    # ------------------------------------------------------------- checkpoint
    def opt_leaves(self) -> List[np.ndarray]:
        """The optimizer state as the JAX package's `jax.tree.leaves` of
        (ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count)) over
        {"loss_weight", "model"}, in its layouts."""
        order = weights.jax_param_order(self.model, self.cfg.uncert)
        opt = self.optimizer
        moments = []
        for table in (opt.mu, opt.nu):
            for key in order:
                moments.append(weights.param_to_flax(
                    key, table[key].detach().cpu().numpy()))
        return ([np.asarray(opt.count, np.int32)] + moments +
                [np.asarray(opt.sched_count, np.int32)])

    def save(self, path: str, epoch: int) -> None:
        """Write the checkpoint (rank 0 alone: the ranks hold the same
        state)."""
        if self.mesh.rank != 0:
            return
        params, batch_stats = weights.to_flax(self.model.state_dict())
        opt_flat = {f"leaf_{i}": a for i, a in enumerate(self.opt_leaves())}
        lw = (self.loss_weight.detach().cpu().numpy() if self.cfg.uncert
              else None)
        ckpt.save_checkpoint(path, epoch, params, batch_stats, opt_flat, lw)

    def load(self, path: str, resume: bool = False) -> int:
        """Shape-tolerant load of a checkpoint of either package; with
        `resume`, also the Adam moments and counts and the epoch, so the lr
        schedule continues where it stopped.  Returns the epoch to resume
        after (0 without resume)."""
        loaded = ckpt.load_checkpoint(path)
        ckpt.warn_radius_mismatch(loaded)
        weights.merge_state(self.model, weights.from_flax(
            loaded["params"], loaded["batch_stats"]))
        if self.cfg.uncert and loaded.get("loss_weight") is not None:
            with torch.no_grad():
                self.loss_weight.copy_(torch.as_tensor(loaded["loss_weight"]))
        start_epoch = 0
        if resume and loaded.get("opt"):
            opt = loaded["opt"]
            order = weights.jax_param_order(self.model, self.cfg.uncert)
            n = len(order)
            if len(opt) != 2 * n + 2:
                print(f"Could not restore optimizer state ({len(opt)} "
                      f"leaves, expected {2 * n + 2}); reinit.")
            else:
                state = {}
                for j, table in enumerate(("mu", "nu")):
                    for i, key in enumerate(order):
                        a = weights.param_from_flax(
                            key, opt[f"leaf_{1 + j * n + i}"])
                        state[(table, key)] = torch.as_tensor(a)
                if any(tuple(v.shape) != tuple(self.params[k].shape)
                       for (_, k), v in state.items()):
                    print("Could not restore optimizer state (shape "
                          "drift); reinit.")
                else:
                    for (table, key), v in state.items():
                        getattr(self.optimizer, table)[key].copy_(v)
                    self.optimizer.count = int(opt["leaf_0"])
                    self.optimizer.sched_count = int(opt[f"leaf_{2 * n + 1}"])
                    start_epoch = loaded["epoch"]
                    self.step = start_epoch * self.steps_per_epoch
                    print(f"Resumed optimizer at epoch {start_epoch}")
        return start_epoch
