"""Training entry point of the port (mirrors tools/train.py).

    python -m side_tpu_torch.train stereo --data_dir data --batch_size 16 \\
        --num_epochs 70 --lr_step 45,60 [--uncert] [--num_devices N]

Reads the KITTI-layout data under `--data_dir` (as tools/train.py does;
PNGs need OpenCV), trains on the GPU and writes `.npz` checkpoints in the
JAX package's format under `exp/<task>/<exp_id>/`.  Add `--device cpu` to
run the plain CPU path.

Data parallel on one host: `--num_devices N` (0, the default, means every
visible GPU; 1 with `--device cpu`) starts N ranks, rank r on `cuda:r`
(or N CPU ranks over gloo with `--device cpu`).  Every rank draws the same
shuffle of the global batch of `--batch_size` and keeps its slice, so the
run equals the one-process run batch for batch (the JAX package's
single-host semantics); each rank loads and augments the whole global
batch to keep the augmentation draws in that order.

Across hosts: `--distributed --coordinator_address host:port
--num_processes P --process_id i`, one process per GPU (pick it with
CUDA_VISIBLE_DEVICES); the process is rank i on `--device` (default
`cuda`), its local batch is `batch_size // P` and its loader seed
`seed + 13 * i`, as in tools/train.py.

`--reference_exact` trains in exact DCN mode unless SIDE_TPU_TORCH_DCN
pins one: `train`, which every rank runs, applies it, and the checkpoints
carry `meta::dcn_radius` -1.

Rank 0 alone writes the log files and checkpoints.  The validation inside
the loop reports losses; for KITTI result files and AP run
`python -m side_tpu_torch.val` on a checkpoint.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

from .config import Config
from .data.dataset import StereoKitti
from .data.loader import Loader
from .demo import _pop_option
from .models.factory import create_model
from .ops import deform_conv as dc
from .parallel.mesh import (Mesh, ShardedLoader, init_distributed, make_mesh,
                            shutdown)
from .runtime.logger import Logger
from .runtime.trainer import Trainer


class _NoLog:
    """The Logger of ranks other than 0."""

    def write(self, txt: str) -> None:
        pass

    def scalar_summary(self, tag: str, value, step: int) -> None:
        pass

    def close(self) -> None:
        pass


def rank_loaders(cfg: Config, mesh: Mesh, distributed: bool = False):
    """(train loader, val loader) of this rank.  One host: the global
    batch from seed `cfg.seed`, sliced to the rank's share.  Across hosts
    (`distributed`): a local batch of batch_size // world from seed
    `cfg.seed + 13 * rank`."""
    train_ds = StereoKitti(cfg, "train")
    val_ds = StereoKitti(cfg, "val")
    if distributed:
        train_loader = Loader(train_ds, max(1, cfg.batch_size // mesh.world),
                              shuffle=True, num_workers=cfg.num_workers,
                              drop_last=True, seed=cfg.seed + 13 * mesh.rank)
    else:
        train_loader = Loader(train_ds, cfg.batch_size, shuffle=True,
                              num_workers=cfg.num_workers, drop_last=True,
                              seed=cfg.seed)
        if mesh.world > 1:
            train_loader = ShardedLoader(train_loader, mesh)
    val_loader = Loader(val_ds, 1, shuffle=False, num_workers=1)
    return train_loader, val_loader


def train(cfg: Config, device, mesh: Optional[Mesh] = None,
          distributed: bool = False) -> int:
    """The training loop of one rank, or of the only process without a
    mesh."""
    rank_mesh = mesh or Mesh()
    chief = rank_mesh.rank == 0
    logger = Logger(cfg) if chief else _NoLog()
    np.random.seed(cfg.seed + 13 * rank_mesh.rank if distributed
                   else cfg.seed)
    torch.manual_seed(cfg.seed)
    train_loader, val_loader = rank_loaders(cfg, rank_mesh, distributed)

    if cfg.reference_exact:
        dc.apply_reference_exact()
    if chief:
        print("Creating model...")
    model = create_model(cfg, seed=cfg.seed)
    trainer = Trainer(cfg, model, steps_per_epoch=len(train_loader),
                      device=device, mesh=mesh)
    start_epoch = 0
    if cfg.load_model:
        start_epoch = trainer.load(cfg.load_model, resume=cfg.resume)
    elif cfg.resume:
        path = os.path.join(cfg.save_dir, "model_last.npz")
        if os.path.exists(path):
            start_epoch = trainer.load(path, resume=True)

    if chief:
        print("Starting training...")
    best = 1e10
    for epoch in range(start_epoch + 1, cfg.num_epochs + 1):
        mark = epoch if cfg.save_all else "last"
        log_train = trainer.train(epoch, train_loader, logger)
        logger.write(f"epoch: {epoch} |")
        for k, v in log_train.items():
            logger.scalar_summary(f"train_{k}", v, epoch)
            logger.write(f"{k} {v:8f} | ")
        if cfg.val_intervals > 0 and epoch % cfg.val_intervals == 0:
            trainer.save(os.path.join(cfg.save_dir, f"model_{mark}.npz"),
                         epoch)
            log_val = trainer.val(epoch, val_loader, logger)
            for k, v in log_val.items():
                logger.scalar_summary(f"val_{k}", v, epoch)
                logger.write(f"{k} {v:8f} | ")
            if log_val[cfg.metric] < best:
                best = log_val[cfg.metric]
                trainer.save(os.path.join(cfg.save_dir, "model_best.npz"),
                             epoch)
        else:
            trainer.save(os.path.join(cfg.save_dir, "model_last.npz"), epoch)
        logger.write("\n")
        if epoch in cfg.lr_step:
            trainer.save(os.path.join(cfg.save_dir, f"model_{epoch}.npz"),
                         epoch)
    logger.close()
    return 0


def run_rank(rank: int, world: int, cfg: Config, device, address: str,
             distributed: bool = False) -> int:
    """Join the process group as `rank` of `world` and train.  `device` is
    the rank's device; nccl carries CUDA ranks, gloo CPU ones."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_distributed(address, world, rank,
                     backend="nccl" if device.type == "cuda" else "gloo")
    try:
        return train(cfg, device, make_mesh(world, device), distributed)
    finally:
        shutdown()


def _spawned(rank: int, world: int, cfg: Config, device_type: str,
             address: str) -> None:
    """A rank started by `main` on this host: cuda:rank, or its share of
    the host's CPU threads."""
    if device_type != "cuda":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    run_rank(rank, world, cfg,
             f"cuda:{rank}" if device_type == "cuda" else "cpu", address)


def num_ranks(num_devices: int, device_type: str) -> int:
    """`--num_devices` resolved: 0 means every visible GPU (1 on the
    CPU)."""
    if device_type == "cuda":
        visible = torch.cuda.device_count()
        n = num_devices or visible
        if n > visible:
            raise ValueError(f"--num_devices {n}: {visible} GPUs visible")
        return max(n, 1)
    return max(num_devices, 1)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    argv, device = _pop_option(argv, "--device")
    cfg = Config.cli(argv)
    if cfg.distributed:
        return run_rank(cfg.process_id, cfg.num_processes, cfg,
                        device or "cuda", cfg.coordinator_address,
                        distributed=True)
    device_type = torch.device(device or "cuda").type
    world = num_ranks(cfg.num_devices, device_type)
    if world == 1:
        return train(cfg, device)
    if cfg.batch_size % world:
        raise ValueError(f"--batch_size {cfg.batch_size} does not split over "
                         f"{world} ranks")
    store = tempfile.mkdtemp(prefix="side_tpu_torch_dp_")
    try:
        torch.multiprocessing.spawn(
            _spawned, args=(world, cfg, device_type,
                            f"file://{os.path.join(store, 'rendezvous')}"),
            nprocs=world, join=True)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
