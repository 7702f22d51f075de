"""Training entry point of the port (mirrors tools/train.py).

    python -m side_tpu_torch.train stereo --data_dir data --batch_size 16 \\
        --num_epochs 70 --lr_step 45,60 [--uncert]

Reads the KITTI-layout data under `--data_dir` (as tools/train.py does;
PNGs need OpenCV), trains on the GPU and writes `.npz` checkpoints in the
JAX package's format under `exp/<task>/<exp_id>/`.  Add `--device cpu` to
run the plain CPU path.  One device: `--distributed` is not ported yet.
The validation inside the loop reports losses; for KITTI result files and
AP run `python -m side_tpu_torch.val` on a checkpoint.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .config import Config
from .data.dataset import StereoKitti
from .data.loader import Loader
from .demo import _pop_option
from .models.factory import create_model
from .runtime.logger import Logger
from .runtime.trainer import Trainer


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    argv, device = _pop_option(argv, "--device")
    cfg = Config.cli(argv)
    if cfg.distributed:
        raise NotImplementedError("multi-GPU training is not ported yet "
                                  "(ROADMAP.md, Queue 1)")
    logger = Logger(cfg)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)

    train_ds = StereoKitti(cfg, "train")
    val_ds = StereoKitti(cfg, "val")
    train_loader = Loader(train_ds, cfg.batch_size, shuffle=True,
                          num_workers=cfg.num_workers, drop_last=True,
                          seed=cfg.seed)
    val_loader = Loader(val_ds, 1, shuffle=False, num_workers=1)

    print("Creating model...")
    model = create_model(cfg, seed=cfg.seed)
    trainer = Trainer(cfg, model, steps_per_epoch=len(train_loader),
                      device=device)
    start_epoch = 0
    if cfg.load_model:
        start_epoch = trainer.load(cfg.load_model, resume=cfg.resume)
    elif cfg.resume:
        path = os.path.join(cfg.save_dir, "model_last.npz")
        if os.path.exists(path):
            start_epoch = trainer.load(path, resume=True)

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


if __name__ == "__main__":
    sys.exit(main())
