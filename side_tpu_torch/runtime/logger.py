"""Experiment logging (copy of side_tpu/runtime/logger.py).

Writes the full config to opt.txt, timestamped scalar lines to log.txt, and
optional TensorBoard event files when a writer backend is importable."""

from __future__ import annotations

import dataclasses
import os
import sys
import time


class AverageMeter:
    """Running average (reference utils/utils.py:7-23)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        if self.count > 0:
            self.avg = self.sum / self.count


class Logger:
    def __init__(self, cfg, quiet: bool = False):
        save_dir = cfg.save_dir
        os.makedirs(save_dir, exist_ok=True)
        os.makedirs(cfg.debug_dir, exist_ok=True)
        self.quiet = quiet

        with open(os.path.join(save_dir, "opt.txt"), "w") as f:
            f.write("==> commandline: {}\n".format(" ".join(sys.argv)))
            f.write("==> config:\n")
            for field in dataclasses.fields(cfg):
                f.write(f"  {field.name}: {getattr(cfg, field.name)}\n")

        ts = time.strftime("%Y-%m-%d-%H-%M")
        self.log = open(os.path.join(save_dir, f"log_{ts}.txt"), "w")
        self.start_line = True

        self.writer = None
        try:  # optional tensorboard backend
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            SummaryWriter = None
        if SummaryWriter is not None:
            self.writer = SummaryWriter(os.path.join(save_dir, "tb"))

    def write(self, txt: str):
        if self.start_line:
            self.log.write(time.strftime("%Y-%m-%d-%H-%M: ") + txt)
        else:
            self.log.write(txt)
        self.start_line = txt.endswith("\n")
        self.log.flush()
        if not self.quiet:
            print(txt, end="", flush=True)

    def scalar_summary(self, tag: str, value, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)

    def close(self):
        self.log.close()
        if self.writer is not None:
            self.writer.close()
