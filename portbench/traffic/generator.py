"""The benchmark's one traffic generator: reads a mix file
(`traffic/<mix>.json`) and makes the cell's inputs from the run's seed with
the frozen scene renderer and target code beside it.

Kinds:
  train_loop: `pool_batches` collated training batches of `pairs_per_step`
      rendered scenes (1-3 Cars, Vans or Trucks each, with the training
      augmentation), cycled through the window.
  val_pass: `pool_frames` rendered 375x1242 uint8 stereo frames with
      KITTI's calibration, cycled through the window.

The seed changes which scenes are drawn, never how many or their sizes."""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from .config import Config
from .synthetic import scene_batch, val_scenes

HERE = os.path.dirname(os.path.abspath(__file__))


def load_mix(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, f"{name}.json")) as fh:
        return json.load(fh)


def derived_seed(seed: int, salt: int) -> int:
    """A 31-bit seed for NumPy's RandomState from any whole number."""
    state = np.random.SeedSequence([seed % 2 ** 64, salt]).generate_state(1)
    return int(state[0] & 0x7FFFFFFF)


def train_pool(cfg: Config, mix: dict, seed: int) -> List[dict]:
    rng = np.random.RandomState(derived_seed(seed, 1))
    return [scene_batch(cfg, rng, int(mix["pairs_per_step"]), cfg.max_objs)
            for _ in range(int(mix["pool_batches"]))]


def val_pool(cfg: Config, mix: dict, seed: int) -> List[tuple]:
    """(pool index, (left, right), calib) frames."""
    return val_scenes(int(mix["pool_frames"]), seed=derived_seed(seed, 2))
