"""Throughput of the port on one GPU (port of bench.py).

    python -m side_tpu_torch.bench                 # on the card
    python -m side_tpu_torch.bench --train-only 2  # the training figure alone

Serving: `graft_entry.entry()`'s function (the flagship at 384x1280, bf16:
stereo network, heads, cost-volume depth, sigmoid and `ddd_decode`; no
device tail) on the example pair repeated BENCH_BATCH times (default 2)
along the batch axis.  The loop is dependency-chained: each call's input
is the previous call's plus 1e-6 times its first score, added on the
device, so no call can start before the previous one has finished.  The
loop makes no `.item()` and fetches nothing to the host; the calls that
still make the host wait on the stream (a copy of a host tensor to the
card does) are counted for one iteration by chip_smoke.py phase 16 under
`torch.cuda.set_sync_debug_mode`, and PERF.md §5 has the count.  Two
loop lengths, max(2, BENCH_ITERS // 10) and BENCH_ITERS (default 20),
each the best of 2 host-clock timings between `torch.cuda.synchronize()`
fences after one warm-up run (which also absorbs the kernels' first-use
build), give pairs/s = (n_big - n_small) * B / (t_big - t_small).  `vs_baseline` divides
by 1 / 0.031 s, the inherited monocular CenterNet `ddd_3dop` at 31 ms an
image on a TITAN Xp, as bench.py does.

Training: the port's Trainer at `Config(batch_size=B, uncert=True)`, bf16,
full width, on bench.py's fixed uint8 batch (the same numpy draws), 2
warm-up steps, then 3 and 13 steps, best of 2 each, each timing fenced by
a synchronize and a read of the last loss.  It runs in this process after
the serving model is freed (the JAX file runs it in a subprocess to get
round a TPU compile helper's leak, which has no counterpart here).
BENCH_SKIP_TRAIN=1 skips it.  A failure of either figure ends the run
with an error and no result line.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline",
"train_pairs_per_sec_per_chip"}; the timings go to stderr.  On the card
unless `--device cpu`, which runs a small configuration (64x128, f32, 3
iterations) for the tests.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .config import Config
from .demo import _pop_option
from .graft_entry import entry, fixed_batch, served
from .models.factory import create_model
from .runtime.detector import resolve_device
from .runtime.trainer import Trainer

BASELINE_PAIRS_PER_S = 1.0 / 0.031   # TITAN Xp CenterNet ddd (MODEL_ZOO)
TRAIN_STEPS = (3, 13)
# the CPU run of the tests: small input, few iterations
CPU_KW = dict(input_h=64, input_w=128, K=8, max_objs=4, roi_size=4,
              compute_dtype="float32")
CPU_ITERS = 3
CPU_TRAIN_STEPS = (1, 2)


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def repeat_pairs(batch: Dict[str, torch.Tensor], n: int):
    """The batch repeated n times along the batch axis."""
    return {k: torch.cat([v] * n, dim=0) for k, v in batch.items()}


@torch.inference_mode()
def chained(fn, model, batch: Dict[str, torch.Tensor], n: int):
    """n calls of fn, each on the batch whose input is shifted by 1e-6 times
    the previous call's first score (0 for the first); returns the n scores
    as one device tensor.  Nothing is fetched to the host."""
    x = batch["input"]
    carry = torch.zeros((), dtype=x.dtype, device=x.device)
    scores = []
    for _ in range(n):
        b = dict(batch)
        b["input"] = x + carry
        dets, _, _ = fn(model, b)
        carry = (dets[0, 0, 4] * 1e-6).to(x.dtype)
        scores.append(dets[0, 0, 4])
    return torch.stack(scores)


def _best_of_2(run, device: torch.device) -> float:
    times = []
    for _ in range(2):
        _fence(device)
        t0 = time.perf_counter()
        run()
        _fence(device)
        times.append(time.perf_counter() - t0)
    return min(times)


def serving_pairs_per_s(fn, model, batch: Dict[str, torch.Tensor],
                        iters: int, device) -> float:
    """Chained pairs/s of fn over two loop lengths (module docstring)."""
    device = torch.device(device)
    n_small, n_big = max(2, iters // 10), iters
    chained(fn, model, batch, n_small)               # warm-up, first build
    t_small = _best_of_2(lambda: chained(fn, model, batch, n_small), device)
    t_big = _best_of_2(lambda: chained(fn, model, batch, n_big), device)
    print(f"[bench] n_small={n_small}: {t_small:.3f}s  "
          f"n_big={n_big}: {t_big:.3f}s", file=sys.stderr)
    pairs = batch["input"].shape[0]
    return (n_big - n_small) * pairs / max(t_big - t_small, 1e-9)


def train_batch(cfg: Config, batch_size: int) -> Dict[str, np.ndarray]:
    """bench.py's fixed training batch (bench.py:58-79, the same draws):
    uint8 images, one GT slot repeated at the map's centre."""
    ho, wo = cfg.output_h, cfg.output_w
    return fixed_batch(batch_size, (cfg.input_h, cfg.input_w), (ho, wo),
                       cfg.max_objs, (ho // 2, wo // 2), 12.0, np.uint8)


def train_pairs_per_s(batch_size: int, cfg_kw: Optional[dict] = None,
                      device=None,
                      steps: Sequence[int] = TRAIN_STEPS) -> float:
    """Steady-state training pairs/s: forward, backward and Adam on one
    device, over two step counts (module docstring)."""
    device = resolve_device(device)
    cfg = Config(batch_size=batch_size, uncert=True, num_devices=1,
                 **(cfg_kw or {}))
    trainer = Trainer(cfg, create_model(cfg, seed=0), steps_per_epoch=1000,
                      device=device)
    batch = trainer.to_device(train_batch(cfg, batch_size))

    def run_n(n: int) -> None:
        for _ in range(n):
            stats = trainer.train_step(batch)
        float(stats["loss"])                  # the last loss, on the host

    run_n(2)                                  # warm-up, first build
    n_small, n_big = steps
    t_small = _best_of_2(lambda: run_n(n_small), device)
    t_big = _best_of_2(lambda: run_n(n_big), device)
    print(f"[bench-train] n_small={n_small}: {t_small:.3f}s  "
          f"n_big={n_big}: {t_big:.3f}s", file=sys.stderr)
    return (n_big - n_small) * batch_size / max(t_big - t_small, 1e-9)


def _train_figure(batch_size: int, device: torch.device) -> float:
    """The training pairs/s at the flagship's settings on the card, at
    CPU_KW on the CPU."""
    if device.type == "cuda":
        return train_pairs_per_s(batch_size, None, device, TRAIN_STEPS)
    return train_pairs_per_s(batch_size, CPU_KW, device, CPU_TRAIN_STEPS)


def run(device, batch_size: int, iters: int, skip_train: bool = False
        ) -> dict:
    """The result line's dict: the card at the flagship's settings, or the
    CPU at CPU_KW."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if on_card:
        fn, (model, pair) = entry(device)
    else:
        fn, (model, pair) = served(CPU_KW, torch.float32, device)
    pairs_per_s = serving_pairs_per_s(fn, model,
                                      repeat_pairs(pair, batch_size), iters,
                                      device)
    del fn, model, pair
    if on_card:
        torch.cuda.empty_cache()
    result = {
        "metric": "kitti_stereo_infer_pairs_per_sec_per_chip",
        "value": round(pairs_per_s, 3),
        "unit": "stereo_pairs/s",
        "vs_baseline": round(pairs_per_s / BASELINE_PAIRS_PER_S, 3),
    }
    if not skip_train:
        result["train_pairs_per_sec_per_chip"] = round(
            _train_figure(batch_size, device), 3)
    return result


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    argv, device = _pop_option(argv, "--device")
    device = resolve_device(device)
    if argv[:1] == ["--train-only"]:
        print(_train_figure(int(argv[1]) if len(argv) > 1 else 2, device))
        return 0
    batch_size = int(os.environ.get("BENCH_BATCH", "2"))
    iters = int(os.environ.get(
        "BENCH_ITERS", "20" if device.type == "cuda" else str(CPU_ITERS)))
    skip_train = os.environ.get("BENCH_SKIP_TRAIN", "0") == "1"
    print(json.dumps(run(device, batch_size, iters, skip_train)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
