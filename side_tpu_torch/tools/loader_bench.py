"""Host input-pipeline throughput of the port (port of
tools/loader_bench.py; no device work).

Steady-state training-batch pairs/s out of `data.Loader`: decode
(cv2.imread), augmentation, affine warps and the whole target generation,
occlusion sweep included, at the production batch size.  The number to
hold against is the trainer's pairs/s on the card: the host must outrun
it.

    python -m side_tpu_torch.tools.loader_bench [--batch_size 16] \\
        [--workers 8] [--data_dir DIR] [--scenes 64] [--epochs 3] \\
        [--no_aug]

Without `--data_dir` it writes a `--scenes`-scene fixture
(`data/synthetic.py:build_fixture`) under a temporary directory, removed at
the end.  Reads PNGs with OpenCV (cv2).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m side_tpu_torch.tools.loader_bench")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 8)
    ap.add_argument("--data_dir", default="")
    ap.add_argument("--scenes", type=int, default=64,
                    help="fixture scenes when no --data_dir")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--no_aug", action="store_true",
                    help="eval-style loading (no random aug)")
    args = ap.parse_args(argv)

    from ..config import Config
    from ..data.dataset import StereoKitti
    from ..data.loader import Loader
    from ..data.synthetic import build_fixture

    tmp = None
    root = args.data_dir
    if not root:
        tmp = tempfile.mkdtemp(prefix="loaderbench_")
        print(f"[loader-bench] building {args.scenes}-scene fixture at {tmp}",
              flush=True)
        root = build_fixture(tmp, n_train=args.scenes, n_val=2, seed=0)
    try:
        cfg = Config(data_dir=root, batch_size=args.batch_size,
                     flip=0.0 if args.no_aug else 0.5,
                     aug_ddd=0.0 if args.no_aug else 0.35)
        loader = Loader(StereoKitti(cfg, "train"),
                        batch_size=args.batch_size, shuffle=True,
                        num_workers=args.workers, drop_last=True)
        # warm-up epoch: page caches, cv2 thread pools, numpy allocators
        for _ in loader:
            pass
        t0 = time.perf_counter()
        n_pairs = n_batches = 0
        for _ in range(args.epochs):
            for batch in loader:
                n_pairs += batch["input"].shape[0]
                n_batches += 1
        dt = time.perf_counter() - t0
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    print(f"[loader-bench] batch={args.batch_size} workers={args.workers} "
          f"aug={not args.no_aug}: {n_pairs / dt:.1f} pairs/s "
          f"({dt / n_batches * 1e3:.1f} ms/batch, {n_batches} batches)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
