"""Audit of the DCN offsets and of the +-R clamp on a checkpoint (port of
tools/offset_audit.py).

The production kernels clamp every DeformBlock's offsets to [-R, R]
(windowed, R = 1 by default); the reference DCNv2 samples them unbounded
(exact).  Over a few frames this prints

1. per DeformBlock (named by module path) the statistics of |dy| and |dx|:
   max, the 99th percentile (the mean over frames of each frame's), the
   share of values beyond 1 and beyond 2, and the global max.  The offsets
   are the [..., 0:2] channels of each tap's [dy, dx, mask logit] triple of
   the block's 27-channel offset/mask conv output, captured during an eval
   forward (`capture_offsets`).  They come from the pass in the mode in
   force when the audit starts: the clamped pass, or the exact one where
   the exact mode is set;
2. per frame, eval-mode max |d sigmoid(hm)| and max |d depth| between the
   clamped pass (`dcn_mode("windowed", R)`, R the radius in force) and the
   exact pass (`dcn_mode("exact")`), each mode set for its pass.

The checkpoint is loaded keeping the mode the audit sets (a warning where
its `meta::dcn_radius` differs), so an exact-trained checkpoint still runs
its clamped pass windowed.

    python -m side_tpu_torch.tools.offset_audit stereo --load_model ckpt.npz \\
        [--num_images 2] [--data_dir DIR | --synthetic_scenes N] \\
        [--device cpu]

`--data_dir` reads the val split's PNGs (OpenCV); `--synthetic_scenes N`
renders N scenes in memory (`data/synthetic.py:val_scenes`; the default, 2
scenes, when neither is given).  `--dcn_fused` runs the clamped pass's
DeformBlocks through K4, as `val --dcn_fused` does (the capture is the same
on both routes).  Runs on the GPU unless `--device cpu`; every other flag is
Config's.
"""

from __future__ import annotations

import contextlib
import functools
import sys
from collections import Counter
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from ..models.dla import DeformBlock
from ..ops import deform_conv as dc
from ..ops.dcn_cuda import launch_counts, launches_since


def block_offsets(block: DeformBlock, x: torch.Tensor) -> torch.Tensor:
    """The (B, H, W, 9, 2) offsets (dy, dx) that `block` computes from its
    NCHW input `x`: its offset/mask conv as `deform_block_om` runs it
    (output in x's dtype, bias added after), split per tap into [dy, dx,
    mask logit], the first two kept, in f32."""
    conv = block.offset_mask
    om = F.conv2d(x, conv.weight.to(x.dtype), padding=1)
    om = (om + conv.bias.to(om.dtype)[:, None, None]).permute(0, 2, 3, 1)
    B, H, W, _ = om.shape
    return om.reshape(B, H, W, 9, 3)[..., 0:2].float()


@contextlib.contextmanager
def capture_offsets(model: torch.nn.Module,
                    on_offsets: Callable[[str, torch.Tensor], None]):
    """Within the block, every forward of a DeformBlock of `model` first
    hands (module path, `block_offsets` of its input) to `on_offsets`.  A
    forward pre-hook, removed on exit: outside the block the model runs as
    it always does (its own route, fused or not, is untouched)."""
    def hook(name, block, args):
        on_offsets(name, block_offsets(block, args[0]))

    handles = [m.register_forward_pre_hook(functools.partial(hook, name))
               for name, m in model.named_modules()
               if isinstance(m, DeformBlock)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


class OffsetStats:
    """The JAX tool's per-layer statistics of |offset|, accumulated over
    forwards: running max, counts beyond 1 and 2, one p99 per forward."""

    def __init__(self):
        self.layers: Dict[str, dict] = {}

    def __call__(self, name: str, offsets: torch.Tensor) -> None:
        off = offsets.abs().cpu().numpy().reshape(-1)
        st = self.layers.setdefault(
            name, {"max": 0.0, "n": 0, "gt1": 0, "gt2": 0, "p99s": []})
        st["max"] = max(st["max"], float(off.max()))
        st["n"] += off.size
        st["gt1"] += int((off > 1.0).sum())
        st["gt2"] += int((off > 2.0).sum())
        st["p99s"].append(float(np.percentile(off, 99)))

    def table(self) -> Dict[str, dict]:
        """{layer: {max, p99, pct_gt1, pct_gt2}} in module order."""
        return {name: {"max": st["max"], "p99": float(np.mean(st["p99s"])),
                       "pct_gt1": 100.0 * st["gt1"] / st["n"],
                       "pct_gt2": 100.0 * st["gt2"] / st["n"]}
                for name, st in self.layers.items()}


def _sigmoid_delta(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((torch.sigmoid(a.float()) - torch.sigmoid(b.float()))
                 .abs().max())


def audit(detector, frames: Iterable, radius: Optional[int] = None,
          log: Callable[[str], None] = print) -> dict:
    """Run the audit over `frames` ((image id, (left, right) arrays or
    paths, calib), as `val.run_pass` reads them) with `detector`'s network.
    `radius`: the clamped pass's R (default: the radius in force).  Returns
    {"layers": {name: stats}, "global_max", "stats_pass", "radius",
    "deltas": [{"image", "hm", "depth"}], "launches": {pass: counts}}, where
    `launches` are the DCN kernels' launches during each pass
    (`dcn_cuda.launch_counts`: all zero on the CPU)."""
    radius = dc.get_dcn_radius() if radius is None else int(radius)
    stats_pass = "exact" if dc.get_dcn_mode() == "exact" else "windowed"
    modes = {"windowed": ("windowed", radius), "exact": ("exact", None)}
    stats = OffsetStats()
    launches = {name: Counter() for name in modes}
    deltas: List[dict] = []
    for img_id, images, calib in frames:
        batch = detector.load_and_pre(images, calib)["batch"]
        outs = {}
        for name, mode in modes.items():
            hooks = (capture_offsets(detector.model, stats)
                     if name == stats_pass else contextlib.nullcontext())
            before = launch_counts()
            with dc.dcn_mode(*mode), hooks:
                outs[name] = detector.network(batch)
            launches[name].update(launches_since(before))
        exact, clamped = outs["exact"], outs["windowed"]
        row = {"image": img_id, "hm": _sigmoid_delta(exact["hm"],
                                                     clamped["hm"])}
        if "depth" in exact:
            row["depth"] = float((exact["depth"].float()
                                  - clamped["depth"].float()).abs().max())
        deltas.append(row)
    table = stats.table()
    out = {"layers": table, "frames": len(deltas), "stats_pass": stats_pass,
           "radius": radius,
           "global_max": max((st["max"] for st in table.values()),
                             default=0.0),
           "deltas": deltas,
           "launches": {k: dict(v) for k, v in launches.items()}}
    report(out, log)
    return out


def report(out: dict, log: Callable[[str], None] = print) -> None:
    """The JAX tool's two tables."""
    r = out["radius"]
    log(f"\n== |offset| statistics over {out['frames']} images "
        f"({out['stats_pass']} pass; radius clamp = {r}) ==")
    for name, st in out["layers"].items():
        log(f"{name:60s} max={st['max']:6.3f} p99={st['p99']:6.3f} "
            f"%>1={st['pct_gt1']:5.2f} %>2={st['pct_gt2']:5.2f}")
    log(f"[offset-audit] global max |offset| = {out['global_max']:.3f}")
    log(f"\n== clamped (windowed, r={r}) vs exact unbounded gather ==")
    for i, row in enumerate(out["deltas"]):
        msg = f"image {i}: |d sigmoid(hm)|_max = {row['hm']:.5f}"
        if "depth" in row:
            msg += f"  |d depth|_max = {row['depth']:.4f} m"
        log(msg)


def frames_for(cfg: Config, num_images: int,
               synthetic_scenes: Optional[int] = None) -> list:
    """The first `num_images` frames: of `synthetic_scenes` scenes rendered
    in memory where that is given, else of the val split of
    `cfg.data_dir`."""
    if synthetic_scenes is not None:
        from ..data.synthetic import val_scenes
        return val_scenes(synthetic_scenes, seed=cfg.seed)[:num_images]
    from ..data.dataset import StereoKitti
    from ..val import kitti_source
    return list(kitti_source(StereoKitti(cfg, "val")))[:num_images]


def main(argv=None) -> int:
    from ..demo import _pop_option
    from ..runtime.detector import Detector
    argv = list(sys.argv[1:] if argv is None else argv)
    argv, num_images = _pop_option(argv, "--num_images")
    argv, n_scenes = _pop_option(argv, "--synthetic_scenes")
    argv, device = _pop_option(argv, "--device")
    fused = "--dcn_fused" in argv
    argv = [a for a in argv if a != "--dcn_fused"]
    num_images = int(num_images or 2)
    if n_scenes is None and "--data_dir" not in argv:
        n_scenes = num_images
    cfg = Config.cli(argv)
    detector = Detector(cfg, device=device, keep_dcn_mode=True)
    dc.set_dcn_fused(fused)     # K4 in the clamped pass (val's --dcn_fused)
    audit(detector, frames_for(cfg, num_images,
                               None if n_scenes is None else int(n_scenes)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
