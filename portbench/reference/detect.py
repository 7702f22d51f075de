"""The reference inference path: the port's Detector stages (pre-process,
normalisation, network, sigmoid + ddd_decode, the device tail, the score
filter) as plain float32 PyTorch, from frozen copies of
side_tpu_torch/runtime/detector.py and the modules it calls at commit
ca59ff401c87.  `decoded` runs a frame's network and decode; `tail_on` runs
the tail on decoded detections that it is given (the program's, to judge
the tail on the program's own input to it); `results` is the score
filter's bucketing."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..traffic import geometry as G
from ..traffic.config import Config
from ..traffic.dataset import warp_affine
from . import decode as dec
from .device_tail import bucket_results, run_tail


def _frame_meta(cfg: Config, image, calib):
    height, width = image.shape[:2]
    c = np.array([width / 2.0, height / 2.0], np.float32)
    if cfg.keep_res:
        s = np.array([cfg.input_w, cfg.input_h], np.int32)
    else:
        s = np.array([width, height], np.int32)
    trans = G.get_affine_transform(c, s, 0, [cfg.input_w, cfg.input_h])
    trans_out = G.get_affine_transform(c, s, 0, [cfg.output_w, cfg.output_h])
    trans_inv = G.get_affine_transform(
        c, s, 0, [cfg.output_w, cfg.output_h], inv=True)
    meta = {"c": c, "s": s, "calib": calib, "trans": trans_out,
            "trans_inv": trans_inv}
    return trans, meta


def pre_process(cfg: Config, image, image_right, calib):
    trans, meta = _frame_meta(cfg, image, calib)

    def prep(im):
        return warp_affine(im, trans, cfg.input_w, cfg.input_h)[None]
    return prep(image), prep(image_right), meta


def _inputs(cfg: Config, pair, calib, device):
    image, image_right = pair
    inp, inp_right, meta = pre_process(cfg, image, image_right, calib)
    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=device)
    std = torch.tensor(cfg.std, dtype=torch.float32, device=device)
    p2 = np.asarray(calib[2], np.float64).reshape(3, 4)
    p3 = np.asarray(calib[3], np.float64).reshape(3, 4)

    def norm(x):
        x = torch.from_numpy(x).to(device)
        return (x.float() / 255.0 - mean) / std
    batch = {"input": norm(inp), "input_right": norm(inp_right),
             "fb": torch.tensor([p2[0, 3] - p3[0, 3]], dtype=torch.float32,
                                device=device)}
    for key, a in (("p2", p2), ("p3", p3), ("trans", meta["trans"]),
                   ("trans_inv", meta["trans_inv"])):
        batch[key] = torch.tensor(np.asarray(a, np.float32)[None],
                                  device=device)
    return batch, meta


@torch.no_grad()
def decoded(cfg: Config, model: torch.nn.Module, pair, calib, K: int):
    """One frame through the reference network, sigmoid and ddd_decode
    with its own top `K` slots: (dets, dets_r, info, meta), B = 1."""
    device = next(model.parameters()).device
    model.eval()
    batch, meta = _inputs(cfg, pair, calib, device)
    prev, model.topk = model.topk, K
    try:
        out = model(batch, use_cost_volume=cfg.cost_volume)
    finally:
        model.topk = prev
    dets, dets_r, info = dec.ddd_decode(
        torch.sigmoid(out["hm"]), out["kept_type"], out["dim"], out["orien"],
        out["wh"], out["reg"], grid_size=cfg.grid, K=K)
    if cfg.cost_volume:
        info = torch.cat([info, out["depth"]], dim=2)
    return dets, dets_r, info, meta


def results(cfg: Config, rows, classes, keep) -> Dict[int, np.ndarray]:
    """{class id: rows} as the program's Detector returns them."""
    return bucket_results(rows, classes, keep, cfg.num_classes)


@torch.no_grad()
def tail_on(cfg: Config, dets, dets_r, info, frames, run_align: bool = True
            ) -> np.ndarray:
    """The reference tail, frame by frame, on a group's decoded detections
    as the program's decode gave them: dets / dets_r (B, K, 6), info (B, K,
    9|10) tensors; frames the B (pair, calib) the group was made from.
    Returns the rows (B, K, 13)."""
    out = []
    for i, (pair, calib) in enumerate(frames):
        _, meta = _frame_meta(cfg, pair[0], calib)
        rows, _ = run_tail(dets[i].float(), dets_r[i].float(),
                           info[i].float(), pair[0], pair[1], meta, cfg,
                           run_align=run_align)
        out.append(rows.double().cpu().numpy())
    return np.stack(out)
