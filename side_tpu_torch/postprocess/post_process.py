"""The inference tail of one frame on the host (port of
side_tpu/postprocess/post_process.py).

From the decode outputs as numpy arrays: affine unwarp of both views' boxes
and the keypoint / border cells, disparity or cost-volume depth, the batched
box solve, dense photometric alignment on the 2x-upsampled frames and the
re-solve, giving per-class KITTI rows [alpha, x1, y1, x2, y2, h, w, l, x, y,
z, ry, score].  The arithmetic between the solves is numpy; the solver and
the aligner are the port's, run on CPU tensors.  Unlike the device tail it
aligns every detection above `peak_thresh` (no `align_topk` cap) and hands
the solver the pre-process scale `s` as the image extent, as the JAX
package's host tail does.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
import torch

from ..config import Config
from ..data import geometry as G
from ..data.kitti import calib_from_list
from . import box_solver as BS
from . import dense_align as DA


def get_alpha(orien: np.ndarray) -> np.ndarray:
    """(sin, cos) -> viewpoint angle."""
    return np.arctan2(orien[..., 0], orien[..., 1])


def unwarp_boxes(dets: np.ndarray, c, s, output_size) -> np.ndarray:
    """Center/size detections -> corner boxes in original pixels.
    dets: (K, >=4) [cx, cy, w, h, ...]."""
    boxes = np.zeros((dets.shape[0], 4), np.float32)
    boxes[:, :2] = dets[:, :2] - 0.5 * dets[:, 2:4]
    boxes[:, 2:] = dets[:, :2] + 0.5 * dets[:, 2:4]
    boxes[:, :2] = G.transform_preds(boxes[:, :2], c, s, output_size)
    boxes[:, 2:] = G.transform_preds(boxes[:, 2:], c, s, output_size)
    return boxes


def cells_to_pixels(info: np.ndarray, boxes_left: np.ndarray,
                    grid: int) -> np.ndarray:
    """Keypoint / border grid cells -> pixel u coordinates anchored on the
    unwarped left box.  Returns (K, 4) = [border_l_u, border_r_u, kpt_u,
    kpt_type]."""
    width = boxes_left[:, 2] - boxes_left[:, 0]
    px = boxes_left[:, 0:1] + info[:, 5:8] * width[:, None] / grid
    return np.concatenate([px, info[:, 8:9]], axis=1)


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@torch.no_grad()
def process_frame(dets: np.ndarray, dets_right: np.ndarray,
                  info_3d: np.ndarray, meta: Dict, cfg: Config,
                  img_left: np.ndarray = None, img_right: np.ndarray = None,
                  run_align: bool = True) -> Dict[int, np.ndarray]:
    """Full post-processing of one frame's decoded outputs.

    dets/dets_right: (K, 6); info_3d: (K, 9), or (K, 10) with cost-volume
    depth appended.  Returns {class id (1-based): (n, 13) KITTI rows}."""
    c, s = meta["c"], meta["s"]
    calib = calib_from_list(meta["calib"])
    out_size = (cfg.output_w, cfg.output_h)

    f = calib.f
    bl = calib.baseline
    x_shift = (calib.p2[0, 3] - calib.p0[0, 3]) / f
    y_shift = (calib.p2[1, 3] - calib.p0[1, 3]) / f
    z_shift = (calib.p2[2, 3] - calib.p0[2, 3]) / f

    scores = dets[:, 4]
    classes = dets[:, 5].astype(np.int32)
    keep = scores > cfg.peak_thresh

    box_left = unwarp_boxes(dets, c, s, out_size)
    box_right = unwarp_boxes(dets_right, c, s, out_size)
    kpts = cells_to_pixels(info_3d, box_left, cfg.grid)
    dim = info_3d[:, :3]                       # (h, w, l)
    alpha = get_alpha(info_3d[:, 3:5])

    center_x = (box_left[:, 0] + box_left[:, 2]) / 2
    center_y = (box_left[:, 1] + box_left[:, 3]) / 2
    center_x_r = (box_right[:, 0] + box_right[:, 2]) / 2

    if cfg.cost_volume and info_3d.shape[1] > 9:
        depth = info_3d[:, 9].copy()
    else:
        disp = center_x - center_x_r
        depth = f * bl / np.where(np.abs(disp) < 1e-3, 1e-3, disp)
    depth = np.clip(depth, 0.5, 300.0)

    # closed-form back-projection, kept where the solve fails
    z = depth - calib.p2[2, 3]
    x = (center_x * depth - calib.p2[0, 3] - calib.p2[0, 2] * z) / \
        calib.p2[0, 0]
    y = (center_y * depth - calib.p2[1, 3] - calib.p2[1, 2] * z) / \
        calib.p2[1, 1] + dim[:, 0] / 2
    theta = G.alpha_to_rot_y(alpha, center_x, calib.p2[0, 2], calib.p2[0, 0])

    # first solve, at the network's depth
    dim_whl = dim[:, [1, 0, 2]]
    consts = BS.build_consts(_f32(s), _f32(calib.p2), bl, _f32(alpha),
                             _f32(dim_whl), _f32(box_left), _f32(box_right),
                             _f32(kpts), use_right=False, grid=cfg.grid)
    states = BS.solve_x_y_theta(consts, _f32(depth)).numpy()
    solved_ok = np.isfinite(states).all(axis=1)
    x = np.where(solved_ok, states[:, 0] - x_shift, x)
    y = np.where(solved_ok, states[:, 1] - y_shift, y)
    z_out = np.where(solved_ok, depth - z_shift, z)
    theta = np.where(solved_ok, states[:, 2] - math.pi / 2, theta)

    # dense alignment and re-solve
    if run_align and img_left is not None and keep.any():
        mean = np.asarray(cfg.mean, np.float32).reshape(1, 1, 3)
        std = np.asarray(cfg.std, np.float32).reshape(1, 1, 3)
        norm_l = (img_left.astype(np.float32) / 255.0 - mean) / std
        norm_r = (img_right.astype(np.float32) / 255.0 - mean) / std
        im_l2 = DA.upsample2x(_f32(norm_l))
        im_r2 = DA.upsample2x(_f32(norm_r))
        scale = 2.0
        poses = np.stack([x + x_shift, y + y_shift, z_out + z_shift,
                          dim[:, 1], dim[:, 0], dim[:, 2],
                          theta + math.pi / 2], axis=1)
        status, best_dis = DA.align_depths(
            im_l2, im_r2, float(np.float32(f * scale)), float(np.float32(bl)),
            float(np.float32(calib.p2[0, 2] * scale)),
            float(np.float32(calib.p2[1, 2] * scale)),
            _f32(box_left * scale), _f32(kpts[:, :2] * scale), _f32(poses),
            torch.from_numpy(keep))
        status = status.numpy()
        best_dis = best_dis.numpy()
        z_aligned = f * bl / np.maximum(best_dis, 1e-3)
        states2 = BS.solve_x_y_theta(consts, _f32(z_aligned)).numpy()
        ok2 = (status > 0) & np.isfinite(states2).all(axis=1)
        x = np.where(ok2, states2[:, 0] - x_shift, x)
        y = np.where(ok2, states2[:, 1] - y_shift, y)
        z_out = np.where(ok2, z_aligned - z_shift, z_out)
        theta = np.where(ok2, states2[:, 2] - math.pi / 2, theta)

    rows = np.concatenate([
        alpha[:, None], box_left, dim, x[:, None], y[:, None],
        z_out[:, None], theta[:, None], scores[:, None]], axis=1
    ).astype(np.float32)
    return {cls + 1: rows[keep & (classes == cls)]
            for cls in range(cfg.num_classes)}


def save_kitti_results(results: Dict[int, Dict[int, np.ndarray]],
                       save_dir: str, class_names: List[str]) -> str:
    """Write one KITTI txt file per image under `save_dir`/results."""
    results_dir = os.path.join(save_dir, "results")
    os.makedirs(results_dir, exist_ok=True)
    for img_id, per_cls in results.items():
        path = os.path.join(results_dir, f"{img_id:06d}.txt")
        with open(path, "w") as fh:
            for cls_ind, rows in per_cls.items():
                name = class_names[cls_ind]
                for r in np.asarray(rows):
                    vals = " ".join(f"{v:.2f}" for v in r)
                    fh.write(f"{name} 0.0 0 {vals}\n")
    return results_dir
