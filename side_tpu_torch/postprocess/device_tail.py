"""The inference tail on the device (port of
side_tpu/postprocess/device_tail.py, single frame).

From the decode outputs (still on the device), the raw uint8 frame and a
few calib/affine scalars: affine unwarp, disparity or cost-volume depth,
the 3-DoF box solve, dense photometric alignment on the 2x-upsampled frame
and the re-solve.  The host fetches one (K, 13) array.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import Config
from ..data import geometry as G
from ..data.kitti import calib_from_list
from . import box_solver as BS
from . import dense_align as DA


def _affine_pts(pts: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """(..., 2) points through a (2, 3) affine matrix."""
    return pts @ A[:, :2].T + A[:, 2]


def _tail_one(dets, dets_r, info, img_left, img_right, trans_inv_out,
              calib_pack, mean, std, *, grid: int, run_align: bool,
              cost_volume: bool, align_topk: int = 0):
    """dets/dets_r: (K, 6); info: (K, 9|10); img_*: (H, W, 3) uint8.
    calib_pack (16,): [f, bl, cx, cy, x_shift, y_shift, z_shift, p2_03,
    p2_13, p2_23, p2_02, p2_12, p2_00, p2_11, im_w, im_h].
    Returns (rows (K, 13), classes (K,))."""
    (f, bl, cx, cy, x_shift, y_shift, z_shift, p2_03, p2_13, p2_23, p2_02,
     p2_12, p2_00, p2_11, im_w, im_h) = calib_pack.unbind(0)

    scores = dets[:, 4]
    classes = dets[:, 5].int()

    def unwarp(d):
        p1 = _affine_pts(d[:, :2] - 0.5 * d[:, 2:4], trans_inv_out)
        p2 = _affine_pts(d[:, :2] + 0.5 * d[:, 2:4], trans_inv_out)
        return torch.cat([p1, p2], dim=1)

    box_left = unwarp(dets)
    box_right = unwarp(dets_r)
    width = box_left[:, 2] - box_left[:, 0]
    px = box_left[:, 0:1] + info[:, 5:8] * width[:, None] / grid
    kpts = torch.cat([px, info[:, 8:9]], dim=1)
    dim = info[:, :3]
    alpha = torch.atan2(info[:, 3], info[:, 4])

    center_x = (box_left[:, 0] + box_left[:, 2]) / 2
    center_y = (box_left[:, 1] + box_left[:, 3]) / 2
    center_x_r = (box_right[:, 0] + box_right[:, 2]) / 2

    if cost_volume and info.shape[1] > 9:
        depth = info[:, 9]
    else:
        disp = center_x - center_x_r
        depth = f * bl / torch.where(disp.abs() < 1e-3,
                                     torch.full_like(disp, 1e-3), disp)
    depth = depth.clamp(0.5, 300.0)

    z = depth - p2_23
    x = (center_x * depth - p2_03 - p2_02 * z) / p2_00
    y = (center_y * depth - p2_13 - p2_12 * z) / p2_11 + dim[:, 0] / 2
    theta = alpha + torch.atan2(center_x - cx, f)
    theta = torch.where(theta > math.pi, theta - 2 * math.pi, theta)
    theta = torch.where(theta < -math.pi, theta + 2 * math.pi, theta)

    dim_whl = dim[:, [1, 0, 2]]
    zero, one = torch.zeros_like(f), torch.ones_like(f)
    p2_mat = torch.stack([torch.stack([p2_00, zero, cx, p2_03]),
                          torch.stack([zero, p2_11, cy, p2_13]),
                          torch.stack([zero, zero, one, p2_23])])
    consts = BS.build_consts(torch.stack([im_w, im_h]), p2_mat, bl, alpha,
                             dim_whl, box_left, box_right, kpts,
                             use_right=False, grid=grid)
    states = BS.solve_x_y_theta(consts, depth)
    solved_ok = torch.isfinite(states).all(dim=1)
    x = torch.where(solved_ok, states[:, 0] - x_shift, x)
    y = torch.where(solved_ok, states[:, 1] - y_shift, y)
    z_out = torch.where(solved_ok, depth - z_shift, z)
    theta = torch.where(solved_ok, states[:, 2] - math.pi / 2, theta)

    if run_align:
        norm_l = (img_left.float() / 255.0 - mean) / std
        norm_r = (img_right.float() / 255.0 - mean) / std
        im_l2 = DA.upsample2x(norm_l)
        im_r2 = DA.upsample2x(norm_r)
        scale = 2.0
        keep = scores > 0.0
        poses = torch.stack([x + x_shift, y + y_shift, z_out + z_shift,
                             dim[:, 1], dim[:, 0], dim[:, 2],
                             theta + math.pi / 2], dim=1)
        # align the top align_topk score-ordered slots; the rest keep
        # their solved depth (the status = 0 fallback)
        K = dets.shape[0]
        A = K if align_topk <= 0 else min(align_topk, K)
        status_a, best_dis_a = DA.align_depths(
            im_l2, im_r2, f * scale, bl, cx * scale, cy * scale,
            box_left[:A] * scale, kpts[:A, :2] * scale, poses[:A], keep[:A])
        status = torch.nn.functional.pad(status_a, (0, K - A))
        best_dis = torch.nn.functional.pad(best_dis_a, (0, K - A), value=1.0)
        z_aligned = f * bl / torch.clamp(best_dis, min=1e-3)
        states2 = BS.solve_x_y_theta(consts, z_aligned)
        ok2 = (status > 0) & torch.isfinite(states2).all(dim=1)
        x = torch.where(ok2, states2[:, 0] - x_shift, x)
        y = torch.where(ok2, states2[:, 1] - y_shift, y)
        z_out = torch.where(ok2, z_aligned - z_shift, z_out)
        theta = torch.where(ok2, states2[:, 2] - math.pi / 2, theta)

    rows = torch.cat([alpha[:, None], box_left, dim, x[:, None], y[:, None],
                      z_out[:, None], theta[:, None], scores[:, None]], dim=1)
    return rows, classes


def calib_pack_from_meta(meta: Dict, cfg: Config, im_w: float, im_h: float
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Host side: the per-frame affine and calib scalars of `_tail_one`."""
    c, s = meta["c"], meta["s"]
    calib = calib_from_list(meta["calib"])
    trans_inv_out = G.get_affine_transform(
        c, s, 0, [cfg.output_w, cfg.output_h], inv=True).astype(np.float32)
    f = calib.f
    pack = np.array([
        f, calib.baseline, calib.p2[0, 2], calib.p2[1, 2],
        (calib.p2[0, 3] - calib.p0[0, 3]) / f,
        (calib.p2[1, 3] - calib.p0[1, 3]) / f,
        (calib.p2[2, 3] - calib.p0[2, 3]) / f,
        calib.p2[0, 3], calib.p2[1, 3], calib.p2[2, 3],
        calib.p2[0, 2], calib.p2[1, 2],
        calib.p2[0, 0], calib.p2[1, 1],
        im_w, im_h,
    ], np.float32)
    return trans_inv_out, pack


def run_tail(dets, dets_r, info, img_left_u8, img_right_u8, meta: Dict,
             cfg: Config, run_align: bool = True):
    """The tail of one frame on dets' device: dets/dets_r (K, 6), info
    (K, 9|10) tensors, img_* (H, W, 3) uint8 numpy frames.  Returns
    (rows (K, 13), classes (K,)) on the device, not synchronised."""
    dev = dets.device
    trans_inv_out, pack = calib_pack_from_meta(
        meta, cfg, float(img_left_u8.shape[1]), float(img_left_u8.shape[0]))
    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=dev)
    std = torch.tensor(cfg.std, dtype=torch.float32, device=dev)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            dev, non_blocking=True)

    return _tail_one(dets, dets_r, info, up(img_left_u8), up(img_right_u8),
                     up(trans_inv_out), up(pack), mean, std, grid=cfg.grid,
                     run_align=run_align, cost_volume=cfg.cost_volume,
                     align_topk=cfg.align_topk)
