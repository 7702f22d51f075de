"""The inference tail on the device (port of
side_tpu/postprocess/device_tail.py): one frame (`run_tail`) or a group of
frames at once (`run_tail_batch`).

From the decode outputs (still on the device), the raw uint8 frame and a
few calib/affine scalars: affine unwarp, disparity or cost-volume depth,
the 3-DoF box solve, dense photometric alignment on the 2x-upsampled frame
and the re-solve.  The host fetches one (K, 13) array.

Under torch.profiler a tail shows as the span `tail`, holding `tail.prep`
(calibration packs, padding and uploads), `tail.solve` (the box solve),
`tail.align` (up-sampling and dense alignment) and `tail.resolve` (the
re-solve at the aligned depths); see runtime/spans.py.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import Config
from ..data import geometry as G
from ..data.kitti import calib_from_list
from ..runtime.spans import span
from . import box_solver as BS
from . import dense_align as DA


def _affine_pts(pts: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """(B, K, 2) points through (B, 2, 3) affine matrices."""
    return pts @ A[:, :, :2].transpose(1, 2) + A[:, None, :, 2]


def _tail_batch(dets, dets_r, info, img_left, img_right, trans_inv_out,
                calib_pack, mean, std, *, grid: int, run_align: bool,
                cost_volume: bool, align_topk: int = 0):
    """The tail over a frame axis (side_tpu `_tail_batch`, a vmap of
    `_tail_one`): dets/dets_r (B, K, 6); info (B, K, 9|10); img_* (B, H, W,
    3) uint8, frames padded to a common extent; trans_inv_out (B, 2, 3);
    calib_pack (B, 16): [f, bl, cx, cy, x_shift, y_shift, z_shift, p2_03,
    p2_13, p2_23, p2_02, p2_12, p2_00, p2_11, im_w, im_h], im_w and im_h
    the true extent of each frame.  Returns (rows (B, K, 13), classes
    (B, K)).

    Nothing couples frames, so every step runs once on all B*K detections:
    the per-frame scalars broadcast as (B, 1) columns, the solver takes the
    flattened rows with per-row calibration, and the aligner gathers from
    the B images through a per-detection frame index."""
    B, K = dets.shape[:2]
    (f, bl, cx, cy, x_shift, y_shift, z_shift, p2_03, p2_13, p2_23, p2_02,
     p2_12, p2_00, p2_11, im_w, im_h) = calib_pack[:, :, None].unbind(1)

    scores = dets[..., 4]
    classes = dets[..., 5].int()

    def unwarp(d):
        p1 = _affine_pts(d[..., :2] - 0.5 * d[..., 2:4], trans_inv_out)
        p2 = _affine_pts(d[..., :2] + 0.5 * d[..., 2:4], trans_inv_out)
        return torch.cat([p1, p2], dim=-1)

    box_left = unwarp(dets)
    box_right = unwarp(dets_r)
    width = box_left[..., 2] - box_left[..., 0]
    px = box_left[..., 0:1] + info[..., 5:8] * width[..., None] / grid
    kpts = torch.cat([px, info[..., 8:9]], dim=-1)
    dim = info[..., :3]
    alpha = torch.atan2(info[..., 3], info[..., 4])

    center_x = (box_left[..., 0] + box_left[..., 2]) / 2
    center_y = (box_left[..., 1] + box_left[..., 3]) / 2
    center_x_r = (box_right[..., 0] + box_right[..., 2]) / 2

    if cost_volume and info.shape[-1] > 9:
        depth = info[..., 9]
    else:
        disp = center_x - center_x_r
        depth = f * bl / torch.where(disp.abs() < 1e-3,
                                     torch.full_like(disp, 1e-3), disp)
    depth = depth.clamp(0.5, 300.0)

    z = depth - p2_23
    x = (center_x * depth - p2_03 - p2_02 * z) / p2_00
    y = (center_y * depth - p2_13 - p2_12 * z) / p2_11 + dim[..., 0] / 2
    theta = alpha + torch.atan2(center_x - cx, f)
    theta = torch.where(theta > math.pi, theta - 2 * math.pi, theta)
    theta = torch.where(theta < -math.pi, theta + 2 * math.pi, theta)

    def rows_of(a, n=K):
        """A per-frame (B, 1) scalar as one value per detection, (B*n,)."""
        return a.expand(B, n).reshape(-1)

    def flat(a, n=K):
        return a[:, :n].reshape(B * n, *a.shape[2:])

    dim_whl = dim[..., [1, 0, 2]]
    zero, one = torch.zeros_like(f), torch.ones_like(f)
    p2_mat = torch.stack([torch.cat([p2_00, zero, cx, p2_03], 1),
                          torch.cat([zero, p2_11, cy, p2_13], 1),
                          torch.cat([zero, zero, one, p2_23], 1)], dim=1)
    with span("tail.solve"):
        consts = BS.build_consts(
            torch.cat([im_w, im_h], 1)[:, None].expand(B, K, 2).reshape(
                -1, 2),
            p2_mat[:, None].expand(B, K, 3, 4).reshape(-1, 3, 4),
            rows_of(bl), flat(alpha), flat(dim_whl), flat(box_left),
            flat(box_right), flat(kpts), use_right=False, grid=grid)
        states = BS.solve_x_y_theta(consts, flat(depth)).reshape(B, K, 3)
        solved_ok = torch.isfinite(states).all(dim=-1)
        x = torch.where(solved_ok, states[..., 0] - x_shift, x)
        y = torch.where(solved_ok, states[..., 1] - y_shift, y)
        z_out = torch.where(solved_ok, depth - z_shift, z)
        theta = torch.where(solved_ok, states[..., 2] - math.pi / 2, theta)

    if run_align:
        with span("tail.align"):
            im_l2 = DA.upsample2x((img_left.float() / 255.0 - mean) / std)
            im_r2 = DA.upsample2x((img_right.float() / 255.0 - mean) / std)
            scale = 2.0
            keep = scores > 0.0
            poses = torch.stack([x + x_shift, y + y_shift, z_out + z_shift,
                                 dim[..., 1], dim[..., 0], dim[..., 2],
                                 theta + math.pi / 2], dim=-1)
            # align the top align_topk score-ordered slots of each frame;
            # the rest keep their solved depth (the status = 0 fallback)
            A = K if align_topk <= 0 else min(align_topk, K)
            frame = torch.arange(B, device=dets.device).repeat_interleave(A)
            status_a, best_dis_a = DA.align_depths(
                im_l2, im_r2, rows_of(f, A) * scale, rows_of(bl, A),
                rows_of(cx, A) * scale, rows_of(cy, A) * scale,
                flat(box_left, A) * scale, flat(kpts[..., :2], A) * scale,
                flat(poses, A), flat(keep, A), frame=frame)
            status = torch.nn.functional.pad(status_a.reshape(B, A),
                                             (0, K - A))
            best_dis = torch.nn.functional.pad(best_dis_a.reshape(B, A),
                                               (0, K - A), value=1.0)
        with span("tail.resolve"):
            z_aligned = f * bl / torch.clamp(best_dis, min=1e-3)
            states2 = BS.solve_x_y_theta(consts, flat(z_aligned)
                                         ).reshape(B, K, 3)
            ok2 = (status > 0) & torch.isfinite(states2).all(dim=-1)
            x = torch.where(ok2, states2[..., 0] - x_shift, x)
            y = torch.where(ok2, states2[..., 1] - y_shift, y)
            z_out = torch.where(ok2, z_aligned - z_shift, z_out)
            theta = torch.where(ok2, states2[..., 2] - math.pi / 2, theta)

    rows = torch.cat([alpha[..., None], box_left, dim, x[..., None],
                      y[..., None], z_out[..., None], theta[..., None],
                      scores[..., None]], dim=-1)
    return rows, classes


def _tail_one(dets, dets_r, info, img_left, img_right, trans_inv_out,
              calib_pack, mean, std, **kw):
    """One frame: `_tail_batch` at B = 1.  dets/dets_r (K, 6); info
    (K, 9|10); img_* (H, W, 3) uint8; calib_pack (16,).  Returns (rows
    (K, 13), classes (K,))."""
    rows, classes = _tail_batch(
        dets[None], dets_r[None], info[None], img_left[None],
        img_right[None], trans_inv_out[None], calib_pack[None], mean, std,
        **kw)
    return rows[0], classes[0]


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
    with span("tail"):
        with span("tail.prep"):
            trans_inv_out, pack = calib_pack_from_meta(
                meta, cfg, float(img_left_u8.shape[1]),
                float(img_left_u8.shape[0]))
            mean = torch.tensor(cfg.mean, dtype=torch.float32, device=dev)
            std = torch.tensor(cfg.std, dtype=torch.float32, device=dev)
            ups = [_upload(a, dev) for a in (img_left_u8, img_right_u8,
                                              trans_inv_out, pack)]
        return _tail_one(dets, dets_r, info, *ups, mean, std, grid=cfg.grid,
                         run_align=run_align, cost_volume=cfg.cost_volume,
                         align_topk=cfg.align_topk)


def _upload(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, non_blocking=True)


def _pad_stack(imgs, H: int, W: int) -> np.ndarray:
    """Edge-pad per-frame uint8 images to a common (H, W) and stack.

    The padding lies outside every true extent (im_w, im_h ride in the calib
    pack); edge replication keeps bilinear reads at the true boundary equal
    to those of the unpadded single-frame tail."""
    out = np.empty((len(imgs), H, W, 3), np.uint8)
    for i, im in enumerate(imgs):
        h, w = im.shape[:2]
        out[i, :h, :w] = im
        if w < W:
            out[i, :h, w:] = im[:, w - 1:w]
        if h < H:
            out[i, h:] = out[i, h - 1:h]
    return out


def run_tail_batch(dets, dets_r, info, imgs_left, imgs_right, metas,
                   cfg: Config, run_align: bool = True):
    """The tail of B frames in one pass on dets' device: dets/dets_r
    (B, K, 6), info (B, K, 9|10) tensors; imgs_* lists of B uint8 numpy
    frames whose sizes may differ by a few pixels; metas the B per-frame
    dicts.  Returns (rows (B, K, 13), classes (B, K)) on the device, not
    synchronised.

    The frames are padded to the group's largest extent.  (The JAX package
    rounds that up to multiples of 64 x 128 so that every group compiles to
    one program; eager PyTorch compiles nothing, so no rounding.)"""
    dev = dets.device
    with span("tail"):
        with span("tail.prep"):
            H = max(im.shape[0] for im in [*imgs_left, *imgs_right])
            W = max(im.shape[1] for im in [*imgs_left, *imgs_right])
            packs, trans = [], []
            for meta, im in zip(metas, imgs_left):
                t, p = calib_pack_from_meta(meta, cfg, float(im.shape[1]),
                                            float(im.shape[0]))
                trans.append(t)
                packs.append(p)
            mean = torch.tensor(cfg.mean, dtype=torch.float32, device=dev)
            std = torch.tensor(cfg.std, dtype=torch.float32, device=dev)
            ups = [_upload(a, dev) for a in (
                _pad_stack(imgs_left, H, W), _pad_stack(imgs_right, H, W),
                np.stack(trans), np.stack(packs))]
        return _tail_batch(dets, dets_r, info, *ups, mean, std,
                           grid=cfg.grid, run_align=run_align,
                           cost_volume=cfg.cost_volume,
                           align_topk=cfg.align_topk)


def bucket_results(rows: np.ndarray, classes: np.ndarray, keep: np.ndarray,
                   num_classes: int) -> Dict[int, np.ndarray]:
    """Rows of one frame by 1-based class id, those with `keep` only."""
    return {cls + 1: rows[keep & (classes == cls)]
            for cls in range(num_classes)}
