# Frozen copy of side_tpu_torch/data/targets.py at commit ca59ff401c87, kept with the benchmark
# so that later changes to the program do not move the yardstick.
"""Fixed-shape training-target generation for stereo CenterNet (copy of
side_tpu/data/targets.py).

Host-side re-design of the reference's StereoDataset.__getitem__
(/root/reference/src/lib/modules/stereoDataset.py:72-300): every sample
emits tensors of static shape (max_objs slots + validity mask) so the
device pipeline stays fully shape-static under jit.

Per object (slot k):
    hm      (C, Oh, Ow)  class gaussian heatmap
    wh      (K, 3)       (w_left, w_right, h) at output res
    reg     (K, 3)       (dx_left, dx_right, dy) sub-pixel center offsets
    ind     (K,)         flattened output-cell index of the int center
    dim     (K, 3)       metric h, w, l
    orien   (K, 2)       (sin alpha, cos alpha)
    depth   (K, 1)       z in metres
    kept    (K, 6)       4 keypoint u + visible-left/right u, box-relative
    rot_mask(K,)         slot validity
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from . import geometry as G
from .kitti import KittiObject


@dataclass
class TargetSpec:
    num_classes: int = 3
    output_w: int = 320
    output_h: int = 96
    max_objs: int = 50
    mse_loss: bool = False


def flip_object_boxes(obj: KittiObject, img_w: int):
    """Return the (bbox, bbox_right, keypoints6) of an object in the
    horizontally-flipped right image (the stereo-flip trick: flipped right
    image plays the left role; stereoDataset.py:163-222)."""
    # flipped sample: left role <- boxes[1] mirrored, right role <- boxes[0]
    b1, b0 = obj.boxes[1], obj.boxes[0]
    bbox = np.array(b1.box, np.float64)
    bbox_right = np.array(b0.box, np.float64)
    bbox[0], bbox[2] = img_w - b1.box[2] - 1, img_w - b1.box[0] - 1
    bbox_right[0], bbox_right[2] = img_w - b0.box[2] - 1, img_w - b0.box[0] - 1

    kp = b1.keypoints
    kpts = np.empty(6, np.float64)
    # keypoint order reverses under mirror: 0<->3, 1<->2; borders swap
    src = [kp[3], kp[2], kp[1], kp[0], b1.visible_right, b1.visible_left]
    for i, v in enumerate(src):
        kpts[i] = -1.0 if v == -1 else img_w - v - 1
    return bbox, bbox_right, kpts


def flip_alpha(alpha: float) -> float:
    """Observation-angle flip (stereoDataset.py:248-253)."""
    if alpha > math.pi:
        alpha -= 2.0 * math.pi
    elif alpha < -math.pi:
        alpha += 2.0 * math.pi
    return (math.pi - alpha) if alpha >= 0 else (-math.pi - alpha)


def generate_targets(objects: List[KittiObject], cls_to_id: Dict[str, int],
                     trans_output: np.ndarray, spec: TargetSpec,
                     flipped: bool = False, img_w: int = 0) -> Dict[str, np.ndarray]:
    """Build the per-sample target dict from geometric objects."""
    K = spec.max_objs
    hm = np.zeros((spec.num_classes, spec.output_h, spec.output_w), np.float32)
    wh = np.zeros((K, 3), np.float32)
    reg = np.zeros((K, 3), np.float32)
    dim = np.zeros((K, 3), np.float32)
    orien = np.zeros((K, 2), np.float32)
    depth = np.zeros((K, 1), np.float32)
    kept = np.zeros((K, 6), np.float32)
    ind = np.zeros((K,), np.int64)
    rot_mask = np.zeros((K,), np.uint8)

    draw = G.draw_msra_gaussian if spec.mse_loss else G.draw_umich_gaussian

    num_objs = min(len(objects), K)
    for k in range(num_objs):
        obj = objects[k]
        cls_id = cls_to_id[obj.cls]

        if flipped:
            bbox, bbox_right, raw_kpts = flip_object_boxes(obj, img_w)
            # keypoints are anchored at the (pre-transform) box bottom edge v
            kpt_v = obj.boxes[1].box[3]
        else:
            bbox = np.array(obj.boxes[0].box, np.float64)
            bbox_right = np.array(obj.boxes[1].box, np.float64)
            b0 = obj.boxes[0]
            raw_kpts = np.array([b0.keypoints[0], b0.keypoints[1],
                                 b0.keypoints[2], b0.keypoints[3],
                                 b0.visible_left, b0.visible_right])
            kpt_v = obj.boxes[0].box[3]

        # warp both boxes to output resolution and clip
        bbox[:2] = G.affine_transform(bbox[:2], trans_output)
        bbox[2:] = G.affine_transform(bbox[2:], trans_output)
        bbox[[0, 2]] = np.clip(bbox[[0, 2]], 0, spec.output_w - 1)
        bbox[[1, 3]] = np.clip(bbox[[1, 3]], 0, spec.output_h - 1)
        bbox_right[:2] = G.affine_transform(bbox_right[:2], trans_output)
        bbox_right[2:] = G.affine_transform(bbox_right[2:], trans_output)
        bbox_right[[0, 2]] = np.clip(bbox_right[[0, 2]], 0, spec.output_w - 1)
        bbox_right[[1, 3]] = np.clip(bbox_right[[1, 3]], 0, spec.output_h - 1)

        h = bbox[3] - bbox[1]
        w = bbox[2] - bbox[0]
        w_right = bbox_right[2] - bbox_right[0]

        # keypoints: warp u-coords through the same affine (paired with the
        # box bottom v so the x-shear of the affine is honoured), then clip.
        kpts = np.empty(6, np.float64)
        for i in range(6):
            kpts[i] = G.affine_transform((raw_kpts[i], kpt_v), trans_output)[0]
        kpts = np.clip(kpts, -1, spec.output_w - 1)

        if h > 0 and w > 0:
            radius = max(0, int(G.gaussian_radius((h, w))))
            ct = np.array([(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2],
                          np.float32)
            ct_right = np.array([(bbox_right[0] + bbox_right[2]) / 2,
                                 (bbox_right[1] + bbox_right[3]) / 2],
                                np.float32)
            ct_int = ct.astype(np.int32)
            draw(hm[cls_id], ct, radius)

            wh[k] = w, w_right, h
            ind[k] = ct_int[1] * spec.output_w + ct_int[0]
            reg[k] = (ct[0] - ct_int[0], ct_right[0] - ct_int[0],
                      ct[1] - ct_int[1])
            dim[k] = obj.dim
            alpha = flip_alpha(obj.alpha) if flipped else obj.alpha
            orien[k] = math.sin(alpha), math.cos(alpha)
            depth[k] = obj.pos[2]
            rot_mask[k] = 1
            kept[k] = kpts - bbox[0]

    return {
        "hm": hm, "wh": wh, "reg": reg, "dim": dim, "orien": orien,
        "depth": depth, "kept": kept, "ind": ind,
        "ind_float": ind.astype(np.float32), "rot_mask": rot_mask,
    }


def compute_kept_label(kept: np.ndarray, wh: np.ndarray, grid: int) -> np.ndarray:
    """Quantise box-relative keypoint u into grid cells and pick the
    classification targets (stereoTrainer.py:77-95), vectorised NumPy.

    kept: (..., 6), wh: (..., 3) -> (..., 3) int64 targets
    [kpt_type*grid + kpt_cell, border_left_cell, border_right_cell].
    """
    width = wh[..., 0:1] + 1.0
    target = np.round(kept * grid / width)
    target = np.where((target < 0) | (target > grid - 1), -225.0, target)
    kpts_pos = target[..., :4].max(axis=-1)
    kpts_type = target[..., :4].argmax(axis=-1).astype(np.float64)
    merged = np.stack([kpts_type * grid + kpts_pos,
                       target[..., 4], target[..., 5]], axis=-1)
    merged = np.where(merged < 0, 0.0, merged)
    return merged.astype(np.int64)
