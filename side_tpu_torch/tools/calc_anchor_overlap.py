"""Dataset statistics and anchor-overlap study over a COCO-format
annotation file (a copy of tools/calc_anchor_overlap.py; pure NumPy, an
offline analysis off the main path).  Reports:

  * center-cell collisions at stride 4, class-agnostic and class-aware:
    two objects sharing a heatmap peak, CenterNet's failure mode;
  * same-class GT pairs with IoU > 0.5;
  * the object-size histogram small / medium / large;
  * per size, GT boxes that no RPN-style anchor covers at IoU 0.5, and
    the anchor recall per class.

    python -m side_tpu_torch.tools.calc_anchor_overlap \
        data/kitti/annotations_3d/kitti_3dop_train.json
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict

import numpy as np

ANCHOR_SCALES = [16, 32, 64, 128, 256]
ANCHOR_RATIOS = [0.5, 1.0, 2.0]
STRIDE = 16
IMG_W, IMG_H = 1248, 384


def anchors():
    out = []
    for s in ANCHOR_SCALES:
        for r in ANCHOR_RATIOS:
            w = s * np.sqrt(r)
            h = s / np.sqrt(r)
            out.append((w, h))
    return out


def recall_at(boxes, thresh=0.5):
    """Best-anchor IoU per gt box over a dense stride grid."""
    cx = np.arange(STRIDE / 2, IMG_W, STRIDE)
    cy = np.arange(STRIDE / 2, IMG_H, STRIDE)
    best = np.zeros(len(boxes))
    for (aw, ah) in anchors():
        ax1 = cx[None, :] - aw / 2
        ay1 = cy[:, None] - ah / 2
        for i, b in enumerate(boxes):
            x1 = np.maximum(ax1, b[0])
            y1 = np.maximum(ay1, b[1])
            x2 = np.minimum(ax1 + aw, b[0] + b[2])
            y2 = np.minimum(ay1 + ah, b[1] + b[3])
            inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
            iou = inter / (aw * ah + b[2] * b[3] - inter)
            best[i] = max(best[i], iou.max())
    return (best > thresh).mean(), best.mean()


def _pair_iou(a, b):
    """IoU of two xywh boxes (calc_coco_overlap.py:32-38 semantics)."""
    ax2, ay2 = a[0] + a[2], a[1] + a[3]
    bx2, by2 = b[0] + b[2], b[1] + b[3]
    inter = max(min(ax2, bx2) - max(a[0], b[0]), 0) * \
        max(min(ay2, by2) - max(a[1], b[1]), 0)
    return inter / max(a[2] * a[3] + b[2] * b[3] - inter, 1e-9)


def _size_bucket(area):
    return 0 if area < 32 ** 2 else (1 if area < 96 ** 2 else 2)


def collision_stats(anns_by_img, down=4):
    """Center-cell and IoU collision counts (count/count_agnostic/count_iou)."""
    agn = cls_aware = iou_coll = total = 0
    for anns in anns_by_img.values():
        total += len(anns)
        seen = []
        for cat, bbox in anns:
            cell = ((bbox[0] + bbox[2] / 2) // down,
                    (bbox[1] + bbox[3] / 2) // down)
            for pcat, pcell, pbox in seen:
                if cell == pcell:
                    agn += 1
                    if cat == pcat:
                        cls_aware += 1
                if cat == pcat and _pair_iou(bbox, pbox) > 0.5:
                    iou_coll += 1
            seen.append((cat, cell, bbox))
    return agn, cls_aware, iou_coll, total


def anchor_misses(anns_by_img):
    """GT boxes no dense anchor reaches at IoU 0.5, bucketed by size
    (count_anchor without the COCO 800px resize — KITTI images are a fixed
    geometry, so boxes are used as-is)."""
    miss = [0, 0, 0]
    cnt = [0, 0, 0]
    cx = np.arange(STRIDE / 2, IMG_W, STRIDE)
    cy = np.arange(STRIDE / 2, IMG_H, STRIDE)
    awh = np.asarray(anchors())                       # (A, 2)
    for anns in anns_by_img.values():
        for _, b in anns:
            area = b[2] * b[3]
            s = _size_bucket(area)
            cnt[s] += 1
            best = 0.0
            for (aw, ah) in awh:
                x1 = np.maximum(cx[None, :] - aw / 2, b[0])
                y1 = np.maximum(cy[:, None] - ah / 2, b[1])
                x2 = np.minimum(cx[None, :] + aw / 2, b[0] + b[2])
                y2 = np.minimum(cy[:, None] + ah / 2, b[1] + b[3])
                inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
                best = max(best, float(
                    (inter / (aw * ah + area - inter)).max()))
            if best < 0.5:
                miss[s] += 1
    return miss, cnt


def main(argv=None) -> int:
    path = (sys.argv[1:] if argv is None else argv)[0]
    with open(path) as f:
        d = json.load(f)
    cats = {c["id"]: c["name"] for c in d["categories"]}
    by_cat = {}
    anns_by_img = defaultdict(list)
    for ann in d["annotations"]:
        name = cats[ann["category_id"]]
        if name == "DontCare":
            continue
        by_cat.setdefault(name, []).append(ann["bbox"])
        anns_by_img[ann["image_id"]].append(
            (ann["category_id"], list(map(float, ann["bbox"]))))

    for name, boxes in sorted(by_cat.items()):
        boxes = np.asarray(boxes, np.float64)
        for t in (0.5, 0.7):
            rec, mean_iou = recall_at(boxes, t)
            print(f"{name:16s} n={len(boxes):5d} recall@{t}: {rec:.3f} "
                  f"(mean best IoU {mean_iou:.3f})")

    agn, cls_aware, iou_coll, total = collision_stats(anns_by_img)
    print(f"center collisions @stride4: {agn} agnostic, {cls_aware} "
          f"same-class, of {total} objects")
    print(f"same-class IoU>0.5 pairs: {iou_coll}")

    sizes = [0, 0, 0]
    for anns in anns_by_img.values():
        for _, b in anns:
            sizes[_size_bucket(b[2] * b[3])] += 1
    print(f"size histogram s/m/l: {sizes[0]} {sizes[1]} {sizes[2]}")

    miss, cnt = anchor_misses(anns_by_img)
    print(f"anchor misses @IoU0.5 s/m/l: {miss[0]}/{cnt[0]} "
          f"{miss[1]}/{cnt[1]} {miss[2]}/{cnt[2]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
