"""Stereo KITTI dataset: host-side decode/augment/warp + target generation
(copy of side_tpu/data/dataset.py).

`make_sample` turns one stereo pair, its calibration and its COCO-style
annotations into a training sample: the center/scale augmentation, the
affine warp to the input size, the color augmentation, and the targets.
`StereoKitti` reads the pair from disk and calls it; `data/synthetic.py`
calls it on rendered scenes held in memory.  Images stay NHWC; with
`cfg.uint8_images` they stay uint8 and the trainer normalises them on the
device.  OpenCV is imported at first use: reading PNGs needs it, and
`warp_affine` falls back to NumPy without it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import CLASS_NAMES, Config
from . import geometry as G
from .kitti import CocoIndex, calib_from_list, read_objects
from .targets import TargetSpec, generate_targets

_EIG_VAL = np.array([0.2141788, 0.01817699, 0.00341571], np.float32)
_EIG_VEC = np.array([
    [-0.58752847, -0.69563484, 0.41340352],
    [-0.5832747, 0.00994535, -0.81221408],
    [-0.56089297, 0.71832671, 0.41158938],
], np.float32)
CAT_TO_ID = {name: i - 1 for i, name in enumerate(CLASS_NAMES)}


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def warp_affine(img: np.ndarray, trans: np.ndarray, out_w: int, out_h: int):
    """Bilinear affine warp (cv2 when available, NumPy fallback)."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.warpAffine(img, trans[:2].astype(np.float64),
                              (out_w, out_h), flags=cv2.INTER_LINEAR)
    # NumPy fallback: inverse-map each output pixel and bilinearly sample
    inv = np.linalg.inv(np.vstack([trans, [0, 0, 1]]))[:2]
    ys, xs = np.mgrid[0:out_h, 0:out_w].astype(np.float64)
    src_x = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    src_y = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    h, w = img.shape[:2]
    x0 = np.floor(src_x).astype(int)
    y0 = np.floor(src_y).astype(int)
    fx, fy = src_x - x0, src_y - y0
    out = np.zeros((out_h, out_w) + img.shape[2:], np.float32)
    for dy in (0, 1):
        for dx in (0, 1):
            xi = np.clip(x0 + dx, 0, w - 1)
            yi = np.clip(y0 + dy, 0, h - 1)
            wgt = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
            valid = ((x0 + dx >= 0) & (x0 + dx < w) &
                     (y0 + dy >= 0) & (y0 + dy < h))
            out += (img[yi, xi].astype(np.float32) *
                    (wgt * valid)[..., None if img.ndim == 3 else ()])
    # rounded, as cv2.warpAffine rounds its fixed-point result
    return np.rint(out).astype(img.dtype) if img.dtype == np.uint8 else out


def target_spec(cfg: Config, max_objs: int) -> TargetSpec:
    return TargetSpec(num_classes=len(CLASS_NAMES) - 1,
                      output_w=cfg.output_w, output_h=cfg.output_h,
                      max_objs=max_objs, mse_loss=cfg.mse_loss)


def make_sample(cfg: Config, img: np.ndarray, img_right: np.ndarray,
                calib: Sequence, anns: List[dict], train: bool,
                flipped: bool, aug_rng: np.random.RandomState,
                data_rng: np.random.RandomState, spec: TargetSpec
                ) -> Dict[str, np.ndarray]:
    """One training sample from a stereo pair (HxWx3 BGR uint8, already
    swapped and mirrored when `flipped`), its COCO-JSON calibration and
    annotations.  `aug_rng` draws the geometric and the color augmentation
    decisions, `data_rng` the color noise, in the reference's order."""
    height, width = img.shape[:2]
    c = np.array([width / 2.0, height / 2.0])
    if cfg.keep_res:
        s = np.array([cfg.input_w, cfg.input_h], np.float64)
    else:
        s = np.array([width, height], np.float64)

    rng = aug_rng
    if train and rng.random_sample() < cfg.aug_ddd:
        sf, cf = cfg.scale, cfg.shift
        s = s * np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
        c[0] += width * np.clip(rng.randn() * cf, -2 * cf, 2 * cf)
        c[1] += height * np.clip(rng.randn() * cf, -2 * cf, 2 * cf)

    trans_input = G.get_affine_transform(c, s, 0, [cfg.input_w, cfg.input_h])
    mean = np.asarray(cfg.mean, np.float32).reshape(1, 1, 3)
    std = np.asarray(cfg.std, np.float32).reshape(1, 1, 3)

    def prep(im):
        x = warp_affine(im, trans_input, cfg.input_w, cfg.input_h)
        do_aug = (train and not cfg.no_color_aug
                  and rng.random_sample() < cfg.aug_ddd)
        if cfg.uint8_images:
            # keep the warped uint8; the trainer normalises on the device
            if do_aug:
                xf = x.astype(np.float32) / 255.0
                G.color_aug(data_rng, xf, _EIG_VAL, _EIG_VEC)
                x = np.clip(xf * 255.0 + 0.5, 0, 255).astype(np.uint8)
            return x
        x = x.astype(np.float32) / 255.0
        if do_aug:
            G.color_aug(data_rng, x, _EIG_VAL, _EIG_VEC)
        return (x - mean) / std  # NHWC stays HWC

    inp = prep(img)
    inp_right = prep(img_right)

    trans_output = G.get_affine_transform(
        c, s, 0, [cfg.output_w, cfg.output_h])
    objects = read_objects(anns, calib, CLASS_NAMES[1:], img.shape)
    ret = generate_targets(objects, CAT_TO_ID, trans_output, spec,
                           flipped=flipped, img_w=width)
    ret["input"] = inp
    ret["input_right"] = inp_right

    cal = calib_from_list(calib)
    trans_inv = G.get_affine_transform(
        c, s, 0, [cfg.output_w, cfg.output_h], inv=True)
    ret.update({
        "fb": np.float32(cal.fb),
        "p2": cal.p2.astype(np.float32),
        "p3": cal.p3.astype(np.float32),
        "trans": trans_output.astype(np.float32),
        "trans_inv": trans_inv.astype(np.float32),
    })
    ret["meta"] = {"c": c, "s": s, "calib": calib, "flipped": flipped}
    return ret


class StereoKitti:
    """Indexable stereo-KITTI sample source."""

    num_classes = 3
    class_name = CLASS_NAMES
    max_objs = 50

    def __init__(self, cfg: Config, split: str,
                 coco: Optional[CocoIndex] = None):
        """`coco`: the split's index, when it is not read from
        `cfg.data_dir`'s annotation file."""
        self.cfg = cfg
        self.split = split
        data_dir = os.path.join(cfg.data_dir, "kitti")
        self.img_dir = os.path.join(data_dir, "training", "image_2")
        self.img_right_dir = os.path.join(data_dir, "training", "image_3")
        if coco is None:
            coco = CocoIndex(os.path.join(
                data_dir, "annotations_3d",
                f"kitti_{cfg.kitti_split}_{split}.json"))
        self.coco = coco
        self.images: List[int] = list(self.coco.img_ids)
        self.ori_samples = len(self.images)
        if cfg.flip_train and split == "train":
            self.images = self.images * 2
        self._data_rng = np.random.RandomState(123)
        self._aug_rng = np.random.RandomState(cfg.seed)
        self.spec = target_spec(cfg, self.max_objs)

    def __len__(self):
        return len(self.images)

    def _read_pair(self, file_name: str, flipped: bool):
        cv2 = _cv2()
        if cv2 is None:
            raise RuntimeError("StereoKitti reads PNG files with OpenCV "
                               "(cv2), which is not installed; feed the "
                               "trainer in-memory batches instead "
                               "(side_tpu_torch.data.synthetic.scene_batch)")
        lp = os.path.join(self.img_dir, file_name)
        rp = os.path.join(self.img_right_dir, file_name)
        img_l = cv2.imread(lp)
        img_r = cv2.imread(rp)
        if flipped:
            # swap roles and mirror: flipped right image becomes the "left"
            img_l, img_r = img_r[:, ::-1].copy(), img_l[:, ::-1].copy()
        return img_l, img_r, lp, rp

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        img_id = self.images[index]
        info = self.coco.images[img_id]
        flipped = self.cfg.flip_train and index > self.ori_samples - 1
        img, img_right, lp, rp = self._read_pair(info["file_name"], flipped)
        ret = make_sample(self.cfg, img, img_right, info["calib"],
                          self.coco.anns_by_img[img_id],
                          self.split == "train", flipped, self._aug_rng,
                          self._data_rng, self.spec)
        ret["meta"].update(img_id=img_id, image_path=lp, image_right=rp)
        return ret


def collate(samples: List[Dict[str, np.ndarray]],
            out: Optional[Dict[str, np.ndarray]] = None
            ) -> Dict[str, np.ndarray]:
    """Stack a list of samples into a batch; 'meta' stays a list.

    `out` is an optional buffer dict from a previous collate of the same
    batch shape: stacking writes into it in place instead of allocating
    fresh pages per batch.  Callers reusing buffers must be done with the
    previous batch contents (the Loader's ring discipline)."""
    if out is None:
        out = {}
    for k in samples[0]:
        if k == "meta":
            out[k] = [s[k] for s in samples]
            continue
        parts = [np.asarray(s[k]) for s in samples]
        buf = out.get(k)
        if (isinstance(buf, np.ndarray)
                and buf.shape == (len(parts),) + parts[0].shape
                and buf.dtype == parts[0].dtype):
            np.stack(parts, out=buf)
        else:
            out[k] = np.stack(parts)
    return out
