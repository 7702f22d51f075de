"""Host-side image warp of the pre-process (copy of `warp_affine` of
side_tpu/data/dataset.py).  OpenCV is optional: it is imported at first use,
and a NumPy bilinear warp stands in where it is not installed."""

from __future__ import annotations

import numpy as np


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
    return out.astype(img.dtype) if img.dtype == np.uint8 else out
