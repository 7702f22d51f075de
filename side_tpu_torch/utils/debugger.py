"""Visual debugging overlays (port of side_tpu/utils/debugger.py): heatmap
blends, 2D boxes with class labels, decoded keypoint and occlusion-border
marks, calib-projected 3D boxes and bird's-eye-view renders, composited per
named canvas and saved to disk.

Every canvas is drawn with OpenCV, call for call as the JAX package draws
it, so both give the same pixels.  Where OpenCV is missing the JAX copy
silently draws nothing; here `Debugger()` raises instead, naming cv2, so an
overlay run never writes empty or missing images without saying so.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..data.kitti import box3d_corners, project

_COLORS = np.array([
    [66, 135, 245], [66, 245, 141], [245, 102, 66], [245, 233, 66],
    [188, 66, 245], [66, 236, 245], [245, 66, 158], [144, 245, 66],
], np.uint8)

# 3D box edge list over the corner order of box3d_corners (bottom ring 0-3,
# top ring 4-7)
_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
          (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]


def require_cv2():
    """OpenCV, or a RuntimeError that names it."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "the debug overlays are drawn with OpenCV (cv2), which is not "
            "installed; run without --debug or where cv2 is present") from e
    return cv2


def _color(i: int):
    return tuple(int(x) for x in _COLORS[i % len(_COLORS)])


def _bev_rect(r):
    """The BEV footprint corners (4, 2) of a result row [alpha, box4, h, w,
    l, x, y, z, ry, score] in world (x, z)."""
    w, l = r[6], r[7]
    x, z, ry = r[8], r[10], r[11]
    c, s = np.cos(ry), np.sin(ry)
    rect = np.array([[-l / 2, -w / 2], [l / 2, -w / 2],
                     [l / 2, w / 2], [-l / 2, w / 2]])
    return rect @ np.array([[c, -s], [s, c]]).T + np.array([x, z])


class Debugger:
    def __init__(self, class_names=None, theme: str = "white",
                 down_ratio: int = 4):
        self.cv2 = require_cv2()
        self.imgs: Dict[str, np.ndarray] = {}
        self.class_names = class_names or ["Car", "Van", "Truck"]
        self.theme = theme
        self.down_ratio = down_ratio
        self.world_size = 64
        self.out_size = 384

    # ----------------------------------------------------------- canvases
    def add_img(self, img: np.ndarray, img_id: str = "default"):
        self.imgs[img_id] = img.copy()

    def gen_colormap(self, heatmap: np.ndarray) -> np.ndarray:
        """Per-class colored heatmap, upsampled to input res.  Accepts
        (C, H, W) or (H, W, C)."""
        if heatmap.ndim == 3 and heatmap.shape[0] <= 8:
            heatmap = heatmap.transpose(1, 2, 0)
        h, w, c = heatmap.shape
        out = np.zeros((h * self.down_ratio, w * self.down_ratio, 3),
                       np.float32)
        for i in range(c):
            hm = self.cv2.resize(heatmap[:, :, i], (w * self.down_ratio,
                                                    h * self.down_ratio))
            color = _COLORS[i % len(_COLORS)].astype(np.float32)
            out = np.maximum(out, hm[:, :, None] * color[None, None])
        return out.astype(np.uint8)

    def add_blend_img(self, back: np.ndarray, fore: np.ndarray,
                      img_id: str = "blend", trans: float = 0.7):
        if fore.shape[:2] != back.shape[:2]:
            fore = self.cv2.resize(fore, (back.shape[1], back.shape[0]))
        blend = back.astype(np.float32) * (1 - trans) + \
            fore.astype(np.float32) * trans
        self.imgs[img_id] = np.clip(blend, 0, 255).astype(np.uint8)

    # ----------------------------------------------------------- overlays
    def add_ct_detection(self, img, dets, show_box=True, center_thresh=0.3,
                         img_id="det"):
        """dets rows: [cx, cy, w, h, score, cls] at input resolution."""
        cv2 = self.cv2
        if img_id not in self.imgs:
            self.imgs[img_id] = img.copy()
        canvas = self.imgs[img_id]
        for d in np.asarray(dets):
            if d[4] < center_thresh:
                continue
            cls = int(d[5])
            color = _color(cls)
            cv2.circle(canvas, (int(d[0]), int(d[1])), 3, color, -1)
            if show_box:
                x1, y1 = int(d[0] - d[2] / 2), int(d[1] - d[3] / 2)
                x2, y2 = int(d[0] + d[2] / 2), int(d[1] + d[3] / 2)
                cv2.rectangle(canvas, (x1, y1), (x2, y2), color, 2)
                cv2.putText(canvas,
                            f"{self.class_names[cls]} {d[4]:.2f}",
                            (x1, max(y1 - 3, 0)), cv2.FONT_HERSHEY_SIMPLEX,
                            0.4, color, 1, cv2.LINE_AA)

    def add_kept(self, kpts, img_id="det", color=(0, 0, 255)):
        """kpts rows: [border_l_u, border_r_u, kpt_u, kpt_type, v]."""
        cv2 = self.cv2
        if img_id not in self.imgs:
            return
        canvas = self.imgs[img_id]
        for k in np.asarray(kpts):
            v = int(k[4]) if len(k) > 4 else canvas.shape[0] // 2
            cv2.drawMarker(canvas, (int(k[2]), v), color,
                           cv2.MARKER_TILTED_CROSS, 8, 2)
            for u in (k[0], k[1]):
                cv2.line(canvas, (int(u), max(v - 12, 0)), (int(u), v),
                         (255, 200, 0), 1)

    def add_3d_detection(self, image_or_path, results, calib_p2,
                         center_thresh=0.3, img_id="add_pred"):
        """results: {cls: rows [alpha, box4, h, w, l, x, y, z, ry, score]}."""
        cv2 = self.cv2
        img = cv2.imread(image_or_path) if isinstance(image_or_path, str) \
            else image_or_path.copy()
        p2 = np.asarray(calib_p2, np.float64).reshape(3, 4)
        for cls, rows in results.items():
            color = _color(cls - 1)
            for r in np.asarray(rows):
                if r[-1] < center_thresh:
                    continue
                dim, loc, ry = r[5:8], r[8:11], r[11]
                corners = box3d_corners(dim, loc, ry)
                if (corners[:, 2] < 0.1).any():
                    continue
                pts = project(p2, corners).astype(np.int32)
                for a, b in _EDGES:
                    cv2.line(img, tuple(pts[a]), tuple(pts[b]), color, 1,
                             cv2.LINE_AA)
        self.imgs[img_id] = img

    def _bev_canvas(self):
        bg = 255 if self.theme == "white" else 0
        return np.full((self.out_size, self.out_size, 3), bg, np.uint8)

    def _to_bev(self, pts):
        # world x in [-ws/2, ws/2], z in [0, ws] -> canvas
        ws = self.world_size
        u = (pts[:, 0] + ws / 2) / ws * self.out_size
        v = self.out_size - pts[:, 1] / ws * self.out_size
        return np.stack([u, v], axis=1).astype(np.int32)

    def add_bird_view(self, results, center_thresh=0.3, img_id="bird"):
        cv2 = self.cv2
        canvas = self._bev_canvas()
        for cls, rows in results.items():
            color = _color(cls - 1)
            for r in np.asarray(rows):
                if r[-1] < center_thresh:
                    continue
                pix = self._to_bev(_bev_rect(r))
                cv2.polylines(canvas, [pix.reshape(-1, 1, 2)], True,
                              color, 2, cv2.LINE_AA)
        self.imgs[img_id] = canvas

    def add_bird_views(self, dets, gts, center_thresh=0.3, img_id="bird"):
        """Predictions and ground truth on one BEV canvas."""
        cv2 = self.cv2
        self.add_bird_view(dets, center_thresh, img_id)
        canvas = self.imgs[img_id]
        for rows in gts.values():
            for r in np.asarray(rows):
                cv2.polylines(canvas,
                              [self._to_bev(_bev_rect(r)).reshape(-1, 1, 2)],
                              True, (128, 128, 128), 1, cv2.LINE_AA)

    # --------------------------------------------------------------- output
    def save_all_imgs(self, path: str, prefix: str = ""):
        os.makedirs(path, exist_ok=True)
        for name, img in self.imgs.items():
            self.cv2.imwrite(os.path.join(path, f"{prefix}{name}.png"), img)

    def show_all_imgs(self, pause: bool = False):  # pragma: no cover
        for name, img in self.imgs.items():
            self.cv2.imshow(name, img)
        self.cv2.waitKey(0 if pause else 1)
