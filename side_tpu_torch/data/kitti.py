"""KITTI stereo domain model (copy of side_tpu/data/kitti.py).

Re-implements the label/calib geometry of the reference
(/root/reference/src/lib/utils/stereo_utils.py:13-328): projecting 3D boxes
into both cameras, recovering the 4 perspective keypoints, marking invisible
ones, and computing per-object visible borders via a column depth-line
occlusion sweep.  Also the COCO-format JSON reader/writer used by the data
pipeline (src/tools/convert_kitti_to_coco.py).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

KITTI_CATS = ["Pedestrian", "Car", "Cyclist", "Van", "Truck",
              "Person_sitting", "Tram", "Misc", "DontCare"]
CAT_IDS = {c: i + 1 for i, c in enumerate(KITTI_CATS)}
ID_TO_CAT = {i + 1: c for i, c in enumerate(KITTI_CATS)}


@dataclass
class Calib:
    """Full-frame calibration: P0..P3 3x4 projections (stereo_utils.py:33-43)."""
    p0: np.ndarray = None
    p1: np.ndarray = None
    p2: np.ndarray = None
    p3: np.ndarray = None

    @property
    def f(self) -> float:
        return float(self.p2[0, 0])

    @property
    def baseline(self) -> float:
        """Stereo baseline in metres (stereoDataset.py:277-278)."""
        return float((self.p2[0, 3] - self.p3[0, 3]) / self.f)

    @property
    def fb(self) -> float:
        return self.f * self.baseline


def calib_from_list(calib_list: Sequence) -> Calib:
    """Build a Calib from the per-image COCO-JSON calib (list of 4+ 3x4s)."""
    ps = [np.asarray(calib_list[i], np.float64).reshape(3, 4) for i in range(4)]
    return Calib(p0=ps[0], p1=ps[1], p2=ps[2], p3=ps[3])


def parse_calib(text: str) -> List[List[float]]:
    """Parse the text of a raw KITTI calib file into the list-of-rows
    format stored in the COCO JSON (convert_kitti_to_coco.py:43-55)."""
    out = []
    for i, line in enumerate(text.splitlines()):
        line = line.strip()
        if not line:
            continue
        vals = np.array(line.split(" ")[1:], np.float32)
        vals = vals.reshape(3, 3) if i == 4 else vals.reshape(3, 4)
        out.append(vals.tolist())
    return out


def read_calib_file(path: str) -> List[List[float]]:
    """`parse_calib` of a raw KITTI calib file."""
    with open(path) as f:
        return parse_calib(f.read())


@dataclass
class StereoBox:
    """2D box in one view plus its perspective keypoints (stereo_utils.py:13-18)."""
    box: np.ndarray = field(default_factory=lambda: np.zeros(4))
    keypoints: np.ndarray = field(default_factory=lambda: -np.ones(4))
    visible_left: float = 0.0
    visible_right: float = 0.0


@dataclass
class KittiObject:
    cls: str = ""
    truncate: float = 0.0
    occlusion: int = 0
    alpha: float = 0.0
    boxes: tuple = ()          # (left StereoBox, right StereoBox)
    pos: np.ndarray = None     # x, y, z in cam2 frame
    dim: np.ndarray = None     # h, w, l  (KITTI label order)
    orientation: float = 0.0


def box3d_corners(dim, pos, rot_y) -> np.ndarray:
    """The 8 corners of a 3D box in camera frame, (8, 3).

    Corner order matches stereo_utils.py:252-259: bottom ring first
    (x: -l/2,l/2,l/2,-l/2 ; z: w/2,w/2,-w/2,-w/2) then the top ring, so that
    corners 0..3 are the perspective-keypoint candidates.
    """
    h, w, l = float(dim[0]), float(dim[1]), float(dim[2])
    c, s = np.cos(rot_y), np.sin(rot_y)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)
    x = np.array([-l, l, l, -l, -l, l, l, -l]) / 2.0
    y = np.array([0, 0, 0, 0, -h, -h, -h, -h], np.float64)
    z = np.array([w, w, -w, -w, w, w, -w, -w]) / 2.0
    corners = R @ np.stack([x, y, z])
    return corners.T + np.asarray(pos, np.float64)


def project(P: np.ndarray, pts3: np.ndarray) -> np.ndarray:
    """Project (N, 3) camera-frame points through a 3x4 matrix -> (N, 2)."""
    pts3 = np.atleast_2d(pts3)
    homo = np.concatenate([pts3, np.ones((pts3.shape[0], 1))], axis=1)
    uvw = homo @ P.T
    return uvw[:, :2] / uvw[:, 2:3]


def _project_object(obj: KittiObject, calib: Calib, im_shape=None) -> None:
    """Fill obj.boxes with projected 2D boxes + raw keypoints for both views.

    Mirrors stereo_utils.py:248-305: corners behind the camera are skipped,
    the two extreme keypoints (left/right silhouette edges) and self-occluded
    middle corners are marked -1.
    """
    corners = box3d_corners(obj.dim, obj.pos, obj.orientation)
    boxes = []
    for P in (calib.p2, calib.p3):
        bx = StereoBox(box=np.array([1e4, 1e4, 0, 0], np.float64),
                       keypoints=-np.ones(4))
        front = corners[:, 2] >= 0
        pts = project(P, corners)
        for i in range(8):
            if corners[i, 2] < 0:
                continue
            u, v = pts[i]
            if i < 4:
                bx.keypoints[i] = u
            bx.box[0] = min(bx.box[0], u)
            bx.box[1] = min(bx.box[1], v)
            bx.box[2] = max(bx.box[2], u)
            bx.box[3] = max(bx.box[3], v)
        bx.box[0] = max(bx.box[0], 0.0)
        bx.box[1] = max(bx.box[1], 0.0)
        if im_shape is not None:
            bx.box[2] = min(bx.box[2], im_shape[1] - 1)
            bx.box[3] = min(bx.box[3], im_shape[0] - 1)

        # silhouette-edge keypoints are not "perspective" keypoints
        left_i = int(np.argmin(bx.keypoints))
        right_i = int(np.argmax(bx.keypoints))
        for i in range(4):
            if i in (left_i, right_i):
                bx.keypoints[i] = -1
            elif corners[i, 2] > obj.pos[2]:
                # behind the box center -> self-occluded
                bx.keypoints[i] = -1
        boxes.append(bx)
    obj.boxes = tuple(boxes)


def _paint_depth_line(depth_line: np.ndarray, lo: int, hi: int,
                      z: float) -> None:
    """One object's contribution to the depth line, vectorised over its
    column span (exact semantics of the per-column loop at
    stereo_utils.py:69-76: empty columns take z, nearer objects average)."""
    seg = depth_line[lo:hi]
    depth_line[lo:hi] = np.where(
        seg == 0.0, z, np.where(z < seg, (z + seg) / 2.0, seg))


def _visible_span(depth_line: np.ndarray, lo: int, hi: int, z: float):
    """Visible [left, right] border scan, vectorised (stereo_utils.py:90-118).

    The reference walks columns left->right keeping the LAST column where
    `left_visible and depth >= z` as the right border and the last where
    (elif) `right_visible and depth < z` as the left border.  Because the
    elif's guard `depth < z` already excludes the first branch, the two
    reduce to independent last-index scans.  Returns (vl, vr, lv, rv) with
    None for borders the reference loop would leave untouched."""
    seg = depth_line[lo:hi + 1]
    lv = bool(depth_line[lo] >= z)
    rv = bool(depth_line[hi] >= z)
    vl = vr = None
    if lv:
        nz = np.flatnonzero(seg >= z)
        if nz.size:
            vr = lo + int(nz[-1])
    if rv:
        nz = np.flatnonzero(seg < z)
        if nz.size:
            vl = lo + int(nz[-1])
    return vl, vr, lv, rv


def _occlusion_sweep(objects: List[KittiObject], view: int) -> None:
    """Per-column depth-line occlusion reasoning (stereo_utils.py:64-120).

    Builds a 1260-column line of the nearest (averaged) object depth, then
    derives each object's visible [left, right] border and invalidates
    keypoints of fully occluded objects.  Vectorised over columns (the
    reference's per-column Python loops held the data-loader GIL; parity
    with the loop form is asserted in tests/test_kitti_data.py).
    """
    depth_line = np.zeros(1260, np.float64)
    for obj in objects:
        b = obj.boxes[view].box
        _paint_depth_line(depth_line, int(b[0]), int(b[2]) + 1, obj.pos[2])

    for obj in objects:
        bx = obj.boxes[view]
        bx.visible_left = bx.box[0]
        bx.visible_right = bx.box[2]
        vl, vr, lv, rv = _visible_span(depth_line, int(bx.box[0]),
                                       int(bx.box[2]), obj.pos[2])
        if not lv and not rv:
            bx.visible_right = bx.box[0]
            bx.keypoints[:] = -1
        if vr is not None:
            bx.visible_right = vr
        if vl is not None:
            bx.visible_left = vl


def read_objects(anns: List[dict], calib_list: Sequence, used_cls: Sequence[str],
                 im_shape=None) -> List[KittiObject]:
    """COCO-style annotations -> fully geometric KittiObjects
    (stereo_utils.py:211-328), filtered to truncation < 1 and occlusion < 3."""
    calib = calib_from_list(calib_list)
    objects = []
    for ann in anns:
        cat = ID_TO_CAT[ann["category_id"]]
        if cat not in used_cls:
            continue
        obj = KittiObject(
            cls=cat,
            truncate=float(ann["truncated"]),
            occlusion=int(ann["occluded"]),
            alpha=float(ann["alpha"]),
            dim=np.asarray(ann["dim"], np.float64),
            pos=np.asarray(ann["location"], np.float64),
            orientation=float(ann["rotation_y"]),
        )
        _project_object(obj, calib, im_shape)
        objects.append(obj)

    _occlusion_sweep(objects, 0)
    _occlusion_sweep(objects, 1)
    return [o for o in objects if o.truncate < 1.0 and o.occlusion < 3]


def infer_boundary(im_shape, boxes_left: np.ndarray) -> np.ndarray:
    """Test-time occlusion border inference from 2D boxes only
    (stereo_utils.py:461-500): pseudo-depth 1050/box_height drives the same
    depth-line sweep."""
    n = boxes_left.shape[0]
    left_right = np.zeros((n, 2), np.float32)
    depth_line = np.zeros(1280, np.float64)
    pseudo_depth = 1050.0 / boxes_left[:, 3]
    for i in range(n):
        _paint_depth_line(depth_line, int(boxes_left[i, 0]),
                          int(boxes_left[i, 2]) + 1, pseudo_depth[i])

    for i in range(n):
        left_right[i, 0] = boxes_left[i, 0]
        left_right[i, 1] = boxes_left[i, 2]
        vl, vr, lv, rv = _visible_span(depth_line, int(boxes_left[i, 0]),
                                       int(boxes_left[i, 2]),
                                       pseudo_depth[i])
        if not lv and not rv:
            left_right[i, 1] = boxes_left[i, 0]
        if vr is not None:
            left_right[i, 1] = vr
        if vl is not None:
            left_right[i, 0] = vl
    return left_right


# ------------------------------------------------------------- COCO-ish JSON
def label_annotation(txt: str, image_id: int, ann_id: int) -> Optional[dict]:
    """One KITTI label row -> its COCO-style annotation (None for a row
    with fewer than 15 fields)."""
    t = txt.strip().split(" ")
    if len(t) < 15:
        return None
    bbox = [float(t[4]), float(t[5]), float(t[6]), float(t[7])]
    return {
        "image_id": image_id,
        "id": ann_id,
        "category_id": CAT_IDS[t[0]],
        "dim": [float(t[8]), float(t[9]), float(t[10])],
        "bbox": [bbox[0], bbox[1], bbox[2] - bbox[0], bbox[3] - bbox[1]],
        "depth": float(t[13]),
        "alpha": float(t[3]),
        "truncated": float(t[1]),
        "occluded": int(float(t[2])),
        "location": [float(t[11]), float(t[12]), float(t[13])],
        "rotation_y": float(t[14]),
    }


def convert_split(data_dir: str, split_name: str, split: str,
                  out_path: Optional[str] = None) -> dict:
    """Raw KITTI -> COCO-format JSON with embedded calib
    (convert_kitti_to_coco.py:72-157)."""
    image_set = os.path.join(data_dir, f"ImageSets_{split_name}", f"{split}.txt")
    ann_dir = os.path.join(data_dir, "training", "label_2")
    calib_dir = os.path.join(data_dir, "training", "calib")

    cat_info = [{"name": c, "id": i + 1} for i, c in enumerate(KITTI_CATS)]
    ret = {"images": [], "annotations": [], "categories": cat_info}

    with open(image_set) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    for line in lines:
        image_id = int(line)
        calib = read_calib_file(os.path.join(calib_dir, f"{line}.txt"))
        ret["images"].append({"file_name": f"{line}.png",
                              "id": image_id, "calib": calib})
        with open(os.path.join(ann_dir, f"{line}.txt")) as f:
            for txt in f:
                ann = label_annotation(txt, image_id,
                                       len(ret["annotations"]) + 1)
                if ann is not None:
                    ret["annotations"].append(ann)
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(ret, f)
    return ret


class CocoIndex:
    """Minimal COCO-JSON index (replaces pycocotools for our fixed schema)."""

    def __init__(self, path_or_dict):
        if isinstance(path_or_dict, str):
            with open(path_or_dict) as f:
                d = json.load(f)
        else:
            d = path_or_dict
        self.images = {im["id"]: im for im in d["images"]}
        self.img_ids = [im["id"] for im in d["images"]]
        self.anns_by_img: Dict[int, List[dict]] = {i: [] for i in self.img_ids}
        for ann in d["annotations"]:
            if ann["image_id"] in self.anns_by_img:
                self.anns_by_img[ann["image_id"]].append(ann)

    def __len__(self):
        return len(self.img_ids)
