# Frozen copy of side_tpu_torch/data/synthetic.py at commit ca59ff401c87, kept with the benchmark
# so that later changes to the program do not move the yardstick.
"""Synthetic mini-KITTI scenes (copy of side_tpu/data/synthetic.py, plus
`scene_batch`, which feeds the trainer rendered scenes held in memory,
`val_scenes`, which feeds the validation pass the same way, and the fixed
fixture of `build_fixture` held in memory: `fixture_scenes`, read as a
training split by `FixtureKitti` and as validation frames by
`fixture_frames`).

The reference ships no fixtures (SURVEY.md §4); this generator renders a few
stereo pairs of textured 3D boxes with a real pinhole stereo rig so the full
pipeline — label projection, target generation, training, decoding, the 3D
solver, and the C++ evaluator — can be exercised without the real dataset.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import Config
from .dataset import StereoKitti, collate, make_sample, target_spec
from .kitti import (KITTI_CATS, CocoIndex, box3d_corners, convert_split,
                    label_annotation, parse_calib, project)

F = 721.5377
CX, CY = 609.5593, 172.854
BASELINE = 0.54
IMG_H, IMG_W = 375, 1242


def default_calib() -> Tuple[np.ndarray, np.ndarray]:
    p2 = np.array([[F, 0, CX, F * 0.06],
                   [0, F, CY, 0.0],
                   [0, 0, 1, 0.0]], np.float64)
    p3 = p2.copy()
    p3[0, 3] = p2[0, 3] - F * BASELINE
    return p2, p3


def calib_lines(p2, p3) -> str:
    def row(name, p):
        return name + ": " + " ".join(f"{v:.12e}" for v in p.reshape(-1))
    p0 = p2.copy(); p0[0, 3] = 0.0
    p1 = p3.copy()
    r0 = np.eye(3)
    tr = np.eye(3, 4)
    return "\n".join([
        row("P0", p0), row("P1", p1), row("P2", p2), row("P3", p3),
        row("R0_rect", r0), row("Tr_velo_to_cam", tr), row("Tr_imu_to_velo", tr),
    ]) + "\n"


def _render(objs: List[dict], P: np.ndarray, rng: np.random.RandomState
            ) -> np.ndarray:
    """Rasterise textured cuboids (far to near) over a gradient background."""
    img = np.zeros((IMG_H, IMG_W, 3), np.uint8)
    ramp = np.linspace(60, 160, IMG_H, dtype=np.float32)[:, None]
    img[:] = np.stack([ramp, ramp * 0.9, ramp * 0.8], axis=-1
                      ).astype(np.uint8).reshape(IMG_H, 1, 3)
    # deterministic speckle texture so photometric alignment has gradients
    noise = (rng.rand(IMG_H, IMG_W, 1) * 40).astype(np.uint8)
    img = np.clip(img.astype(np.int32) + noise, 0, 255).astype(np.uint8)

    for obj in sorted(objs, key=lambda o: -o["location"][2]):
        corners = box3d_corners(obj["dim"], obj["location"], obj["rotation_y"])
        pts = project(P, corners)
        x0 = int(np.clip(pts[:, 0].min(), 0, IMG_W - 1))
        x1 = int(np.clip(pts[:, 0].max(), 0, IMG_W - 1))
        y0 = int(np.clip(pts[:, 1].min(), 0, IMG_H - 1))
        y1 = int(np.clip(pts[:, 1].max(), 0, IMG_H - 1))
        if x1 <= x0 or y1 <= y0:
            continue
        color = np.array(obj["color"], np.int32)
        patch = img[y0:y1, x0:x1].astype(np.int32)
        yy = np.linspace(0, 1, y1 - y0)[:, None, None]
        xx = np.linspace(0, 1, x1 - x0)[None, :, None]
        tex = color * (0.6 + 0.4 * np.sin(8 * np.pi * xx) * np.cos(6 * np.pi * yy))
        img[y0:y1, x0:x1] = np.clip(0.2 * patch + 0.8 * tex, 0, 255).astype(np.uint8)
    return img


# per-class (h, w, l) dimension priors: base + rand()*spread, KITTI-typical
# (stereoDataset.py:21 trains Car/Van/Truck; dim_exp is the Car prior)
_DIM_PRIORS = {
    "Car": ([1.5, 1.6, 3.8], [0.3, 0.2, 0.6]),
    "Van": ([1.9, 1.8, 4.7], [0.3, 0.2, 0.7]),
    "Truck": ([2.9, 2.4, 7.5], [0.5, 0.3, 3.0]),
}


def _obj(rng, x, z, cls="Car", ry=None):
    ry = rng.uniform(-np.pi, np.pi) if ry is None else ry
    base, spread = _DIM_PRIORS[cls]
    dim = [b + rng.rand() * s for b, s in zip(base, spread)]  # h, w, l
    color = rng.randint(60, 255, size=3).tolist()
    return {"type": cls, "dim": dim, "location": [x, 1.65, z],
            "rotation_y": ry, "color": color}


def _car(rng, x, z, ry=None):
    return _obj(rng, x, z, "Car", ry)


def make_scene(rng: np.random.RandomState, n_cars: int,
               recipe: str = "easy", classes: Tuple[str, ...] = ("Car",)
               ) -> List[dict]:
    """Scene recipes:
      easy      — fully visible, untruncated cars (round-2 behaviour)
      occluded  — an occlusion pair (a near car partially covering a far
                  one) plus optional extras, to exercise the depth-line
                  occlusion sweep (stereo_utils.py:64-120 semantics) and
                  the evaluator's max-occlusion difficulty filters
      truncated — one car hanging off the left or right image edge
                  (truncation branches of the dataset and box solver)

    `classes` is the draw pool for the FILLER objects (the recipe-specific
    pair/truncated objects stay Car so their calibrated geometry holds);
    ("Car", "Van", "Truck") gives the multi-class fixture (the reference
    trains 3 classes, stereoDataset.py:21).
    """
    objs = []
    if recipe == "occluded":
        z_far = rng.uniform(18, 32)
        x_far = rng.uniform(-0.2, 0.2) * z_far * 0.5
        far = _car(rng, x_far, z_far)
        # near car shifted ~half a car width so it covers part of the far
        # one but leaves its center and one edge visible
        z_near = z_far * rng.uniform(0.45, 0.6)
        u_far = x_far / z_far
        near = _car(rng, (u_far + rng.choice([-1, 1]) *
                          rng.uniform(0.06, 0.1)) * z_near, z_near)
        objs += [far, near]
        n_cars = max(0, n_cars - 2)
    elif recipe == "truncated":
        z = rng.uniform(7, 14)
        side = rng.choice([-1, 1])
        # center inside the image but a box edge crossing the border:
        # ~15-45% of the box hangs outside (Moderate/Hard truncation band)
        u_edge = (IMG_W - 1 - CX) / F if side > 0 else -CX / F
        x = (u_edge - side * rng.uniform(0.02, 0.10)) * z
        objs.append(_car(rng, x, z, ry=rng.uniform(-0.4, 0.4)))
        n_cars = max(0, n_cars - 1)
    for j in range(n_cars):
        cls = classes[j % len(classes)] if len(classes) > 1 else classes[0]
        # trucks are ~2x car size: push them further out so they stay
        # fully inside the image (recipe "easy" must not truncate)
        z = rng.uniform(16, 40) if cls == "Truck" else rng.uniform(8, 40)
        x = rng.uniform(-0.35, 0.35) * z * 0.5
        objs.append(_obj(rng, x, z, cls))
    return objs


def _bbox2d(o, P):
    corners = box3d_corners(o["dim"], o["location"], o["rotation_y"])
    pts = project(P, corners)
    return np.array([pts[:, 0].min(), pts[:, 1].min(),
                     pts[:, 0].max(), pts[:, 1].max()])


def label_lines(objs, p2) -> str:
    """KITTI label rows with REAL truncation/occlusion values: truncation =
    fraction of the 2D box outside the image; occlusion level from the
    fraction covered by boxes of strictly nearer objects (0/1/2 at
    0.2/0.5, mirroring the evaluator's difficulty filters)."""
    full_boxes = [_bbox2d(o, p2) for o in objs]
    lines = []
    for i, o in enumerate(objs):
        fb = full_boxes[i]
        bbox = [max(fb[0], 0), max(fb[1], 0),
                min(fb[2], IMG_W - 1), min(fb[3], IMG_H - 1)]
        full_area = max((fb[2] - fb[0]) * (fb[3] - fb[1]), 1e-6)
        vis_area = max(bbox[2] - bbox[0], 0) * max(bbox[3] - bbox[1], 0)
        trunc = float(np.clip(1.0 - vis_area / full_area, 0.0, 1.0))

        covered = 0.0
        for j, other in enumerate(objs):
            if other["location"][2] >= o["location"][2] - 0.5 or j == i:
                continue
            ob = full_boxes[j]
            ix = max(0.0, min(bbox[2], ob[2]) - max(bbox[0], ob[0]))
            iy = max(0.0, min(bbox[3], ob[3]) - max(bbox[1], ob[1]))
            covered = max(covered, ix * iy / max(vis_area, 1e-6))
        occ = 0 if covered < 0.2 else (1 if covered < 0.5 else 2)

        x, y, z = o["location"]
        alpha = o["rotation_y"] - np.arctan2(x, z)
        if alpha > np.pi:
            alpha -= 2 * np.pi
        if alpha < -np.pi:
            alpha += 2 * np.pi
        lines.append(
            f"{o['type']} {trunc:.2f} {occ} {alpha:.2f} "
            f"{bbox[0]:.2f} {bbox[1]:.2f} {bbox[2]:.2f} {bbox[3]:.2f} "
            f"{o['dim'][0]:.2f} {o['dim'][1]:.2f} {o['dim'][2]:.2f} "
            f"{x:.2f} {y:.2f} {z:.2f} {o['rotation_y']:.2f}")
    return "\n".join(lines) + "\n"


def scene_annotations(objs: List[dict], p2: np.ndarray,
                      image_id: int = 0) -> List[dict]:
    """The COCO-style annotations `convert_split` would read back from the
    scene's KITTI label file."""
    rows = label_lines(objs, p2).splitlines()
    anns = [label_annotation(r, image_id, i + 1) for i, r in enumerate(rows)]
    return [a for a in anns if a is not None]


def scene_batch(cfg: Config, rng: np.random.RandomState, batch_size: int,
                max_objs: int) -> Dict[str, np.ndarray]:
    """A collated training batch of `batch_size` rendered scenes, built by
    the same target and pre-process code as StereoKitti (`make_sample`),
    without image files: for machines without OpenCV, and for runs that
    must not touch the disk.  All randomness comes from `rng`."""
    p2, p3 = default_calib()
    calib = scene_calib()
    spec = target_spec(cfg, max_objs)
    aug_rng = np.random.RandomState(rng.randint(2 ** 31))
    data_rng = np.random.RandomState(rng.randint(2 ** 31))
    samples = []
    for i in range(batch_size):
        objs = make_scene(rng, n_cars=rng.randint(1, 4),
                          classes=("Car", "Van", "Truck"))
        tex_seed = rng.randint(2 ** 31)
        img_l = _render(objs, p2, np.random.RandomState(tex_seed))
        img_r = _render(objs, p3, np.random.RandomState(tex_seed))
        sample = make_sample(cfg, img_l, img_r, calib,
                             scene_annotations(objs, p2, i), True, False,
                             aug_rng, data_rng, spec)
        sample.pop("meta")
        samples.append(sample)
    return collate(samples)


def scene_calib() -> list:
    """The COCO-JSON calibration [P0, P1, P2, P3] of `default_calib`."""
    p2, p3 = default_calib()
    p0 = p2.copy()
    p0[0, 3] = 0.0
    return [p0.tolist(), p3.tolist(), p2.tolist(), p3.tolist()]


def val_scenes(n: int, seed: int = 0, label_dir: Optional[str] = None
               ) -> List[tuple]:
    """`n` rendered validation frames held in memory, as the validation pass
    reads them: (image id, (left, right) uint8 arrays, calib).  With
    `label_dir`, each scene's KITTI ground truth is written to
    `label_dir/%06d.txt` (text only, no OpenCV).  Recipes cycle as in
    `build_fixture`'s later scenes: easy, occluded and truncated."""
    rng = np.random.RandomState(seed)
    p2, p3 = default_calib()
    calib = scene_calib()
    if label_dir is not None:
        os.makedirs(label_dir, exist_ok=True)
    frames = []
    for i in range(n):
        recipe = ("occluded" if i % 3 == 2 else
                  "truncated" if i % 4 == 3 else "easy")
        objs = make_scene(rng, n_cars=rng.randint(1, 4), recipe=recipe,
                          classes=("Car", "Van", "Truck"))
        tex_seed = rng.randint(2 ** 31)
        img_l = _render(objs, p2, np.random.RandomState(tex_seed))
        img_r = _render(objs, p3, np.random.RandomState(tex_seed))
        if label_dir is not None:
            with open(os.path.join(label_dir, f"{i:06d}.txt"), "w") as fh:
                fh.write(label_lines(objs, p2))
        frames.append((i, (img_l, img_r), calib))
    return frames


def fixture_scenes(n_train: int = 4, n_val: int = 2, seed: int = 0,
                   classes: Tuple[str, ...] = ("Car", "Van", "Truck")
                   ) -> List[dict]:
    """The scenes `build_fixture` writes, held in memory, in its order and
    from its draws: per scene its `name` ("%06d"), `image_id` (the id
    `convert_split` gives it), `left` / `right` (the BGR arrays the PNGs
    hold: PNG is lossless), `label` (the label file's text) and `calib`
    (the calib file's text).

    Scenes 0-1 stay Car-only easy (the 2-scene overfit calibration depends
    on them); from scene 2 on, filler objects cycle through `classes`
    (rotated per scene) so the per-class decode bucketing, merge threshold
    and the multi-class train->detect->eval loop are exercised
    (stereoDataset.py:21 trains Car/Van/Truck)."""
    rng = np.random.RandomState(seed)
    p2, p3 = default_calib()
    scenes = []
    for i in range(n_train + n_val):
        # scenes 0-1 stay easy (the overfit acceptance test's calibration
        # depends on them); beyond that, mix in occlusion pairs and
        # truncated cars so the evaluator's difficulty filters and the
        # occlusion/truncation branches get end-to-end coverage
        if i < 2:
            recipe = "easy"
        elif i % 3 == 2:
            recipe = "occluded"
        elif i % 4 == 3:
            recipe = "truncated"
        else:
            recipe = "easy"
        scene_classes = (("Car",) if i < 2 else
                         tuple(classes[(i + j) % len(classes)]
                               for j in range(len(classes))))
        objs = make_scene(rng, n_cars=rng.randint(1, 4), recipe=recipe,
                          classes=scene_classes)
        name = f"{i:06d}"
        scenes.append({
            "name": name, "image_id": int(name),
            "left": _render(objs, p2, np.random.RandomState(1000 + i)),
            "right": _render(objs, p3, np.random.RandomState(1000 + i)),
            "label": label_lines(objs, p2), "calib": calib_lines(p2, p3)})
    return scenes


def fixture_coco(scenes: List[dict]) -> dict:
    """The COCO-style split `convert_split` writes for these scenes, built
    from their label and calib texts: the same ids, calibration (parsed
    through float32) and annotations."""
    ret = {"images": [], "annotations": [],
           "categories": [{"name": c, "id": i + 1}
                          for i, c in enumerate(KITTI_CATS)]}
    for sc in scenes:
        ret["images"].append({"file_name": sc["name"] + ".png",
                              "id": sc["image_id"],
                              "calib": parse_calib(sc["calib"])})
        for txt in sc["label"].splitlines(keepends=True):
            ann = label_annotation(txt, sc["image_id"],
                                   len(ret["annotations"]) + 1)
            if ann is not None:
                ret["annotations"].append(ann)
    return ret


class FixtureKitti(StereoKitti):
    """`StereoKitti` over fixture scenes held in memory: the same samples
    (`make_sample`, the same random streams, `meta` with `img_id`) without
    image files or OpenCV.  `fixture_scenes(n, ...)[:n]` with `split`
    "train" is what `StereoKitti(cfg, "train")` reads from
    `build_fixture(root, n, ...)`'s tree."""

    def __init__(self, cfg: Config, scenes: List[dict],
                 split: str = "train"):
        self._pairs = {sc["name"] + ".png": (sc["left"], sc["right"])
                       for sc in scenes}
        super().__init__(cfg, split, coco=CocoIndex(fixture_coco(scenes)))

    def _read_pair(self, file_name: str, flipped: bool):
        img_l, img_r = self._pairs[file_name]
        if flipped:
            img_l, img_r = img_r[:, ::-1].copy(), img_l[:, ::-1].copy()
        return img_l, img_r, file_name, file_name


def fixture_frames(scenes: List[dict], label_dir: Optional[str] = None
                   ) -> List[tuple]:
    """The scenes as the validation pass reads them: (image id, (left,
    right), calib), with the calibration `StereoKitti` gives the detector.
    With `label_dir`, each scene's label file is written to
    `label_dir/<name>.txt`, byte for byte the fixture's."""
    if label_dir is not None:
        os.makedirs(label_dir, exist_ok=True)
    frames = []
    for sc in scenes:
        if label_dir is not None:
            with open(os.path.join(label_dir, sc["name"] + ".txt"),
                      "w") as fh:
                fh.write(sc["label"])
        frames.append((sc["image_id"], (sc["left"], sc["right"]),
                       parse_calib(sc["calib"])))
    return frames


def build_fixture(root: str, n_train: int = 4, n_val: int = 2,
                  seed: int = 0, split_name: str = "3dop",
                  classes: Tuple[str, ...] = ("Car", "Van", "Truck")) -> str:
    """Write a synthetic KITTI tree of `fixture_scenes` under `root`/kitti
    (the PNGs only where OpenCV is installed); returns the data dir."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    base = os.path.join(root, "kitti")
    for d in ["training/image_2", "training/image_3", "training/label_2",
              "training/calib", f"ImageSets_{split_name}", "annotations_3d"]:
        os.makedirs(os.path.join(base, d), exist_ok=True)

    ids = []
    for sc in fixture_scenes(n_train, n_val, seed, classes):
        name = sc["name"]
        ids.append(name)
        if cv2 is not None:
            cv2.imwrite(os.path.join(base, "training/image_2", name + ".png"),
                        sc["left"])
            cv2.imwrite(os.path.join(base, "training/image_3", name + ".png"),
                        sc["right"])
        with open(os.path.join(base, "training/label_2", name + ".txt"), "w") as f:
            f.write(sc["label"])
        with open(os.path.join(base, "training/calib", name + ".txt"), "w") as f:
            f.write(sc["calib"])

    with open(os.path.join(base, f"ImageSets_{split_name}", "train.txt"), "w") as f:
        f.write("\n".join(ids[:n_train]) + "\n")
    with open(os.path.join(base, f"ImageSets_{split_name}", "val.txt"), "w") as f:
        f.write("\n".join(ids[n_train:]) + "\n")

    for split in ("train", "val"):
        convert_split(base, split_name, split,
                      os.path.join(base, "annotations_3d",
                                   f"kitti_{split_name}_{split}.json"))
    return root
