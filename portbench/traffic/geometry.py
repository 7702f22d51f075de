# Frozen copy of side_tpu_torch/data/geometry.py at commit ca59ff401c87, kept with the benchmark
# so that later changes to the program do not move the yardstick.
"""Host-side 2D geometry: center/scale affine warps and gaussian targets
(copy of side_tpu/data/geometry.py; OpenCV is imported at first use).

Functionally equivalent to the CenterNet toolkit the reference relies on
(/root/reference/src/lib/utils/image.py:19-196), built directly on NumPy:
the affine is derived in closed form instead of via cv2.getAffineTransform,
and all helpers are vectorised so the target generator can run per-image
without Python-level inner loops.
"""

from __future__ import annotations

import numpy as np


# --------------------------------------------------------------------- affine
def get_affine_transform(center, scale, rot, output_size, shift=(0.0, 0.0),
                         inv=False) -> np.ndarray:
    """2x3 affine mapping a (center, scale) crop box to `output_size`.

    Same geometry as image.py:27-60: the source box is an axis-aligned
    square-ish region of width scale[0] centered at `center` (optionally
    rotated by `rot` degrees), the destination is the output canvas.
    Returns the 2x3 matrix; `inv=True` returns the inverse mapping.
    """
    center = np.asarray(center, np.float64)
    if not isinstance(scale, (np.ndarray, list, tuple)):
        scale = np.array([scale, scale], np.float64)
    scale = np.asarray(scale, np.float64)
    shift = np.asarray(shift, np.float64)

    src_w = float(scale[0])
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    rot_rad = np.pi * rot / 180.0
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    # direction from center to a point half-a-width "up", rotated
    src_dir = np.array([0.0 * cs - (-0.5 * src_w) * sn,
                        0.0 * sn + (-0.5 * src_w) * cs])
    dst_dir = np.array([0.0, -0.5 * dst_w])

    def third(a, b):
        d = a - b
        return b + np.array([-d[1], d[0]])

    src = np.zeros((3, 2))
    dst = np.zeros((3, 2))
    src[0] = center + scale * shift
    src[1] = center + src_dir + scale * shift
    src[2] = third(src[0], src[1])
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    dst[2] = third(dst[0], dst[1])

    if inv:
        src, dst = dst, src

    # solve [x y 1] @ A.T = dst for the 2x3 matrix A
    ones = np.ones((3, 1))
    M = np.concatenate([src, ones], axis=1)  # 3x3
    A = np.linalg.solve(M, dst)              # 3x2
    return A.T.astype(np.float64)            # 2x3


def affine_transform(pt, t) -> np.ndarray:
    """Apply a 2x3 affine to one point (image.py:63-66)."""
    p = np.array([pt[0], pt[1], 1.0], np.float64)
    return (t @ p)[:2]


def affine_transform_batch(pts, t) -> np.ndarray:
    """Apply a 2x3 affine to an (N, 2) array of points."""
    pts = np.asarray(pts, np.float64)
    return pts @ t[:, :2].T + t[:, 2]


def transform_preds(coords, center, scale, output_size) -> np.ndarray:
    """Map output-resolution coords back to original pixels (image.py:19-24)."""
    trans = get_affine_transform(center, scale, 0, output_size, inv=True)
    return affine_transform_batch(np.asarray(coords)[:, :2], trans)


# ------------------------------------------------------------------- gaussian
def gaussian_radius(det_size, min_overlap=0.7) -> float:
    """CornerNet radius such that any center within it keeps IoU >= min_overlap
    (image.py:95-115): the three quadratic cases for corner displacement."""
    height, width = det_size

    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * a1 * c1)) / 2

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2 ** 2 - 4 * a2 * c2)) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


def gaussian2d(shape, sigma=1.0) -> np.ndarray:
    """Un-normalised 2D gaussian patch (image.py:118-124)."""
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m:m + 1, -n:n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_umich_gaussian(heatmap, center, radius, k=1.0) -> np.ndarray:
    """Max-composite a gaussian peak into `heatmap` in place (image.py:126-141)."""
    diameter = 2 * radius + 1
    gaussian = gaussian2d((diameter, diameter), sigma=diameter / 6.0)
    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]

    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)

    masked_hm = heatmap[y - top:y + bottom, x - left:x + right]
    masked_g = gaussian[radius - top:radius + bottom,
                        radius - left:radius + right]
    if min(masked_g.shape) > 0 and min(masked_hm.shape) > 0:
        np.maximum(masked_hm, masked_g * k, out=masked_hm)
    return heatmap


def draw_dense_reg(regmap, heatmap, center, value, radius,
                   is_offset=False) -> np.ndarray:
    """Paint a dense regression patch where the gaussian dominates the
    current heatmap (image.py:143-173).  Unused by the stereo main path
    (SIDE regresses at center indices only); kept for CenterNet-toolkit
    parity.  regmap: (dim, H, W); heatmap: (H, W)."""
    diameter = 2 * radius + 1
    gaussian = gaussian2d((diameter, diameter), sigma=diameter / 6.0)
    value = np.asarray(value, np.float32).reshape(-1, 1, 1)
    dim = value.shape[0]
    reg = np.ones((dim, diameter * 2 + 1, diameter * 2 + 1),
                  np.float32) * value
    if is_offset and dim == 2:
        delta = np.arange(diameter * 2 + 1) - radius
        reg[0] -= delta.reshape(1, -1)
        reg[1] -= delta.reshape(-1, 1)

    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]
    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)

    masked_hm = heatmap[y - top:y + bottom, x - left:x + right]
    masked_reg_out = regmap[:, y - top:y + bottom, x - left:x + right]
    masked_g = gaussian[radius - top:radius + bottom,
                        radius - left:radius + right]
    masked_reg = reg[:, radius - top:radius + bottom,
                     radius - left:radius + right]
    if min(masked_g.shape) > 0 and min(masked_hm.shape) > 0:
        idx = (masked_g >= masked_hm).reshape(1, *masked_g.shape)
        masked_reg_out = (1 - idx) * masked_reg_out + idx * masked_reg
    regmap[:, y - top:y + bottom, x - left:x + right] = masked_reg_out
    return regmap


def draw_msra_gaussian(heatmap, center, sigma) -> np.ndarray:
    """MSRA-style gaussian used with --mse_loss (image.py:175-196).

    DELIBERATE FIX over the reference: sigma == 0 (radius-0 objects) makes
    the reference's exp(-d2/(2*sigma^2)) evaluate 0/0 = NaN at the centre
    pixel and poisons the whole heatmap (observed: hm_loss = NaN from step
    0 on the fixture).  The sigma -> 0 limit of the gaussian is a unit
    impulse at the centre, so draw that instead."""
    if sigma <= 0:
        mu_x, mu_y = int(center[0] + 0.5), int(center[1] + 0.5)
        h, w = heatmap.shape[0], heatmap.shape[1]
        if 0 <= mu_x < w and 0 <= mu_y < h:
            heatmap[mu_y, mu_x] = max(heatmap[mu_y, mu_x], 1.0)
        return heatmap
    tmp_size = sigma * 3
    mu_x, mu_y = int(center[0] + 0.5), int(center[1] + 0.5)
    h, w = heatmap.shape[0], heatmap.shape[1]
    ul = [int(mu_x - tmp_size), int(mu_y - tmp_size)]
    br = [int(mu_x + tmp_size + 1), int(mu_y + tmp_size + 1)]
    if ul[0] >= w or ul[1] >= h or br[0] < 0 or br[1] < 0:
        return heatmap
    size = 2 * tmp_size + 1
    x = np.arange(0, size, 1, np.float32)
    y = x[:, None]
    x0 = y0 = size // 2
    g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma ** 2))
    g_x = max(0, -ul[0]), min(br[0], w) - ul[0]
    g_y = max(0, -ul[1]), min(br[1], h) - ul[1]
    img_x = max(0, ul[0]), min(br[0], w)
    img_y = max(0, ul[1]), min(br[1], h)
    heatmap[img_y[0]:img_y[1], img_x[0]:img_x[1]] = np.maximum(
        heatmap[img_y[0]:img_y[1], img_x[0]:img_x[1]],
        g[g_y[0]:g_y[1], g_x[0]:g_x[1]])
    return heatmap


# ---------------------------------------------------------------- orientation
def alpha_to_rot_y(alpha, x, cx, fx):
    """Viewpoint angle -> global yaw (post_process.py:73-89), vectorised."""
    rot_y = np.asarray(alpha) + np.arctan2(np.asarray(x) - cx, fx)
    rot_y = np.where(rot_y > np.pi, rot_y - 2 * np.pi, rot_y)
    rot_y = np.where(rot_y < -np.pi, rot_y + 2 * np.pi, rot_y)
    return rot_y


def rot_y_to_alpha(rot_y, x, cx, fx):
    alpha = np.asarray(rot_y) - np.arctan2(np.asarray(x) - cx, fx)
    alpha = np.where(alpha > np.pi, alpha - 2 * np.pi, alpha)
    alpha = np.where(alpha < -np.pi, alpha + 2 * np.pi, alpha)
    return alpha


def unproject_2d_to_3d(pt_2d, depth, P) -> np.ndarray:
    """Back-project an image point at known depth through a 3x4 camera
    matrix (reference ddd_utils.py:66-75)."""
    z = depth - P[2, 3]
    x = (pt_2d[0] * depth - P[0, 3] - P[0, 2] * z) / P[0, 0]
    y = (pt_2d[1] * depth - P[1, 3] - P[1, 2] * z) / P[1, 1]
    return np.array([x, y, z], np.float32)


# ------------------------------------------------------------------ color aug
def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def color_aug(rng: np.random.RandomState, image: np.ndarray,
              eig_val: np.ndarray, eig_vec: np.ndarray) -> None:
    """In-place PCA color augmentation (image.py:198-230).

    `image` is float32 HxWx3 in [0, 1].  Same math and identical rng draw
    sequence as the reference; the pixel work runs through in-place cv2
    ops when available (SIMD + GIL-releasing — the numpy form measured
    ~150 ms/image of temporary-allocating, GIL-holding elementwise ops,
    the single largest host data-pipeline cost; parity is asserted by
    tests/test_geometry.py::test_color_aug_cv2_matches_numpy)."""
    cv2 = _cv2()
    if cv2 is not None and image.dtype == np.float32 and image.ndim == 3 \
            and image.shape[2] == 3:
        _color_aug_cv2(cv2, rng, image, eig_val, eig_vec)
        return
    _color_aug_numpy(rng, image, eig_val, eig_vec)


def _color_aug_cv2(cv2, rng: np.random.RandomState, image: np.ndarray,
                   eig_val: np.ndarray, eig_vec: np.ndarray) -> None:
    """The pixel work of color_aug through in-place OpenCV ops."""
    # BGR grayscale: cv2's BGR2GRAY uses exactly [0.114, 0.587, 0.299]
    gs = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
    gs_mean = float(cv2.mean(gs)[0])
    gs3 = None

    def brightness(var):
        a = 1.0 + rng.uniform(low=-var, high=var)
        cv2.addWeighted(image, a, image, 0.0, 0.0, dst=image)

    def contrast(var):
        a = 1.0 + rng.uniform(low=-var, high=var)
        cv2.addWeighted(image, a, image, 0.0, (1.0 - a) * gs_mean,
                        dst=image)

    def saturation(var):
        nonlocal gs3
        a = 1.0 + rng.uniform(low=-var, high=var)
        if gs3 is None:
            gs3 = cv2.cvtColor(gs, cv2.COLOR_GRAY2BGR)
        cv2.addWeighted(image, a, gs3, 1.0 - a, 0.0, dst=image)

    fns = [brightness, contrast, saturation]
    for i in rng.permutation(3):
        fns[i](0.4)
    alpha = rng.normal(scale=0.1, size=(3,))
    b = (eig_vec @ (eig_val * alpha)).astype(np.float64)
    cv2.add(image, (b[0], b[1], b[2], 0.0), dst=image)


def _color_aug_numpy(rng: np.random.RandomState, image: np.ndarray,
                     eig_val: np.ndarray, eig_vec: np.ndarray) -> None:
    """Reference numpy form, kept callable for the cv2-parity test."""
    gs = image @ np.array([0.114, 0.587, 0.299], np.float32)
    gs_mean = gs.mean()

    def brightness(var):
        image[:] = image * (1.0 + rng.uniform(low=-var, high=var))

    def contrast(var):
        alpha = 1.0 + rng.uniform(low=-var, high=var)
        image[:] = image * alpha + (1 - alpha) * gs_mean

    def saturation(var):
        alpha = 1.0 + rng.uniform(low=-var, high=var)
        image[:] = image * alpha + (1 - alpha) * gs[:, :, None]

    for i in rng.permutation(3):
        [brightness, contrast, saturation][i](0.4)
    alpha = rng.normal(scale=0.1, size=(3,))
    image[:] = image + eig_vec @ (eig_val * alpha)
