"""Dense photometric alignment, batched over detections (port of
side_tpu/postprocess/dense_align.py).

Pixels in the lower half of each RoI between the occlusion borders are
intersected with the solved 3D box (the 3 faces around its nearest vertex),
giving each a depth offset to the box centre; 50 coarse (0.5 m) then 20
fine depth candidates are scored by the photometric L1 between the left
pixel and its disparity-warped right sample on the 2x-upsampled images, and
the first candidate of least error wins.
"""

from __future__ import annotations

from typing import Tuple

import torch

N_U, N_V = 56, 22
COARSE_ITERS, COARSE_STEP = 50, 0.5
FINE_ITERS = 20

# per nearest-vertex candidate face triple
_PLANE_GROUP = [[0, 3, 4], [2, 3, 4], [1, 2, 4], [0, 1, 4],
                [0, 3, 5], [2, 3, 5], [1, 2, 5], [0, 1, 5]]


def _unit_linspace(n: int, device) -> torch.Tensor:
    """linspace(0, 1, n) in f32 as the JAX package computes it: i * (1/(n-1))
    with the endpoint exactly 1."""
    step = torch.arange(n - 1, dtype=torch.float32, device=device) * (
        1.0 / (n - 1))
    return torch.cat([step, torch.ones(1, device=device)])


def _box_planes(poses: torch.Tensor):
    """Face planes, rotation, centre, object-frame corners and nearest
    vertex of (N, 7) poses (x, y, z, w, h, l, theta)."""
    t = poses[:, 0:3]
    w, h, l, th = poses[:, 3], poses[:, 4], poses[:, 5], poses[:, 6]
    c, s = torch.cos(th), torch.sin(th)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([torch.stack([c, zero, s], -1),
                     torch.stack([zero, one, zero], -1),
                     torch.stack([-s, zero, c], -1)], dim=1)       # (N, 3, 3)
    dev = poses.device
    sx = torch.tensor([-1, -1, 1, 1, -1, -1, 1, 1], dtype=torch.float32,
                      device=dev) * (w / 2)[:, None]
    sy = torch.tensor([0, 0, 0, 0, -1, -1, -1, -1], dtype=torch.float32,
                      device=dev) * h[:, None]
    sz = torch.tensor([-1, 1, 1, -1, -1, 1, 1, -1], dtype=torch.float32,
                      device=dev) * (l / 2)[:, None]
    P_o = torch.stack([sx, sy, sz], dim=2)                         # (N, 8, 3)
    P_c = P_o @ R.transpose(1, 2) + t[:, None]

    def plane(i1, i2, i3):
        p1, p2, p3 = P_c[:, i1], P_c[:, i2], P_c[:, i3]
        n = torch.linalg.cross(p2 - p1, p3 - p1)
        return torch.cat([n, -(n * p1).sum(-1, keepdim=True)], dim=-1)

    planes = torch.stack([plane(0, 3, 4), plane(2, 3, 6), plane(1, 2, 5),
                          plane(0, 1, 4), plane(0, 1, 2), plane(4, 5, 6)],
                         dim=1)                                    # (N, 6, 4)
    nearest = torch.argmin(torch.linalg.norm(P_c, dim=2), dim=1)
    return planes, R, t, P_o, nearest


def ray_box_intersect(poses: torch.Tensor, rays: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intersect normalised-image-plane rays (N, P, 2) with the 3 visible
    faces of each box.  Returns (dz, valid) (N, P): depth offset to the box
    centre and an inside-box flag; the first valid face in group order
    wins."""
    planes, R, t, P_o, nearest = _box_planes(poses)
    group = torch.tensor(_PLANE_GROUP, device=poses.device)[nearest]  # (N,3)
    homo = torch.cat([rays, torch.ones_like(rays[..., :1])], dim=-1)
    eps = 0.01
    lo = (P_o[:, 4] - eps)[:, None]                                # (N,1,3)
    hi = (P_o[:, 2] + eps)[:, None]

    def face(i):
        pl = torch.gather(planes, 1, group[:, i, None, None].expand(-1, 1, 4)
                          )[:, 0]                                  # (N, 4)
        denom = (homo @ pl[:, :3, None])[..., 0]                   # (N, P)
        denom = torch.where(denom.abs() < 1e-12,
                            torch.full_like(denom, 1e-12), denom)
        tscale = -pl[:, 3:4] / denom
        rel = homo * tscale[..., None] - t[:, None]
        pt_o = rel @ R
        inside = ((pt_o >= lo) & (pt_o <= hi)).all(dim=-1)
        return rel[..., 2], inside

    dz0, v0 = face(0)
    dz1, v1 = face(1)
    dz2, v2 = face(2)
    dz = torch.where(v0, dz0, torch.where(v1, dz1, dz2))
    return dz, v0 | v1 | v2


def sample_grid(box_left: torch.Tensor, borders: torch.Tensor):
    """(N, P, 2) pixel grid in the lower half of each RoI between the
    occlusion borders, and whether the border span is non-empty."""
    x1 = borders[:, 0]
    x2 = torch.maximum(borders[:, 1], x1 + 1.0)
    y_top = (box_left[:, 1] + box_left[:, 3]) / 2.0
    y_bot = box_left[:, 3] - (box_left[:, 3] - box_left[:, 1]) * 0.1
    uu = _unit_linspace(N_U, box_left.device)[None, :]
    vv = _unit_linspace(N_V, box_left.device)[None, :]
    us = x1[:, None] + (x2 - x1)[:, None] * uu                    # (N, U)
    vs = y_top[:, None] + (y_bot - y_top)[:, None] * vv           # (N, V)
    n = us.shape[0]
    grid = torch.stack([us[:, None, :].expand(n, N_V, N_U),
                        vs[:, :, None].expand(n, N_V, N_U)], dim=-1)
    return grid.reshape(n, N_V * N_U, 2), (x2 > x1 + 0.5)


def bilinear_border(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Border-clamped bilinear sampling of img (H, W, C) at u, v (...)."""
    H, W = img.shape[0], img.shape[1]
    u = u.clamp(0.0, W - 1.0)
    v = v.clamp(0.0, H - 1.0)
    x0f, y0f = torch.floor(u), torch.floor(v)
    fx, fy = u - x0f, v - y0f
    x0, y0 = x0f.long(), y0f.long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    flat = img.reshape(H * W, -1)

    def g(yi, xi):
        return flat[(yi * W + xi).reshape(-1)].reshape(*u.shape, -1)

    return (g(y0, x0) * ((1 - fy) * (1 - fx))[..., None] +
            g(y0, x1) * ((1 - fy) * fx)[..., None] +
            g(y1, x0) * (fy * (1 - fx))[..., None] +
            g(y1, x1) * (fy * fx)[..., None])


def photometric_errors(im_left, im_right, uv, dz, weight, depth_enum, fb):
    """Warped L1 of every candidate depth: depth_enum (I, N) -> (I, N)."""
    left_px = bilinear_border(im_left, uv[..., 0], uv[..., 1])    # (N, P, C)
    zpix = dz[None] + depth_enum[..., None]                       # (I, N, P)
    delta = fb / torch.clamp(zpix, min=0.5)
    right_px = bilinear_border(im_right, uv[None, ..., 0] - delta,
                               uv[None, ..., 1].expand_as(delta))
    err = (left_px[None] - right_px).abs() * weight[None, ..., None]
    return err.sum(dim=(2, 3))


def _photometric_best(im_left, im_right, uv, dz, weight, depth_enum, fb):
    errors = photometric_errors(im_left, im_right, uv, dz, weight,
                                depth_enum, fb)
    best = torch.argmin(errors, dim=0)        # first of equal minima
    return torch.gather(depth_enum, 0, best[None])[0]


def align_depths(im_left2x, im_right2x, f2x, bl, cx2x, cy2x, box_left2x,
                 borders2x, poses, valid):
    """Alignment of N detections.  im_*2x: (H, W, 3) normalised 2x images;
    box / border coordinates in 2x pixels; poses (N, 7) = (x, y, z, w, h,
    l, theta).  Returns (status (N,), best_dis (N,)) with the disparity in
    original pixels (+0.5 bias)."""
    fb = f2x * bl
    uv, has_span = sample_grid(box_left2x, borders2x)
    rays = torch.stack([(uv[..., 0] - cx2x) / f2x,
                        (uv[..., 1] - cy2x) / f2x], dim=-1)
    dz, inside = ray_box_intersect(poses, rays)
    weight = (inside & has_span[:, None] & valid[:, None]).float()
    status = (weight.sum(dim=1) > 0).float()
    z0 = poses[:, 2]

    steps = torch.arange(COARSE_ITERS, dtype=torch.float32,
                         device=poses.device)
    coarse = (z0[None, :] - COARSE_ITERS * COARSE_STEP / 2 +
              steps[:, None] * COARSE_STEP)
    coarse = torch.clamp(coarse, min=1.5)
    best = _photometric_best(im_left2x, im_right2x, uv, dz, weight, coarse,
                             fb)
    fine_step = COARSE_STEP * 2.0 / FINE_ITERS
    fsteps = torch.arange(FINE_ITERS, dtype=torch.float32,
                          device=poses.device)
    fine = (best[None, :] - FINE_ITERS * fine_step / 2 +
            fsteps[:, None] * fine_step)
    best = _photometric_best(im_left2x, im_right2x, uv, dz, weight, fine, fb)

    best_dis = fb / (best * 2.0) + 0.5
    dis_init = fb / (z0 * 2.0) + 0.5
    return status, torch.where(status > 0, best_dis, dis_init)


def upsample2x(img: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (2H, 2W, C) bilinear, half-pixel centres (equal to
    jax.image.resize(..., "bilinear") for a 2x upsample)."""
    x = img.permute(2, 0, 1)[None]
    out = torch.nn.functional.interpolate(
        x, scale_factor=2, mode="bilinear", align_corners=False,
        antialias=False)
    return out[0].permute(1, 2, 0)
