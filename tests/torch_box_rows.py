"""Rows for the box solve's tests (postprocess/box_solver.py against the
kernel csrc/box_solve.cu): seeded cars of a KITTI-sized frame through
`build_consts`, and a few rows made degenerate.  Imports nothing of JAX.

`solve_rows(n, seed)` returns (consts, z) on the CPU, f32:
  * rows 0-7 have no keypoint (type 0 in the first grid cell: the alpha
    residual on, the keypoint's off) with the regressed alpha at the centre
    of each of the 8 viewpoint sectors;
  * rows 8-11 are truncated at the left or right border;
  * the rest are cars at 4-70 m anywhere in front of the camera (many cut
    by the image border), a random keypoint type and position, 15 % of them
    without a keypoint, the solve's depth within 1 m of the car's;
  * the last 4 rows: z NaN, z infinite, every vertex offset 0 at z = 0 (the
    projected u is 0 / 0, every denominator zero) and the same at z = 1e-30
    (J^T J overflows).
`rejected(consts, z)` says which rows had a step rejected in the plain
solve (recorded from `gauss_newton`'s residual calls).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from side_tpu_torch.postprocess import box_solver as BS

W, H = 1242.0, 375.0
F, CX, CY, BL = 721.5377, 609.5593, 172.854, 0.54
P2 = np.array([[F, 0, CX, 44.857], [0, F, CY, 0.2163], [0, 0, 1, 0.002745]])
SECTOR_DEG = (-90.0, -135.0, 180.0, 135.0, 90.0, 45.0, 0.0, -45.0)
DEGENERATE = 4


def _project(p, pts):
    """(n, 8, 3) camera points through a (3, 4) projection -> (n, 8, 2)."""
    h = pts @ p[:, :3].T + p[:, 3]
    return h[..., :2] / h[..., 2:3]


def _boxes(p, pts):
    uv = _project(p, pts)
    return np.stack([uv[..., 0].min(1).clip(0, W - 1),
                     uv[..., 1].min(1).clip(0, H - 1),
                     uv[..., 0].max(1).clip(0, W - 1),
                     uv[..., 1].max(1).clip(0, H - 1)], 1)


def solve_rows(n: int, seed: int):
    rng = np.random.RandomState(seed)
    ry = rng.uniform(-math.pi, math.pi, n)
    x = rng.uniform(-20.0, 20.0, n)
    zc = rng.uniform(4.0, 70.0, n)
    y = rng.uniform(1.2, 2.0, n)
    hwl = np.stack([rng.normal(1.52, 0.1, n), rng.normal(1.63, 0.1, n),
                    rng.normal(3.88, 0.3, n)], 1)
    # rows 0-11 in the middle of the frame, 8-11 then pushed to a border
    x[:12] = zc[:12] * rng.uniform(-0.3, 0.3, 12)
    x[8:10] = -zc[8:10] * 0.85
    x[10:12] = zc[10:12] * 0.9
    sign_w = np.array([1, 1, -1, -1, 1, 1, -1, -1]) / 2
    sign_l = np.array([1, -1, -1, 1, 1, -1, -1, 1]) / 2
    up = np.array([0, 0, 0, 0, -1, -1, -1, -1])
    cw, cl = hwl[:, 1:2] * sign_w, hwl[:, 2:3] * sign_l
    c, s = np.cos(ry)[:, None], np.sin(ry)[:, None]
    pts = np.stack([x[:, None] + c * cl + s * cw,
                    y[:, None] + hwl[:, 0:1] * up,
                    zc[:, None] - s * cl + c * cw], -1)
    p3 = P2.copy()
    p3[0, 3] -= F * BL
    box_l, box_r = _boxes(P2, pts), _boxes(p3, pts)
    alpha = ry - np.arctan2(x, zc) + rng.normal(0, 0.1, n)
    alpha[:8] = np.radians(SECTOR_DEG)
    kpt_type = rng.randint(0, 4, n).astype(np.float64)
    frac = rng.uniform(0.0, 1.0, n)
    none = rng.rand(n) < 0.15
    none[:8] = True
    kpt_type[none] = 0.0
    frac[none] = rng.uniform(0.0, 0.9 / 28, none.sum())
    kpt_pos = box_l[:, 0] + frac * (box_l[:, 2] - box_l[:, 0])
    kpts = np.stack([box_l[:, 0], box_l[:, 2], kpt_pos, kpt_type], 1)
    dim_whl = hwl[:, [1, 0, 2]] * rng.uniform(0.95, 1.05, (n, 3))
    z = zc + rng.uniform(-1.0, 1.0, n)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32)

    consts = BS.build_consts(
        t(np.tile([W, H], (n, 1))), t(np.tile(P2, (n, 1, 1))),
        t(np.full(n, BL)), t(alpha), t(dim_whl), t(box_l), t(box_r),
        t(kpts), use_right=False, grid=28)
    z = t(z)
    z[n - 4], z[n - 3], z[n - 2], z[n - 1] = (
        float("nan"), float("inf"), 0.0, 1e-30)
    flat = ("lw", "ll", "rw", "rl", "bw", "bot_l", "kw", "kl")
    consts = consts._replace(**{
        name: getattr(consts, name).index_fill(0, torch.tensor([n - 2, n - 1]),
                                               0.0) for name in flat})
    return consts, z


def rejected(consts, z, num_iters: int = 20) -> torch.Tensor:
    """(N,) bool: rows of which the plain solve rejected some step.  Each
    iteration of `gauss_newton` evaluates the residuals at its state and at
    the candidate; a row rejected the candidate where the next state
    differs from it."""
    seen = []

    def res(state):
        seen.append(state.clone())
        return BS.residuals_xytheta(state, z, consts)

    x0 = BS.solve_x_y_theta_plain(consts, z, num_iters=0)
    BS.gauss_newton(res, lambda s: BS.jacobian_xytheta(s, z, consts), x0,
                    num_iters)
    states, candidates = seen[0::2], seen[1::2]
    out = torch.zeros(z.shape[0], dtype=torch.bool)
    for cand, nxt in zip(candidates, states[1:]):
        out |= (cand != nxt).any(dim=1) & torch.isfinite(cand).all(dim=1)
    return out
