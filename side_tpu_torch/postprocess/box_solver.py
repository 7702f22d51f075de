"""Batched geometric-constraint 3D box solver (port of
side_tpu/postprocess/box_solver.py, the 3-DoF solve the inference tail uses).

The residuals are the Stereo-RCNN-style reprojection terms (2D box edges,
perspective keypoint, viewpoint angle, truncation-aware masks), solved by a
damped Gauss-Newton over a fixed iteration count for all detections at
once.  The Jacobian is exact and written out (`jacobian_xytheta`), where
the JAX package vmaps `jax.jacfwd`: the tail runs under
`torch.inference_mode`, where forward-mode AD (`torch.func.jvp`) gives no
derivative in some PyTorch releases (on 2.11 the solver then returned its
initial state).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# per viewpoint, the (w, l) signs of the 3D vertex that projects to the
# left / right / bottom edge of the 2D box (viewpoint 7 = the fallback)
_LEFT_W = [-1, -1, -1, 1, 1, 1, 1, -1]
_LEFT_L = [-1, 1, 1, 1, 1, -1, -1, -1]
_RIGHT_W = [1, 1, -1, -1, -1, -1, 1, 1]
_RIGHT_L = [-1, -1, -1, -1, 1, 1, 1, 1]
_BOT_W = [1, -1, -1, -1, -1, 1, 1, 1]
_BOT_L = [-1, -1, -1, 1, 1, 1, 1, -1]
# keypoint type -> vertex signs
_KPT_W = [-1, -1, 1, 1]
_KPT_L = [-1, 1, 1, -1]


def viewpoint_from_alpha(alpha: torch.Tensor) -> torch.Tensor:
    """8 viewpoint sectors with a 4-degree boundary band."""
    deg = alpha * (180.0 / math.pi)
    deg = torch.where(deg > 360.0, deg - 360.0, deg)
    deg = torch.where(deg < -360.0, deg + 360.0, deg)
    t = 4.0
    vp = torch.full(deg.shape, 7, dtype=torch.long, device=deg.device)
    conds = [
        ((deg >= -90 - t) & (deg <= -90 + t), 0),
        ((deg >= -180 + t) & (deg <= -90 - t), 1),
        ((deg >= 180 - t) | (deg <= -180 + t), 2),
        ((deg >= 90 + t) & (deg <= 180 - t), 3),
        ((deg >= 90 - t) & (deg <= 90 + t), 4),
        ((deg >= 0 + t) & (deg <= 90 - t), 5),
        ((deg >= 0 - t) & (deg <= 0 + t), 6),
        ((deg >= -90 + t) & (deg <= 0 - t), 7),
    ]
    for cond, v in conds:
        vp = torch.where(cond, torch.full_like(vp, v), vp)
    return vp


def kpt_to_alpha(kpt_pos, kpt_type, box):
    """Approximate viewpoint angle from the keypoint position in the box."""
    width = torch.clamp(box[..., 2] - box[..., 0], min=1e-6)
    s = torch.arcsin(torch.clamp((kpt_pos - box[..., 0]) / width, -1.0, 1.0))
    base = torch.tensor([-math.pi / 2, math.pi, math.pi / 2, 0.0],
                        dtype=s.dtype, device=s.device)
    kt = torch.clamp(kpt_type.long(), 0, 3)
    return base[kt] - s


class SolveConsts(NamedTuple):
    """Per-detection constants of the residual system, each (N,)."""
    left_u: torch.Tensor
    right_u: torch.Tensor
    top_v: torch.Tensor
    bottom_v: torch.Tensor
    kpt_u: torch.Tensor
    left_u_r: torch.Tensor
    right_u_r: torch.Tensor
    alpha: torch.Tensor
    h: torch.Tensor
    bl: torch.Tensor
    lw: torch.Tensor
    ll: torch.Tensor
    rw: torch.Tensor
    rl: torch.Tensor
    bw: torch.Tensor
    bot_l: torch.Tensor
    kw: torch.Tensor
    kl: torch.Tensor
    m_ul: torch.Tensor
    m_ur: torch.Tensor
    m_uk: torch.Tensor
    m_vt: torch.Tensor
    m_vb: torch.Tensor
    m_alpha: torch.Tensor
    m_ul_r: torch.Tensor
    m_ur_r: torch.Tensor


def build_consts(im_shape, calib_p2, bl, alpha, dim_whl, box_left, box_right,
                 kpts, use_right: bool, grid: int = 28) -> SolveConsts:
    """Normalise the image observations and pick the vertex tables.
    dim_whl (N, 3) as (w, h, l); box_* (N, 4); kpts (N, 4) = [border_l_u,
    border_r_u, kpt_u, kpt_type] in pixels.  im_shape (2,) = (w, h),
    calib_p2 (3, 4) and bl (a number or a 0-d tensor) hold for every row;
    for rows of several frames they are per row: (N, 2), (N, 3, 4), (N,)."""
    f = calib_p2[..., 0, 0]
    cx, cy = calib_p2[..., 0, 2], calib_p2[..., 1, 2]
    w_max, h_max = im_shape[..., 0], im_shape[..., 1]
    tb = 10.0

    ul, vt, ur, vb = (box_left[:, 0], box_left[:, 1], box_left[:, 2],
                      box_left[:, 3])
    ul_r, ur_r = box_right[:, 0], box_right[:, 2]
    w, h, l = dim_whl[:, 0], dim_whl[:, 1], dim_whl[:, 2]
    kpt_pos, kpt_type = kpts[:, 2], kpts[:, 3]

    truncated = (ul < 2 * tb) | (ur > w_max - 2 * tb)
    # a (type 0, cell 0) keypoint label means "no visible keypoint": trust
    # the regressed alpha there, as for truncated boxes
    width_l = torch.clamp(ur - ul, min=1e-6)
    kpt_cell = (kpt_pos - ul) / width_l * grid
    degenerate = (kpt_type.long() == 0) & (kpt_cell < 1.0)
    no_kpt = truncated | degenerate
    alpha_eff = torch.where(no_kpt, alpha,
                            kpt_to_alpha(kpt_pos, kpt_type, box_left))
    vp = viewpoint_from_alpha(alpha_eff)

    def lt(tab):
        return torch.tensor(tab, dtype=ul.dtype, device=ul.device)[vp]

    kt = torch.clamp(kpt_type.long(), 0, 3)
    ones = torch.ones_like(ul)
    zeros = torch.zeros_like(ul)
    m_uk = torch.where(no_kpt, zeros, ones)
    m_alpha = torch.where(no_kpt, ones, zeros)
    m_right = m_alpha if use_right else zeros
    kpt_tab = lambda tab: torch.tensor(tab, dtype=ul.dtype,
                                       device=ul.device)[kt]
    return SolveConsts(
        left_u=(ul - cx) / f, right_u=(ur - cx) / f,
        top_v=(vt - cy) / f, bottom_v=(vb - cy) / f,
        kpt_u=(kpt_pos - cx) / f,
        left_u_r=(ul_r - cx) / f, right_u_r=(ur_r - cx) / f,
        alpha=alpha_eff, h=h,
        bl=torch.as_tensor(bl, dtype=ul.dtype, device=ul.device).expand_as(ul),
        lw=lt(_LEFT_W) * w / 2, ll=lt(_LEFT_L) * l / 2,
        rw=lt(_RIGHT_W) * w / 2, rl=lt(_RIGHT_L) * l / 2,
        bw=lt(_BOT_W) * w / 2, bot_l=lt(_BOT_L) * l / 2,
        kw=kpt_tab(_KPT_W) * w / 2, kl=kpt_tab(_KPT_L) * l / 2,
        m_ul=torch.where(ul < 2 * tb, zeros, ones),
        m_ur=torch.where(ur > w_max - 2 * tb, zeros, ones),
        m_uk=m_uk,
        m_vt=torch.where(vt < tb, zeros, ones),
        m_vb=torch.where(vb > h_max - tb, zeros, ones),
        m_alpha=m_alpha,
        m_ul_r=m_right * torch.where(ul_r < 2 * tb, zeros, ones),
        m_ur_r=m_right * torch.where(ur_r > w_max - 2 * tb, zeros, ones),
    )


def _edge_u(x, z, theta, vw, vl):
    """Projected u of the box vertex (vw, vl) at pose (x, z, theta)."""
    s, c = torch.sin(theta), torch.cos(theta)
    return (x + c * vw + s * vl) / (z - s * vw + c * vl)


def residuals_xytheta(state: torch.Tensor, z: torch.Tensor,
                      c: SolveConsts) -> torch.Tensor:
    """3-DoF residuals, (N, 3) states at fixed depth z (N,) -> (N, 6)."""
    x, y, theta = state[:, 0], state[:, 1], state[:, 2]
    s, ct = torch.sin(theta), torch.cos(theta)
    r_ul = (_edge_u(x, z, theta, c.lw, c.ll) - c.left_u) * c.m_ul
    r_ur = (_edge_u(x, z, theta, c.rw, c.rl) - c.right_u) * c.m_ur
    r_uk = 2.0 * (_edge_u(x, z, theta, c.kw, c.kl) - c.kpt_u) * c.m_uk
    r_vb = (y / (z - s * c.bw + ct * c.bot_l) - c.bottom_v) * c.m_vb
    r_vt = ((y - c.h) / (z + s * c.bw - ct * c.bot_l) - c.top_v) * c.m_vt
    r_a = (theta - math.pi / 2 + torch.atan2(-x, z) - c.alpha) * c.m_alpha
    return torch.stack([r_ul, r_ur, r_uk, r_vb, r_vt, r_a], dim=1)


def jacobian_xytheta(state: torch.Tensor, z: torch.Tensor,
                     c: SolveConsts) -> torch.Tensor:
    """d residuals_xytheta / d (x, y, theta), (N, 6, 3), in closed form."""
    x, y, theta = state[:, 0], state[:, 1], state[:, 2]
    s, ct = torch.sin(theta), torch.cos(theta)
    zero = torch.zeros_like(x)

    def edge(vw, vl, m):
        # u = (x + c vw + s vl) / (z - s vw + c vl)
        num = x + ct * vw + s * vl
        den = z - s * vw + ct * vl
        d_num = -s * vw + ct * vl
        d_den = -ct * vw - s * vl
        return (m / den, zero, m * (d_num * den - num * d_den) / den ** 2)

    r_ul = edge(c.lw, c.ll, c.m_ul)
    r_ur = edge(c.rw, c.rl, c.m_ur)
    r_uk = edge(c.kw, c.kl, 2.0 * c.m_uk)
    den_b = z - s * c.bw + ct * c.bot_l
    r_vb = (zero, c.m_vb / den_b,
            -c.m_vb * y * (-ct * c.bw - s * c.bot_l) / den_b ** 2)
    den_t = z + s * c.bw - ct * c.bot_l
    r_vt = (zero, c.m_vt / den_t,
            -c.m_vt * (y - c.h) * (ct * c.bw + s * c.bot_l) / den_t ** 2)
    # d atan2(-x, z) / dx = -z / (x^2 + z^2)
    r_a = (-c.m_alpha * z / (x * x + z * z), zero, c.m_alpha)
    return torch.stack([torch.stack(row, dim=1) for row in
                        (r_ul, r_ur, r_uk, r_vb, r_vt, r_a)], dim=1)


def gauss_newton(res_fn, jac_fn, x0: torch.Tensor, num_iters: int = 20,
                 damping: float = 1e-4) -> torch.Tensor:
    """Damped Gauss-Newton on per-row residuals res_fn (N, n) -> (N, m)
    with their Jacobian jac_fn (N, n) -> (N, m, n), rows independent.  A
    step that is non-finite or raises the cost is rejected (the row keeps
    its state)."""
    x = x0
    n = x.shape[1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    for _ in range(num_iters):
        r = res_fn(x)
        J = jac_fn(x)                                       # (N, m, n)
        JtJ = J.transpose(1, 2) @ J
        g = (J.transpose(1, 2) @ r[..., None])[..., 0]
        step = torch.linalg.solve_ex(JtJ + damping * eye, g)[0]
        x_new = x - step
        ok = torch.isfinite(x_new).all(dim=1) & (
            (res_fn(x_new) ** 2).sum(dim=1) <= (r ** 2).sum(dim=1) + 1e-9)
        x = torch.where(ok[:, None], x_new, x)
    return x


def solve_x_y_theta(consts: SolveConsts, z: torch.Tensor,
                    num_iters: int = 20) -> torch.Tensor:
    """Batched 3-DoF pose refinement at depth z (N,).  Returns (N, 3) =
    (x, y, theta)."""
    init_x = z * (consts.left_u + consts.right_u) / 2.0
    init_y = z * (consts.bottom_v + consts.top_v) / 2.0 + consts.h / 2.0
    init_t = consts.alpha + math.pi / 2 - torch.atan2(-init_x, z)
    x0 = torch.stack([init_x, init_y, init_t], dim=-1)
    return gauss_newton(lambda s: residuals_xytheta(s, z, consts),
                        lambda s: jacobian_xytheta(s, z, consts), x0,
                        num_iters)
