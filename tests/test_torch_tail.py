"""The port's inference tail (box solve, dense alignment, fused device tail)
against side_tpu's, on identical decoded inputs.

The inputs are the synthetic scene of tests/test_inference_tail.py: decode
outputs projected from known 3D cars and the rendered stereo pair.
`align_depths` picks a depth by argmin over 0.5 m (then 0.05 m) steps: the
picks must be equal, except where the reference's best two errors lie
within 1e-4 of each other (relative), where float noise may pick either.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from side_tpu.config import Config as JConfig
from side_tpu.data.synthetic import _render
from side_tpu.postprocess import box_solver as JBS
from side_tpu.postprocess import dense_align as JDA
from side_tpu.postprocess.device_tail import run_tail as j_run_tail
from side_tpu_torch.config import Config
from side_tpu_torch.postprocess import box_solver as TBS
from side_tpu_torch.postprocess import dense_align as TDA
from side_tpu_torch.postprocess.device_tail import run_tail as t_run_tail

import torch_parity  # noqa: F401  (thread count)
from test_inference_tail import CARS, DIM_HWL, _make_decode_outputs, _meta

NEAR_TIE = 1e-4


def _scene(cars):
    cfg = JConfig()
    _, p2, p3 = _meta(cfg)
    objs = [{"type": "Car", "dim": list(DIM_HWL),
             "location": [c[0], c[1], c[2]], "rotation_y": c[3],
             "color": [200, 80, 60]} for c in cars]
    img_l = _render(objs, p2, np.random.RandomState(3))
    img_r = _render(objs, p3, np.random.RandomState(3))
    return cfg, p2, p3, img_l, img_r


def _solver_inputs(cfg, cars, depth_fn):
    """numpy inputs of build_consts, as _tail_one derives them."""
    dets, dets_r, info, meta = _make_decode_outputs(cfg, cars,
                                                    depth_fn=depth_fn)
    n = len(cars)
    A = meta["trans_inv"]

    def unwarp(d):
        p1 = (d[:, :2] - 0.5 * d[:, 2:4]) @ A[:, :2].T + A[:, 2]
        p2 = (d[:, :2] + 0.5 * d[:, 2:4]) @ A[:, :2].T + A[:, 2]
        return np.concatenate([p1, p2], 1).astype(np.float32)

    box_l, box_r = unwarp(dets[:n]), unwarp(dets_r[:n])
    width = box_l[:, 2] - box_l[:, 0]
    px = box_l[:, 0:1] + info[:n, 5:8] * width[:, None] / cfg.grid
    kpts = np.concatenate([px, info[:n, 8:9]], 1).astype(np.float32)
    alpha = np.arctan2(info[:n, 3], info[:n, 4]).astype(np.float32)
    dim_whl = info[:n, [1, 0, 2]].astype(np.float32)
    return box_l, box_r, kpts, alpha, dim_whl, info[:n, 9].astype(np.float32)


def test_solve_x_y_theta_matches():
    cfg, p2, p3, _, _ = _scene([])
    rng = np.random.RandomState(0)
    cars = list(CARS)
    box_l, box_r, kpts, alpha, dim_whl, z = _solver_inputs(
        cfg, cars, depth_fn=lambda zz: zz + rng.uniform(-1.0, 1.0))
    bl = float((p2[0, 3] - p3[0, 3]) / p2[0, 0])
    im = np.array([1242.0, 375.0], np.float32)
    p2f = p2.astype(np.float32)
    args = (im, p2f, bl, alpha, dim_whl, box_l, box_r, kpts)
    jc = JBS.build_consts(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                            else a for a in args], use_right=False,
                          grid=cfg.grid)
    tc = TBS.build_consts(*[torch.from_numpy(a) if isinstance(a, np.ndarray)
                            else a for a in args], use_right=False,
                          grid=cfg.grid)
    for name in JBS.SolveConsts._fields:
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    want = np.asarray(JBS.solve_x_y_theta(jc, jnp.asarray(z)))
    got = TBS.solve_x_y_theta(tc, torch.from_numpy(z)).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _solver_case(seed=0):
    """Consts of the CARS scene in float64, some rows with their keypoint
    masked (the alpha residual on), and random states around the cars."""
    cfg, p2, p3, _, _ = _scene([])
    box_l, box_r, kpts, alpha, dim_whl, z = _solver_inputs(
        cfg, list(CARS), depth_fn=lambda zz: zz)
    bl = float((p2[0, 3] - p3[0, 3]) / p2[0, 0])
    c = TBS.build_consts(torch.tensor([1242.0, 375.0]),
                         torch.from_numpy(p2.astype(np.float32)), bl,
                         *[torch.from_numpy(a) for a in
                           (alpha, dim_whl, box_l, box_r, kpts)],
                         use_right=False, grid=cfg.grid)
    c = TBS.SolveConsts(*[t.double() for t in c])
    rng = np.random.RandomState(seed)
    flip = torch.from_numpy(rng.rand(len(z)) < 0.5)
    c = c._replace(m_uk=torch.where(flip, 0.0, c.m_uk),
                   m_alpha=torch.where(flip, 1.0, c.m_alpha))
    z = torch.from_numpy(z).double()
    state = torch.from_numpy(np.stack([
        rng.uniform(-8, 8, len(z)), rng.uniform(0.5, 2.5, len(z)),
        rng.uniform(-math.pi, 2 * math.pi, len(z))], 1))
    return c, z, state


def test_jacobian_matches_forward_mode_ad():
    """The solver's closed-form Jacobian equals forward-mode AD of its
    residuals (float64), keypoint and alpha residuals both exercised."""
    c, z, state = _solver_case()
    cols = []
    for j in range(3):
        tangent = torch.zeros_like(state)
        tangent[:, j] = 1.0
        cols.append(torch.func.jvp(
            lambda s: TBS.residuals_xytheta(s, z, c), (state,),
            (tangent,))[1])
    want = torch.stack(cols, dim=2)
    got = TBS.jacobian_xytheta(state, z, c)
    assert bool(c.m_alpha.any()) and bool(c.m_uk.any())
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_solver_needs_no_forward_mode_ad(monkeypatch):
    """The device tail solves under torch.inference_mode, where forward-mode
    AD gives no derivative in some PyTorch releases (2.11: zero tangents;
    the solver then returned its initial state and the trained
    acceptance run's rotations were off by up to 0.68 rad on the card).
    With torch.func.jvp giving zero tangents, the solve under inference
    mode equals the solve outside it and moves away from the initial
    state."""
    c, z, _ = _solver_case()
    c = TBS.SolveConsts(*[t.float() for t in c])
    z = z.float()
    want = TBS.solve_x_y_theta(c, z)

    def no_tangent(fn, primals, tangents):
        out = fn(*primals)
        return out, torch.zeros_like(out)

    monkeypatch.setattr(torch.func, "jvp", no_tangent)
    with torch.inference_mode():
        got = TBS.solve_x_y_theta(c, z)
    torch.testing.assert_close(got, want)
    init_t = c.alpha + math.pi / 2 - torch.atan2(
        -z * (c.left_u + c.right_u) / 2, z)
    assert float((got[:, 2] - init_t).abs().max()) > 1e-2


def _jax_errors(im_l, im_r, uv, dz, weight, enum, fb):
    """The reference's photometric error table (I, N), as
    dense_align._photometric_best scores it."""
    left_px = JDA._bilinear_border(im_l, uv[..., 0], uv[..., 1])

    def score(depth_n):
        delta = fb / jnp.maximum(dz + depth_n[:, None], 0.5)
        right_px = JDA._bilinear_border(im_r, uv[..., 0] - delta, uv[..., 1])
        return jnp.sum(jnp.abs(left_px - right_px) * weight[..., None],
                       axis=(1, 2))
    return np.asarray(jax.vmap(score)(enum))


def _near_tie(errors: np.ndarray) -> np.ndarray:
    """Per roi: are the best two errors within NEAR_TIE (relative)?"""
    two = np.sort(errors, axis=0)[:2]
    return (two[1] - two[0]) <= NEAR_TIE * np.maximum(np.abs(two[0]), 1e-30)


def test_align_depths_picks_match():
    cars = CARS[:3]
    cfg, p2, p3, img_l, img_r = _scene(cars)
    box_l, _, kpts, _, dim_whl, _ = _solver_inputs(cfg, cars, lambda z: z)
    mean = np.asarray(cfg.mean, np.float32)
    std = np.asarray(cfg.std, np.float32)
    norm = [((im.astype(np.float32) / 255.0 - mean) / std) for im in
            (img_l, img_r)]
    ups = [np.asarray(JDA.upsample2x(n)) for n in norm]
    f, cx, cy = float(p2[0, 0]), float(p2[0, 2]), float(p2[1, 2])
    bl = float((p2[0, 3] - p3[0, 3]) / f)
    poses = np.array([[c[0], c[1], c[2] + 1.5, DIM_HWL[1], DIM_HWL[0],
                       DIM_HWL[2], c[3] + math.pi / 2] for c in cars],
                     np.float32)
    valid = np.ones(len(cars), bool)
    args = (ups[0], ups[1], 2 * f, bl, 2 * cx, 2 * cy, box_l * 2,
            kpts[:, :2] * 2, poses, valid)
    j_status, j_dis = (np.asarray(a) for a in JDA.align_depths(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    t_status, t_dis = (a.numpy() for a in TDA.align_depths(
        *[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for a in args]))
    np.testing.assert_array_equal(t_status, j_status)
    assert (j_status > 0).all()

    # which rois may legitimately differ: near-ties of the reference
    fb = 2 * f * bl
    uv, _ = JDA.sample_grid(jnp.asarray(box_l * 2), jnp.asarray(kpts[:, :2] * 2))
    rays = jnp.stack([(uv[..., 0] - 2 * cx) / (2 * f),
                      (uv[..., 1] - 2 * cy) / (2 * f)], axis=-1)
    dz, inside = jax.vmap(JDA.ray_box_intersect)(jnp.asarray(poses), rays)
    weight = inside.astype(jnp.float32)
    coarse = jnp.maximum(jnp.asarray(poses[:, 2])[None] - 12.5 +
                         jnp.arange(50.0)[:, None] * 0.5, 1.5)
    e_c = _jax_errors(*map(jnp.asarray, ups), uv, dz, weight, coarse, fb)
    best = np.asarray(coarse)[np.argmin(e_c, 0), np.arange(len(cars))]
    fine = jnp.asarray(best)[None] - 0.5 + jnp.arange(20.0)[:, None] * 0.05
    e_f = _jax_errors(*map(jnp.asarray, ups), uv, dz, weight, fine, fb)
    tie = _near_tie(e_c) | _near_tie(e_f)
    assert (~tie).any()
    np.testing.assert_allclose(t_dis[~tie], j_dis[~tie], rtol=1e-5, atol=0)
    # the picks moved the depth off the +1.5 m start (a real alignment)
    z_aligned = fb / 2 / (j_dis - 0.5)
    assert np.abs(z_aligned - poses[:, 2]).max() > 0.5


def test_upsample2x_equals_jax_resize():
    img = np.random.RandomState(4).randn(7, 9, 3).astype(np.float32)
    want = np.asarray(JDA.upsample2x(img))
    got = TDA.upsample2x(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("run_align", [False, True],
                         ids=["solve", "solve_align"])
def test_tail_one_matches(run_align):
    cars = CARS[:3]
    jcfg, _, _, img_l, img_r = _scene(cars)
    dets, dets_r, info, meta = _make_decode_outputs(
        jcfg, cars, depth_fn=lambda zz: zz + 1.5)
    j_rows, j_cls = j_run_tail(jnp.asarray(dets), jnp.asarray(dets_r),
                               jnp.asarray(info), img_l, img_r, meta, jcfg,
                               run_align=run_align)
    t_rows, t_cls = t_run_tail(torch.from_numpy(dets),
                               torch.from_numpy(dets_r),
                               torch.from_numpy(info), img_l, img_r, meta,
                               Config(), run_align=run_align)
    j_rows, t_rows = np.asarray(j_rows), t_rows.numpy()
    np.testing.assert_array_equal(t_cls.numpy(), np.asarray(j_cls))
    n = len(cars)
    assert np.isfinite(j_rows[:n]).all()
    np.testing.assert_allclose(t_rows[:n], j_rows[:n], atol=1e-3, rtol=1e-5)
    same = np.isfinite(j_rows) == np.isfinite(t_rows)
    assert same.all()
    fin = np.isfinite(j_rows)
    np.testing.assert_allclose(t_rows[fin], j_rows[fin], atol=1e-3, rtol=1e-4)
