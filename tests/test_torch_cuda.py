"""Tests of side_tpu_torch that need a CUDA device (marker `cuda`); each
skips without one.  This file imports nothing of JAX, so it also runs on a
machine that has the card but no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances of the kernels against their plain version, relative to each
result's max: forward 1e-5 in f32 (sum order) and 8e-3 in bf16 (sum order
and the output's rounding), as csrc/dcn_fwd.cu states; backward (K2, K3
against autograd of the plain version) 1e-4 in f32 (sum order, atomics)
and 2e-2 in bf16 (the plain version rounds the column gradient and d_x to
bf16), as csrc/dcn_bwd.cu states.  The fused forward K4 (dcn_fwd_om) is held
to the forward's tolerances, the gather K5 to 1e-6 relative in f32 (fused
multiply-add contraction) and one bf16 ulp (plus that f32 noise where the
four terms cancel).
"""

import numpy as np
import pytest
import torch

from side_tpu_torch.config import Config
from side_tpu_torch.ops import deform_conv as tdc
from side_tpu_torch.ops.dcn_cuda import (DCN_BWD_DCOORD, DCN_BWD_DX, DCN_FWD,
                                         DCN_FWD_OM)
from side_tpu_torch.ops.gather_cuda import (GATHER_BILINEAR,
                                            gather_bilinear_plain)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: dcn_fwd runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(device, seed=0, B=2, H=9, W=21, C=40, Cout=72, off_range=2.5):
    """Odd sizes: a pixel count, a channel count and an output width that
    are no multiples of the kernel's tiles."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(B, H, W, C) * 0.5,
              rng.uniform(-off_range, off_range, (B, H, W, 9, 2)),
              rng.rand(B, H, W, 9),
              rng.randn(3, 3, C, Cout) * 0.3,
              rng.randn(Cout)]
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


@pytest.mark.parametrize("radius", [1, 2, -1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_matches_plain_on_card(card, dtype, radius):
    x, off, mask, w, b = _case(card)
    x = x.to(dtype)
    got = DCN_FWD(x, off, mask, w, b, radius)
    want = tdc.deform_conv_plain(x, off, mask, w, b, radius)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= TOL[dtype], float(err)


def test_dispatch_on_card_launches_the_kernel(card):
    x, off, mask, w, b = _case(card, seed=1)
    before = DCN_FWD.launches
    with torch.inference_mode():
        got = tdc.deform_conv2d(x, off, mask, w)          # bias None
    assert DCN_FWD.launches == before + 1
    want = tdc.deform_conv_plain(x, off, mask, w, None, tdc.dcn_radius_tag())
    err = (got - want).abs().max() / want.abs().max()
    assert float(err) <= TOL[torch.float32]
    # with a gradient asked for, the forward is the same kernel, and the
    # backward launches K2 and K3 once each
    n_dx, n_dc = DCN_BWD_DX.launches, DCN_BWD_DCOORD.launches
    out = tdc.deform_conv2d(x, off, mask, w.requires_grad_(True), b)
    assert DCN_FWD.launches == before + 2
    out.sum().backward()
    assert (DCN_BWD_DX.launches, DCN_BWD_DCOORD.launches) == (n_dx, n_dc + 1)
    assert w.grad is not None and bool(torch.isfinite(w.grad).all())


@pytest.mark.parametrize("fault", ["f64_x", "f16_x", "bf16_offset",
                                   "strided_x", "offset_shape",
                                   "mask_on_cpu"])
def test_wrapper_raises_on_what_it_cannot_take(card, fault):
    x, off, mask, w, b = _case(card, seed=2)
    if fault == "f64_x":
        x = x.double()
    elif fault == "f16_x":
        x = x.half()
    elif fault == "bf16_offset":
        off = off.bfloat16()
    elif fault == "strided_x":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "offset_shape":
        off = off[:, :, :-1].contiguous()
    elif fault == "mask_on_cpu":
        mask = mask.cpu()
    before = DCN_FWD.launches
    with pytest.raises((TypeError, ValueError)):
        DCN_FWD(x, off, mask, w, b, 1)
    assert DCN_FWD.launches == before


def test_detector_run_on_card(card):
    """Detector.run on the card at a small input: 16 DCN launches, K
    finite rows."""
    from side_tpu_torch.runtime.detector import Detector
    from side_tpu_torch.runtime.synthetic import (he_scale, kitti_calib,
                                                  perturb_offsets,
                                                  random_frame)
    cfg = Config(input_h=128, input_w=256, K=20)
    det = Detector(cfg)
    assert det.device.type == "cuda"
    he_scale(det.model)
    perturb_offsets(det.model, seed=1)
    frame = random_frame(np.random.RandomState(0))
    before = DCN_FWD.launches
    pending = det.dispatch(det.load_and_pre(frame, kitti_calib()))
    out = det.finish(pending)
    assert DCN_FWD.launches == before + 16
    rows = pending["handles"][0]
    assert tuple(rows.shape) == (cfg.K, 13)
    assert bool(torch.isfinite(rows).all())
    assert out["tot"] > 0


def _grads(fn, x, off, mask, w, b, g):
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, off, mask, w, b)]
    fn(*leaves).backward(g)
    return [t.grad for t in leaves]


@pytest.mark.parametrize("radius", [1, 2, -1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_backward_kernels_match_plain_autograd_on_card(card, dtype, radius):
    """K2 (d_x) and K3 (d_offset, d_mask, d_weight) through DcnFunction
    against autograd of the plain version, odd sizes, offsets beyond +-R."""
    x, off, mask, w, b = _case(card, seed=3)
    x = x.to(dtype)
    g = torch.randn(x.shape[:3] + (w.shape[-1],), device=card,
                    generator=torch.Generator(card).manual_seed(4)).to(dtype)
    mode = ("exact", None) if radius < 0 else ("windowed", radius)
    with tdc.dcn_mode(*mode):
        got = _grads(tdc.deform_conv2d, x, off, mask, w, b, g)
    want = _grads(lambda *a: tdc.deform_conv_plain(*a, radius),
                  x, off, mask, w, b, g)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    for name, a, ref in zip(("x", "offset", "mask", "weight", "bias"),
                            got, want):
        err = float((a.float() - ref.float()).abs().max() /
                    ref.float().abs().max())
        assert err <= BWD_TOL[dtype], (name, err)


def test_nan_offset_gets_zero_offset_gradient(card):
    x, off, mask, w, b = _case(card, seed=5)
    off[0, 3, 4, 2] = torch.tensor([float("nan"), 0.3])
    off[1, 2, 7, 5] = float("nan")
    g = torch.randn(x.shape[:3] + (w.shape[-1],), device=card)
    d_x, d_off, d_mask, d_w, _ = _grads(tdc.deform_conv2d, x, off, mask, w,
                                        b, g)
    torch.cuda.synchronize()
    assert float(d_off[0, 3, 4, 2, 0]) == 0.0
    assert float(d_off[1, 2, 7, 5].abs().max()) == 0.0
    assert float(d_off[0, 3, 4, 2, 1].abs()) > 0.0     # its dx is 0.3
    for t in (d_x, d_off, d_mask, d_w):
        assert bool(torch.isfinite(t).all())


@pytest.mark.parametrize("fault", ["g_dtype", "g_shape", "strided_g",
                                   "f16_x", "offset_on_cpu", "weight_f64"])
def test_backward_wrappers_raise_on_what_they_cannot_take(card, fault):
    x, off, mask, w, b = _case(card, seed=6)
    g = torch.randn(x.shape[:3] + (w.shape[-1],), device=card)
    if fault == "g_dtype":
        g = g.bfloat16()
    elif fault == "g_shape":
        g = g[..., :-1].contiguous()
    elif fault == "strided_g":
        g = g.transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "f16_x":
        x, g = x.half(), g.half()
    elif fault == "offset_on_cpu":
        off = off.cpu()
    elif fault == "weight_f64":
        w = w.double()
    before = (DCN_BWD_DX.launches, DCN_BWD_DCOORD.launches)
    with pytest.raises((TypeError, ValueError)):
        DCN_BWD_DCOORD(x, g, off, mask, w, 1)
    with pytest.raises((TypeError, ValueError)):
        if fault == "g_dtype":
            DCN_BWD_DX(g.half(), off, mask, w, 1)
        else:
            DCN_BWD_DX(g, off, mask, w, 1)
    assert (DCN_BWD_DX.launches, DCN_BWD_DCOORD.launches) == before


def test_train_step_on_card_launches_each_kernel_16_times(card):
    """One Trainer step on the card at a small input: the forward kernel,
    K2 and K3 launch once per DeformBlock (16), every loss part is finite
    and the parameters move."""
    from side_tpu_torch.data.synthetic import scene_batch
    from side_tpu_torch.models.factory import create_model
    from side_tpu_torch.runtime.synthetic import he_scale, perturb_offsets
    from side_tpu_torch.runtime.trainer import Trainer
    cfg = Config(input_h=128, input_w=256, max_objs=8, uncert=True)
    model = create_model(cfg, seed=0)
    he_scale(model)
    perturb_offsets(model, seed=1)
    tr = Trainer(cfg, model, steps_per_epoch=4)
    assert tr.device.type == "cuda"
    batch = tr.to_device(scene_batch(cfg, np.random.RandomState(0), 2, 8))
    before = {k: v.clone() for k, v in tr.params.items()}
    counts = [k.launches for k in (DCN_FWD, DCN_BWD_DX, DCN_BWD_DCOORD)]
    stats = tr.train_step(batch)
    torch.cuda.synchronize()
    after = [k.launches for k in (DCN_FWD, DCN_BWD_DX, DCN_BWD_DCOORD)]
    assert [a - c for a, c in zip(after, counts)] == [16, 16, 16]
    assert all(np.isfinite(float(v)) for v in stats.values())
    moved = sum(not torch.equal(before[k], v) for k, v in tr.params.items())
    assert moved >= len(before) - 6      # all but the unread projections


# ------------------------------------------------- K4: fused offset/mask DCN
def _om_case(device, dtype, seed=7, B=3, H=9, W=21, C=40, Cout=72):
    """Odd sizes; dy, dx reach beyond +-2, some exactly on integers."""
    rng = np.random.RandomState(seed)
    om = rng.uniform(-2.5, 2.5, (B, H, W, 9, 3))
    om[0, :3, :5, :, :2] = rng.randint(-3, 4, (3, 5, 9, 2))
    arrays = [rng.randn(B, H, W, C) * 0.5, om.reshape(B, H, W, 27),
              rng.randn(3, 3, C, Cout) * 0.3, rng.randn(Cout)]
    x, om, w, b = [torch.tensor(a, dtype=torch.float32, device=device)
                   for a in arrays]
    return x.to(dtype), om.to(dtype), w, b


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_kernel_matches_plain_on_card(card, dtype, radius):
    x, om, w, b = _om_case(card, dtype)
    got = DCN_FWD_OM(x, om, w, b, radius)
    want = tdc.deform_conv_om_plain(x, om, w, b, radius)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= TOL[dtype], float(err)
    # and the unfused kernel fed the split operands
    o5 = om.reshape(*om.shape[:3], 9, 3)
    split = DCN_FWD(x, o5[..., :2].float().contiguous(),
                    torch.sigmoid(o5[..., 2].float()).contiguous(), w, b,
                    radius)
    err = (got.float() - split.float()).abs().max() / want.float().abs().max()
    assert float(err) <= TOL[dtype], float(err)


def test_fused_kernel_nan_offset_and_logit(card):
    """A NaN offset samples at -R (as dcn_fwd); a NaN mask logit makes that
    pixel's outputs NaN and no other's."""
    x, om, w, b = _om_case(card, torch.float32, seed=8)
    ref = om.clone()
    om[1, 4, 6, 3 * 2] = float("nan")          # dy of tap 2
    ref[1, 4, 6, 3 * 2] = -1.0
    got = DCN_FWD_OM(x, om, w, b, 1)
    want = DCN_FWD_OM(x, ref, w, b, 1)
    assert torch.equal(got, want)
    om[0, 2, 3, 3 * 5 + 2] = float("nan")      # mask logit of tap 5
    got = DCN_FWD_OM(x, om, w, b, 1)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[0, 2, 3]).all())
    got[0, 2, 3] = want[0, 2, 3]
    assert torch.equal(got, want)


@pytest.mark.parametrize("fault", ["strided_om", "f32_om_for_bf16_x",
                                   "om_shape", "f64_x", "negative_radius",
                                   "weight_bf16", "om_on_cpu"])
def test_fused_wrapper_raises_on_what_it_cannot_take(card, fault):
    x, om, w, b = _om_case(card, torch.float32, seed=9)
    radius = 1
    if fault == "strided_om":
        om = om.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    elif fault == "f32_om_for_bf16_x":
        x = x.bfloat16()
    elif fault == "om_shape":
        om = om[..., :18].contiguous()
    elif fault == "f64_x":
        x, om = x.double(), om.double()
    elif fault == "negative_radius":
        radius = -1
    elif fault == "weight_bf16":
        w = w.bfloat16()
    elif fault == "om_on_cpu":
        om = om.cpu()
    before = DCN_FWD_OM.launches
    with pytest.raises((TypeError, ValueError)):
        DCN_FWD_OM(x, om, w, b, radius)
    assert DCN_FWD_OM.launches == before


def test_fused_switch_routes_deform_block_om_on_card(card):
    """With the switch on, `deform_block_om` launches K4 and not K1 under
    no_grad; with a gradient wanted, or in exact mode, it takes K1."""
    rng = np.random.RandomState(10)
    x = torch.tensor(rng.randn(2, 9, 21, 40) * 0.5, dtype=torch.float32,
                     device=card)
    w_om = torch.tensor(rng.randn(27, 40, 3, 3) * 0.1, dtype=torch.float32,
                        device=card)
    b_om = torch.tensor(rng.randn(27) * 0.3, dtype=torch.float32, device=card)
    w = torch.tensor(rng.randn(3, 3, 40, 72) * 0.3, dtype=torch.float32,
                     device=card)
    b = torch.tensor(rng.randn(72), dtype=torch.float32, device=card)

    def counts():
        return DCN_FWD.launches, DCN_FWD_OM.launches

    with tdc.dcn_mode("windowed", 1):
        with torch.no_grad():
            want = tdc.deform_block_om(x, w_om, b_om, w, b)
        with tdc.dcn_fused():
            c0 = counts()
            with torch.no_grad():
                got = tdc.deform_block_om(x, w_om, b_om, w, b)
            assert counts() == (c0[0], c0[1] + 1)
            err = (got - want).abs().max() / want.abs().max()
            assert float(err) <= TOL[torch.float32]
            c0 = counts()
            out = tdc.deform_block_om(x, w_om, b_om,
                                      w.clone().requires_grad_(True), b)
            assert counts() == (c0[0] + 1, c0[1]) and out.requires_grad
    with tdc.dcn_mode("exact"), tdc.dcn_fused(), torch.no_grad():
        c0 = counts()
        tdc.deform_block_om(x, w_om, b_om, w, b)
        assert counts() == (c0[0] + 1, c0[1])


# --------------------------------------------------- K5: bilinear gather
def _gather_case(device, dtype, seed=11, B=2, H=11, W=19, C=24, P=501):
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(B, H, W, C), dtype=torch.float32,
                     device=device).to(dtype)
    sy = rng.rand(B, P) * (H - 1)
    sx = rng.rand(B, P) * (W - 1)
    sy[:, :7], sx[:, 3:11] = H - 1, W - 1        # last row / last column
    y0, x0 = np.floor(sy), np.floor(sx)
    as_t = lambda a, dt: torch.tensor(a, dtype=dt, device=device)
    return (x, as_t(y0, torch.int32), as_t(x0, torch.int32),
            as_t(sy - y0, torch.float32), as_t(sx - x0, torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gather_kernel_matches_plain_on_card(card, dtype):
    args = _gather_case(card, dtype)
    before = GATHER_BILINEAR.launches
    got = GATHER_BILINEAR(*args)
    assert GATHER_BILINEAR.launches == before + 1
    want = gather_bilinear_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max() / want.abs().max()) <= 1e-6
    else:
        # one bf16 ulp of each value, plus the f32 noise of the sum (fused
        # multiply-adds) where the four terms cancel
        ulp = want.float().abs() * 2.0 ** -7
        assert bool((diff <= ulp + 1e-6 * want.float().abs().max()).all())


@pytest.mark.parametrize("fault", ["int64_y0", "c_not_multiple_of_8",
                                   "strided_x", "fy_on_cpu", "count"])
def test_gather_wrapper_raises_on_what_it_cannot_take(card, fault):
    x, y0, x0, fy, fx = _gather_case(card, torch.float32, seed=12)
    if fault == "int64_y0":
        y0 = y0.long()
    elif fault == "c_not_multiple_of_8":
        x = x[..., :20].contiguous()
    elif fault == "strided_x":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "fy_on_cpu":
        fy = fy.cpu()
    elif fault == "count":
        fx = fx[:, :-1].contiguous()
    before = GATHER_BILINEAR.launches
    with pytest.raises((TypeError, ValueError)):
        GATHER_BILINEAR(x, y0, x0, fy, fx)
    assert GATHER_BILINEAR.launches == before


# ------------------------------------------------ the batched validation path
def test_batched_group_launches_k4_16_times_and_k1_never(card):
    """One batched group (2 frames, small input) with the fused switch on:
    16 launches of dcn_fwd_om, none of dcn_fwd; the rows agree with the
    unfused route's."""
    from side_tpu_torch.data.synthetic import val_scenes
    from side_tpu_torch.runtime.detector import Detector
    from side_tpu_torch.runtime.synthetic import he_scale, perturb_offsets
    cfg = Config(input_h=128, input_w=256, K=20, compute_dtype="float32")
    det = Detector(cfg)
    he_scale(det.model)
    perturb_offsets(det.model, seed=1)
    scenes = val_scenes(2, seed=0)

    def group():
        pres = [det.load_and_pre(pair, calib) for _, pair, calib in scenes]
        pending = det.dispatch_batch(pres)
        outs = det.finish_batch(pending)
        return pending["handles"][0], outs

    with tdc.dcn_mode("windowed", 1):
        before = (DCN_FWD.launches, DCN_FWD_OM.launches)
        with tdc.dcn_fused():
            rows_fused, outs = group()
        assert (DCN_FWD.launches, DCN_FWD_OM.launches) == (before[0],
                                                           before[1] + 16)
        rows_plain, _ = group()
        assert (DCN_FWD.launches, DCN_FWD_OM.launches) == (before[0] + 16,
                                                           before[1] + 16)
    assert tuple(rows_fused.shape) == (2, cfg.K, 13) and len(outs) == 2
    assert bool(torch.isfinite(rows_fused).all())
    # scores of the two routes (the network's output, before the solver)
    err = (rows_fused[..., 12] - rows_plain[..., 12]).abs().max()
    assert float(err) <= 1e-4
