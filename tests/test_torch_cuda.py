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

The forward body (K1, K4), K2 and K3 have two routes (ops/dcn_cuda.py:
dcn_route): bf16 at Cin % 64 == 0 and Cout in {64, 128, 256} runs on the
tensor cores, everything else (f32, and the odd widths of `_case`) on CUDA
cores.  Both are held to the same tolerances; the tensor-core route also
rounds the weight to bf16, which stays inside them
(tests/test_torch_dcn_mma.py).  On its tensor-core route K2 keeps the scatter
in the block where `dx_plan` says "patch" (R = 1 at Cout 64: no atomics,
the same bits every run) and adds to device memory where it says
"tile"; d_x is also compared over the image-border and patch-seam pixels
alone.  Outputs that sum with f32 atomics (d_weight on both routes; d_offset
and d_mask on the tensor-core route, over Cin/64 partial sums) may differ
between two runs by the order of the additions: bounded below at 1e-5 of each
output's max; under `deterministic_mode` K2 takes its patch body at every
width of the window and K3 sums partial copies in a fixed order, the same
bits on a second call.  K5 has two bodies (ops/gather_cuda.py:gather_body), both held
to the same tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

from side_tpu_torch.config import Config
from side_tpu_torch.ops import deform_conv as tdc
from side_tpu_torch.ops.dcn_cuda import (DCN_BWD_DCOORD, DCN_BWD_DX, DCN_FWD,
                                         DCN_FWD_OM, dcn_route, dx_plan)
from side_tpu_torch.models.resnet_dcn import deform_shapes
from side_tpu_torch.ops.gather_cuda import (GATHER_BILINEAR,
                                            GatherBilinearFunction,
                                            gather_bilinear_plain)
from side_tpu_torch.tools.acceptance_16 import PROTOCOL_SHAPES

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


# ------------------------------- the tensor-core route of the forward and K3
# ragged: 1,443 pixels in patches that overhang the image; small: one patch,
# the reduction split over blocks; wide: Cout 256 (64-pixel tiles) and Cin 128
MMA_CASES = {"ragged": dict(B=3, H=13, W=37, C=64, Cout=64),
             "small": dict(B=1, H=5, W=8, C=64, Cout=128),
             "wide": dict(B=2, H=9, W=21, C=128, Cout=256),
             "deep": dict(B=2, H=11, W=35, C=128, Cout=64)}


def _mma_case(device, name, seed):
    x, off, mask, w, b = _case(device, seed=seed, **MMA_CASES[name])
    w = w / (9 * x.shape[-1]) ** 0.5 / 0.3
    g = torch.randn(x.shape[:3] + (w.shape[-1],), device=device,
                    generator=torch.Generator(device).manual_seed(seed + 1))
    return x.bfloat16(), off, mask, w, b, g.bfloat16()


@pytest.mark.parametrize("radius", [1, 2, -1])
@pytest.mark.parametrize("name", list(MMA_CASES))
def test_tensor_core_forward_matches_plain_on_card(card, name, radius):
    x, off, mask, w, b, _ = _mma_case(card, name, seed=20)
    assert dcn_route(x.dtype, x.shape[-1], w.shape[-1]) == "tensor"
    before = (DCN_FWD.launches, DCN_FWD.tensor_core_launches)
    got = DCN_FWD(x, off, mask, w, b, radius)
    assert (DCN_FWD.launches, DCN_FWD.tensor_core_launches) == (
        before[0] + 1, before[1] + 1)
    want = tdc.deform_conv_plain(x, off, mask, w, b, radius)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= TOL[torch.bfloat16], float(err)
    # the same bits run to run (no atomics, the splits add in a fixed order)
    assert torch.equal(got, DCN_FWD(x, off, mask, w, b, radius))
    # and the CUDA-core body on the same operands, through the test entry
    old = DCN_FWD(x, off, mask, w, b, radius, cuda_core=True)
    assert DCN_FWD.tensor_core_launches == before[1] + 2
    err = (old.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= TOL[torch.bfloat16], float(err)


@pytest.mark.parametrize("name", list(MMA_CASES))
def test_tensor_core_fused_forward_equals_unfused_on_card(card, name):
    x, off, mask, w, b, _ = _mma_case(card, name, seed=22)
    logit = torch.randn(mask.shape, device=card,
                        generator=torch.Generator(card).manual_seed(23))
    om = torch.cat([off, logit[..., None]], -1).reshape(
        *x.shape[:3], 27).bfloat16()
    before = DCN_FWD_OM.tensor_core_launches
    got = DCN_FWD_OM(x, om, w, b, 1)
    assert DCN_FWD_OM.tensor_core_launches == before + 1
    want = tdc.deform_conv_om_plain(x, om, w, b, 1)
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= TOL[torch.bfloat16], float(err)
    o5 = om.reshape(*om.shape[:3], 9, 3)
    split = DCN_FWD(x, o5[..., :2].float().contiguous(),
                    torch.sigmoid(o5[..., 2].float()).contiguous(), w, b, 1)
    assert torch.equal(got, split)


@pytest.mark.parametrize("radius", [1, 2, -1])
@pytest.mark.parametrize("name", list(MMA_CASES))
def test_tensor_core_k3_matches_plain_autograd_on_card(card, name, radius):
    x, off, mask, w, b, g = _mma_case(card, name, seed=24)
    before = (DCN_BWD_DCOORD.launches, DCN_BWD_DCOORD.tensor_core_launches)
    got = DCN_BWD_DCOORD(x, g, off, mask, w, radius)
    assert (DCN_BWD_DCOORD.launches,
            DCN_BWD_DCOORD.tensor_core_launches) == (before[0] + 1,
                                                     before[1] + 1)
    want = _grads(lambda *a: tdc.deform_conv_plain(*a, radius),
                  x, off, mask, w, b, g)[1:4]
    old = DCN_BWD_DCOORD(x, g, off, mask, w, radius, cuda_core=True)
    assert DCN_BWD_DCOORD.tensor_core_launches == before[1] + 1
    for name_, a, o, ref in zip(("offset", "mask", "weight"), got, old, want):
        assert a.dtype == torch.float32 and a.shape == ref.shape
        scale = float(ref.abs().max())
        assert float((a - ref).abs().max()) / scale <= BWD_TOL[
            torch.bfloat16], name_
        assert float((o - ref).abs().max()) / scale <= BWD_TOL[
            torch.bfloat16], name_


def test_route_counter_follows_dtype_and_widths(card):
    """f32 operands and odd widths take the CUDA-core route (the counter of
    tensor-core launches stays), bf16 at the model's widths the other."""
    kernels = (DCN_FWD, DCN_BWD_DCOORD)
    for dtype, kw, tensor in ((torch.float32, MMA_CASES["ragged"], 0),
                              (torch.bfloat16, dict(C=40, Cout=72), 0),
                              (torch.bfloat16, dict(C=64, Cout=72), 0),
                              (torch.bfloat16, MMA_CASES["ragged"], 1)):
        x, off, mask, w, b = _case(card, seed=26, **kw)
        x = x.to(dtype)
        g = torch.randn(x.shape[:3] + (w.shape[-1],), device=card).to(dtype)
        route = dcn_route(dtype, x.shape[-1], w.shape[-1])
        assert (route == "tensor") == bool(tensor)
        before = [(k.launches, k.tensor_core_launches) for k in kernels]
        out = DCN_FWD(x, off, mask, w, b, 1)
        grads = DCN_BWD_DCOORD(x, g, off, mask, w, 1)
        after = [(k.launches, k.tensor_core_launches) for k in kernels]
        assert after == [(n + 1, t + tensor) for n, t in before]
        want = tdc.deform_conv_plain(x, off, mask, w, b, 1)
        err = (out.float() - want.float()).abs().max()
        assert float(err / want.float().abs().max()) <= TOL[dtype]
        assert all(bool(torch.isfinite(t).all()) for t in grads)


def test_atomic_sums_spread_between_runs_is_bounded(card):
    """K3 on the tensor-core route adds d_offset and d_mask over Cin/64 = 4
    partial sums and d_weight over the pixel slices with f32 atomics: two
    runs agree to 1e-5 of each output's max (seen: 1e-7)."""
    x, off, mask, w, b = _case(card, seed=28, B=2, H=24, W=40, C=256, Cout=64)
    x = x.bfloat16()
    g = torch.randn(x.shape[:3] + (64,), device=card).bfloat16()
    first = DCN_BWD_DCOORD(x, g, off, mask, w, 1)
    for _ in range(3):
        again = DCN_BWD_DCOORD(x, g, off, mask, w, 1)
        for a, c in zip(first, again):
            assert float((a - c).abs().max()) <= 1e-5 * float(a.abs().max())


# ----------------------------------------------- K2 on the tensor-core route
def _seam_mask(H, W, patch_h, device):
    """Pixels on the image border or on the first / last row or column of a
    d_x patch (patch_h x 16; 64-pixel tiles have no seams in the image)."""
    ys = torch.arange(H, device=device)
    xs = torch.arange(W, device=device)
    on_y = (ys == 0) | (ys == H - 1)
    on_x = (xs == 0) | (xs == W - 1)
    if patch_h:
        on_y |= (ys % patch_h == 0) | (ys % patch_h == patch_h - 1)
        on_x |= (xs % 16 == 0) | (xs % 16 == 15)
    return on_y[:, None] | on_x[None, :]


@pytest.mark.parametrize("offsets", ["random", "at_radius", "far_outside"])
@pytest.mark.parametrize("radius", [1, 2, 0, -1])
@pytest.mark.parametrize("name", list(MMA_CASES))
def test_tensor_core_k2_matches_plain_autograd_on_card(card, name, radius,
                                                       offsets):
    """d_x of the tensor-core K2 (the patch route for R = 1 at Cout 64, the
    tile route elsewhere) against autograd of the plain version: over the
    whole output and over the border and patch-seam pixels alone, with
    random offsets, every offset at exactly +-R and offsets far outside
    the window; the CUDA-core body and the tile route on the same operands
    through the test entries."""
    x, off, mask, w, b, g = _mma_case(card, name, seed=30)
    B, H, W, C = x.shape
    if offsets == "at_radius":
        off = torch.where(off > 0, 1.0, -1.0) * abs(radius)
    elif offsets == "far_outside":
        off = off * 8.0
    plan = dx_plan(B, H, W, C, w.shape[-1], radius)
    patch = radius == 1 and w.shape[-1] == 64
    assert plan["scatter"] == ("patch" if patch else "tile")
    before = (DCN_BWD_DX.launches, DCN_BWD_DX.tensor_core_launches)
    got = DCN_BWD_DX(g, off, mask, w, radius)
    assert (DCN_BWD_DX.launches, DCN_BWD_DX.tensor_core_launches) == (
        before[0] + 1, before[1] + 1)
    want = _grads(lambda *a: tdc.deform_conv_plain(*a, radius),
                  x, off, mask, w, b, g)[0]
    old = DCN_BWD_DX(g, off, mask, w, radius, cuda_core=True)
    tile = DCN_BWD_DX(g, off, mask, w, radius, scatter="tile")
    assert DCN_BWD_DX.tensor_core_launches == before[1] + 2
    seam = _seam_mask(H, W, plan["patch_h"], card)
    scale = float(want.float().abs().max())
    assert scale > 0
    for a in (got, old, tile):
        assert a.dtype == torch.bfloat16 and a.shape == want.shape
        diff = (a.float() - want.float()).abs()
        assert float(diff.max()) / scale <= BWD_TOL[torch.bfloat16]
        seam_scale = float(want.float()[:, seam].abs().max())
        assert float(diff[:, seam].max()) / seam_scale <= BWD_TOL[
            torch.bfloat16]
    if plan["scatter"] == "patch":
        # no atomics on the patch route: the same bits every run
        assert torch.equal(got, DCN_BWD_DX(g, off, mask, w, radius))


@pytest.mark.parametrize("offsets", ["random", "far_outside"])
@pytest.mark.parametrize("name", list(MMA_CASES))
def test_deterministic_k2_k3_match_plain_and_repeat_on_card(card, name,
                                                            offsets):
    """Under deterministic_mode (R = 1): K2 on its patch body at every
    width and K3 with its partial sums in copies against autograd of the
    plain version (the same tolerances, d_x also over the border and patch
    seams), two calls equal bit for bit, still on the tensor-core route."""
    from side_tpu_torch.ops.dcn_cuda import deterministic_mode
    x, off, mask, w, b, g = _mma_case(card, name, seed=36)
    if offsets == "far_outside":
        off = off * 8.0
    B, H, W, C = x.shape
    plan = dx_plan(B, H, W, C, w.shape[-1], 1, deterministic=True)
    assert plan["scatter"] == "patch"
    want = _grads(lambda *a: tdc.deform_conv_plain(*a, 1),
                  x, off, mask, w, b, g)
    before = (DCN_BWD_DX.tensor_core_launches,
              DCN_BWD_DCOORD.tensor_core_launches)
    with deterministic_mode():
        runs = [(DCN_BWD_DX(g, off, mask, w, 1),
                 *DCN_BWD_DCOORD(x, g, off, mask, w, 1)) for _ in range(2)]
    assert (DCN_BWD_DX.tensor_core_launches,
            DCN_BWD_DCOORD.tensor_core_launches) == (before[0] + 2,
                                                     before[1] + 2)
    for a, b2 in zip(*runs):
        assert torch.equal(a, b2)
    seam = _seam_mask(H, W, plan["patch_h"], card)
    for got, ref in zip(runs[0], want[:4]):
        ref = ref.reshape(got.shape).float()
        diff = (got.float() - ref).abs()
        assert float(diff.max()) / float(ref.abs().max()) <= BWD_TOL[
            torch.bfloat16]
    diff = (runs[0][0].float() - want[0].float()).abs()[:, seam]
    assert float(diff.max()) / float(
        want[0].float()[:, seam].abs().max()) <= BWD_TOL[torch.bfloat16]


def test_deterministic_mode_refuses_the_atomic_routes_on_card(card):
    """With torch.use_deterministic_algorithms(True) and no warn-only, K2
    off the window and both kernels on their CUDA-core routes raise, as
    PyTorch's own operations without a deterministic implementation do;
    the windowed tensor-core route launches."""
    x, off, mask, w, b, g = _mma_case(card, "wide", seed=38)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with pytest.raises(RuntimeError, match="deterministic"):
            DCN_BWD_DX(g, off, mask, w, -1)
        with pytest.raises(RuntimeError, match="deterministic"):
            DCN_BWD_DX(g, off, mask, w, 1, cuda_core=True)
        with pytest.raises(RuntimeError, match="deterministic"):
            DCN_BWD_DCOORD(x, g, off, mask, w, 1, cuda_core=True)
        assert bool(torch.isfinite(DCN_BWD_DX(g, off, mask, w, 1)).all())
    finally:
        torch.use_deterministic_algorithms(prev)


def test_k2_route_counter_follows_dtype_and_widths(card):
    for dtype, kw, tensor in ((torch.float32, MMA_CASES["ragged"], 0),
                              (torch.bfloat16, dict(C=40, Cout=72), 0),
                              (torch.bfloat16, dict(C=64, Cout=72), 0),
                              (torch.bfloat16, MMA_CASES["wide"], 1)):
        x, off, mask, w, b = _case(card, seed=32, **kw)
        g = torch.randn(x.shape[:3] + (w.shape[-1],), device=card).to(dtype)
        before = (DCN_BWD_DX.launches, DCN_BWD_DX.tensor_core_launches)
        d_x = DCN_BWD_DX(g, off, mask, w, 1)
        assert (DCN_BWD_DX.launches, DCN_BWD_DX.tensor_core_launches) == (
            before[0] + 1, before[1] + tensor)
        assert d_x.dtype == dtype and bool(torch.isfinite(d_x).all())


def test_k2_launcher_refuses_a_foreign_plan(card):
    """The C launcher checks the plan's shared-memory bytes, patch height
    and tap split against its own and launches nothing otherwise."""
    from side_tpu_torch.ops.dcn_cuda import BWD_LIB
    _, off, mask, w, _, g = _mma_case(card, "ragged", seed=34)
    B, H, W, Cout = g.shape
    plan = dx_plan(B, H, W, 64, Cout, 1)
    tile = dx_plan(B, H, W, 64, Cout, -1)
    dx = torch.zeros((B, H, W, 64), dtype=torch.float32, device=card)
    lib = BWD_LIB.load()

    def launch(radius, patch_h, splits, smem):
        return lib.dcn_bwd_dx_launch(
            g.data_ptr(), off.data_ptr(), mask.data_ptr(), w.data_ptr(),
            dx.data_ptr(), B, H, W, 64, Cout, radius, 1, 1, patch_h, splits,
            smem, torch.cuda.current_stream().cuda_stream)

    assert launch(1, plan["patch_h"], 1, plan["smem_bytes"] + 16) != 0
    assert launch(1, 5, 1, plan["smem_bytes"]) != 0
    assert launch(2, plan["patch_h"], 1, plan["smem_bytes"]) != 0
    assert launch(-1, 0, 1, tile["smem_bytes"] + 16) != 0
    assert launch(-1, 0, 8, tile["smem_bytes"]) != 0     # an empty split
    torch.cuda.synchronize()
    assert float(dx.abs().max()) == 0.0
    assert launch(-1, 0, 1, tile["smem_bytes"]) == 0
    torch.cuda.synchronize()
    assert float(dx.abs().max()) > 0.0


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


@pytest.mark.parametrize("C,P", [(8, 501), (64, 333), (256, 77), (24, 501)],
                         ids=["C8", "C64", "C256", "C24_thread_body"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gather_bodies_match_plain_on_card(card, dtype, C, P):
    """The warp-chunk kernel at its narrowest and widest width (C = 8: a
    warp instruction covers 32 samples; C = 256: one) with sample counts that
    are no multiple of a warp's 32-sample chunk or of the samples a thread
    has in flight, the one-thread-per-(sample, 8 channels) kernel at a
    width only it takes (C = 24), and the latter through the test entry on
    the former's operands."""
    from side_tpu_torch.ops.gather_cuda import gather_body
    args = _gather_case(card, dtype, seed=13, C=C, P=P)
    assert gather_body(C) == ("thread" if C == 24 else "warp")
    want = gather_bilinear_plain(*args)
    for kw in ({}, {"per_thread": True}):
        got = GATHER_BILINEAR(*args, **kw)
        assert got.dtype == dtype and got.shape == want.shape
        diff = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            assert float(diff.max() / want.abs().max()) <= 1e-6
        else:
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", PROTOCOL_SHAPES,
                         ids=["x".join(map(str, s)) for s in PROTOCOL_SHAPES])
def test_kernels_at_the_protocol_shapes_on_card(card, shape, dtype):
    """The forward kernel, K2 and K3 through DcnFunction against the plain
    version and its autograd at B = 8, R = 1, offsets far outside the
    window (as a trained model's are); bf16 takes the tensor-core route."""
    _check_kernels_at(card, shape, dtype, 8, 8.0)


RESDCN_SHAPES = [(s, b) for s in deform_shapes(18) for b in (2, 8)] + [
    (deform_shapes(50)[0], 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,batch", RESDCN_SHAPES, ids=[
    "x".join(map(str, s)) + f"_B{b}" for s, b in RESDCN_SHAPES])
def test_kernels_at_the_resdcn_shapes_on_card(card, shape, batch, dtype):
    """The forward kernel, K2 and K3 at the DeformBlock shapes of resdcn_18
    at 384x1280 (Cin 512/256/128 at 1/32, 1/16, 1/8; B = 2 serves a pair,
    B = 8 trains four) and resdcn_50's first (Cin 2048), offsets beyond
    +-1."""
    _check_kernels_at(card, shape, dtype, batch, 1.0)


def _check_kernels_at(card, shape, dtype, batch, off_scale, radius=1):
    """Forward, K2 and K3 through DcnFunction against the plain version and
    its autograd at one shape (offsets in +-1.5 * off_scale), windowed at
    `radius` or exact where it is -1."""
    cin, h, w_, cout = shape
    gen = torch.Generator(card).manual_seed(sum(shape) + batch)
    x = torch.randn(batch, h, w_, cin, device=card, generator=gen).to(dtype)
    off = (torch.rand(batch, h, w_, 9, 2, device=card, generator=gen) * 3.0
           - 1.5) * off_scale
    mask = torch.rand(batch, h, w_, 9, device=card, generator=gen)
    w = torch.randn(3, 3, cin, cout, device=card, generator=gen) / (
        9 * cin) ** 0.5
    b = torch.randn(cout, device=card, generator=gen) * 0.1
    g = torch.randn(batch, h, w_, cout, device=card,
                    generator=gen).to(dtype)
    kernels = (DCN_FWD, DCN_BWD_DX, DCN_BWD_DCOORD)
    before = [k.tensor_core_launches for k in kernels]
    at_radius = [k.radius_launches[radius] for k in kernels]
    with (tdc.dcn_mode("windowed", radius) if radius >= 0
          else tdc.dcn_mode("exact")):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, off, mask, w, b)]
        out = tdc.deform_conv2d(*leaves)
        out.backward(g)
    got = [out.detach()] + [t.grad for t in leaves]
    assert [k.radius_launches[radius] - n
            for k, n in zip(kernels, at_radius)] == [1, 1, 1]
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, off, mask, w, b)]
    ref = tdc.deform_conv_plain(*leaves, radius)
    ref.backward(g)
    want = [ref.detach()] + [t.grad for t in leaves]
    tensor = dtype == torch.bfloat16
    assert [k.tensor_core_launches - n for k, n in zip(
        kernels, before)] == [int(tensor)] * 3
    for name, a, r in zip(("out", "x", "offset", "mask", "weight", "bias"),
                          got, want):
        err = float((a.float() - r.float()).abs().max() /
                    r.float().abs().max())
        tol = (TOL if name == "out" else BWD_TOL)[dtype]
        assert err <= tol, (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_exact_kernels_at_a_protocol_shape_on_card(card, dtype):
    """Exact mode (R = -1), as the clamp-finetune recipe trains: the forward
    kernel, K2 and K3 against the plain exact version and its autograd at
    the protocol's Cin-256, Cout-64 shape with 2 pairs (B = 4), offsets far
    outside +-1; each launch counted at radius -1."""
    _check_kernels_at(card, PROTOCOL_SHAPES[3], dtype, 4, 8.0, radius=-1)


def _small_detector(card):
    """A 128x256 f32 flagship on the card, He-scaled with seeded offset
    convs (chip_smoke.py phase 3's weights): offsets reach past +-1."""
    from side_tpu_torch.runtime.detector import Detector
    from side_tpu_torch.runtime.synthetic import he_scale, perturb_offsets
    det = Detector(Config(input_h=128, input_w=256, K=12, cv_topk=6,
                          compute_dtype="float32"), device=card)
    he_scale(det.model)
    perturb_offsets(det.model, seed=3)
    return det


def test_offset_audit_capture_matches_conv_on_card(card):
    """The audit's capture of every DeformBlock's offsets equals F.conv2d
    of that block's input on the card (f32, TF32 off), split per tap
    [dy, dx, logit], and leaves the network's output as it was."""
    import functools
    from side_tpu_torch.data.synthetic import val_scenes
    from side_tpu_torch.tools import offset_audit
    det = _small_detector(card)
    _, images, calib = val_scenes(1, seed=2)[0]
    batch = det.load_and_pre(images, calib)["batch"]
    inputs, got = {}, {}
    blocks = {n: m for n, m in det.model.named_modules()
              if isinstance(m, offset_audit.DeformBlock)}
    handles = [m.register_forward_pre_hook(functools.partial(
        lambda n, mod, args: inputs.setdefault(n, args[0].clone()), n))
        for n, m in blocks.items()]
    try:
        with offset_audit.capture_offsets(det.model,
                                          lambda n, o: got.setdefault(n, o)):
            out = det.network(batch)
    finally:
        for h in handles:
            h.remove()
    assert list(got) == list(blocks) and len(got) == 16
    for name, block in blocks.items():
        with torch.no_grad():
            om = torch.nn.functional.conv2d(
                inputs[name], block.offset_mask.weight,
                block.offset_mask.bias, padding=1).permute(0, 2, 3, 1)
        want = om.reshape(*om.shape[:3], 9, 3)[..., 0:2]
        err = float((got[name] - want).abs().max() / want.abs().max())
        assert err <= 1e-6, (name, err)
    assert max(float(o.abs().max()) for o in got.values()) > 1.0
    assert torch.equal(det.network(batch)["hm"], out["hm"])


def test_keep_mode_load_on_card(card, tmp_path):
    """An exact-tagged checkpoint loaded with keep_dcn_mode runs its forward
    at R = 1 on the card (16 launches at radius 1, none at -1); the
    default load switches to exact (16 at radius -1)."""
    from side_tpu_torch import weights
    from side_tpu_torch.data.synthetic import val_scenes
    from side_tpu_torch.runtime import checkpoint
    from side_tpu_torch.runtime.detector import Detector
    det = _small_detector(card)
    path = str(tmp_path / "exact.npz")
    params, stats = weights.to_flax(det.model.state_dict())
    with tdc.dcn_mode("exact"):
        checkpoint.save_checkpoint(path, 1, params, stats)
    cfg = dataclasses.replace(det.cfg, load_model=path)
    _, images, calib = val_scenes(1, seed=2)[0]
    for keep, radius in ((True, 1), (False, -1)):
        with tdc.dcn_mode("windowed", 1):
            det = Detector(cfg, device=card, keep_dcn_mode=keep)
            before = dict(DCN_FWD.radius_launches)
            det.network(det.load_and_pre(images, calib)["batch"])
            torch.cuda.synchronize()
            launched = {r: n - before.get(r, 0)
                        for r, n in DCN_FWD.radius_launches.items()
                        if n - before.get(r, 0)}
            assert launched == {radius: 16}, (keep, launched)
            assert tdc.dcn_radius_tag() == radius


def test_box_solver_moves_under_inference_mode_on_card(card):
    """The tail solves under torch.inference_mode; the solve must not rely
    on forward-mode AD there (PyTorch 2.11 gives zero tangents, and the
    solver returned its initial state).  One detection of the acceptance
    fixture's scene 0 (a car at z = 29.8 m, keypoint type 1): the solve
    on the card under inference mode equals the CPU's outside it, and
    theta moves from its initial 4.466 to 3.916."""
    from side_tpu_torch.postprocess import box_solver as BS
    row = dict(left_u=0.0580025, right_u=0.1813406, top_v=-0.0006835,
               bottom_v=0.0621107, kpt_u=0.1020519, left_u_r=0.0369943,
               right_u_r=0.1637822, alpha=2.7763853, h=1.6257122, bl=0.54,
               lw=0.8229299, ll=1.9409431, rw=-0.8229299, rl=-1.9409431,
               bw=-0.8229299, bot_l=1.9409431, kw=-0.8229299,
               kl=1.9409431, m_ul=1.0, m_ur=1.0, m_uk=1.0, m_vt=1.0,
               m_vb=1.0, m_alpha=0.0, m_ul_r=0.0, m_ur_r=0.0)

    def consts(device):
        return BS.SolveConsts(**{k: torch.full((3,), v, device=device)
                                 for k, v in row.items()})

    z = torch.full((3,), 29.823736)
    want = BS.solve_x_y_theta(consts("cpu"), z)
    with torch.inference_mode():
        got = BS.solve_x_y_theta(consts(card), z.to(card)).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert abs(float(got[0, 2]) - 3.9159) < 1e-3


# ---------------------------------------------------- the voxel variant's K5
def test_gather_autograd_backward_matches_plain_on_card(card):
    """GatherBilinearFunction (K5 forward, the scatter-add backward) on an
    f32 map against autograd of the plain gather: 1e-5 of the gradient's
    largest value; a bf16 map with the f32 output the voxel path takes
    launches the kernel and matches the plain version to 1e-6."""
    args = _gather_case(card, torch.float32, seed=21, C=64, P=3001)
    x = args[0].clone().requires_grad_(True)
    out = GatherBilinearFunction.apply(x, *args[1:], torch.float32)
    g = torch.randn(out.shape, device=card,
                    generator=torch.Generator(card).manual_seed(22))
    out.backward(g)
    xp = args[0].clone().requires_grad_(True)
    gather_bilinear_plain(xp, *args[1:]).backward(g)
    assert float((x.grad - xp.grad).abs().max() / xp.grad.abs().max()) \
        <= 1e-5
    xb = args[0].to(torch.bfloat16)
    before = GATHER_BILINEAR.launches
    got = GATHER_BILINEAR(xb, *args[1:], out_dtype=torch.float32)
    assert GATHER_BILINEAR.launches == before + 1
    want = gather_bilinear_plain(xb, *args[1:], torch.float32)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-6


def test_voxel_net_on_card_launches_k5_twice(card, monkeypatch):
    """The voxel variant's forward on the card runs K5 once a view (and
    never the plain gather) and equals the same network on the CPU (f32,
    TF32 off): head maps and depths 1e-3 of their largest value."""
    from side_tpu_torch.models import voxel_net as tvn
    from side_tpu_torch.models.factory import create_model
    from side_tpu_torch.runtime.synthetic import interior_init
    cfg = Config(input_h=128, input_w=256, compute_dtype="float32", K=3,
                 depth_variant="voxel")
    cpu = create_model(cfg, seed=3).eval()
    interior_init(cpu, seed=4)
    gpu = create_model(cfg, seed=3)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(card).eval()
    gen = torch.Generator().manual_seed(5)
    f, W = 200.0, 256
    p2 = torch.tensor([[[f, 0, W / 2, 0.0], [0, f, 64.0, 0.0],
                        [0, 0, 1, 0]]])
    p3 = p2.clone()
    p3[0, 0, 3] = -f * 0.5
    batch = {"input": torch.randn(1, 128, 256, 3, generator=gen),
             "input_right": torch.randn(1, 128, 256, 3, generator=gen),
             "fb": torch.tensor([f * 0.5]), "p2": p2, "p3": p3,
             "trans": torch.tensor([[[0.25, 0, 0], [0, 0.25, 0]]]),
             "trans_inv": torch.tensor([[[4.0, 0, 0], [0, 4.0, 0]]])}
    # GT boxes at feature resolution, 8-12 m away (the decode order of
    # random heads is float noise between devices)
    bbox = torch.tensor([[[10.0, 10, 16, 18], [28, 12, 40, 20],
                          [44, 14, 50, 22]]])
    disp = torch.tensor([[2.5, 2.0, 3.0]])[..., None] * torch.tensor(
        [1.0, 0, 1, 0])
    target = (bbox, bbox - disp, torch.tensor([[True, True, False]]))
    with torch.inference_mode():
        want = cpu(batch, target=target)

        def refuse(*a, **k):
            raise AssertionError("the plain gather ran on the card")
        monkeypatch.setattr(tvn, "gather_bilinear_plain", refuse)
        before = GATHER_BILINEAR.launches
        got = gpu({k: v.to(card) for k, v in batch.items()},
                  target=tuple(t.to(card) for t in target))
    assert GATHER_BILINEAR.launches == before + 2
    for name, w in want.items():
        err = float((got[name].cpu() - w).abs().max() / w.abs().max())
        assert err <= 1e-3, (name, err)


def test_synced_folded_batchnorm_two_gloo_ranks_on_card(card, tmp_path):
    """Two gloo ranks on cuda:0 (tests/torch_dp.py: NCCL refuses two ranks
    on one GPU) each run a training-mode FoldedBatchNorm forward and
    backward on half of the batch, synced; against one module on the joined
    batch on the card, f32: output, d_x, d_weight and d_bias (summed over
    the ranks) and running statistics to 1e-6 relative."""
    import torch_dp
    got = [r["folded1"] for r in torch_dp.spawn(
        torch_dp.bn_job, 2, str(tmp_path), (("folded", 1),), "cuda")]
    bn, x, g = torch_dp.bn_case("folded", 1)
    want = torch_dp.bn_run(bn.to(card), torch.from_numpy(x).to(card),
                           torch.from_numpy(g).to(card))
    for key in ("y", "dx"):
        assert torch_dp.rel_err(torch.cat([r[key] for r in got]),
                                want[key]) <= 1e-6, key
    for key in ("dweight", "dbias"):
        assert torch_dp.rel_err(got[0][key] + got[1][key],
                                want[key]) <= 1e-6, key
    for key in ("running_mean", "running_var"):
        assert torch.equal(got[0][key], got[1][key]), key
        assert torch_dp.rel_err(got[0][key], want[key]) <= 1e-6, key
