"""Tests of side_tpu_torch that need a CUDA device (marker `cuda`); each
skips without one.  This file imports nothing of JAX, so it also runs on a
machine that has the card but no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances of the kernel against its plain version, relative to the output's
max: 1e-5 in f32 (sum order) and 8e-3 in bf16 (sum order and the output's
rounding), as csrc/dcn_fwd.cu states.
"""

import numpy as np
import pytest
import torch

from side_tpu_torch.config import Config
from side_tpu_torch.ops import deform_conv as tdc
from side_tpu_torch.ops.dcn_cuda import DCN_FWD

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


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
    with pytest.raises(RuntimeError, match="inference-only"):
        tdc.deform_conv2d(x, off, mask, w.requires_grad_(True), b)


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
