"""The port's DCN (side_tpu_torch.ops.deform_conv) against side_tpu's.

Same numpy inputs through both packages, f32, tolerance 1e-5 absolute: the
two compute the same bilinear samples and differ only in the order of the
9*Cin-term sums.  The Pallas kernels (K1a per-image, K1b batch-packed) run
in interpret mode, patched as tests/test_deform_conv.py does.
"""

import functools
import unittest.mock as um

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from side_tpu.ops import deform_conv as jdc
from side_tpu_torch.ops import deform_conv as tdc

import torch_parity  # noqa: F401  (thread count)

ATOL = 1e-5


def _case(seed, B=2, H=8, W=16, C=8, Cout=8, off_range=2.5):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, H, W, C) * 0.5).astype(np.float32)
    w = (rng.randn(3, 3, C, Cout) * 0.3).astype(np.float32)
    b = rng.randn(Cout).astype(np.float32)
    off = rng.uniform(-off_range, off_range, (B, H, W, 9, 2)).astype(
        np.float32)
    mask = rng.rand(B, H, W, 9).astype(np.float32)
    return x, off, mask, w, b


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("radius", [1, 2])
def test_windowed_matches_jax_windowed(radius):
    x, off, mask, w, b = _case(0)
    want = np.asarray(jdc.deform_conv2d_windowed(
        *map(jnp.asarray, (x, off, mask, w, b)), radius=radius))
    got = tdc.deform_conv2d_windowed(*_t(x, off, mask, w, b), radius=radius)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("B", [2, 1], ids=["packed_K1b", "per_image_K1a"])
def test_windowed_matches_pallas_interpret(B):
    from side_tpu.ops import dcn_pallas as DP
    x, off, mask, w, b = _case(1, B=B)
    with um.patch("side_tpu.ops.dcn_pallas.pl.pallas_call",
                  functools.partial(DP.pl.pallas_call, interpret=True)):
        want = np.asarray(DP.deform_conv2d_pallas(
            *map(jnp.asarray, (x, off, mask, w, b)), radius=1))
    got = tdc.deform_conv2d_windowed(*_t(x, off, mask, w, b), radius=1)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_exact_matches_jax_gather():
    x, off, mask, w, b = _case(2, off_range=3.0)
    want = np.asarray(jdc._deform_conv2d_gather(
        *map(jnp.asarray, (x, off, mask, w, b))))
    got = tdc.deform_conv2d_exact(*_t(x, off, mask, w, b))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_om_block_matches_jax():
    """offset/mask conv + DCN, windowed R=1 on both sides."""
    rng = np.random.RandomState(3)
    B, H, W, C, Cout = 2, 8, 16, 8, 8
    x = (rng.randn(B, H, W, C) * 0.5).astype(np.float32)
    w_om = (rng.randn(3, 3, C, 27) * 0.4).astype(np.float32)
    b_om = (rng.randn(27) * 0.5).astype(np.float32)
    w = (rng.randn(3, 3, C, Cout) * 0.3).astype(np.float32)
    b = rng.randn(Cout).astype(np.float32)
    with jdc.dcn_mode("windowed"):
        want = np.asarray(jdc.deform_conv2d_om(
            *map(jnp.asarray, (x, w_om, b_om, w, b))))
    with tdc.dcn_mode("windowed", 1), torch.no_grad():
        got = tdc.deform_conv2d_om(*_t(x, w_om, b_om, w, b))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("radius", [1, 2])
def test_offsets_at_the_bound_and_integers(radius):
    """Offsets exactly at +-R, beyond it (clamped onto R) and at integers:
    the floor/fraction split must give the triangle-sum value there."""
    x, _, mask, w, b = _case(4)
    rng = np.random.RandomState(5)
    choices = np.array([-radius - 0.5, -radius, -1.0, 0.0, 1.0, radius,
                        radius + 0.75], np.float32)
    off = rng.choice(choices, size=(2, 8, 16, 9, 2)).astype(np.float32)
    want = np.asarray(jdc.deform_conv2d_windowed(
        *map(jnp.asarray, (x, off, mask, w, b)), radius=radius))
    got = tdc.deform_conv2d_windowed(*_t(x, off, mask, w, b), radius=radius)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_zero_offset_unit_mask_is_plain_conv():
    x, off, mask, w, b = _case(6)
    off[:] = 0.0
    mask[:] = 1.0
    got = tdc.deform_conv2d_windowed(*_t(x, off, mask, w, b))
    ref = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w).permute(3, 2, 0, 1), torch.from_numpy(b),
        padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)


def test_dispatch_follows_mode_and_rejects_gradients():
    x, off, mask, w, b = _case(7)
    xt, ot, mt, wt, bt = _t(x, off, mask, w, b)
    with tdc.dcn_mode("exact"):
        assert tdc.dcn_radius_tag() == -1
        got = tdc.deform_conv2d(xt, ot, mt, wt, bt)
    np.testing.assert_array_equal(
        got.numpy(), tdc.deform_conv2d_exact(xt, ot, mt, wt, bt).numpy())
    assert tdc.get_dcn_mode() == "windowed" and tdc.dcn_radius_tag() == 1
    # gradients are no longer rejected: on CPU tensors they come from
    # autograd through the plain version
    tdc.deform_conv2d(xt, ot, mt, wt.requires_grad_(True), bt).sum().backward()
    want = torch.tensor(w, requires_grad=True)
    tdc.deform_conv_plain(xt, ot, mt, want, bt, 1).sum().backward()
    np.testing.assert_array_equal(wt.grad.numpy(), want.grad.numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never computes on the CPU: only the dispatcher
    takes the plain version, for CPU tensors."""
    from side_tpu_torch.ops.dcn_cuda import DCN_FWD
    before = DCN_FWD.launches
    with pytest.raises(ValueError, match="CUDA device"):
        DCN_FWD(*_t(*_case(9)), 1)
    assert DCN_FWD.launches == before

